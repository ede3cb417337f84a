// K3: fused split re/im MMSE equalizer, a lane on one CTA or one warp.
//
// Replaces: src/repro/pipelines/mmse.py, mmse_equalize_split_pallas
// (_mmse_split_kernel): the Gram matrix and matched filter of the complex
// system accumulated straight from the Re/Im planes
//   Gr = Hr^T Hr + Hi^T Hi   (one stacked sum over [Hr; Hi])
//   Gi = C - C^T,  C = Hr^T Hi
//   rhs = [Hs^T [yr; yi] ; Hs^T [yi; -yr]],  Hs = [Hr; Hi]
// and the real embedding [[Gr + sigma2 I, -Gi], [Gi, Gr + sigma2 I]]
// (2n x 2n) solved by the fused Cholesky chain of K1.  The output is the
// real-stacked (2n, k) = [Re x; Im x].
//
// What bounds it on an H100: each lane reads 2 m n + 2 m k floats and
// writes 2 n k; the least work is 2 m n (n + 1) (one triangle of Gr) +
// 2 m n^2 (C) + 8 m n k + (2n)^3/3 + 2 (2n)^2 k FLOPs.  Both bounds are
// small; the 4n-step ordered chain on the 2n x 2n embedding, a block
// barrier per step, is what holds it back.  The design builds only the
// lower triangle of the embedding (the chain never reads the upper half,
// which is where -Gi would go, so C is parked there on its way to Gi),
// keeps planes, system and right-hand sides in shared memory, and shares
// the chain with K1 and K2.
//
// A lane larger than shared memory (n > 96 at m = n + 4, k = 2) takes the
// global form: the four planes are read in place from device memory, the
// 2n x 2n embedding lives in a per-lane slice of a work buffer (1 MB a
// lane at n = 256) and x is solved in place in X.  After the same Gram
// stage it runs the panel chain (chol_panels.cuh): a panel of bs columns
// is factored in shared memory and the embedding's trailing lower
// triangle updated once a panel from register tiles, each product
// subtracted in chol_chain's order, so the global form equals the shared
// form bit for bit at every panel width.  The plan (threads, bs, shared
// memory) is pipelines/cholesky_solve.py's chol_panel_plan at (2n, k).
//
// The warp form (n <= 32, k <= 8) runs a lane on one warp, a CTA of 32
// threads, with no block barrier (warp_chain.cuh): the planes are
// staged into the CTA's shared memory (columns padded to a
// multiple of four, so a tile's four columns are one 16-byte load); each
// thread sums a unit of 4 x 4 tiles -- Gr(I, J), C(I, J) and C(J, I) in
// the order above, so that Gi = C - C^T on both sides of the diagonal
// comes out of one thread's registers (past n = 28 four threads first
// sum a second, diagonal unit and park it in the chain's scratch) -- and
// the matched filter of its own rows into registers; then the embedding
// is written over the planes (its lower triangle only, at the pitch
// warp_pitch(2n), 68 at n = 32) and the chain runs with thread t owning
// rows t and 2n - 1 - t, the k right-hand sides in its registers.  A
// lane takes 4 (max(2n warp_pitch(2n), 2 m n4 + 2 m k) +
// warp_scratch_floats(2n, k)) bytes (n4 = n rounded up to 4; each part
// rounded to 16 bytes): 17,984 at n = 32, m = 36, k = 2, so an SM holds
// 12 lanes.  The form is pipelines/mmse.py's mmse_split_plan; every form
// gives the same bits.
//
// The stamped instance (kStamps, mmse_equalize_split_phases_f32) splits a
// lane of the warp form into phase_clock.cuh's LanePhase.
#include <cstddef>

#include "chol_panels.cuh"
#include "lane_common.cuh"
#include "phase_clock.cuh"
#include "warp_chain.cuh"

namespace repro_torch {
namespace {

template <bool kGlobal>
__global__ void __launch_bounds__(kGlobal ? kPanelThreads : kThreads,
                                  kGlobal ? kPanelMinBlocks : 0)
mmse_equalize_split_kernel(const float* __restrict__ Hr,
                           const float* __restrict__ Hi,
                           const float* __restrict__ Yr,
                           const float* __restrict__ Yi,
                           float* __restrict__ X, float* __restrict__ work,
                           int m, int n, int k, int bs, float sigma2,
                           float eps) {
  extern __shared__ float smem[];
  const int n2 = 2 * n;
  const size_t lane = blockIdx.x;
  const float* hr;             // m * n
  const float* hi;             // m * n
  const float* yr;             // m * k
  const float* yi;             // m * k
  float* g;                    // 2n * 2n
  float* rhs;                  // 2n * k
  float* col = nullptr;        // 2n (the shared form's chain scratch)
  if (kGlobal) {               // planes read in place, x solved in place
    hr = Hr + lane * m * n;
    hi = Hi + lane * m * n;
    yr = Yr + lane * m * k;
    yi = Yi + lane * m * k;
    g = work + lane * n2 * n2;
    rhs = X + lane * n2 * k;
  } else {
    float* hrs = smem;
    float* his = hrs + m * n;
    float* yrs = his + m * n;
    float* yis = yrs + m * k;
    for (int e = threadIdx.x; e < m * n; e += blockDim.x) {
      hrs[e] = Hr[lane * m * n + e];
      his[e] = Hi[lane * m * n + e];
    }
    for (int e = threadIdx.x; e < m * k; e += blockDim.x) {
      yrs[e] = Yr[lane * m * k + e];
      yis[e] = Yi[lane * m * k + e];
    }
    hr = hrs;
    hi = his;
    yr = yrs;
    yi = yis;
    g = yis + m * k;
    rhs = g + n2 * n2;
    col = rhs + n2 * k;
    __syncthreads();
  }
  // split Gram region: Gr into both diagonal blocks (lower triangles), and
  // C = Hr^T Hi, each entry once, into the upper-right block, which the
  // chain never reads
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n;
    const int j = e % n;
    if (j <= i) {
      float s = 0.0f;
      for (int r = 0; r < m; ++r) s += hr[r * n + i] * hr[r * n + j];
      for (int r = 0; r < m; ++r) s += hi[r * n + i] * hi[r * n + j];
      if (i == j) s += sigma2;
      g[i * n2 + j] = s;
      g[(i + n) * n2 + (j + n)] = s;
    }
    float c = 0.0f;
    for (int r = 0; r < m; ++r) c += hr[r * n + i] * hi[r * n + j];
    g[i * n2 + (j + n)] = c;
  }
  // split matched filter: rr = Hr^T yr + Hi^T yi, ri = Hr^T yi - Hi^T yr
  for (int e = threadIdx.x; e < n * k; e += blockDim.x) {
    const int i = e / k;
    const int c = e % k;
    float rr = 0.0f;
    for (int r = 0; r < m; ++r) rr += hr[r * n + i] * yr[r * k + c];
    for (int r = 0; r < m; ++r) rr += hi[r * n + i] * yi[r * k + c];
    float ri = 0.0f;
    for (int r = 0; r < m; ++r) ri += hr[r * n + i] * yi[r * k + c];
    for (int r = 0; r < m; ++r) ri += hi[r * n + i] * -yr[r * k + c];
    rhs[i * k + c] = rr;
    rhs[(i + n) * k + c] = ri;
  }
  __syncthreads();
  // Gi = C - C^T into the whole lower-left block.  Entries go out along
  // diagonals (j = i + d mod n) so that, at n = 32, a warp's reads of C
  // and of C^T both fall in distinct banks.
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e % n;
    const int j = (e / n + i) % n;
    g[(i + n) * n2 + j] = g[i * n2 + (j + n)] - g[j * n2 + (i + n)];
  }
  __syncthreads();
  if (kGlobal) {
    chol_chain_panels(g, g, rhs, n2, k, bs, eps, smem);
  } else {
    float* yk = col + n2;      // k
    float* thresh = yk + k;    // 1
    chol_chain(g, rhs, n2, k, eps, col, yk, thresh);
    float* xl = X + lane * n2 * k;
    for (int e = threadIdx.x; e < n2 * k; e += blockDim.x) xl[e] = rhs[e];
  }
}

// Floats of one lane of the warp form (a multiple of 4: 16-byte slices).
__host__ __device__ inline int warp_lane_floats(int m, int n, int k) {
  const int n2 = 2 * n;
  const int n4 = 4 * ((n + 3) / 4);
  const int l = n2 * warp_pitch(n2);
  const int planes = 2 * m * n4 + 2 * m * k;
  const int region = ((l > planes ? l : planes) + 3) / 4 * 4;
  return (region + warp_scratch_floats(n2, k) + 3) / 4 * 4;
}

// The sums of one Gram unit of the warp form from the staged planes (row
// pitch n4): Gr(I, J) over hr then hi, C(I, J) = hr_I^T hi_J and, off the
// diagonal, C(J, I) = hr_J^T hi_I (c2[w * 4 + q] is C's (4J + w, 4I + q)),
// each sum in the CTA form's order.
__device__ __forceinline__ void split_unit(const float* hr, const float* hi,
                                           int n4, int m, int ti, int tj,
                                           float (&gr)[16], float (&c1)[16],
                                           float (&c2)[16]) {
#pragma unroll
  for (int e = 0; e < 16; ++e) gr[e] = c1[e] = c2[e] = 0.0f;
  const int io = 4 * ti;
  const int jo = 4 * tj;
  for (int r = 0; r < m; ++r) {
    const float4 ai = *reinterpret_cast<const float4*>(hr + r * n4 + io);
    const float4 aj = *reinterpret_cast<const float4*>(hr + r * n4 + jo);
    const float4 bi = *reinterpret_cast<const float4*>(hi + r * n4 + io);
    const float4 bj = *reinterpret_cast<const float4*>(hi + r * n4 + jo);
    const float av[4] = {ai.x, ai.y, ai.z, ai.w};
    const float aw[4] = {aj.x, aj.y, aj.z, aj.w};
    const float bv[4] = {bi.x, bi.y, bi.z, bi.w};
    const float bw[4] = {bj.x, bj.y, bj.z, bj.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        gr[q * 4 + w] += av[q] * aw[w];
        c1[q * 4 + w] += av[q] * bw[w];
        c2[w * 4 + q] += aw[w] * bv[q];
      }
  }
  for (int r = 0; r < m; ++r) {
    const float4 bi = *reinterpret_cast<const float4*>(hi + r * n4 + io);
    const float4 bj = *reinterpret_cast<const float4*>(hi + r * n4 + jo);
    const float bv[4] = {bi.x, bi.y, bi.z, bi.w};
    const float bw[4] = {bj.x, bj.y, bj.z, bj.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int w = 0; w < 4; ++w) gr[q * 4 + w] += bv[q] * bw[w];
  }
}

// The lane on one warp: see the header.  kK >= k bounds the right-hand
// sides held in registers.
template <int kK, bool kStamps>
__global__ void __launch_bounds__(32)
mmse_split_warp_kernel(const float* __restrict__ Hr,
                       const float* __restrict__ Hi,
                       const float* __restrict__ Yr,
                       const float* __restrict__ Yi, float* __restrict__ X,
                       int m, int n, int k, float sigma2, float eps,
                       unsigned long long* __restrict__ stamps) {
  extern __shared__ float4 smem4[];
  const int t = threadIdx.x;
  const size_t lane = blockIdx.x;
  PhaseClock<kStamps, kLanePhases> clk(true);
  const int n2 = 2 * n;
  const int pitch = warp_pitch(n2);
  const int tiles = (n + 3) / 4;
  const int n4 = 4 * tiles;
  float* base = reinterpret_cast<float*>(smem4);
  float* hr = base;                  // m x n4
  float* hi = hr + m * n4;           // m x n4
  float* yr = hi + m * n4;           // m x k
  float* yi = yr + m * k;            // m x k
  float* a = base;                   // 2n x warp_pitch(2n), over the planes
  const int l = n2 * pitch;
  const int planes = 2 * m * n4 + 2 * m * k;
  float* col = base + ((l > planes ? l : planes) + 3) / 4 * 4;   // scratch

  if (n4 == n) {                     // the planes are contiguous rows
    stage_rows(Hr + lane * m * n, hr, 1, m * n, m * n);
    stage_rows(Hi + lane * m * n, hi, 1, m * n, m * n);
  } else {
    stage_rows(Hr + lane * m * n, hr, m, n, n4);
    stage_rows(Hi + lane * m * n, hi, m, n, n4);
  }
  stage_rows(Yr + lane * m * k, yr, 1, m * k, m * k);
  stage_rows(Yi + lane * m * k, yi, 1, m * k, m * k);
  stage_wait();
  clk.mark(kLpLoad);

  // Gram units: the strict lower tiles (I, J), then the diagonal ones;
  // thread t takes unit t and, past 32 units (n > 28: the last diagonal
  // tiles), unit 63 - t, which it sums first and parks in the column
  // buffers (26 floats a unit: Gr's lower triangle, then Gi), so that only
  // one unit's sums are held in registers across the __syncwarp
  const int off_diag = tiles * (tiles - 1) / 2;
  const int units = off_diag + tiles;
  float gr[16], c1[16], c2[16];
  int ti = -1, tj = 0;
  float* park = col + 26 * (31 - t);
  const bool second = 63 - t < units;
  if (second) {
    ti = tj = 63 - t - off_diag;
    split_unit(hr, hi, n4, m, ti, tj, gr, c1, c2);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if (w <= q) park[q * (q + 1) / 2 + w] = gr[q * 4 + w];
        park[10 + q * 4 + w] = c1[q * 4 + w] - c1[w * 4 + q];
      }
  }
  const int parked = ti;
  ti = -1;
  if (t < units) {
    if (t < off_diag) {
      tri_tile(t, ti, tj);
      ++ti;
    } else {
      ti = tj = t - off_diag;
    }
    split_unit(hr, hi, n4, m, ti, tj, gr, c1, c2);
  }
  // matched filter of this thread's rows: rr = Hr^T yr + Hi^T yi (rows < n),
  // ri = Hr^T yi - Hi^T yr (rows n + i); both rows' sums in one walk over
  // hr, then one over hi (each sum's terms in the CTA form's order; -yr
  // is exact, so a selected sign gives its FFMA's bits)
  float y[2][kK];
  int col_of[2];
  const float* by_hr[2];               // yr or yi, taken with hr
  const float* by_hi[2];               // yi or yr, taken with hi
  bool neg[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int row = warp_row(n2, t, s);
    const bool rr = row < n;
    col_of[s] = row < 0 ? 0 : rr ? row : row - n;
    by_hr[s] = rr ? yr : yi;
    by_hi[s] = rr ? yi : yr;
    neg[s] = !rr;
#pragma unroll
    for (int c = 0; c < kK; ++c) y[s][c] = 0.0f;
  }
  for (int r = 0; r < m; ++r) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float h = hr[r * n4 + col_of[s]];
#pragma unroll
      for (int c = 0; c < kK; ++c)
        if (c < k) y[s][c] += h * by_hr[s][r * k + c];
    }
  }
  for (int r = 0; r < m; ++r) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float h = hi[r * n4 + col_of[s]];
#pragma unroll
      for (int c = 0; c < kK; ++c) {
        if (c < k) {
          const float v = by_hi[s][r * k + c];
          y[s][c] += h * (neg[s] ? -v : v);
        }
      }
    }
  }
  __syncwarp();
  // the embedding's lower triangle over the planes: Gr + sigma2 I in both
  // diagonal blocks, Gi = C - C^T below them
  if (ti >= 0) {
    const bool diag = ti == tj;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int i = 4 * ti + q;
        const int j = 4 * tj + w;
        if (i >= n || j >= n) continue;
        if (!diag || j <= i) {
          float g = gr[q * 4 + w];
          if (i == j) g += sigma2;
          a[i * pitch + j] = g;
          a[(i + n) * pitch + (j + n)] = g;
        }
        const float cij = c1[q * 4 + w];
        const float cji = diag ? c1[w * 4 + q] : c2[w * 4 + q];
        a[(i + n) * pitch + j] = cij - cji;
        if (!diag) a[(j + n) * pitch + i] = cji - cij;
      }
  }
  if (second) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int i = 4 * parked + q;
        const int j = 4 * parked + w;
        if (i >= n || j >= n) continue;
        if (w <= q) {
          float g = park[q * (q + 1) / 2 + w];
          if (i == j) g += sigma2;
          a[i * pitch + j] = g;
          a[(i + n) * pitch + (j + n)] = g;
        }
        a[(i + n) * pitch + j] = park[10 + q * 4 + w];
      }
  }
  __syncwarp();
  clk.mark(kLpGram);
  const float thresh = warp_threshold<2>(a, pitch, n2, eps);
  warp_factor<2, kK>(a, pitch, n2, thresh, col, nullptr, y, k);
  clk.mark(kLpFactor);
  warp_back<2, kK>(a, pitch, n2, col, y, k);
  clk.mark(kLpBack);
  float* xl = X + lane * n2 * k;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int row = warp_row(n2, t, s);
#pragma unroll
    for (int c = 0; c < kK; ++c)
      if (row >= 0 && c < k) xl[row * k + c] = y[s][c];
  }
  clk.mark(kLpStore);
  clk.write(stamps + lane * kLaneStampWords);
}

template <bool kStamps>
cudaError_t launch_warp(const float* hr, const float* hi, const float* yr,
                        const float* yi, float* x, int batch, int m, int n,
                        int k, float sigma2, float eps,
                        unsigned long long* stamps, cudaStream_t s) {
  if (n < 1 || 2 * n > 64 || k < 1 || k > kWarpMaxRhs)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * warp_lane_floats(m, n, k);
#define REPRO_SPLIT_WARP(KK)                                                \
  {                                                                         \
    cudaError_t err =                                                       \
        allow_warp_smem<mmse_split_warp_kernel<KK, kStamps>>();             \
    if (err != cudaSuccess) return err;                                     \
    mmse_split_warp_kernel<KK, kStamps><<<batch, 32, smem, s>>>(            \
        hr, hi, yr, yi, x, m, n, k, sigma2, eps, stamps);                   \
    return cudaGetLastError();                                              \
  }
  if (k == 1) REPRO_SPLIT_WARP(1)
  if (k == 2) REPRO_SPLIT_WARP(2)
  if (k <= 4) REPRO_SPLIT_WARP(4)
  REPRO_SPLIT_WARP(8)
#undef REPRO_SPLIT_WARP
}

size_t smem_bytes(int m, int n, int k) {
  const size_t n2 = 2 * static_cast<size_t>(n);
  return sizeof(float) *
         (2 * static_cast<size_t>(m) * n + 2 * m * k + n2 * n2 + n2 * k +
          n2 + k + 1);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

size_t mmse_equalize_split_smem(int m, int n, int k) {
  return repro_torch::smem_bytes(m, n, k);
}

// Dynamic shared memory one lane of the warp form takes.
size_t mmse_equalize_split_warp_smem(int m, int n, int k) {
  return sizeof(float) * repro_torch::warp_lane_floats(m, n, k);
}

// Dynamic shared memory one lane of the global form needs at panel width bs
// (the panel chain on the 2n x 2n embedding).
size_t mmse_equalize_split_global_smem(int m, int n, int k, int bs) {
  return repro_torch::chol_panel_smem_bytes(2 * n, k, bs);
}

// Floats of work buffer one lane of the global form needs (the 2n x 2n
// embedding).
size_t mmse_equalize_split_work(int m, int n, int k) {
  return 4 * static_cast<size_t>(n) * n;
}

// hr, hi (batch, m, n), yr, yi (batch, m, k) -> x (batch, 2n, k), float32.
// work: null for a shared-memory form, else batch *
// mmse_equalize_split_work floats and the global form's plan
// (pipelines/cholesky_solve.py chol_panel_plan at (2n, k): threads, panel
// width bs, smem bytes), refused unless it is one the panel chain was
// compiled for.  Without work, warp = 1 runs the warp form
// (pipelines/mmse.py mmse_split_plan; refused past n = 32 or k = 8),
// warp = 0 the CTA form; both ignore threads, bs and smem.
int mmse_equalize_split_f32(const void* hr, const void* hi, const void* yr,
                            const void* yi, void* x, void* work, int batch,
                            int m, int n, int k, float sigma2, float eps,
                            int warp, int threads, int bs, int smem,
                            void* stream) {
  using namespace repro_torch;
  const auto s = static_cast<cudaStream_t>(stream);
  const float* hrf = static_cast<const float*>(hr);
  const float* hif = static_cast<const float*>(hi);
  const float* yrf = static_cast<const float*>(yr);
  const float* yif = static_cast<const float*>(yi);
  float* xf = static_cast<float*>(x);
  float* wf = static_cast<float*>(work);
  if (!work && warp)
    return launch_warp<false>(hrf, hif, yrf, yif, xf, batch, m, n, k, sigma2,
                              eps, nullptr, s);
  if (work) {
    if (!chol_panel_plan_ok(2 * n, k, threads, bs, smem))
      return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(mmse_equalize_split_kernel<true>, smem);
    if (err != cudaSuccess) return err;
    mmse_equalize_split_kernel<true><<<batch, threads, smem, s>>>(
        hrf, hif, yrf, yif, xf, wf, m, n, k, bs, sigma2, eps);
    return cudaGetLastError();
  }
  const size_t smem_shared = smem_bytes(m, n, k);
  cudaError_t err =
      allow_smem(mmse_equalize_split_kernel<false>, smem_shared);
  if (err != cudaSuccess) return err;
  mmse_equalize_split_kernel<false><<<batch, kThreads, smem_shared, s>>>(
      hrf, hif, yrf, yif, xf, wf, m, n, k, 0, sigma2, eps);
  return cudaGetLastError();
}

// The phase-stamped instance of the warp form (scripts/lane_phases.py):
// x as mmse_equalize_split_f32's and per lane kLaneStampWords words of
// stamps.
int mmse_equalize_split_phases_f32(const void* hr, const void* hi,
                                   const void* yr, const void* yi, void* x,
                                   void* stamps, int batch, int m, int n,
                                   int k, float sigma2, float eps,
                                   void* stream) {
  return repro_torch::launch_warp<true>(
      static_cast<const float*>(hr), static_cast<const float*>(hi),
      static_cast<const float*>(yr), static_cast<const float*>(yi),
      static_cast<float*>(x), batch, m, n, k, sigma2, eps,
      static_cast<unsigned long long*>(stamps),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
