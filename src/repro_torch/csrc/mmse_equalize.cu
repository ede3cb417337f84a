// K2: fused MMSE equalizer on the real (or real-expanded) system, a lane on
// one warp, on a CTA of W warps or on one 128-thread CTA.
//
// Replaces: src/repro/pipelines/mmse.py, mmse_equalize_pallas
// (_mmse_kernel): G = H^T H + sigma2 I and rhs = H^T y computed in the lane,
// then the fused Cholesky chain of K1 on the lane-resident Gram matrix.
//
// What bounds it on an H100: each lane reads m*n + m*k floats and writes
// n*k; the least work is m n (n + 1) (one triangle of G) + 2 m n k +
// n^3/3 + 2 n^2 k FLOPs.  At
// the slot mix's widths both bounds are a few microseconds per carrier,
// so what holds it back is the 2n-step ordered chain with a block barrier
// per step.  The design computes both products in the lane with f32 FMAs
// (the lower triangle of G only: the chain never reads the upper half),
// keeps H, G and the right-hand sides in shared memory so nothing
// round-trips device memory between the four stages, and shares the
// factor -> forward -> back chain with K1 and K3 (lane_common.cuh).
//
// A lane larger than shared memory (n > 168 at m = n + 4, k = 2) takes
// the global form: H and y are read in place from device memory, G lives
// in a per-lane slice of a work buffer and x is solved in place in X.
// After the same Gram stage it runs the panel chain (chol_panels.cuh): a
// panel of bs columns is factored in shared memory and the trailing lower
// triangle of G updated once a panel from register tiles, each product
// subtracted in chol_chain's order, so the global form equals the shared
// form bit for bit at every panel width.  The plan (threads, bs, shared
// memory) is pipelines/cholesky_solve.py's chol_panel_plan.
//
// The warp form (n <= 32, k <= 8) runs a lane on one warp, a CTA of 32
// threads, with no block barrier: K6's second stage (warp_equalize in
// warp_chain.cuh) on an H staged row-major at warp_pitch(n), each Gram
// tile a 16-byte slice of a row (no transpose), the matched filter a row
// a thread, the chain with the k symbols in registers.  A lane takes 4
// (m warp_pitch(n) + m k + n warp_pitch(n) + warp_scratch_floats(n, k))
// bytes (each part rounded to 16): 10,400 at n = 32, m = 36, k = 2.
//
// The wide form (past n = 32, while the lane's CTA form fits shared
// memory: n <= 168 at m = n + 4, k = 2) runs a lane on one CTA of W warps
// (mmse_wide_kernel) with its triangle in registers: thread t owns 4 x 4
// tile t of the Gram's lower triangle (dealt column by column,
// col_tri_tile) or of y (n x k, after them), summed over r in order from
// 16-byte slices of the staged H and y; so W is the fewest of 2, 4, 8, 16
// or 32 warps whose threads hold the lane's tiles (32 at n = 128, k = 2:
// 560 tiles), and a lane of more than 1024 tiles takes the CTA form.  A
// factor step: after the block barrier every thread reads the step's raw
// column and solution row, which their owners published to a
// double-buffered scratch, takes the guarded rsqrt and col[i] = raw[i] *
// inv itself, sets its tile's column-k elements to col[i] (rows of y: row k to
// y[k] * inv) and subtracts col[i] * col[j] from the live ones (y:
// col[i] * y[k] * inv), one FFMA each in k order; the owners of column k +
// 1 and row k + 1 of y publish them; one barrier.  No division, no masked
// half, and a tile whose columns are done drops out.  Then L and y go
// over H in shared memory and a warp a right-hand side solves back, a
// row a thread, in chol_chain's order.  So it gives the CTA form's bits.
// A lane takes 4 (m n4 + m k4 + 2 n4 + 2 k4 + 2 W) bytes (n4, k4: n, k
// rounded up to 4): 71,008 at n = 128, m = 132, k = 2, W = 32, so an SM
// holds three lanes by shared memory.  The forms are pipelines/mmse.py's
// mmse_form and mmse_wide_plan (W); every form gives the same bits.
//
// The stamped instances (kStamps, mmse_equalize_phases_f32) split a lane
// of the warp or wide form into phase_clock.cuh's LanePhase.
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
mmse_equalize_kernel(const float* __restrict__ H, const float* __restrict__ Y,
                     float* __restrict__ X, float* __restrict__ work, int m,
                     int n, int k, int bs, float sigma2, float eps) {
  extern __shared__ float smem[];
  const size_t lane = blockIdx.x;
  const float* hl = H + lane * m * n;
  const float* yl = Y + lane * m * k;
  const float* h;             // m * n
  const float* yv;            // m * k
  float* g;                   // n * n
  float* rhs;                 // n * k
  float* col = nullptr;       // n (the shared form's chain scratch)
  if (kGlobal) {              // H and y read in place, x solved in place
    h = hl;
    yv = yl;
    g = work + lane * n * n;
    rhs = X + lane * n * k;
  } else {
    float* hs = smem;
    float* ys = hs + m * n;
    for (int e = threadIdx.x; e < m * n; e += blockDim.x) hs[e] = hl[e];
    for (int e = threadIdx.x; e < m * k; e += blockDim.x) ys[e] = yl[e];
    h = hs;
    yv = ys;
    g = ys + m * k;
    rhs = g + n * n;
    col = rhs + n * k;
    __syncthreads();
  }
  // Gram region: lower triangle of H^T H + sigma2 I
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n;
    const int j = e % n;
    if (j > i) continue;
    float s = 0.0f;
    for (int r = 0; r < m; ++r) s += h[r * n + i] * h[r * n + j];
    g[e] = (i == j) ? s + sigma2 : s;
  }
  // matched filter: rhs = H^T y
  for (int e = threadIdx.x; e < n * k; e += blockDim.x) {
    const int i = e / k;
    const int c = e % k;
    float s = 0.0f;
    for (int r = 0; r < m; ++r) s += h[r * n + i] * yv[r * k + c];
    rhs[e] = s;
  }
  __syncthreads();
  if (kGlobal) {
    chol_chain_panels(g, g, rhs, n, k, bs, eps, smem);
  } else {
    float* yk = col + n;      // k
    float* thresh = yk + k;   // 1
    chol_chain(g, rhs, n, k, eps, col, yk, thresh);
    float* xl = X + lane * n * k;
    for (int e = threadIdx.x; e < n * k; e += blockDim.x) xl[e] = rhs[e];
  }
}

// Floats of one lane of the warp form: H (m x warp_pitch(n)), the
// symbols, the system and the chain's scratch, each part a multiple of 4.
__host__ __device__ inline int warp_lane_floats(int m, int n, int k) {
  const int pitch = warp_pitch(n);
  return m * pitch + (m * k + 3) / 4 * 4 + n * pitch +
         (warp_scratch_floats(n, k) + 3) / 4 * 4;
}

// The lane on one warp: see the header.  kK >= k bounds the symbols held
// in registers.
template <int kK, bool kStamps>
__global__ void __launch_bounds__(32)
mmse_warp_kernel(const float* __restrict__ H, const float* __restrict__ Y,
                 float* __restrict__ X, int m, int n, int k, float sigma2,
                 float eps, unsigned long long* __restrict__ stamps) {
  extern __shared__ float4 smem4[];
  const int t = threadIdx.x;
  const size_t lane = blockIdx.x;
  PhaseClock<kStamps, kLanePhases> clk(true);
  const int pitch = warp_pitch(n);
  float* hs = reinterpret_cast<float*>(smem4);   // m x pitch
  float* yv = hs + m * pitch;                     // m x k symbols
  float* a = yv + (m * k + 3) / 4 * 4;            // n x pitch
  float* scratch = a + n * pitch;
  stage_rows(H + lane * m * n, hs, m, n, pitch, n);
  stage_rows(Y + lane * m * k, yv, 1, m * k, m * k);
  stage_wait();
  clk.mark(kLpLoad);
  float y[1][kK];
  warp_equalize<kK, false>(hs, pitch, yv, a, pitch, scratch, n, m, k,
                           sigma2, eps, y, clk, kLpGram);
  float* xl = X + lane * n * k;
#pragma unroll
  for (int c = 0; c < kK; ++c)
    if (t < n && c < k) xl[t * k + c] = y[0][c];
  clk.mark(kLpStore);
  clk.write(stamps + lane * kLaneStampWords);
}

constexpr int kWideBackRows = 6;    // rows of the back substitution a thread

// The wide form's lane: H (m x n4), y (m x k4), two raw columns (n4) and
// two raw solution rows (k4), each warp's diagonal max and NaN flag.
struct WideLane {
  int n4, k4, floats;
  __host__ __device__ WideLane(int m, int n, int k, int warps)
      : n4((n + 3) / 4 * 4), k4((k + 3) / 4 * 4) {
    floats = m * n4 + m * k4 + 2 * n4 + 2 * k4 + 2 * warps;
  }
};

// The 4 x 4 tiles of the wide form: the Gram's lower triangle, then y's.
__host__ __device__ inline int wide_units(int n, int k) {
  const int tiles = (n + 3) / 4;
  return tiles * (tiles + 1) / 2 + tiles * ((k + 3) / 4);
}

// The (i, j) tile of unit u of a lower triangle of T x T tiles dealt
// column by column (column j holds tiles j .. T - 1), so that the tiles a
// factor step has finished are the first units and their warps fall idle.
__device__ __forceinline__ void col_tri_tile(int u, int t, int& i, int& j) {
  j = 0;
  while (u >= t - j) {
    u -= t - j;
    ++j;
  }
  i = j + u;
}

// One of a0 .. a3 by the runtime index v (0-3), by selects on its bits
// (an indexed register array would go to local memory).
__device__ __forceinline__ float pick4(float a0, float a1, float a2,
                                       float a3, int v) {
  const float lo = (v & 1) ? a1 : a0;
  const float hi = (v & 1) ? a3 : a2;
  return (v & 2) ? hi : lo;
}

// Copies rows x len floats of device memory into shared memory at row
// pitch ld by cp.async, the columns len .. ld - 1 zeroed, a row a warp at
// a time over the CTA's warps.
__device__ __forceinline__ void stage_block(const float* __restrict__ src,
                                            float* dst, int rows, int len,
                                            int ld) {
  const int warps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows; r += warps)
    for (int c = threadIdx.x & 31; c < ld; c += 32) {
      if (c >= len) {
        dst[r * ld + c] = 0.0f;
        continue;
      }
      const unsigned d = static_cast<unsigned>(
          __cvta_generic_to_shared(dst + r * ld + c));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                   "l"(src + r * len + c)
                   : "memory");
    }
}

// The lane on a CTA of W warps: see the header.  Thread t holds tile t.
template <bool kStamps>
__global__ void __launch_bounds__(1024)
mmse_wide_kernel(const float* __restrict__ H, const float* __restrict__ Y,
                 float* __restrict__ X, int m, int n, int k, float sigma2,
                 float eps, unsigned long long* __restrict__ stamps) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int warps = blockDim.x >> 5;
  const size_t lane = blockIdx.x;
  PhaseClock<kStamps, kLanePhases> clk(true);
  const WideLane w(m, n, k, warps);
  float* hs = reinterpret_cast<float*>(smem4);   // m x n4
  float* ys = hs + m * w.n4;                      // m x k4
  float* colb = ys + m * w.k4;                    // 2 x n4 raw columns
  float* rowb = colb + 2 * w.n4;                  // 2 x k4 raw rows of y
  float* part = rowb + 2 * w.k4;                  // warps x 2
  stage_block(H + lane * m * n, hs, m, n, w.n4);
  stage_block(Y + lane * m * k, ys, m, k, w.k4);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  clk.mark(kLpLoad);

  // the tile: (I, J) of the Gram's lower triangle, or (I, J) of y (rows
  // 4I.., columns 4J..), summed over r in order; ti < 0: none
  const int tiles = (n + 3) / 4;
  const int tri = tiles * (tiles + 1) / 2;
  const int units = tri + tiles * ((k + 3) / 4);
  float acc[16];
  int ti = -1, tj = 0;
  bool ty = false;
  float dmax = -INFINITY;
  bool nan = false;
  if (tid < tri) {
    col_tri_tile(tid, tiles, ti, tj);
  } else if (tid < units) {
    ti = (tid - tri) / ((k + 3) / 4);
    tj = (tid - tri) % ((k + 3) / 4);
    ty = true;
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.0f;
  if (ti >= 0 && ty) {
    col_tile(hs, w.n4, 4 * ti, ys, w.k4, 4 * tj, m, acc);
  } else if (ti >= 0) {
    col_tile(hs, w.n4, 4 * ti, hs, w.n4, 4 * tj, m, acc);
    if (ti == tj) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[q * 5] = acc[q * 5] + sigma2;
        if (4 * ti + q < n) {
          nan |= isnan(acc[q * 5]);
          dmax = fmaxf(dmax, acc[q * 5]);
        }
      }
    }
  }
  // the threshold: each warp's diagonal max (max is exact, so its order
  // is free; a NaN on the diagonal gives a NaN threshold)
  for (int off = 16; off > 0; off >>= 1)
    dmax = fmaxf(dmax, __shfl_xor_sync(kFullMask, dmax, off));
  nan = __any_sync(kFullMask, nan);
  if ((tid & 31) == 0) {
    part[2 * (tid >> 5)] = dmax;
    part[2 * (tid >> 5) + 1] = nan ? 1.0f : 0.0f;
  }
  // step 0's column and solution row, as the Gram left them
  if (ti >= 0 && !ty && tj == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) colb[4 * ti + q] = acc[q * 4];
  } else if (ti == 0 && ty) {
#pragma unroll
    for (int v = 0; v < 4; ++v) rowb[4 * tj + v] = acc[v];
  }
  __syncthreads();
  float thresh;
  {
    float dm = -INFINITY;
    bool nn = false;
    for (int v = 0; v < warps; ++v) {
      dm = fmaxf(dm, part[2 * v]);
      nn |= part[2 * v + 1] != 0.0f;
    }
    thresh = nn ? NAN : fmaxf(eps * dm, kPivotFloor);
  }
  clk.mark(kLpGram);

  // the last step that changes a tile of this warp: past it the warp only
  // meets the barriers (the tiles dealt column by column, whole warps
  // finish early)
  int last = ti >= 0 ? 4 * (ty ? ti : tj) + 3 : -1;
  for (int off = 16; off > 0; off >>= 1)
    last = max(last, __shfl_xor_sync(kFullMask, last, off));
  for (int kk = 0; kk < n; ++kk) {
    if (kk <= last) {
      const int b = kk & 1;
      const float* rc = colb + b * w.n4;
      const float* ry = rowb + b * w.k4;
      const float akk = rc[kk];
      const bool ok = akk > thresh;
      const float inv = ok ? rsqrtf(fmaxf(akk, thresh)) : 0.0f;
      const int kt = kk >> 2;
      const int dk = kk & 3;
      if (ti >= 0 && (ty ? ti : tj) >= kt) {      // not done
        const float4 r4 = *reinterpret_cast<const float4*>(rc + 4 * ti);
        const float ci[4] = {r4.x * inv, r4.y * inv, r4.z * inv, r4.w * inv};
        if (ty) {                    // rows of y: y[i] -= col[i] * y[k] inv
          const float4 y4 = *reinterpret_cast<const float4*>(ry + 4 * tj);
          const float yk[4] = {y4.x * inv, y4.y * inv, y4.z * inv,
                               y4.w * inv};
          if (ti > kt) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int v = 0; v < 4; ++v) acc[q * 4 + v] -= ci[q] * yk[v];
          } else {                   // row k set to y[k] inv
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int v = 0; v < 4; ++v) {
                const float nv = acc[q * 4 + v] - ci[q] * yk[v];
                acc[q * 4 + v] = q > dk ? nv : q == dk ? yk[v] : acc[q * 4 + v];
              }
          }
        } else {                     // a[i][j] -= col[i] * col[j], j > k
          const float4 c4 = *reinterpret_cast<const float4*>(rc + 4 * tj);
          const float cj[4] = {c4.x * inv, c4.y * inv, c4.z * inv,
                               c4.w * inv};
          if (tj > kt) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int v = 0; v < 4; ++v) acc[q * 4 + v] -= ci[q] * cj[v];
          } else {                   // column k set to col[i]
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float cq = (ti == kt && q == dk && !ok) ? 1.0f : ci[q];
#pragma unroll
              for (int v = 0; v < 4; ++v) {
                const float nv = acc[q * 4 + v] - ci[q] * cj[v];
                acc[q * 4 + v] = v > dk ? nv : v == dk ? cq : acc[q * 4 + v];
              }
            }
          }
        }
      }
      // publish step kk + 1: its column and solution row as left here
      const int k1 = kk + 1;
      if (k1 < n && ti >= 0 && !ty && tj == (k1 >> 2)) {
        float* nc = colb + (b ^ 1) * w.n4;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          nc[4 * ti + q] = pick4(acc[q * 4], acc[q * 4 + 1], acc[q * 4 + 2],
                                 acc[q * 4 + 3], k1 & 3);
      } else if (k1 < n && ty && ti == (k1 >> 2)) {
        float* ny = rowb + (b ^ 1) * w.k4;
#pragma unroll
        for (int v = 0; v < 4; ++v)
          ny[4 * tj + v] = pick4(acc[v], acc[4 + v], acc[8 + v], acc[12 + v],
                                 k1 & 3);
      }
    }
    __syncthreads();
  }
  // L and the forward solution over H; then a warp a right-hand side
  // solves back, a row a thread (rows t, t + 32, ...), in chol_chain's
  // order: x[k] = y[k] / l[k][k], y[i < k] -= l[k][i] x[k]
  float* l = hs;                    // n x n4
  float* yf = hs + n * w.n4;        // n x k4
  if (ti >= 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int i = 4 * ti + q;
        const int j = 4 * tj + v;
        if (ty) {
          if (i < n && j < k) yf[i * w.k4 + j] = acc[q * 4 + v];
        } else if (i < n && j <= i) {
          l[i * w.n4 + j] = acc[q * 4 + v];
        }
      }
  }
  __syncthreads();
  clk.mark(kLpFactor);
  const int t = tid & 31;
  float* xl = X + lane * n * k;
  for (int c = tid >> 5; c < k; c += warps) {
    float yr[kWideBackRows];
#pragma unroll
    for (int s = 0; s < kWideBackRows; ++s) {
      const int i = t + 32 * s;
      yr[s] = i < n ? yf[i * w.k4 + c] : 0.0f;
    }
    // the steps in blocks of 32 rows, so that the owner's row is a
    // register of a fixed slot; rows of higher slots are done
#pragma unroll
    for (int sb = kWideBackRows - 1; sb >= 0; --sb) {
      if (32 * sb >= n) continue;
      const int top = n < 32 * sb + 32 ? n : 32 * sb + 32;
      // row kk of L loaded a step ahead, off the chain of divisions
      const int i = t + 32 * sb;
      float lkk = l[(top - 1) * w.n4 + top - 1];
      float li[kWideBackRows];
#pragma unroll
      for (int s = 0; s <= sb; ++s)
        li[s] = l[(top - 1) * w.n4 + min(t + 32 * s, top - 1)];
      for (int kk = top - 1; kk >= 32 * sb; --kk) {
        const float xk = __shfl_sync(kFullMask, yr[sb], kk & 31) / lkk;
#pragma unroll
        for (int s = 0; s < sb; ++s) yr[s] -= li[s] * xk;
        if (i == kk)
          yr[sb] = xk;
        else if (i < kk)
          yr[sb] -= li[sb] * xk;
        if (kk > 32 * sb) {        // in flight during the next shuffle
          lkk = l[(kk - 1) * w.n4 + kk - 1];
#pragma unroll
          for (int s = 0; s <= sb; ++s)
            li[s] = l[(kk - 1) * w.n4 + min(t + 32 * s, top - 1)];
        }
      }
    }
    if (c == tid >> 5) clk.mark(kLpBack);
#pragma unroll
    for (int s = 0; s < kWideBackRows; ++s) {
      const int i = t + 32 * s;
      if (i < n) xl[i * k + c] = yr[s];
    }
  }
  clk.mark(kLpStore);
  clk.write(stamps + lane * kLaneStampWords);
}

template <bool kStamps>
cudaError_t launch_warp(const float* h, const float* y, float* x, int batch,
                        int m, int n, int k, float sigma2, float eps,
                        unsigned long long* stamps, cudaStream_t s) {
  if (n < 1 || n > 32 || k < 1 || k > kWarpMaxRhs || m < n)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * warp_lane_floats(m, n, k);
#define REPRO_MMSE_WARP(KK)                                                 \
  {                                                                         \
    cudaError_t err = allow_warp_smem<mmse_warp_kernel<KK, kStamps>>();     \
    if (err != cudaSuccess) return err;                                     \
    mmse_warp_kernel<KK, kStamps><<<batch, 32, smem, s>>>(                  \
        h, y, x, m, n, k, sigma2, eps, stamps);                             \
    return cudaGetLastError();                                              \
  }
  if (k == 1) REPRO_MMSE_WARP(1)
  if (k == 2) REPRO_MMSE_WARP(2)
  if (k <= 4) REPRO_MMSE_WARP(4)
  REPRO_MMSE_WARP(8)
#undef REPRO_MMSE_WARP
}

template <bool kStamps>
cudaError_t launch_wide(const float* h, const float* y, float* x, int batch,
                        int m, int n, int k, float sigma2, float eps,
                        int threads, unsigned long long* stamps,
                        cudaStream_t s) {
  const size_t smem = sizeof(float) * WideLane(m, n, k, threads / 32).floats;
  if (n < 1 || n > 32 * kWideBackRows || k < 1 || m < n || threads < 32 ||
      threads % 32 || threads > 1024 || threads < wide_units(n, k) ||
      smem > 232448)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_warp_smem<mmse_wide_kernel<kStamps>>();
  if (err != cudaSuccess) return err;
  mmse_wide_kernel<kStamps><<<batch, threads, smem, s>>>(h, y, x, m, n, k,
                                                         sigma2, eps, stamps);
  return cudaGetLastError();
}

size_t smem_bytes(int m, int n, int k) {
  return sizeof(float) *
         (static_cast<size_t>(m) * n + m * k + n * n + n * k + n + k + 1);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

size_t mmse_equalize_smem(int m, int n, int k) {
  return repro_torch::smem_bytes(m, n, k);
}

// Dynamic shared memory one lane of the global form needs at panel width bs.
size_t mmse_equalize_global_smem(int m, int n, int k, int bs) {
  return repro_torch::chol_panel_smem_bytes(n, k, bs);
}

// Dynamic shared memory one lane of the warp form takes.
size_t mmse_equalize_warp_smem(int m, int n, int k) {
  return sizeof(float) * repro_torch::warp_lane_floats(m, n, k);
}

// Dynamic shared memory one lane of the wide form takes on `warps` warps.
size_t mmse_equalize_wide_smem(int m, int n, int k, int warps) {
  return sizeof(float) * repro_torch::WideLane(m, n, k, warps).floats;
}

// Floats of work buffer one lane of the global form needs (G).
size_t mmse_equalize_work(int m, int n, int k) {
  return static_cast<size_t>(n) * n;
}

// h (batch, m, n), y (batch, m, k) -> x (batch, n, k), all float32.
// work: null for a form in shared memory, else batch * mmse_equalize_work
// floats and the global form's plan (pipelines/cholesky_solve.py
// chol_panel_plan at (n, k): threads, panel width bs, smem bytes), refused
// unless it is one the panel chain was compiled for.  In shared memory,
// form 0 is the CTA form, 1 the warp form (refused past n = 32 or k = 8)
// and 2 the wide form on `threads` threads (pipelines/mmse.py
// mmse_wide_plan; refused off a warp multiple, past 1024 or under its
// tiles, one a thread); they ignore bs and smem.
int mmse_equalize_f32(const void* h, const void* y, void* x, void* work,
                      int batch, int m, int n, int k, float sigma2, float eps,
                      int threads, int bs, int smem, int form, void* stream) {
  using namespace repro_torch;
  const auto s = static_cast<cudaStream_t>(stream);
  const float* hf = static_cast<const float*>(h);
  const float* yf = static_cast<const float*>(y);
  float* xf = static_cast<float*>(x);
  float* wf = static_cast<float*>(work);
  if (work) {
    if (!chol_panel_plan_ok(n, k, threads, bs, smem))
      return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(mmse_equalize_kernel<true>, smem);
    if (err != cudaSuccess) return err;
    mmse_equalize_kernel<true><<<batch, threads, smem, s>>>(
        hf, yf, xf, wf, m, n, k, bs, sigma2, eps);
    return cudaGetLastError();
  }
  if (form == 1)
    return launch_warp<false>(hf, yf, xf, batch, m, n, k, sigma2, eps,
                              nullptr, s);
  if (form == 2)
    return launch_wide<false>(hf, yf, xf, batch, m, n, k, sigma2, eps,
                              threads, nullptr, s);
  if (form != 0) return cudaErrorInvalidValue;
  const size_t smem_shared = smem_bytes(m, n, k);
  cudaError_t err = allow_smem(mmse_equalize_kernel<false>, smem_shared);
  if (err != cudaSuccess) return err;
  mmse_equalize_kernel<false><<<batch, kThreads, smem_shared, s>>>(
      hf, yf, xf, wf, m, n, k, 0, sigma2, eps);
  return cudaGetLastError();
}

// The phase-stamped instances of the warp form (form 1) and the wide form
// (form 2, on `threads` threads) (scripts/lane_phases.py): x as
// mmse_equalize_f32's and per lane kLaneStampWords words of stamps (the
// second chain's phases 0).
int mmse_equalize_phases_f32(const void* h, const void* y, void* x,
                             void* stamps, int batch, int m, int n, int k,
                             int form, int threads, float sigma2, float eps,
                             void* stream) {
  using namespace repro_torch;
  const auto s = static_cast<cudaStream_t>(stream);
  const float* hf = static_cast<const float*>(h);
  const float* yf = static_cast<const float*>(y);
  float* xf = static_cast<float*>(x);
  auto* st = static_cast<unsigned long long*>(stamps);
  if (form == 1)
    return launch_warp<true>(hf, yf, xf, batch, m, n, k, sigma2, eps, st, s);
  if (form == 2)
    return launch_wide<true>(hf, yf, xf, batch, m, n, k, sigma2, eps,
                             threads, st, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
