// K5: pilot-based channel estimate, and K6: channel estimate fused with the
// MMSE equalizer, a lane on one CTA or on one warp.
//
// Replaces: src/repro/pipelines/pusch.py, channel_estimate_pallas
// (_chanest_kernel, _estimate_h, _chol_solve_inline) and pusch_chain_pallas
// (_pusch_chain_kernel): per lane, (Xp Xp^T + ridge I) Z = Xp Yp^T with
// H = Z^T, and -- in K6 -- the LMMSE x = (H^T H + sigma2 I)^{-1} H^T y on
// the H just produced, which never leaves the lane.
//
// What bounds it on an H100: per lane K5 reads n*p + m*p floats and writes
// m*n; its least work is a symmetric Gram n (n + 1) p + the cross product
// 2 n p m + the chain n^3/3 + 2 n^2 m FLOPs.  K6 reads m*k more, writes
// n*k and adds K2's work at k columns.  At the DAG's widths both bounds are
// microseconds per carrier; what holds the kernels back is the 2n-step
// ordered chain (two chains in K6) with a block barrier per step.  The
// design builds only the lower triangles of both Gram matrices (the chain
// reads nothing else, and the pivot threshold reads only the diagonal),
// keeps pilots, observations, H and both systems in shared memory -- the
// pilots and their observations transposed, p-major with an odd row pitch,
// so the threads of a warp, which work on neighbouring Gram columns, read
// neighbouring banks (row-major, a warp's reads of a pilot column land p
// floats apart, on one bank at p = 64) -- and
// reuses K1's chol_chain (lane_common.cuh) for both solves: the first with
// the m antennas as right-hand-side columns, the second with the k data
// symbols.
//
// The warp forms (n <= 32; K6: k <= 8) run a lane on one warp, a CTA of 32
// threads, with no block barrier (warp_chain.cuh), a row a thread.  K5's
// lane is K6's first stage (warp_estimate), which both call: the pilots
// and their observations are staged row-major 32 pilots at a time at an
// odd pitch (33), so that the rows of a warp's tiles fall in distinct
// banks; the pilot Gram's lower tiles and the cross product's tiles, 4 x
// 4 each, up to four a thread, are summed in registers over the chunks
// and then written over the pilots (L at warp_pitch(n), Z at
// warp_pitch(m)); the chain factors L alone, keeping each step's rsqrt,
// then solves the m antennas forward and back two columns a thread (the
// next row's value carried in a register, so a step waits on one multiply
// or division and one FFMA, the other rows in passes off that chain).
// K5 then stores H = Z^T a pass of 4 antennas x 8 rows, each 32-byte run
// of a row of H whole and Z's reads in distinct banks.  K6's second stage
// is K2's lane (warp_equalize): the Gram of H = Z^T summed from Z's rows,
// the matched filter of a thread's row into its registers, and the second
// chain with the k symbols in registers.  A lane of K6 takes 4 (max((n +
// m) (min(p, 32) | 1), n warp_pitch(n) + n warp_pitch(m)) + m k +
// warp_scratch_floats(n, k) + n) bytes (each part rounded to 16): 10,976
// at n = 32, p = 64, m = 36, k = 2, so an SM holds 19 lanes by shared
// memory and 16 by registers; K5's the same at k = 0.  The forms are
// pipelines/pusch.py's channel_estimate_plan and pusch_chain_plan; every
// form gives the same bits.
//
// The stamped instances (kStamps, channel_estimate_phases_f32 and
// pusch_chain_phases_f32) split a lane of a warp form into
// phase_clock.cuh's LanePhase.
#include <cstddef>

#include "lane_common.cuh"
#include "phase_clock.cuh"
#include "warp_chain.cuh"

namespace repro_torch {
namespace {

// Loads one lane's pilots xp (n x p) and observations yp (m x p) from
// device memory into shared memory transposed: xt[t * (n+1) + i] and
// yt[t * (m+1) + c].
__device__ void load_pilots(const float* xp, const float* yp, float* xt,
                            float* yt, int n, int p, int m) {
  for (int e = threadIdx.x; e < n * p; e += blockDim.x)
    xt[(e % p) * (n + 1) + e / p] = xp[e];
  for (int e = threadIdx.x; e < m * p; e += blockDim.x)
    yt[(e % p) * (m + 1) + e / p] = yp[e];
}

// Z (n x m) of the pilot system from the transposed pilots xt and
// observations yt (load_pilots), all in shared memory; g (n x n) and the
// chain scratch are overwritten.
__device__ void estimate_h(const float* xt, const float* yt, float* g,
                           float* z, int n, int p, int m, float ridge,
                           float eps, float* col, float* yk, float* thresh) {
  const int lx = n + 1;
  const int ly = m + 1;
  // Gram region: lower triangle of Xp Xp^T + ridge I
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n;
    const int j = e % n;
    if (j > i) continue;
    float s = 0.0f;
    for (int t = 0; t < p; ++t) s += xt[t * lx + i] * xt[t * lx + j];
    g[e] = (i == j) ? s + ridge : s;
  }
  // right-hand sides: Xp Yp^T, one column per antenna
  for (int e = threadIdx.x; e < n * m; e += blockDim.x) {
    const int i = e / m;
    const int c = e % m;
    float s = 0.0f;
    for (int t = 0; t < p; ++t) s += xt[t * lx + i] * yt[t * ly + c];
    z[e] = s;
  }
  __syncthreads();
  chol_chain(g, z, n, m, eps, col, yk, thresh);
}

__global__ void __launch_bounds__(kThreads)
channel_estimate_kernel(const float* __restrict__ XP,
                        const float* __restrict__ YP, float* __restrict__ H,
                        int n, int p, int m, float ridge, float eps) {
  extern __shared__ float smem[];
  float* xt = smem;                 // p * (n + 1)
  float* yt = xt + p * (n + 1);     // p * (m + 1)
  float* g = yt + p * (m + 1);      // n * n
  float* z = g + n * n;             // n * m
  float* col = z + n * m;           // n
  float* yk = col + n;              // m
  float* thresh = yk + m;           // 1
  const size_t lane = blockIdx.x;
  load_pilots(XP + lane * n * p, YP + lane * m * p, xt, yt, n, p, m);
  __syncthreads();
  estimate_h(xt, yt, g, z, n, p, m, ridge, eps, col, yk, thresh);
  // H = Z^T, transposed on store
  float* hl = H + lane * m * n;
  for (int e = threadIdx.x; e < m * n; e += blockDim.x)
    hl[e] = z[(e % n) * m + e / n];
}

__global__ void __launch_bounds__(kThreads)
pusch_chain_kernel(const float* __restrict__ XP, const float* __restrict__ YP,
                   const float* __restrict__ Y, float* __restrict__ X, int n,
                   int p, int m, int k, float ridge, float sigma2,
                   float eps) {
  extern __shared__ float smem[];
  float* xt = smem;                 // p * (n + 1)
  float* yt = xt + p * (n + 1);     // p * (m + 1)
  float* y = yt + p * (m + 1);      // m * k
  float* g = y + m * k;             // n * n (both systems in turn)
  float* z = g + n * n;             // n * m
  float* h = z + n * m;             // m * n
  float* rhs = h + m * n;           // n * k
  float* col = rhs + n * k;         // n
  float* yk = col + n;              // max(m, k)
  float* thresh = yk + (m > k ? m : k);  // 1
  const size_t lane = blockIdx.x;
  load_pilots(XP + lane * n * p, YP + lane * m * p, xt, yt, n, p, m);
  for (int e = threadIdx.x; e < m * k; e += blockDim.x)
    y[e] = Y[lane * m * k + e];
  __syncthreads();
  // stage 1: channel estimate -- H stays in shared memory
  estimate_h(xt, yt, g, z, n, p, m, ridge, eps, col, yk, thresh);
  for (int e = threadIdx.x; e < m * n; e += blockDim.x)
    h[e] = z[(e % n) * m + e / n];
  __syncthreads();
  // stage 2: MMSE equalize on the H just produced (K2's body)
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n;
    const int j = e % n;
    if (j > i) continue;
    float s = 0.0f;
    for (int r = 0; r < m; ++r) s += h[r * n + i] * h[r * n + j];
    g[e] = (i == j) ? s + sigma2 : s;
  }
  for (int e = threadIdx.x; e < n * k; e += blockDim.x) {
    const int i = e / k;
    const int c = e % k;
    float s = 0.0f;
    for (int r = 0; r < m; ++r) s += h[r * n + i] * y[r * k + c];
    rhs[e] = s;
  }
  __syncthreads();
  chol_chain(g, rhs, n, k, eps, col, yk, thresh);
  float* xl = X + lane * n * k;
  for (int e = threadIdx.x; e < n * k; e += blockDim.x) xl[e] = rhs[e];
}

// Pilots a chunk of K6's warp form stages (its sums continue from chunk
// to chunk in order), so that the pilots take no more shared memory than
// the systems written over them.
constexpr int kPilotChunk = 32;

// Floats of one lane of the warp form, and the offsets of its parts (a
// multiple of 4: 16-byte slices).
struct WarpLane {
  int pitch, chunk, px, ldz, z, region, floats;
  __host__ __device__ WarpLane(int n, int p, int m, int k)
      : pitch(warp_pitch(n)), chunk(p < kPilotChunk ? p : kPilotChunk),
        px(chunk | 1), ldz(warp_pitch(m)) {
    z = n * pitch;
    const int pilots = (n + m) * px;
    const int sys = z + n * ldz;
    region = ((pilots > sys ? pilots : sys) + 3) / 4 * 4;
    floats = region + (m * k + 3) / 4 * 4 + warp_scratch_floats(n, k) + n;
    floats = (floats + 3) / 4 * 4;
  }
};

// Units of 4 x 4 tiles a thread of the warp form sums at once.
constexpr int kWarpSlots = 4;

// K5's chain on one warp (K5's warp form, and K6's first stage): the
// lane's pilots xp (n x p) and observations yp (m x p), in device memory,
// staged 32 pilots at a time (stage_wait also ends the caller's copies in
// flight); the pilot Gram's lower tiles and Xp Yp^T's, up to four a
// thread, summed in registers over the chunks and written over the
// pilots; the factor of L alone (its rsqrts into dinv) with the m
// antennas forward a row a thread, then back two columns a thread.  On
// return Z = H^T (n x m at w.ldz) lies at base + w.z and the warp is in
// step.  The clock marks kLpLoad, kLpGram, kLpFactor and kLpBack.
template <class Clock>
__device__ __forceinline__ void warp_estimate(const float* __restrict__ xp,
                                              const float* __restrict__ yp,
                                              int n, int p, int m,
                                              float ridge, float eps,
                                              const WarpLane& w, float* base,
                                              float* col, float* dinv,
                                              Clock& clk) {
  const int t = threadIdx.x & 31;
  float* xs = base;                  // n x (chunk | 1) pilots
  float* ys = xs + n * w.px;         // m x (chunk | 1) observations
  float* a = base;                   // n x warp_pitch(n), over the pilots
  float* z = base + w.z;             // n x warp_pitch(m), over the pilots
  stage_rows(xp, xs, n, w.chunk, w.px, p);
  stage_rows(yp, ys, m, w.chunk, w.px, p);
  stage_wait();
  clk.mark(kLpLoad);

  // the pilot Gram's lower tiles, then Xp Yp^T's, a chunk of pilots at a
  // time
  const int tiles = (n + 3) / 4;
  const int ctiles = (m + 3) / 4;
  const int gram_units = tiles * (tiles + 1) / 2;
  const int units = gram_units + tiles * ctiles;
  float acc[kWarpSlots][16];
  int ti[kWarpSlots], tj[kWarpSlots];
#pragma unroll
  for (int s = 0; s < kWarpSlots; ++s) {
    const int u = t + 32 * s;
    ti[s] = -1;
    tj[s] = 0;
    if (u < gram_units) {
      tri_tile(u, ti[s], tj[s]);
    } else if (u < units) {
      ti[s] = (u - gram_units) / ctiles;
      tj[s] = tiles + (u - gram_units) % ctiles;   // past the Gram's tiles
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[s][e] = 0.0f;
  }
  for (int t0 = 0; t0 < p; t0 += w.chunk) {
    const int len = p - t0 < w.chunk ? p - t0 : w.chunk;
    if (t0 > 0) {                    // the next chunk over the last one
      __syncwarp();
      stage_rows(xp + t0, xs, n, len, w.px, p);
      stage_rows(yp + t0, ys, m, len, w.px, p);
      stage_wait();
    }
    // one call a slot (the Gram's tiles read xs twice, the cross
    // product's xs and ys), so that a lone warp fetches less code
#pragma unroll
    for (int s = 0; s < kWarpSlots; ++s) {
      if (ti[s] < 0) continue;
      const bool gram = tj[s] < tiles;
      row_tile(xs, w.px, 4 * ti[s], n, gram ? xs : ys, w.px,
               4 * (gram ? tj[s] : tj[s] - tiles), gram ? n : m, len,
               acc[s]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kWarpSlots; ++s) {
    if (ti[s] < 0) continue;
    const bool gram = tj[s] < tiles;
    const int j0 = 4 * (gram ? tj[s] : tj[s] - tiles);
    float* dst = gram ? a : z;
    const int ld = gram ? w.pitch : w.ldz;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int i = 4 * ti[s] + q;
        const int j = j0 + v;
        if (i < n && (gram ? j <= i : j < m)) {
          const float g = acc[s][q * 4 + v];
          dst[i * ld + j] = (gram && i == j) ? g + ridge : g;
        }
      }
  }
  __syncwarp();
  clk.mark(kLpGram);
  // the chain: factor alone, then the m antennas a column a thread
  float none[1][1];
  warp_factor<1, 1>(a, w.pitch, n, warp_threshold<1>(a, w.pitch, n, eps),
                    col, dinv, none, 0, z, w.ldz, m);
  clk.mark(kLpFactor);
  warp_columns_back(a, w.pitch, n, z, w.ldz, m);
  __syncwarp();
  clk.mark(kLpBack);
}

// K6's lane on one warp: see the header.  kK >= k bounds the symbols held
// in registers.
template <int kK, bool kStamps>
__global__ void __launch_bounds__(32)
pusch_chain_warp_kernel(const float* __restrict__ XP,
                        const float* __restrict__ YP,
                        const float* __restrict__ Y, float* __restrict__ X,
                        int n, int p, int m, int k, float ridge, float sigma2,
                        float eps, unsigned long long* __restrict__ stamps) {
  extern __shared__ float4 smem4[];
  const int t = threadIdx.x;
  const size_t lane = blockIdx.x;
  PhaseClock<kStamps, kLanePhases> clk(true);
  const WarpLane w(n, p, m, k);
  float* base = reinterpret_cast<float*>(smem4);
  float* a = base;                   // n x warp_pitch(n), over the pilots
  float* z = base + w.z;             // n x warp_pitch(m), over the pilots
  float* yv = base + w.region;       // m x k symbols
  float* col = yv + (m * k + 3) / 4 * 4;   // scratch
  float* dinv = col + warp_scratch_floats(n, k);   // n

  stage_rows(Y + lane * m * k, yv, 1, m * k, m * k);
  warp_estimate(XP + lane * n * p, YP + lane * m * p, n, p, m, ridge, eps,
                w, base, col, dinv, clk);
  // stage 2: K2's chain on H = Z^T, the Gram's tiles over the first
  // chain's L, which is dead
  float y[1][kK];
  warp_equalize<kK, true>(z, w.ldz, yv, a, w.pitch, col, n, m, k, sigma2,
                          eps, y, clk, kLpGram2);
  float* xl = X + lane * n * k;
#pragma unroll
  for (int c = 0; c < kK; ++c)
    if (t < n && c < k) xl[t * k + c] = y[0][c];
  clk.mark(kLpStore);
  clk.write(stamps + lane * kLaneStampWords);
}

// K5's lane on one warp (warp_estimate), then H = Z^T stored a pass of 4
// antennas x 8 rows a warp: each 32-byte run of a row of H written whole,
// Z read at its pitch (4 modulo 8) in 32 distinct banks.
template <bool kStamps>
__global__ void __launch_bounds__(32)
channel_estimate_warp_kernel(const float* __restrict__ XP,
                             const float* __restrict__ YP,
                             float* __restrict__ H, int n, int p, int m,
                             float ridge, float eps,
                             unsigned long long* __restrict__ stamps) {
  extern __shared__ float4 smem4[];
  const int t = threadIdx.x;
  const size_t lane = blockIdx.x;
  PhaseClock<kStamps, kLanePhases> clk(true);
  const WarpLane w(n, p, m, 0);
  float* base = reinterpret_cast<float*>(smem4);
  const float* z = base + w.z;
  float* col = base + w.region;                  // scratch
  float* dinv = col + warp_scratch_floats(n, 0);   // n
  warp_estimate(XP + lane * n * p, YP + lane * m * p, n, p, m, ridge, eps,
                w, base, col, dinv, clk);
  float* hl = H + lane * m * n;
  const int rq = t >> 3;
  const int iq = t & 7;
  for (int r0 = 0; r0 < m; r0 += 4) {
    const int r = r0 + rq;
    for (int i = iq; i < n; i += 8)
      if (r < m) hl[r * n + i] = z[i * w.ldz + r];
  }
  clk.mark(kLpStore);
  clk.write(stamps + lane * kLaneStampWords);
}

// The warp forms' limits: n <= 32 rows, the stage-1 tiles four slots a
// thread.
__host__ inline bool estimate_warp_ok(int n, int p, int m) {
  const int tiles = (n + 3) / 4;
  return n >= 1 && n <= 32 && p >= 1 && m >= 1 &&
         tiles * (tiles + 1) / 2 + tiles * ((m + 3) / 4) <= 32 * kWarpSlots;
}

template <bool kStamps>
cudaError_t launch_chain_warp(const float* xp, const float* yp,
                              const float* y, float* x, int batch, int n,
                              int p, int m, int k, float ridge, float sigma2,
                              float eps, unsigned long long* stamps,
                              cudaStream_t s) {
  if (!estimate_warp_ok(n, p, m) || k < 1 || k > kWarpMaxRhs)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * WarpLane(n, p, m, k).floats;
#define REPRO_CHAIN_WARP(KK)                                                \
  {                                                                         \
    cudaError_t err =                                                       \
        allow_warp_smem<pusch_chain_warp_kernel<KK, kStamps>>();            \
    if (err != cudaSuccess) return err;                                     \
    pusch_chain_warp_kernel<KK, kStamps><<<batch, 32, smem, s>>>(           \
        xp, yp, y, x, n, p, m, k, ridge, sigma2, eps, stamps);              \
    return cudaGetLastError();                                              \
  }
  if (k == 1) REPRO_CHAIN_WARP(1)
  if (k == 2) REPRO_CHAIN_WARP(2)
  if (k <= 4) REPRO_CHAIN_WARP(4)
  REPRO_CHAIN_WARP(8)
#undef REPRO_CHAIN_WARP
}

template <bool kStamps>
cudaError_t launch_estimate_warp(const float* xp, const float* yp, float* h,
                                 int batch, int n, int p, int m, float ridge,
                                 float eps, unsigned long long* stamps,
                                 cudaStream_t s) {
  if (!estimate_warp_ok(n, p, m)) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * WarpLane(n, p, m, 0).floats;
  cudaError_t err = allow_warp_smem<channel_estimate_warp_kernel<kStamps>>();
  if (err != cudaSuccess) return err;
  channel_estimate_warp_kernel<kStamps><<<batch, 32, smem, s>>>(
      xp, yp, h, n, p, m, ridge, eps, stamps);
  return cudaGetLastError();
}

size_t chanest_smem_bytes(int n, int p, int m) {
  return sizeof(float) * (static_cast<size_t>(p) * (n + 1) + p * (m + 1) +
                          n * n + n * m + n + m + 1);
}

size_t chain_smem_bytes(int n, int p, int m, int k) {
  return sizeof(float) * (static_cast<size_t>(p) * (n + 1) + p * (m + 1) +
                          m * k + n * n + n * m + m * n + n * k + n +
                          (m > k ? m : k) + 1);
}
}  // namespace
}  // namespace repro_torch

extern "C" {

size_t channel_estimate_smem(int n, int p, int m) {
  return repro_torch::chanest_smem_bytes(n, p, m);
}

size_t pusch_chain_smem(int n, int p, int m, int k) {
  return repro_torch::chain_smem_bytes(n, p, m, k);
}

// Dynamic shared memory one lane of K6's warp form takes.
size_t pusch_chain_warp_smem(int n, int p, int m, int k) {
  return sizeof(float) * repro_torch::WarpLane(n, p, m, k).floats;
}

// Dynamic shared memory one lane of K5's warp form takes.
size_t channel_estimate_warp_smem(int n, int p, int m) {
  return sizeof(float) * repro_torch::WarpLane(n, p, m, 0).floats;
}

// xp (batch, n, p), yp (batch, m, p) -> h (batch, m, n), all float32.
// warp = 1 runs the warp form (pipelines/pusch.py channel_estimate_plan;
// refused past n = 32 or the tiles four slots a thread hold), warp = 0
// the CTA form.
int channel_estimate_f32(const void* xp, const void* yp, void* h, int batch,
                         int n, int p, int m, float ridge, float eps,
                         int warp, void* stream) {
  using namespace repro_torch;
  const auto s = static_cast<cudaStream_t>(stream);
  const float* xpf = static_cast<const float*>(xp);
  const float* ypf = static_cast<const float*>(yp);
  float* hf = static_cast<float*>(h);
  if (warp)
    return launch_estimate_warp<false>(xpf, ypf, hf, batch, n, p, m, ridge,
                                       eps, nullptr, s);
  const size_t smem = chanest_smem_bytes(n, p, m);
  cudaError_t err = allow_smem(channel_estimate_kernel, smem);
  if (err != cudaSuccess) return err;
  channel_estimate_kernel<<<batch, kThreads, smem, s>>>(xpf, ypf, hf, n, p,
                                                        m, ridge, eps);
  return cudaGetLastError();
}

// The phase-stamped instance of K5's warp form (scripts/lane_phases.py):
// h as channel_estimate_f32's and per lane kLaneStampWords words of
// stamps (the second chain's phases 0).
int channel_estimate_phases_f32(const void* xp, const void* yp, void* h,
                                void* stamps, int batch, int n, int p, int m,
                                float ridge, float eps, void* stream) {
  return repro_torch::launch_estimate_warp<true>(
      static_cast<const float*>(xp), static_cast<const float*>(yp),
      static_cast<float*>(h), batch, n, p, m, ridge, eps,
      static_cast<unsigned long long*>(stamps),
      static_cast<cudaStream_t>(stream));
}

// xp (batch, n, p), yp (batch, m, p), y (batch, m, k) -> x (batch, n, k).
// warp = 1 runs the warp form (pipelines/pusch.py pusch_chain_plan;
// refused past n = 32, k = 8 or the tiles four slots a thread hold),
// warp = 0 the CTA form.
int pusch_chain_f32(const void* xp, const void* yp, const void* y, void* x,
                    int batch, int n, int p, int m, int k, float ridge,
                    float sigma2, float eps, int warp, void* stream) {
  using namespace repro_torch;
  const auto s = static_cast<cudaStream_t>(stream);
  const float* xpf = static_cast<const float*>(xp);
  const float* ypf = static_cast<const float*>(yp);
  const float* yf = static_cast<const float*>(y);
  float* xf = static_cast<float*>(x);
  if (warp)
    return launch_chain_warp<false>(xpf, ypf, yf, xf, batch, n, p, m, k,
                                    ridge, sigma2, eps, nullptr, s);
  const size_t smem = chain_smem_bytes(n, p, m, k);
  cudaError_t err = allow_smem(pusch_chain_kernel, smem);
  if (err != cudaSuccess) return err;
  pusch_chain_kernel<<<batch, kThreads, smem, s>>>(xpf, ypf, yf, xf, n, p, m,
                                                   k, ridge, sigma2, eps);
  return cudaGetLastError();
}

// The phase-stamped instance of K6's warp form (scripts/lane_phases.py): x
// as pusch_chain_f32's and per lane kLaneStampWords words of stamps.
int pusch_chain_phases_f32(const void* xp, const void* yp, const void* y,
                           void* x, void* stamps, int batch, int n, int p,
                           int m, int k, float ridge, float sigma2,
                           float eps, void* stream) {
  return repro_torch::launch_chain_warp<true>(
      static_cast<const float*>(xp), static_cast<const float*>(yp),
      static_cast<const float*>(y), static_cast<float*>(x), batch, n, p, m,
      k, ridge, sigma2, eps, static_cast<unsigned long long*>(stamps),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
