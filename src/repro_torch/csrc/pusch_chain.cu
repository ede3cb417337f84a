// K5: pilot-based channel estimate, and K6: channel estimate fused with the
// MMSE equalizer, one CTA per lane.
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
#include <cstddef>

#include "lane_common.cuh"

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

// xp (batch, n, p), yp (batch, m, p) -> h (batch, m, n), all float32.
int channel_estimate_f32(const void* xp, const void* yp, void* h, int batch,
                         int n, int p, int m, float ridge, float eps,
                         void* stream) {
  using namespace repro_torch;
  const size_t smem = chanest_smem_bytes(n, p, m);
  cudaError_t err = allow_smem(channel_estimate_kernel, smem);
  if (err != cudaSuccess) return err;
  channel_estimate_kernel<<<batch, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xp), static_cast<const float*>(yp),
      static_cast<float*>(h), n, p, m, ridge, eps);
  return cudaGetLastError();
}

// xp (batch, n, p), yp (batch, m, p), y (batch, m, k) -> x (batch, n, k).
int pusch_chain_f32(const void* xp, const void* yp, const void* y, void* x,
                    int batch, int n, int p, int m, int k, float ridge,
                    float sigma2, float eps, void* stream) {
  using namespace repro_torch;
  const size_t smem = chain_smem_bytes(n, p, m, k);
  cudaError_t err = allow_smem(pusch_chain_kernel, smem);
  if (err != cudaSuccess) return err;
  pusch_chain_kernel<<<batch, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xp), static_cast<const float*>(yp),
      static_cast<const float*>(y), static_cast<float*>(x), n, p, m, k,
      ridge, sigma2, eps);
  return cudaGetLastError();
}

}  // extern "C"
