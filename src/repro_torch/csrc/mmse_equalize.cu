// K2: fused MMSE equalizer on the real (or real-expanded) system, one CTA
// per lane.
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
#include <cstddef>

#include "lane_common.cuh"

namespace repro_torch {
namespace {

__global__ void __launch_bounds__(kThreads)
mmse_equalize_kernel(const float* __restrict__ H, const float* __restrict__ Y,
                     float* __restrict__ X, int m, int n, int k,
                     float sigma2, float eps) {
  extern __shared__ float smem[];
  float* h = smem;            // m * n
  float* yv = h + m * n;      // m * k
  float* g = yv + m * k;      // n * n
  float* rhs = g + n * n;     // n * k
  float* col = rhs + n * k;   // n
  float* yk = col + n;        // k
  float* thresh = yk + k;     // 1
  const size_t lane = blockIdx.x;
  const float* hl = H + lane * m * n;
  const float* yl = Y + lane * m * k;
  for (int e = threadIdx.x; e < m * n; e += blockDim.x) h[e] = hl[e];
  for (int e = threadIdx.x; e < m * k; e += blockDim.x) yv[e] = yl[e];
  __syncthreads();
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
  chol_chain(g, rhs, n, k, eps, col, yk, thresh);
  float* xl = X + lane * n * k;
  for (int e = threadIdx.x; e < n * k; e += blockDim.x) xl[e] = rhs[e];
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

// h (batch, m, n), y (batch, m, k) -> x (batch, n, k), all float32.
int mmse_equalize_f32(const void* h, const void* y, void* x, int batch, int m,
                      int n, int k, float sigma2, float eps, void* stream) {
  using namespace repro_torch;
  const size_t smem = smem_bytes(m, n, k);
  cudaError_t err = allow_smem(mmse_equalize_kernel, smem);
  if (err != cudaSuccess) return err;
  mmse_equalize_kernel<<<batch, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(y),
      static_cast<float*>(x), m, n, k, sigma2, eps);
  return cudaGetLastError();
}

}  // extern "C"
