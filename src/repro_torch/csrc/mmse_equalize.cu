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
//
// A lane larger than shared memory (n > 168 at m = n + 4, k = 2) takes
// the global form: H and y are read in place from device memory, G lives
// in a per-lane slice of a work buffer and x is solved in place in X; only
// the chain's per-step scratch stays in shared memory.  Both forms run the
// same source, so they agree bit for bit where both fit.
#include <cstddef>

#include "lane_common.cuh"

namespace repro_torch {
namespace {

template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
mmse_equalize_kernel(const float* __restrict__ H, const float* __restrict__ Y,
                     float* __restrict__ X, float* __restrict__ work, int m,
                     int n, int k, float sigma2, float eps) {
  extern __shared__ float smem[];
  const size_t lane = blockIdx.x;
  const float* hl = H + lane * m * n;
  const float* yl = Y + lane * m * k;
  const float* h;             // m * n
  const float* yv;            // m * k
  float* g;                   // n * n
  float* rhs;                 // n * k
  float* col;                 // n
  if (kGlobal) {              // H and y read in place, x solved in place
    h = hl;
    yv = yl;
    g = work + lane * n * n;
    rhs = X + lane * n * k;
    col = smem;
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
  float* yk = col + n;        // k
  float* thresh = yk + k;     // 1
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
  if (!kGlobal) {
    float* xl = X + lane * n * k;
    for (int e = threadIdx.x; e < n * k; e += blockDim.x) xl[e] = rhs[e];
  }
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

// Floats of work buffer one lane of the global form needs (G).
size_t mmse_equalize_work(int m, int n, int k) {
  return static_cast<size_t>(n) * n;
}

// h (batch, m, n), y (batch, m, k) -> x (batch, n, k), all float32.
// work: null for the shared form, else batch * mmse_equalize_work floats.
int mmse_equalize_f32(const void* h, const void* y, void* x, void* work,
                      int batch, int m, int n, int k, float sigma2, float eps,
                      void* stream) {
  using namespace repro_torch;
  const auto s = static_cast<cudaStream_t>(stream);
  const float* hf = static_cast<const float*>(h);
  const float* yf = static_cast<const float*>(y);
  float* xf = static_cast<float*>(x);
  float* wf = static_cast<float*>(work);
  if (work) {
    mmse_equalize_kernel<true>
        <<<batch, kThreads, sizeof(float) * (n + k + 1), s>>>(
            hf, yf, xf, wf, m, n, k, sigma2, eps);
    return cudaGetLastError();
  }
  const size_t smem = smem_bytes(m, n, k);
  cudaError_t err = allow_smem(mmse_equalize_kernel<false>, smem);
  if (err != cudaSuccess) return err;
  mmse_equalize_kernel<false><<<batch, kThreads, smem, s>>>(
      hf, yf, xf, wf, m, n, k, sigma2, eps);
  return cudaGetLastError();
}

}  // extern "C"
