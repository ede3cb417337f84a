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
// in a per-lane slice of a work buffer and x is solved in place in X.
// After the same Gram stage it runs the panel chain (chol_panels.cuh): a
// panel of bs columns is factored in shared memory and the trailing lower
// triangle of G updated once a panel from register tiles, each product
// subtracted in chol_chain's order, so the global form equals the shared
// form bit for bit at every panel width.  The plan (threads, bs, shared
// memory) is pipelines/cholesky_solve.py's chol_panel_plan.
#include <cstddef>

#include "chol_panels.cuh"
#include "lane_common.cuh"

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

// Floats of work buffer one lane of the global form needs (G).
size_t mmse_equalize_work(int m, int n, int k) {
  return static_cast<size_t>(n) * n;
}

// h (batch, m, n), y (batch, m, k) -> x (batch, n, k), all float32.
// work: null for the shared form, else batch * mmse_equalize_work floats
// and the global form's plan (pipelines/cholesky_solve.py chol_panel_plan
// at (n, k): threads, panel width bs, smem bytes), refused unless it is
// one the panel chain was compiled for.  The shared form ignores the plan.
int mmse_equalize_f32(const void* h, const void* y, void* x, void* work,
                      int batch, int m, int n, int k, float sigma2, float eps,
                      int threads, int bs, int smem, void* stream) {
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
  const size_t smem_shared = smem_bytes(m, n, k);
  cudaError_t err = allow_smem(mmse_equalize_kernel<false>, smem_shared);
  if (err != cudaSuccess) return err;
  mmse_equalize_kernel<false><<<batch, kThreads, smem_shared, s>>>(
      hf, yf, xf, wf, m, n, k, 0, sigma2, eps);
  return cudaGetLastError();
}

}  // extern "C"
