// K1: fused SPD solve, one CTA per lane.
//
// Replaces: src/repro/pipelines/cholesky_solve.py, cholesky_solve_pallas
// (_cholesky_solve_kernel), the TPU kernel that keeps the matrix and the
// right-hand sides VMEM-resident across factor, forward and back
// substitution.
//
// What bounds it on an H100: not bytes (each lane reads n*n/2 + n*m floats
// and writes n*m once) and not FLOPs (n^3/3 + 2 n^2 m per lane), but the
// 2n ordered steps per lane, each ending in a block barrier, with only
// O(n^2) work between barriers.  The design keeps the whole lane in
// shared memory so no step touches device memory, reads only the lower
// triangle of A from device memory (the upper half is never loaded, so
// garbage there cannot leak), and relies on many resident CTAs per SM to
// hide the barrier latency of each one.
//
// A lane larger than shared memory (n >= 240 at m = 2) takes the global
// form: the working matrix lives in a per-lane slice of a device work
// buffer and the right-hand sides are solved in place in X.  It runs the
// panel chain (chol_panels.cuh): a panel of bs columns is factored in
// shared memory and the trailing lower triangle in device memory is
// updated once a panel from register tiles, each product subtracted in
// chol_chain's order, so the global form equals the shared form bit for
// bit at every panel width.  The first panel reads A itself, so A is not
// copied into the work buffer first.  The plan (threads, bs, shared
// memory) is pipelines/cholesky_solve.py's chol_panel_plan.
#include <cstddef>

#include "chol_panels.cuh"
#include "lane_common.cuh"

namespace repro_torch {
namespace {

template <bool kGlobal>
__global__ void __launch_bounds__(kGlobal ? kPanelThreads : kThreads,
                                  kGlobal ? kPanelMinBlocks : 0)
cholesky_solve_kernel(const float* __restrict__ A, const float* __restrict__ B,
                      float* __restrict__ X, float* __restrict__ work, int n,
                      int m, int bs, float eps) {
  extern __shared__ float smem[];
  const size_t lane = blockIdx.x;
  const float* al = A + lane * n * n;
  const float* bl = B + lane * n * m;
  if (kGlobal) {
    float* y = X + lane * n * m;
    for (int e = threadIdx.x; e < n * m; e += blockDim.x) y[e] = bl[e];
    __syncthreads();
    chol_chain_panels(al, work + lane * n * n, y, n, m, bs, eps, smem);
    return;
  }
  float* a = smem;            // n * n
  float* y = a + n * n;       // n * m
  float* col = y + n * m;     // n
  float* yk = col + n;        // m
  float* thresh = yk + m;     // 1
  for (int e = threadIdx.x; e < n * n; e += blockDim.x)
    if (e % n <= e / n) a[e] = al[e];   // lower triangle only
  for (int e = threadIdx.x; e < n * m; e += blockDim.x) y[e] = bl[e];
  __syncthreads();
  chol_chain(a, y, n, m, eps, col, yk, thresh);
  float* xl = X + lane * n * m;
  for (int e = threadIdx.x; e < n * m; e += blockDim.x) xl[e] = y[e];
}

size_t smem_bytes(int n, int m) {
  return sizeof(float) * (static_cast<size_t>(n) * n + n * m + n + m + 1);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

size_t cholesky_solve_smem(int n, int m) {
  return repro_torch::smem_bytes(n, m);
}

// Dynamic shared memory one lane of the global form needs at panel width bs.
size_t cholesky_solve_global_smem(int n, int m, int bs) {
  return repro_torch::chol_panel_smem_bytes(n, m, bs);
}

// Floats of work buffer one lane of the global form needs.
size_t cholesky_solve_work(int n, int m) {
  return static_cast<size_t>(n) * n;
}

// a (batch, n, n), b (batch, n, m) -> x (batch, n, m), all float32.
// work: null for the shared form, else batch * cholesky_solve_work floats
// and the global form's plan (pipelines/cholesky_solve.py chol_panel_plan:
// threads, panel width bs, smem bytes), refused unless it is one the
// panel chain was compiled for.  The shared form ignores the plan.
int cholesky_solve_f32(const void* a, const void* b, void* x, void* work,
                       int batch, int n, int m, float eps, int threads,
                       int bs, int smem, void* stream) {
  using namespace repro_torch;
  const auto s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* xf = static_cast<float*>(x);
  float* wf = static_cast<float*>(work);
  if (work) {
    if (!chol_panel_plan_ok(n, m, threads, bs, smem))
      return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(cholesky_solve_kernel<true>, smem);
    if (err != cudaSuccess) return err;
    cholesky_solve_kernel<true><<<batch, threads, smem, s>>>(af, bf, xf, wf,
                                                             n, m, bs, eps);
    return cudaGetLastError();
  }
  const size_t smem_shared = smem_bytes(n, m);
  cudaError_t err = allow_smem(cholesky_solve_kernel<false>, smem_shared);
  if (err != cudaSuccess) return err;
  cholesky_solve_kernel<false><<<batch, kThreads, smem_shared, s>>>(
      af, bf, xf, wf, n, m, 0, eps);
  return cudaGetLastError();
}

}  // extern "C"
