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
// buffer and the right-hand sides are solved in place in X, only the
// per-step scratch stays in shared memory.  Both forms run the same
// chol_chain source, so they agree bit for bit where both fit; the global
// form's steps go through L1/L2 and are slower.
#include <cstddef>

#include "lane_common.cuh"

namespace repro_torch {
namespace {

template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
cholesky_solve_kernel(const float* __restrict__ A, const float* __restrict__ B,
                      float* __restrict__ X, float* __restrict__ work, int n,
                      int m, float eps) {
  extern __shared__ float smem[];
  const size_t lane = blockIdx.x;
  float* a;                   // n * n
  float* y;                   // n * m
  float* col;                 // n
  if (kGlobal) {
    a = work + lane * n * n;
    y = X + lane * n * m;
    col = smem;
  } else {
    a = smem;
    y = a + n * n;
    col = y + n * m;
  }
  float* yk = col + n;        // m
  float* thresh = yk + m;     // 1
  const float* al = A + lane * n * n;
  const float* bl = B + lane * n * m;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x)
    if (e % n <= e / n) a[e] = al[e];   // lower triangle only
  for (int e = threadIdx.x; e < n * m; e += blockDim.x) y[e] = bl[e];
  __syncthreads();
  chol_chain(a, y, n, m, eps, col, yk, thresh);
  if (!kGlobal) {
    float* xl = X + lane * n * m;
    for (int e = threadIdx.x; e < n * m; e += blockDim.x) xl[e] = y[e];
  }
}

size_t smem_bytes(int n, int m) {
  return sizeof(float) * (static_cast<size_t>(n) * n + n * m + n + m + 1);
}

size_t scratch_bytes(int n, int m) {
  return sizeof(float) * (static_cast<size_t>(n) + m + 1);
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

// Floats of work buffer one lane of the global form needs.
size_t cholesky_solve_work(int n, int m) {
  return static_cast<size_t>(n) * n;
}

// a (batch, n, n), b (batch, n, m) -> x (batch, n, m), all float32.
// work: null for the shared form, else batch * cholesky_solve_work floats.
int cholesky_solve_f32(const void* a, const void* b, void* x, void* work,
                       int batch, int n, int m, float eps, void* stream) {
  using namespace repro_torch;
  const auto s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* xf = static_cast<float*>(x);
  float* wf = static_cast<float*>(work);
  if (work) {
    cholesky_solve_kernel<true><<<batch, kThreads, scratch_bytes(n, m), s>>>(
        af, bf, xf, wf, n, m, eps);
    return cudaGetLastError();
  }
  const size_t smem = smem_bytes(n, m);
  cudaError_t err = allow_smem(cholesky_solve_kernel<false>, smem);
  if (err != cudaSuccess) return err;
  cholesky_solve_kernel<false><<<batch, kThreads, smem, s>>>(af, bf, xf, wf,
                                                             n, m, eps);
  return cudaGetLastError();
}

}  // extern "C"
