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
#include <cstddef>

#include "lane_common.cuh"

namespace repro_torch {
namespace {

__global__ void __launch_bounds__(kThreads)
cholesky_solve_kernel(const float* __restrict__ A, const float* __restrict__ B,
                      float* __restrict__ X, int n, int m, float eps) {
  extern __shared__ float smem[];
  float* a = smem;            // n * n
  float* y = a + n * n;       // n * m
  float* col = y + n * m;     // n
  float* yk = col + n;        // m
  float* thresh = yk + m;     // 1
  const size_t lane = blockIdx.x;
  const float* al = A + lane * n * n;
  const float* bl = B + lane * n * m;
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

// a (batch, n, n), b (batch, n, m) -> x (batch, n, m), all float32.
int cholesky_solve_f32(const void* a, const void* b, void* x, int batch,
                       int n, int m, float eps, void* stream) {
  using namespace repro_torch;
  const size_t smem = smem_bytes(n, m);
  cudaError_t err = allow_smem(cholesky_solve_kernel, smem);
  if (err != cudaSuccess) return err;
  cholesky_solve_kernel<<<batch, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(x), n, m, eps);
  return cudaGetLastError();
}

}  // extern "C"
