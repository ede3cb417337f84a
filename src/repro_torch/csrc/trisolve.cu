// K16: batched triangular solve with many right-hand sides, one CTA per
// lane.
//
// Replaces: src/repro/kernels/trisolve.py, trisolve_pallas
// (_trisolve_kernel): n ordered steps k (ascending for lower, descending
// for upper), each the reciprocal of the pivot, the solution row y[k] =
// y[k] * (1 / l[k][k]), and an AXPY of column k of l into the rows still
// to solve (rows > k for lower, rows < k for upper).
//
// What bounds it on an H100: at n <= 32 neither bytes (each lane reads
// n(n+1)/2 + n*m floats and writes n*m) nor FLOPs (n^2 m), but the n
// ordered steps per lane, two block barriers each, with O(n m) work
// between them.  The design keeps the triangle and the right-hand sides
// in shared memory so no step touches device memory, loads only the
// triangle the solve reads (the other one may hold anything, NaN
// included, and never leaks), keeps the reference's reciprocal-then-
// multiply, and relies on many resident CTAs per SM to hide each one's
// barrier latency.
//
// A lane larger than shared memory (n > 240 at m = 2) takes the global
// form: the right-hand sides are solved in place in the lane's slice of y
// in device memory and the triangle is read where it lies; only the
// solution row stays in shared memory.  Both forms run tri_steps, so they
// agree bit for bit where both fit.
#include <cstddef>

#include "lane_common.cuh"

namespace repro_torch {
namespace {

// The substitution loop of _trisolve_kernel on one lane.  l (n x n, leading
// dimension n) and y (n x m, solved in place) lie in shared or device
// memory; yk: m floats of shared scratch.
__device__ inline void tri_steps(const float* l, float* y, int n, int m,
                                 bool lower, float* yk) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int s = 0; s < n; ++s) {
    const int k = lower ? s : n - 1 - s;
    // point region: the reciprocal of the pivot, then the solution row
    const float inv = 1.0f / l[k * n + k];
    for (int c = tid; c < m; c += nt) yk[c] = y[k * m + c] * inv;
    __syncthreads();
    // critical region: the AXPY of column k into the rows still to solve
    const int lo = lower ? k : 0;           // rows [lo, hi) hold row k
    const int hi = lower ? n : k + 1;
    for (int e = lo * m + tid; e < hi * m; e += nt) {
      const int i = e / m;
      const int c = e % m;
      if (i == k)
        y[e] = yk[c];
      else
        y[e] -= l[i * n + k] * yk[c];
    }
    __syncthreads();
  }
}

template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
trisolve_kernel(const float* __restrict__ L, const float* __restrict__ B,
                float* __restrict__ Y, int n, int m, bool lower) {
  extern __shared__ float smem[];
  const size_t lane = blockIdx.x;
  const float* lg = L + lane * n * n;
  const float* bl = B + lane * n * m;
  float* yl = Y + lane * n * m;
  const float* l;
  float* y;
  float* yk;
  if (kGlobal) {
    l = lg;
    y = yl;
    yk = smem;
  } else {
    float* ls = smem;                 // n * n, the read triangle only
    for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
      const int i = e / n;
      const int j = e % n;
      if (lower ? j <= i : j >= i) ls[e] = lg[e];
    }
    l = ls;
    y = ls + n * n;                   // n * m
    yk = y + n * m;                   // m
  }
  for (int e = threadIdx.x; e < n * m; e += blockDim.x) y[e] = bl[e];
  __syncthreads();
  tri_steps(l, y, n, m, lower, yk);
  if (!kGlobal)
    for (int e = threadIdx.x; e < n * m; e += blockDim.x) yl[e] = y[e];
}

size_t smem_bytes(int n, int m) {
  return sizeof(float) * (static_cast<size_t>(n) * n + n * m + m);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

size_t trisolve_smem(int n, int m) { return repro_torch::smem_bytes(n, m); }

// l (batch, n, n) triangular, b (batch, n, m) -> y (batch, n, m), float32.
// lower: 1 forward, 0 backward substitution.  in_global: 0 for the shared
// form, 1 for the global form (solved in place in y).
int trisolve_f32(const void* l, const void* b, void* y, int batch, int n,
                 int m, int lower, int in_global, void* stream) {
  using namespace repro_torch;
  const auto s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(l);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  if (in_global) {
    const size_t smem = sizeof(float) * m;
    cudaError_t err = allow_smem(trisolve_kernel<true>, smem);
    if (err != cudaSuccess) return err;
    trisolve_kernel<true><<<batch, kThreads, smem, s>>>(lf, bf, yf, n, m,
                                                        lower != 0);
    return cudaGetLastError();
  }
  const size_t smem = smem_bytes(n, m);
  cudaError_t err = allow_smem(trisolve_kernel<false>, smem);
  if (err != cudaSuccess) return err;
  trisolve_kernel<false><<<batch, kThreads, smem, s>>>(lf, bf, yf, n, m,
                                                       lower != 0);
  return cudaGetLastError();
}

}  // extern "C"
