// K15: batched unguarded Cholesky factor L, one CTA per lane.
//
// Replaces: src/repro/kernels/cholesky.py, cholesky_pallas
// (_cholesky_kernel), the TPU kernel that keeps one lane's matrix in VMEM
// for all n outer steps: an unguarded rsqrt of the pivot, column k scaled
// below the diagonal, a rank-1 update of the trailing rows and columns > k,
// the finished column written back, the strict upper triangle zeroed at
// the end.  A non-SPD lane gives NaN, as the reference's does.
//
// What bounds it on an H100: at n <= 32 neither bytes (each lane reads
// n(n+1)/2 floats and writes n*n) nor FLOPs (n^3/3), but the n ordered
// steps per lane, two block barriers each, with O(n^2) work between them.
// The design keeps the lane in shared memory so no step touches device
// memory, reads only the lower triangle of A (the update of the lower
// triangle never reads the upper one, so NaN there cannot leak), updates
// only the lower triangle, and relies on many resident CTAs per SM to
// hide each one's barrier latency.
//
// A lane larger than shared memory (n > 240) takes the global form: the
// factor runs in place in the lane's slice of L in device memory, only
// the scaled column stays in shared memory.  Both forms run chol_factor,
// so they agree bit for bit where both fit.
#include <cstddef>

#include "lane_common.cuh"

namespace repro_torch {
namespace {

// The factor loop of _cholesky_kernel on one lane.  a (n x n, row-major,
// shared or device memory) holds A's lower triangle and receives L there;
// its upper triangle is neither read nor written.  col: n floats of
// shared scratch.
__device__ inline void chol_factor(float* a, int n, float* col) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int k = 0; k < n; ++k) {
    // point + vector region: col = a[:, k] * rsqrt(a[k][k]), rows >= k
    const float inv = rsqrtf(a[k * n + k]);
    for (int i = k + tid; i < n; i += nt) col[i] = a[i * n + k] * inv;
    __syncthreads();
    // matrix region: rank-1 update of the trailing lower triangle, and
    // column k of L written back
    const int t = n - k - 1;
    for (int e = tid; e < t * t; e += nt) {
      const int i = k + 1 + e / t;
      const int j = k + 1 + e % t;
      if (j <= i) a[i * n + j] -= col[i] * col[j];
    }
    for (int i = k + tid; i < n; i += nt) a[i * n + k] = col[i];
    __syncthreads();
  }
}

template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
cholesky_kernel(const float* __restrict__ A, float* __restrict__ L, int n) {
  extern __shared__ float smem[];
  const size_t lane = blockIdx.x;
  const float* al = A + lane * n * n;
  float* ll = L + lane * n * n;
  float* a = kGlobal ? ll : smem;     // n * n
  float* col = kGlobal ? smem : smem + n * n;
  // lower triangle only; the global form zeroes L's upper triangle now
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    if (e % n <= e / n)
      a[e] = al[e];
    else if (kGlobal)
      a[e] = 0.0f;
  }
  __syncthreads();
  chol_factor(a, n, col);
  if (!kGlobal)
    for (int e = threadIdx.x; e < n * n; e += blockDim.x)
      ll[e] = e % n <= e / n ? a[e] : 0.0f;
}

size_t smem_bytes(int n) {
  return sizeof(float) * (static_cast<size_t>(n) * n + n);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

size_t cholesky_smem(int n) { return repro_torch::smem_bytes(n); }

// a (batch, n, n) float32 -> l (batch, n, n).  in_global: 0 for the shared
// form, 1 for the global form (the lane factored in place in l).
int cholesky_f32(const void* a, void* l, int batch, int n, int in_global,
                 void* stream) {
  using namespace repro_torch;
  const auto s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  float* lf = static_cast<float*>(l);
  if (in_global) {
    cholesky_kernel<true><<<batch, kThreads, sizeof(float) * n, s>>>(af, lf,
                                                                    n);
    return cudaGetLastError();
  }
  const size_t smem = smem_bytes(n);
  cudaError_t err = allow_smem(cholesky_kernel<false>, smem);
  if (err != cudaSuccess) return err;
  cholesky_kernel<false><<<batch, kThreads, smem, s>>>(af, lf, n);
  return cudaGetLastError();
}

}  // extern "C"
