// Shared device code of the per-lane kernels (K1-K9).
//
// The solver kernels run one CTA per lane (blockIdx.x = lane) with
// kThreads threads; the lane's working matrix and right-hand sides live in
// dynamic shared memory in float32.  Threads stride over the elements of
// each ordered step and __syncthreads() separates the steps, which is the
// ordered dependence chain the TPU kernels express as a fori_loop carry.
// The FFT (K7, rows per CTA) and the Jacobi SVD (K8, a CTA per lane of its
// plan's thread groups) shape their blocks themselves and take only
// allow_smem from here.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace repro_torch {

constexpr int kThreads = 128;
constexpr float kPivotFloor = 1e-30f;

// Raises the block's dynamic shared memory limit when the lane needs more
// than the default 48 KB; returns the launch configuration's error, if any.
// The Python wrapper (CudaKernel.launch) refuses a lane that does not fit.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Sum over the 32 lanes of a warp; every lane receives the total.
__device__ inline float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// max(eps * max(diag a), floor), with a NaN on the diagonal propagating
// into the threshold as jnp.max does in pivot_threshold.  Thread 0 only.
__device__ inline float diag_threshold(const float* a, int n, int lda,
                                       float scale, float floor_) {
  float dmax = -INFINITY;
  bool nan = false;
  for (int i = 0; i < n; ++i) {
    const float d = a[i * lda + i];
    nan |= isnan(d);
    dmax = fmaxf(dmax, d);
  }
  return nan ? NAN : fmaxf(scale * dmax, floor_);
}

// The fused Cholesky chain of pipelines/cholesky_solve.py on one lane:
// guarded factor with the forward substitution interleaved column by
// column (factor_forward_step), then back substitution on L^T
// (back_substitution_step).
//
//   a        n x n row-major, shared.  Only the lower triangle (i >= j) is
//            read; the upper triangle may hold anything.  L overwrites it.
//   y        n x m row-major, shared; holds x on return.
//   col      n floats of shared scratch (the finished column of L).
//   yk       m floats of shared scratch (the finished solution row).
//   thresh_s one float of shared scratch.
//
// A pivot at or below thresh = max(eps * max diag, 1e-30) takes the
// rank-deficient path: unit diagonal, zeroed column below it and a zeroed
// solution component.  The selects and their order follow the reference
// exactly; back substitution divides by l[k][k] with no further guard.
__device__ inline void chol_chain(float* a, float* y, int n, int m,
                                  float eps, float* col, float* yk,
                                  float* thresh_s) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (tid == 0) *thresh_s = diag_threshold(a, n, n, eps, kPivotFloor);
  __syncthreads();
  const float thresh = *thresh_s;

  for (int k = 0; k < n; ++k) {
    // point + vector region: guarded rsqrt, scaled column, solution row k
    const float akk = a[k * n + k];
    const bool ok = akk > thresh;
    const float inv = ok ? rsqrtf(fmaxf(akk, thresh)) : 0.0f;
    for (int i = k + tid; i < n; i += nt)
      col[i] = (i == k) ? (ok ? akk * inv : 1.0f) : a[i * n + k] * inv;
    for (int c = tid; c < m; c += nt) yk[c] = y[k * m + c] * inv;
    __syncthreads();
    // matrix region: rank-1 update of the trailing lower triangle, column
    // k of L stored, and the forward-substitution AXPY for rows below k
    const int t = n - k - 1;
    for (int e = tid; e < t * t; e += nt) {
      const int i = k + 1 + e / t;
      const int j = k + 1 + e % t;
      if (j <= i) a[i * n + j] -= col[i] * col[j];
    }
    for (int i = k + tid; i < n; i += nt) a[i * n + k] = col[i];
    for (int e = k * m + tid; e < n * m; e += nt) {
      const int i = e / m;
      const int c = e % m;
      if (i == k)
        y[e] = yk[c];
      else
        y[e] -= col[i] * yk[c];
    }
    __syncthreads();
  }

  // back substitution on U = L^T: x[k] = y[k] / l[k][k];
  // y[j < k] -= l[k][j] * x[k]  (row k of L, left of the diagonal)
  for (int k = n - 1; k >= 0; --k) {
    const float lkk = a[k * n + k];
    for (int c = tid; c < m; c += nt) yk[c] = y[k * m + c] / lkk;
    __syncthreads();
    for (int e = tid; e < (k + 1) * m; e += nt) {
      const int i = e / m;
      const int c = e % m;
      if (i == k)
        y[e] = yk[c];
      else
        y[e] -= a[k * n + i] * yk[c];
    }
    __syncthreads();
  }
}

}  // namespace repro_torch
