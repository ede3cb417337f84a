// K16: batched triangular solve with many right-hand sides, one CTA per
// lane.
//
// Replaces: src/repro/kernels/trisolve.py, trisolve_pallas
// (_trisolve_kernel): n ordered steps k (ascending for lower, descending
// for upper), each the reciprocal of the pivot, the solution row y[k] =
// y[k] * (1 / l[k][k]), and an AXPY of column k of l into the rows still
// to solve (rows > k for lower, rows < k for upper).
//
// What bounds it on an H100: neither bytes (each lane reads n(n+1)/2 + n*m
// floats and writes n*m) nor FLOPs (n^2 m), but the n ordered steps per
// lane and what each step waits on.  Every form loads only the triangle
// the solve reads (the other one may hold anything, NaN included, and
// never leaks) and keeps the reference's reciprocal-then-multiply.
//
// The warp form (n <= 32, m <= 8: every path's shapes) runs a lane on one
// warp, eight lanes a CTA: thread i holds row i's m values in registers,
// the triangle is staged row by row, coalesced, into the warp's slice of
// shared memory (pitch 33, so a warp's rows fall in distinct banks),
// thread k takes the reciprocal of pivot k and, at step k, hands the
// solution row y[k] * (1 / l[k][k]) to the warp by __shfl_sync, and each
// live row takes it with one FFMA.  No block barrier anywhere: a step
// waits on one multiply, one shuffle and one FFMA, and the steps are
// unrolled with a predicate, so nothing lands in local memory.
//
// The CTA form (n > 32 or m > 8) runs a lane on a 128-thread CTA with the
// triangle and the right-hand sides in shared memory, two block barriers
// a step, and relies on many resident CTAs per SM to hide them.  A lane
// larger than shared memory (n > 240 at m = 2) takes the global form: the
// right-hand sides are solved in place in the lane's slice of y in device
// memory and the triangle is read where it lies; only the solution row
// stays in shared memory.  The three forms compute the same expressions in
// the same order, so they agree bit for bit where they overlap.  The form
// is kernels/trisolve.py's trisolve_form.
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

constexpr int kWarpLanes = 8;    // lanes (warps) a CTA of the warp form
constexpr int kWarpMaxN = 32;    // a row a thread
constexpr int kWarpPitch = 33;
constexpr int kWarpMaxM = 8;     // right-hand sides in registers

// The substitution loop of tri_steps on one warp, a row a thread; kM >= m
// bounds the right-hand sides held in registers.
template <int kM>
__global__ void __launch_bounds__(32 * kWarpLanes)
trisolve_warp_kernel(const float* __restrict__ L, const float* __restrict__ B,
                     float* __restrict__ Y, int batch, int n, int m,
                     bool lower) {
  __shared__ float tri[kWarpLanes][kWarpMaxN * kWarpPitch];
  const int warp = threadIdx.x >> 5;
  const int i = threadIdx.x & 31;              // this thread's row
  const size_t lane = static_cast<size_t>(blockIdx.x) * kWarpLanes + warp;
  if (lane >= static_cast<size_t>(batch)) return;   // the whole warp
  const float* lg = L + lane * n * n;
  float* l = tri[warp];
  for (int r = 0; r < n; ++r)                  // the read triangle only
    if (i < n && (lower ? i <= r : i >= r))
      l[r * kWarpPitch + i] = lg[r * n + i];
  const float* bl = B + lane * n * m;
  float y[kM];
#pragma unroll
  for (int c = 0; c < kM; ++c)
    y[c] = (i < n && c < m) ? bl[i * m + c] : 0.0f;
  __syncwarp();
  // point region of step i, taken by thread i: the reciprocal of its pivot
  const float inv = i < n ? 1.0f / l[i * kWarpPitch + i] : 0.0f;
#pragma unroll
  for (int s = 0; s < kWarpMaxN; ++s) {
    if (s < n) {
      // the solution row y[k] * inv from thread k, then the AXPY into the
      // rows still to solve
      const int k = lower ? s : n - 1 - s;
      const bool live = i < n && (lower ? i > k : i < k);
      const float lik = live ? l[i * kWarpPitch + k] : 0.0f;
#pragma unroll
      for (int c = 0; c < kM; ++c) {
        if (c < m) {
          const float yk = __shfl_sync(0xffffffffu, y[c] * inv, k);
          if (i == k)
            y[c] = yk;
          else if (live)
            y[c] -= lik * yk;
        }
      }
    }
  }
  float* yl = Y + lane * n * m;
#pragma unroll
  for (int c = 0; c < kM; ++c)
    if (i < n && c < m) yl[i * m + c] = y[c];
}

template <int kM>
cudaError_t launch_warp(const float* l, const float* b, float* y, int batch,
                        int n, int m, bool lower, cudaStream_t s) {
  const int ctas = (batch + kWarpLanes - 1) / kWarpLanes;
  trisolve_warp_kernel<kM><<<ctas, 32 * kWarpLanes, 0, s>>>(l, b, y, batch,
                                                            n, m, lower);
  return cudaGetLastError();
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
// lower: 1 forward, 0 backward substitution.  form: 0 the CTA form, 1 the
// global form (solved in place in y), 2 the warp form (refused past n = 32
// or m = 8).
int trisolve_f32(const void* l, const void* b, void* y, int batch, int n,
                 int m, int lower, int form, void* stream) {
  using namespace repro_torch;
  const auto s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(l);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  if (form == 2) {
    if (n < 1 || n > kWarpMaxN || m < 1 || m > kWarpMaxM)
      return cudaErrorInvalidValue;
    if (m == 1) return launch_warp<1>(lf, bf, yf, batch, n, m, lower, s);
    if (m == 2) return launch_warp<2>(lf, bf, yf, batch, n, m, lower, s);
    if (m <= 4) return launch_warp<4>(lf, bf, yf, batch, n, m, lower, s);
    return launch_warp<8>(lf, bf, yf, batch, n, m, lower, s);
  }
  if (form == 1) {
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
