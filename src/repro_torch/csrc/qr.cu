// K17: batched Householder QR with an explicit Q, one CTA per lane.
//
// Replaces: src/repro/kernels/qr.py, qr_pallas (_qr_kernel): from Q = I and
// R = A, min(n, m-1) reflectors (none when m = 1), each x = R[k:, k],
// alpha = x_k >= 0 ? -|x| : |x|, v = x - alpha e_k, tau = 2 / max(|v|^2,
// 1e-30) (0 where |x| < 1e-30), then R -= v (tau v^T R) and
// Q -= (tau Q v) v^T; R is returned masked to rows <= cols.
//
// What bounds it on an H100: at n <= 32 neither bytes (each lane reads m*n
// floats and writes m*m + m*n) nor FLOPs (about 2 m n^2 - 2 n^3/3 for R and
// 4 m^2 n - 2 m n^2 for Q), but the min(n, m-1) ordered reflectors per lane,
// three phases each (the reflector in one warp, the v^T R and Q v dot
// products, the rank-1 updates) separated by block barriers.  The design
// keeps Q and R in shared memory so no step touches device memory, touches
// only rows and columns >= k of R and columns >= k of Q (the reflector is
// exactly zero above k, and R's columns left of k are masked at the end),
// and keeps Q transposed so that the Q v dot products and the Q update
// read consecutive addresses across threads.
//
// A lane larger than shared memory (m > 170 at m = n + 4) takes the global
// form: Q (transposed) and R are worked on in place in the lane's slices
// of the outputs in device memory, Q transposed back at the end; only v,
// the dot products and tau stay in shared memory.  Both forms run
// qr_steps, so they agree bit for bit where both fit.
#include <cstddef>

#include "lane_common.cuh"

namespace repro_torch {
namespace {

constexpr float kTiny = 1e-30f;

// The reflector loop of _qr_kernel on one lane.  qt (m x m, Q transposed:
// qt[j * m + i] = Q[i][j]) and r (m x n) lie in shared or device memory;
// v (m), w (n + m: tau v^T R, then tau Q v) and tau_s (1) are shared.
__device__ inline void qr_steps(float* qt, float* r, int m, int n, float* v,
                                float* w, float* tau_s) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nref = m > 1 ? min(n, m - 1) : 0;
  float* u = w + n;
  for (int k = 0; k < nref; ++k) {
    // householder region (warp 0): |x|, alpha, v, tau
    if (tid < 32) {
      float s = 0.0f;
      for (int i = k + tid; i < m; i += 32) s += r[i * n + k] * r[i * n + k];
      const float norm = sqrtf(warp_sum(s));
      const float xk = r[k * n + k];
      const float alpha = xk >= 0.0f ? -norm : norm;
      for (int i = tid; i < m; i += 32)
        v[i] = i < k ? 0.0f : (i == k ? xk - alpha : r[i * n + k]);
      __syncwarp();
      float s2 = 0.0f;
      for (int i = k + tid; i < m; i += 32) s2 += v[i] * v[i];
      const float vnorm2 = fmaxf(warp_sum(s2), kTiny);
      if (tid == 0) *tau_s = norm < kTiny ? 0.0f : 2.0f / vnorm2;
    }
    __syncthreads();
    const float tau = *tau_s;
    // w[j] = tau (v^T R)[j] for columns j >= k; u[i] = tau (Q v)[i]
    const int cols = n - k;
    for (int t = tid; t < cols + m; t += nt) {
      float s = 0.0f;
      if (t < cols) {
        const int j = k + t;
        for (int i = k; i < m; ++i) s += v[i] * r[i * n + j];
        w[j] = tau * s;
      } else {
        const int i = t - cols;
        for (int j = k; j < m; ++j) s += qt[j * m + i] * v[j];
        u[i] = tau * s;
      }
    }
    __syncthreads();
    // rank-1 updates: R[k:, k:] -= v w^T, Q[:, k:] -= u v^T
    for (int e = tid; e < (m - k) * cols; e += nt) {
      const int i = k + e / cols;
      const int j = k + e % cols;
      r[i * n + j] -= v[i] * w[j];
    }
    for (int e = tid; e < (m - k) * m; e += nt) {
      const int j = k + e / m;
      const int i = e % m;
      qt[j * m + i] -= u[i] * v[j];
    }
    __syncthreads();
  }
}

template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
qr_kernel(const float* __restrict__ A, float* __restrict__ Q,
          float* __restrict__ R, int m, int n) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t lane = blockIdx.x;
  const float* al = A + lane * m * n;
  float* ql = Q + lane * m * m;
  float* rl = R + lane * m * n;
  float* qt;                  // m * m
  float* r;                   // m * n
  float* v;                   // m
  if (kGlobal) {
    qt = ql;
    r = rl;
    v = smem;
  } else {
    qt = smem;
    r = qt + m * m;
    v = r + m * n;
  }
  float* w = v + m;           // n + m
  float* tau_s = w + n + m;   // 1
  for (int e = tid; e < m * m; e += nt)
    qt[e] = e / m == e % m ? 1.0f : 0.0f;
  for (int e = tid; e < m * n; e += nt) r[e] = al[e];
  __syncthreads();
  qr_steps(qt, r, m, n, v, w, tau_s);
  if (kGlobal) {
    // transpose Q in place (each pair swapped by one thread) and zero R
    // below its diagonal
    for (int e = tid; e < m * m; e += nt) {
      const int i = e / m;
      const int j = e % m;
      if (i < j) {
        const float t = ql[e];
        ql[e] = ql[j * m + i];
        ql[j * m + i] = t;
      }
    }
    for (int e = tid; e < m * n; e += nt)
      if (e / n > e % n) rl[e] = 0.0f;
  } else {
    for (int e = tid; e < m * m; e += nt) ql[e] = qt[(e % m) * m + e / m];
    for (int e = tid; e < m * n; e += nt)
      rl[e] = e / n <= e % n ? r[e] : 0.0f;
  }
}

size_t scratch_floats(int m, int n) {
  return static_cast<size_t>(m) + n + m + 1;
}

size_t smem_bytes(int m, int n) {
  return sizeof(float) *
         (static_cast<size_t>(m) * m + static_cast<size_t>(m) * n +
          scratch_floats(m, n));
}

}  // namespace
}  // namespace repro_torch

extern "C" {

size_t qr_smem(int m, int n) { return repro_torch::smem_bytes(m, n); }

// a (batch, m, n), any m and n -> q (batch, m, m), r (batch, m, n), float32
// (for m < n, min(n, m - 1) reflectors leave r an upper trapezoid).
// in_global: 0 for the shared form, 1 for the global form (Q and R worked
// on in place in q and r).
int qr_f32(const void* a, void* q, void* r, int batch, int m, int n,
           int in_global, void* stream) {
  using namespace repro_torch;
  const auto s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  float* qf = static_cast<float*>(q);
  float* rf = static_cast<float*>(r);
  if (in_global) {
    const size_t smem = sizeof(float) * scratch_floats(m, n);
    cudaError_t err = allow_smem(qr_kernel<true>, smem);
    if (err != cudaSuccess) return err;
    qr_kernel<true><<<batch, kThreads, smem, s>>>(af, qf, rf, m, n);
    return cudaGetLastError();
  }
  const size_t smem = smem_bytes(m, n);
  cudaError_t err = allow_smem(qr_kernel<false>, smem);
  if (err != cudaSuccess) return err;
  qr_kernel<false><<<batch, kThreads, smem, s>>>(af, qf, rf, m, n);
  return cudaGetLastError();
}

}  // extern "C"
