// K4: fused Householder least squares, one CTA per lane.
//
// Replaces: src/repro/pipelines/qr_solve.py, qr_solve_pallas
// (_qr_solve_kernel, reflect_step, back_substitute_r): min(n, m-1)
// Householder reflections applied to R and to the right-hand sides in the
// same step (Q is never formed), then a guarded back substitution on the
// n x n upper triangle of R.
//
// What bounds it on an H100: each lane reads m*n + m*k floats and writes
// n*k; its model work is 2 (m n^2 - n^3/3) + 4 m n k + n^2 k FLOPs.  Both
// bounds are small.  The shared form (the lane in shared memory) is held
// back by its 3 min(n, m-1) + 2n block barriers and by each dot product,
// a serial FFMA chain over the rows below the reflection.  The design
// keeps R, y and the reflector in shared memory, touches only rows k.. of
// each step (the reflector is exactly zero above k), and zeroes -- never
// clamps -- a solution component whose pivot falls below the relative
// threshold, so a rank-deficient lane stays finite.
//
// A lane larger than shared memory (n >= 238 at m = n + 4, k = 1) takes the
// global form: R and y live in a per-lane slice of a device work buffer
// and the chain runs by panels (qr_panels.cuh): a panel of bs columns
// takes its reflections in shared memory and the columns right of it are
// swept once a panel, a column a thread, in shared memory.  What bounds
// the global form is each lane's chain of dependent steps (the reflectors'
// norms and dot products, serial FFMA chains, and the sweeps' loads from
// shared memory), no longer device memory, which it reads and writes
// about once a panel.  Both forms compute qr_chain's expressions in its order, so they
// agree bit for bit where both fit, at every panel and tile width.  The
// first panel reads A and B themselves, so they are not copied into the
// work buffer first.  The plan (threads, bs, tile, shared memory) is
// pipelines/qr_solve.py's qr_panel_plan.
#include <cstddef>

#include "lane_common.cuh"
#include "qr_panels.cuh"

namespace repro_torch {
namespace {

// The Householder least-squares chain of _qr_solve_kernel on one lane in
// shared memory: min(n, m-1) reflections applied to R and y, then the
// guarded back substitution.  r (m x n), y (m x k), v (m), w (n + k) and
// tau_s (1) are shared.  x is left in y[:n].  qr_chain_panels
// (qr_panels.cuh) computes the same chain on a lane in device memory.
__device__ inline void qr_chain(float* r, float* y, int m, int n, int k,
                                float tiny, float* v, float* w,
                                float* tau_s) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nref = m > 1 ? min(n, m - 1) : 0;
  for (int kk = 0; kk < nref; ++kk) {
    // householder region (warp 0): the norm of the masked column, the
    // sign rule, v and tau (0 if degenerate)
    if (tid < 32) {
      const float t = householder(r + kk, n, v, 1, kk, m, tiny);
      if (tid == 0) *tau_s = t;
    }
    __syncthreads();
    const float tau = *tau_s;
    // w = tau * (v^T R) and tau * (v^T y); v is zero above row kk
    for (int j = tid; j < n + k; j += nt) {
      float s = 0.0f;
      if (j < n) {
        for (int i = kk; i < m; ++i) s += v[i] * r[i * n + j];
      } else {
        for (int i = kk; i < m; ++i) s += v[i] * y[i * k + (j - n)];
      }
      w[j] = tau * s;
    }
    __syncthreads();
    // rank-1 updates: R -= v w_R^T, y -= v w_y^T (rows kk.. only)
    for (int e = kk * n + tid; e < m * n; e += nt)
      r[e] -= v[e / n] * w[e % n];
    for (int e = kk * k + tid; e < m * k; e += nt)
      y[e] -= v[e / k] * w[n + e % k];
    __syncthreads();
  }

  // back substitution on R[:n, :n] with the relative deficiency threshold
  // max(1e-6 * max |diag R|, tiny): a component below it is zeroed
  if (tid == 0) {
    float dmax = 0.0f;
    bool nan = false;
    for (int i = 0; i < n; ++i) {
      const float d = fabsf(r[i * n + i]);
      nan |= isnan(d);
      dmax = fmaxf(dmax, d);
    }
    *tau_s = nan ? NAN : fmaxf(1e-6f * dmax, tiny);
  }
  __syncthreads();
  const float thresh = *tau_s;
  for (int kk = n - 1; kk >= 0; --kk) {
    const float rkk = r[kk * n + kk];
    const bool ok = fabsf(rkk) > thresh;
    for (int c = tid; c < k; c += nt) w[c] = ok ? y[kk * k + c] / rkk : 0.0f;
    __syncthreads();
    for (int e = tid; e < (kk + 1) * k; e += nt) {
      const int i = e / k;
      const int c = e % k;
      if (i == kk)
        y[e] = w[c];
      else
        y[e] -= r[i * n + kk] * w[c];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
qr_solve_kernel(const float* __restrict__ A, const float* __restrict__ B,
                float* __restrict__ X, int m, int n, int k, float tiny) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t lane = blockIdx.x;
  float* r = smem;            // m * n
  float* y = r + m * n;       // m * k
  float* v = y + m * k;       // m: reflector
  float* w = v + m;           // n + k: tau * v^T [R | y]
  float* tau_s = w + n + k;   // 1
  for (int e = tid; e < m * n; e += nt) r[e] = A[lane * m * n + e];
  for (int e = tid; e < m * k; e += nt) y[e] = B[lane * m * k + e];
  __syncthreads();
  qr_chain(r, y, m, n, k, tiny, v, w, tau_s);
  float* xl = X + lane * n * k;
  for (int e = tid; e < n * k; e += nt) xl[e] = y[e];
}

// The global form: the lane's [R | y] in its slice of the work buffer.
__global__ void __launch_bounds__(kQrMaxTile)
qr_solve_panels_kernel(const float* __restrict__ A,
                       const float* __restrict__ B, float* __restrict__ X,
                       float* __restrict__ work, int m, int n, int k, int bs,
                       int tile, float tiny) {
  extern __shared__ float smem[];
  const size_t lane = blockIdx.x;
  float* r = work + lane * (static_cast<size_t>(m) * n +
                            static_cast<size_t>(m) * k);
  qr_chain_panels(A + lane * m * n, B + lane * m * k, r, r + m * n,
                  X + lane * n * k, m, n, k, bs, tile, tiny, smem);
}

size_t smem_bytes(int m, int n, int k) {
  return sizeof(float) *
         (static_cast<size_t>(m) * n + m * k + m + n + k + 1);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

size_t qr_solve_smem(int m, int n, int k) {
  return repro_torch::smem_bytes(m, n, k);
}

// Floats of work buffer one lane of the global form needs (R and y).
size_t qr_solve_work(int m, int n, int k) {
  return static_cast<size_t>(m) * n + static_cast<size_t>(m) * k;
}

// Dynamic shared memory one lane of the global form needs at panel width
// bs and tile width tile.
size_t qr_solve_global_smem(int m, int k, int bs, int tile) {
  return repro_torch::qr_panel_smem_bytes(m, k, bs, tile);
}

// a (batch, m, n) with m >= n, b (batch, m, k) -> x (batch, n, k), float32.
// work: null for the shared form, else batch * qr_solve_work floats and the
// global form's plan (pipelines/qr_solve.py qr_panel_plan: threads, panel
// width bs, tile width, smem bytes), refused unless it is one the panel
// chain was compiled for.  The shared form ignores the plan.
int qr_solve_f32(const void* a, const void* b, void* x, void* work, int batch,
                 int m, int n, int k, float tiny, int threads, int bs,
                 int tile, int smem, void* stream) {
  using namespace repro_torch;
  const auto s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* xf = static_cast<float*>(x);
  if (work) {
    if (!qr_panel_plan_ok(m, n, k, threads, bs, tile, smem))
      return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(qr_solve_panels_kernel, smem);
    if (err != cudaSuccess) return err;
    qr_solve_panels_kernel<<<batch, threads, smem, s>>>(
        af, bf, xf, static_cast<float*>(work), m, n, k, bs, tile, tiny);
    return cudaGetLastError();
  }
  const size_t smem_shared = smem_bytes(m, n, k);
  cudaError_t err = allow_smem(qr_solve_kernel, smem_shared);
  if (err != cudaSuccess) return err;
  qr_solve_kernel<<<batch, kThreads, smem_shared, s>>>(af, bf, xf, m, n, k,
                                                       tiny);
  return cudaGetLastError();
}

}  // extern "C"
