// K8: one-sided Jacobi SVD, one warp per lane, and K9: the ridge-regularized
// pseudo-inverse apply from its packed factors, one CTA per lane.
//
// K8 replaces: src/repro/kernels/svd.py, svd_pallas (_svd_kernel,
// _rotate_pair), also served through pipelines/pusch.py svd_factor_pallas.
// Cyclic Jacobi: `sweeps` passes over the pairs (p, q), p = 0..n-2 outer,
// q = p+1..n-1 inner, each pair rotating columns p and q of A and V so that
// they become orthogonal; then s = |a_col| and u = a / max(s, 1e-30),
// unsorted.  The pair order is the reference's exactly: a parallel
// round-robin ordering would give other rotations, and so other U and V.
//
// What bounds K8 on an H100: per lane it reads m*n floats and writes
// m*n + n*n + n; its work is sweeps * n (n-1)/2 * (6m + 6(m + n)) FLOPs, so
// the operations bound it -- but the sweeps * n (n-1)/2 pairs form one
// ordered chain (each rotation reads the columns the previous one wrote),
// with three m-long dot products and a rotation per step.  The design runs
// a lane on one warp: lane t of the warp owns rows t, t+32, ... of A and V
// in shared memory, so the rotations need no barrier at all and the three
// dot products are warp-shuffle sums (every lane ends with the same total).
// The rotation parameters follow the reference's selects in order.
//
// K9 replaces: src/repro/pipelines/pusch.py, svd_apply_pallas
// (_svd_apply_kernel): x = V diag(s / (s^2 + lam)) U^T b.  Per lane it
// reads (m+n+1) n + m k floats and writes n k; 2mnk + 2n^2k + 3nk FLOPs,
// so bytes bound it.  The two products run as f32 FMA loops over the
// lane's shared-memory copy, one output element per thread.
#include <cstddef>

#include "lane_common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarp = 32;

__global__ void __launch_bounds__(kWarp)
svd_kernel(const float* __restrict__ A, float* __restrict__ U,
           float* __restrict__ S, float* __restrict__ V, int m, int n,
           int sweeps, int u_stride, int s_stride, int v_stride) {
  extern __shared__ float smem[];
  float* a = smem;            // n columns of m rows: a[c * m + r]
  float* v = a + m * n;       // n columns of n rows: v[c * n + r]
  float* s = v + n * n;       // n
  const int t = threadIdx.x;
  const size_t lane = blockIdx.x;
  const float* al = A + lane * m * n;
  for (int e = t; e < m * n; e += kWarp) a[(e % n) * m + e / n] = al[e];
  for (int e = t; e < n * n; e += kWarp)
    v[(e % n) * n + e / n] = (e % n == e / n) ? 1.0f : 0.0f;
  __syncwarp();
  // From here until the epilogue lane t reads and writes only its own rows.
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        float* ap = a + p * m;
        float* aq = a + q * m;
        // point region: rotation parameters
        float alpha = 0.0f, beta = 0.0f, gamma = 0.0f;
        for (int r = t; r < m; r += kWarp) {
          const float x = ap[r];
          const float y = aq[r];
          alpha += x * x;
          beta += y * y;
          gamma += x * y;
        }
        alpha = warp_sum(alpha);
        beta = warp_sum(beta);
        gamma = warp_sum(gamma);
        const bool small =
            fabsf(gamma) <= 1e-12f * sqrtf(alpha * beta) + 1e-30f;
        const float zeta = (beta - alpha) / (2.0f * (small ? 1.0f : gamma));
        // jnp.sign: 0 at 0 (copysignf would give +-1)
        const float sgn = zeta > 0.0f ? 1.0f : (zeta < 0.0f ? -1.0f : 0.0f);
        float tn = sgn / (fabsf(zeta) + sqrtf(1.0f + zeta * zeta));
        if (zeta == 0.0f) tn = 1.0f;
        float cs = rsqrtf(1.0f + tn * tn);
        float sn = cs * tn;
        if (small) {
          cs = 1.0f;
          sn = 0.0f;
        }
        // vector region: rotate columns p and q of A and of V
        for (int r = t; r < m; r += kWarp) {
          const float x = ap[r];
          const float y = aq[r];
          ap[r] = cs * x - sn * y;
          aq[r] = sn * x + cs * y;
        }
        float* vp = v + p * n;
        float* vq = v + q * n;
        for (int r = t; r < n; r += kWarp) {
          const float x = vp[r];
          const float y = vq[r];
          vp[r] = cs * x - sn * y;
          vq[r] = sn * x + cs * y;
        }
      }
    }
  }
  // epilogue: s = column norms, u = a / max(s, 1e-30)
  for (int c = 0; c < n; ++c) {
    float ss = 0.0f;
    for (int r = t; r < m; r += kWarp) ss += a[c * m + r] * a[c * m + r];
    ss = warp_sum(ss);
    if (t == 0) s[c] = sqrtf(ss);
  }
  __syncwarp();
  float* ul = U + lane * u_stride;
  float* vl = V + lane * v_stride;
  float* sl = S + lane * s_stride;
  for (int e = t; e < m * n; e += kWarp) {
    const int c = e % n;
    ul[e] = a[c * m + e / n] / fmaxf(s[c], 1e-30f);
  }
  for (int e = t; e < n * n; e += kWarp) vl[e] = v[(e % n) * n + e / n];
  for (int c = t; c < n; c += kWarp) sl[c] = s[c];
}

__global__ void __launch_bounds__(kThreads)
svd_apply_kernel(const float* __restrict__ F, const float* __restrict__ B,
                 float* __restrict__ X, int m, int n, int k, float lam) {
  extern __shared__ float smem[];
  const int mn1 = m + n + 1;
  float* f = smem;            // (m + n + 1) * n: rows [U; V; s]
  float* b = f + mn1 * n;     // m * k
  float* w = b + m * k;       // n * k
  const size_t lane = blockIdx.x;
  for (int e = threadIdx.x; e < mn1 * n; e += blockDim.x)
    f[e] = F[lane * mn1 * n + e];
  for (int e = threadIdx.x; e < m * k; e += blockDim.x)
    b[e] = B[lane * m * k + e];
  __syncthreads();
  const float* u = f;
  const float* v = f + m * n;
  const float* s = f + (m + n) * n;
  // w = diag(s / (s^2 + lam)) U^T b
  for (int e = threadIdx.x; e < n * k; e += blockDim.x) {
    const int i = e / k;
    const int c = e % k;
    float acc = 0.0f;
    for (int r = 0; r < m; ++r) acc += u[r * n + i] * b[r * k + c];
    w[e] = (s[i] / (s[i] * s[i] + lam)) * acc;
  }
  __syncthreads();
  // x = V w
  float* xl = X + lane * n * k;
  for (int e = threadIdx.x; e < n * k; e += blockDim.x) {
    const int i = e / k;
    const int c = e % k;
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) acc += v[i * n + j] * w[j * k + c];
    xl[e] = acc;
  }
}

size_t svd_smem_bytes(int m, int n) {
  return sizeof(float) * (static_cast<size_t>(m) * n + n * n + n);
}

size_t apply_smem_bytes(int m, int n, int k) {
  return sizeof(float) *
         (static_cast<size_t>(m + n + 1) * n + m * k + n * k);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

size_t svd_smem(int m, int n) { return repro_torch::svd_smem_bytes(m, n); }

size_t svd_apply_smem(int m, int n, int k) {
  return repro_torch::apply_smem_bytes(m, n, k);
}

// a (batch, m, n) -> u (m, n), s (n), v (n, n) per lane, float32, written
// at lane strides u_stride, s_stride, v_stride floats (separate tensors, or
// one packed [U; V; s] buffer).
int svd_f32(const void* a, void* u, void* s, void* v, int batch, int m,
            int n, int sweeps, int u_stride, int s_stride, int v_stride,
            void* stream) {
  using namespace repro_torch;
  const size_t smem = svd_smem_bytes(m, n);
  cudaError_t err = allow_smem(svd_kernel, smem);
  if (err != cudaSuccess) return err;
  svd_kernel<<<batch, kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(u),
      static_cast<float*>(s), static_cast<float*>(v), m, n, sweeps, u_stride,
      s_stride, v_stride);
  return cudaGetLastError();
}

// f (batch, m + n + 1, n), b (batch, m, k) -> x (batch, n, k), float32.
int svd_apply_f32(const void* f, const void* b, void* x, int batch, int m,
                  int n, int k, float lam, void* stream) {
  using namespace repro_torch;
  const size_t smem = apply_smem_bytes(m, n, k);
  cudaError_t err = allow_smem(svd_apply_kernel, smem);
  if (err != cudaSuccess) return err;
  svd_apply_kernel<<<batch, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(b),
      static_cast<float*>(x), m, n, k, lam);
  return cudaGetLastError();
}

}  // extern "C"
