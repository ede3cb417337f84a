// K8: one-sided Jacobi SVD, one CTA per lane, the disjoint pairs of each
// round of a round-robin ordering rotated at once; and K9: the
// ridge-regularized pseudo-inverse apply from its packed factors, one CTA
// per lane.
//
// K8 replaces: src/repro/kernels/svd.py, svd_pallas (_svd_kernel,
// _rotate_pair), also served through pipelines/pusch.py svd_factor_pallas.
// One-sided Jacobi: `sweeps` passes over the column pairs (p, q), p < q,
// each pair rotating columns p and q of A and V so that they become
// orthogonal; then s = |a_col| and u = a / max(s, 1e-30), unsorted.  The
// rotation's parameters are the reference's, selects and all.
//
// The pair order is not the reference's.  The reference walks the pairs
// cyclic by rows, n (n-1)/2 rotations a sweep in one dependent chain.
// Here a sweep is the rounds of the circle (round-robin) ordering of
// kernels/svd.py jacobi_rounds: n - 1 rounds of n/2 disjoint pairs for
// even n, n rounds for odd n (a phantom column n, whose pair never
// rotates), every pair once a sweep.  The pairs of a round share no
// column, so they rotate at once; round-robin orderings converge as the
// cyclic one does (Brent & Luk 1985, Luk & Park 1989), to other rotations
// and so to other U and V, but to the same spectrum and the same U diag(S)
// V^T within float32 rounding, which is what every check of K8 holds
// (sorted spectrum and reconstruction at the spec's 4 sqrt(eps)).
//
// What bounds K8 on an H100: per lane it reads m*n floats and writes
// m*n + n*n + n; its work is sweeps * n (n-1)/2 * (6m + 6(m + n)) FLOPs, so
// the operations bound it -- but a sweep is still a chain of rounds, each
// three m-long dot products, a parameter chain of two precise square
// roots, two divisions and an rsqrt (~330 SM cycles on its own), and a
// rotation.  The design runs a lane on one CTA: pair i of a round goes to
// group i of g threads (g = 4, 8, 16 or 32, the plan's; kernels/svd.py
// svd_plan), which sums its three dots, computes (cs, sn) once and
// rotates its two columns of A and of V, in shared memory (A and V
// column-major, m*n + n*n + n floats); one barrier closes a round.  The
// columns stay in place: each group advances its pair a round at a time
// by jacobi_rounds' formula (round_pair).  Where m <= 64 the plan may keep
// a thread's rows of the pair's columns of A and V in registers from their
// loads (issued together, before the reduction) to the rotation, which
// then only stores.  At the served widths a round costs about what one
// rotation cost before; at a carrier's width, where the card is full of
// lanes, a small g spreads a pair's rows over fewer threads and runs the
// parameter chain once for 32 / g pairs a warp.
//
// The same bits at every g: each dot is 32 strided partials (row r into
// partial r mod 32, rows ascending, each step one fused multiply-add)
// closed by the xor butterfly at offsets 16, 8, 4, 2, 1.  A group of g
// threads holds partials j, j + g, ... in registers, adds the levels at
// offsets >= g there in the butterfly's pairing and shuffles only the
// levels below g, so every level is the same add at every g.  The rest
// works element by element in explicit roundings (__fmaf_rn, __fmul_rn,
// precise sqrtf and division), so a lane's U, S and V do not depend on
// the plan, and so not on the batch it rides in.
//
// K9 replaces: src/repro/pipelines/pusch.py, svd_apply_pallas
// (_svd_apply_kernel): x = V diag(s / (s^2 + lam)) U^T b.  Per lane it
// reads (m+n+1) n + m k floats and writes n k; 2mnk + 2n^2k + 3nk FLOPs,
// so bytes bound it.  The two products run as f32 FMA loops over the
// lane's shared-memory copy, one output element per thread.
#include <cstddef>

#include "lane_common.cuh"
#include "phase_clock.cuh"

namespace repro_torch {
namespace {

constexpr int kDotPartials = 32;    // a dot's strided partials

// The most threads a CTA of g threads a pair takes (its launch bound): the
// n / 2 pairs of the n <= 170 that shared memory admits, so the small
// groups may hold their rows in registers.  kernels/svd.py
// SVD_MAX_THREADS.
__host__ __device__ constexpr int max_threads(int g) {
  return g == 4 ? 352 : g == 8 ? 704 : 1024;
}

// The threads of K8's CTA at n columns and g threads a pair:
// kernels/svd.py svd_threads.
__host__ __device__ inline int svd_threads(int n, int g) {
  const int t = (n / 2) * g;
  return t < 32 ? 32 : (t + 31) / 32 * 32;
}

// The butterfly's levels at offsets kOff, kOff / 2, ..., G, in registers:
// thread j of a group of G holds partials j + t G at acc[k][t], and the
// level at offset off adds partial j + t G + off (held at t + off / G) to
// partial j + t G.  Compile-time indices throughout.
template <int G, int K, int kOff>
struct RegisterLevels {
  __device__ static void run(float (&acc)[K][kDotPartials / G]) {
    if constexpr (kOff >= G) {
      constexpr int kStep = kOff / G;
#pragma unroll
      for (int t = 0; t < kDotPartials / G; ++t) {
        if ((t & kStep) == 0) {
#pragma unroll
          for (int k = 0; k < K; ++k)
            acc[k][t] = acc[k][t] + acc[k][t + kStep];
        }
      }
      RegisterLevels<G, K, kOff / 2>::run(acc);
    }
  }
};

// Closes K dot products a group of G threads holds as 32 strided partials
// (thread j holds partials j, j + G, ... at acc[k][0], acc[k][1], ...):
// the butterfly's levels at offsets >= G in registers, the rest by
// shuffles within the group; every thread of the group ends with the
// totals in acc[k][0].  The K sums' levels interleave.  All 32 threads of
// the warp call it.
template <int G, int K>
__device__ inline void group_sums(float (&acc)[K][kDotPartials / G]) {
  RegisterLevels<G, K, kDotPartials / 2>::run(acc);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    float other[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      other[k] = __shfl_xor_sync(0xffffffffu, acc[k][0], off);
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k][0] = acc[k][0] + other[k];
  }
}

// The rotation of one row of a pair's two columns, in explicit roundings.
__device__ inline void rotate(float cs, float sn, float x, float y, float* p,
                              float* q) {
  *p = __fmaf_rn(cs, x, -__fmul_rn(sn, y));
  *q = __fmaf_rn(sn, x, __fmul_rn(cs, y));
}

// The round's barrier: a warp's where the lane is one warp.
__device__ inline void round_barrier() {
  if (blockDim.x == 32)
    __syncwarp();
  else
    __syncthreads();
}

// One lane a CTA, pair i of each round on group i of G threads.  With
// kBlocks > 0 (m <= 32 kBlocks) a thread keeps its rows of the pair's
// columns of A and V in registers from their loads to the rotation; with
// kBlocks = 0 it reads them again (any m).  The same bits either way.
template <int G, int kBlocks, bool kStamps>
__global__ void __launch_bounds__(max_threads(G))
svd_kernel(const float* __restrict__ A, float* __restrict__ U,
           float* __restrict__ S, float* __restrict__ V, int m, int n,
           int sweeps, int u_stride, int s_stride, int v_stride,
           unsigned long long* __restrict__ stamps) {
  constexpr int kHeld = kDotPartials / G;
  constexpr int kCache = kBlocks > 0 ? kBlocks * kHeld : 1;
  extern __shared__ float smem[];
  float* a = smem;            // n columns of m rows: a[c * m + r]
  float* v = a + m * n;       // n columns of n rows: v[c * n + r]
  float* s = v + n * n;       // n
  PhaseClock<kStamps, kSvdPhases> clk(true);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int group = tid / G;
  const int j = tid % G;
  const size_t lane = blockIdx.x;
  const float* al = A + lane * m * n;
  for (int e = tid; e < m * n; e += nt) a[(e % n) * m + e / n] = al[e];
  for (int e = tid; e < n * n; e += nt)
    v[(e % n) * n + e / n] = (e % n == e / n) ? 1.0f : 0.0f;
  __syncthreads();
  clk.mark(kSvLoad);

  // The circle ordering of kernels/svd.py jacobi_rounds: cols (even)
  // columns, odd n with a phantom column n, which is always in pair 0 and
  // never rotates.  Pair i of round r joins x = (r + i) mod (cols - 1) and
  // y = (r - i) mod (cols - 1) (pair 0: r and cols - 1), round_pair's
  // formula, advanced here by one a round.
  const int cols = n + (n & 1);
  const int c1 = cols - 1;
  const int pair = group + (n & 1);
  const bool active = group < n / 2;
  int x = pair;
  int y = pair == 0 ? c1 : c1 - pair;
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int r = 0; r < c1; ++r) {
      const int p = active ? min(x, y) : 0;
      const int q = active ? max(x, y) : 0;
      float* ap = a + p * m;
      float* aq = a + q * m;
      float* vp = v + p * n;
      float* vq = v + q * n;
      // point region: the three sums, then the rotation's parameters
      float acc[3][kHeld];
      float xa[kCache], ya[kCache], xv[kCache], yv[kCache];
#pragma unroll
      for (int t = 0; t < kHeld; ++t) acc[0][t] = acc[1][t] = acc[2][t] = 0.0f;
      if constexpr (kBlocks > 0) {
#pragma unroll
        for (int b = 0; b < kBlocks; ++b) {
#pragma unroll
          for (int t = 0; t < kHeld; ++t) {
            const int row = b * kDotPartials + j + t * G;
            const int c = b * kHeld + t;
            xa[c] = ya[c] = xv[c] = yv[c] = 0.0f;
            if (active && row < n) {
              xv[c] = vp[row];
              yv[c] = vq[row];
            }
            if (active && row < m) {
              xa[c] = ap[row];
              ya[c] = aq[row];
              acc[0][t] = __fmaf_rn(xa[c], xa[c], acc[0][t]);
              acc[1][t] = __fmaf_rn(ya[c], ya[c], acc[1][t]);
              acc[2][t] = __fmaf_rn(xa[c], ya[c], acc[2][t]);
            }
          }
        }
      } else if (active) {
        for (int base = 0; base < m; base += kDotPartials) {
#pragma unroll
          for (int t = 0; t < kHeld; ++t) {
            const int row = base + j + t * G;
            if (row < m) {
              const float xr = ap[row];
              const float yr = aq[row];
              acc[0][t] = __fmaf_rn(xr, xr, acc[0][t]);
              acc[1][t] = __fmaf_rn(yr, yr, acc[1][t]);
              acc[2][t] = __fmaf_rn(xr, yr, acc[2][t]);
            }
          }
        }
      }
      group_sums<G, 3>(acc);
      clk.mark(kSvSums);
      // a group with no pair runs the chain on ordinary numbers, so that
      // the special cases of sqrtf and division at 0 do not split its warp
      const float alpha = active ? acc[0][0] : 1.0f;
      const float beta = active ? acc[1][0] : 2.0f;
      const float gamma = active ? acc[2][0] : 0.5f;
      const bool small =
          fabsf(gamma) <= __fmaf_rn(1e-12f, sqrtf(__fmul_rn(alpha, beta)),
                                    1e-30f);
      const float zeta = __fdiv_rn(__fsub_rn(beta, alpha),
                                   __fmul_rn(2.0f, small ? 1.0f : gamma));
      // jnp.sign: 0 at 0 (copysignf would give +-1)
      const float sgn = zeta > 0.0f ? 1.0f : (zeta < 0.0f ? -1.0f : 0.0f);
      float tn = __fdiv_rn(sgn, __fadd_rn(fabsf(zeta),
                                          sqrtf(__fmaf_rn(zeta, zeta, 1.0f))));
      if (zeta == 0.0f) tn = 1.0f;
      float cs = rsqrtf(__fmaf_rn(tn, tn, 1.0f));
      float sn = __fmul_rn(cs, tn);
      if (small) {
        cs = 1.0f;
        sn = 0.0f;
      }
      clk.mark(kSvParams);
      // vector region: rotate columns p and q of A and of V
      if constexpr (kBlocks > 0) {
#pragma unroll
        for (int b = 0; b < kBlocks; ++b) {
#pragma unroll
          for (int t = 0; t < kHeld; ++t) {
            const int row = b * kDotPartials + j + t * G;
            const int c = b * kHeld + t;
            if (active && row < m)
              rotate(cs, sn, xa[c], ya[c], ap + row, aq + row);
            if (active && row < n)
              rotate(cs, sn, xv[c], yv[c], vp + row, vq + row);
          }
        }
      } else if (active) {
        for (int row = j; row < m; row += G)
          rotate(cs, sn, ap[row], aq[row], ap + row, aq + row);
        for (int row = j; row < n; row += G)
          rotate(cs, sn, vp[row], vq[row], vp + row, vq + row);
      }
      clk.mark(kSvRotate);
      round_barrier();
      clk.mark(kSvBarrier);
      x = x + 1 == c1 ? 0 : x + 1;
      if (pair != 0) y = y + 1 == c1 ? 0 : y + 1;
    }
  }

  // epilogue: s = column norms (a column a group, the same partials),
  // u = a / max(s, 1e-30)
  for (int c0 = 0; c0 < n; c0 += nt / G) {
    const int c = c0 + group;
    float acc[1][kHeld];
#pragma unroll
    for (int t = 0; t < kHeld; ++t) acc[0][t] = 0.0f;
    if (c < n) {
      const float* ac = a + c * m;
      for (int base = 0; base < m; base += kDotPartials) {
#pragma unroll
        for (int t = 0; t < kHeld; ++t) {
          const int row = base + j + t * G;
          if (row < m) acc[0][t] = __fmaf_rn(ac[row], ac[row], acc[0][t]);
        }
      }
    }
    group_sums<G, 1>(acc);
    if (c < n && j == 0) s[c] = sqrtf(acc[0][0]);
  }
  __syncthreads();
  float* ul = U + lane * u_stride;
  float* vl = V + lane * v_stride;
  float* sl = S + lane * s_stride;
  for (int e = tid; e < m * n; e += nt) {
    const int c = e % n;
    ul[e] = a[c * m + e / n] / fmaxf(s[c], 1e-30f);
  }
  for (int e = tid; e < n * n; e += nt) vl[e] = v[(e % n) * n + e / n];
  for (int c = tid; c < n; c += nt) sl[c] = s[c];
  clk.mark(kSvEpilogue);
  clk.write(stamps + lane * kSvdStampWords);
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

template <int G, int kBlocks, bool kStamps>
cudaError_t launch_group(const void* a, void* u, void* s, void* v,
                         int batch, int m, int n, int sweeps, int u_stride,
                         int s_stride, int v_stride, int threads,
                         void* stamps, void* stream) {
  const size_t smem = svd_smem_bytes(m, n);
  cudaError_t err = allow_smem(svd_kernel<G, kBlocks, kStamps>, smem);
  if (err != cudaSuccess) return err;
  svd_kernel<G, kBlocks, kStamps><<<batch, threads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(u),
      static_cast<float*>(s), static_cast<float*>(v), m, n, sweeps, u_stride,
      s_stride, v_stride, static_cast<unsigned long long*>(stamps));
  return cudaGetLastError();
}

template <int G, bool kStamps>
cudaError_t launch_cached(const void* a, void* u, void* s, void* v,
                          int batch, int m, int n, int sweeps, int u_stride,
                          int s_stride, int v_stride, int threads, int cache,
                          void* stamps, void* stream) {
  if (threads != svd_threads(n, G) || threads > max_threads(G))
    return cudaErrorInvalidValue;
  switch (cache) {
    case 0:
      return launch_group<G, 0, kStamps>(a, u, s, v, batch, m, n, sweeps,
                                         u_stride, s_stride, v_stride,
                                         threads, stamps, stream);
    case 1:
      return launch_group<G, 1, kStamps>(a, u, s, v, batch, m, n, sweeps,
                                         u_stride, s_stride, v_stride,
                                         threads, stamps, stream);
    case 2:
      return launch_group<G, 2, kStamps>(a, u, s, v, batch, m, n, sweeps,
                                         u_stride, s_stride, v_stride,
                                         threads, stamps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// K8 on the plan (group, threads, cache: kernels/svd.py SvdPlan); refuses
// a plan off svd_threads, max_threads or m's row blocks.
template <bool kStamps>
cudaError_t launch_svd(const void* a, void* u, void* s, void* v, int batch,
                       int m, int n, int sweeps, int u_stride, int s_stride,
                       int v_stride, int group, int threads, int cache,
                       void* stamps, void* stream) {
  if (cache != 0 && cache != (m + kDotPartials - 1) / kDotPartials)
    return cudaErrorInvalidValue;
  switch (group) {
    case 4:
      return launch_cached<4, kStamps>(a, u, s, v, batch, m, n, sweeps,
                                       u_stride, s_stride, v_stride, threads,
                                       cache, stamps, stream);
    case 8:
      return launch_cached<8, kStamps>(a, u, s, v, batch, m, n, sweeps,
                                       u_stride, s_stride, v_stride, threads,
                                       cache, stamps, stream);
    case 16:
      return launch_cached<16, kStamps>(a, u, s, v, batch, m, n, sweeps,
                                        u_stride, s_stride, v_stride,
                                        threads, cache, stamps, stream);
    case 32:
      return launch_cached<32, kStamps>(a, u, s, v, batch, m, n, sweeps,
                                        u_stride, s_stride, v_stride,
                                        threads, cache, stamps, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
// one packed [U; V; s] buffer), on the plan (group threads a pair, threads
// a CTA, cache the row blocks held in registers or 0: kernels/svd.py
// svd_plan).
int svd_f32(const void* a, void* u, void* s, void* v, int batch, int m,
            int n, int sweeps, int u_stride, int s_stride, int v_stride,
            int group, int threads, int cache, void* stream) {
  return repro_torch::launch_svd<false>(a, u, s, v, batch, m, n, sweeps,
                                        u_stride, s_stride, v_stride, group,
                                        threads, cache, nullptr, stream);
}

// The phase-stamped instance (scripts/svd_phases.py): U, S, V as svd_f32
// into separate tensors, and per lane kSvdStampWords words of stamps.
int svd_phases_f32(const void* a, void* u, void* s, void* v, void* stamps,
                   int batch, int m, int n, int sweeps, int group,
                   int threads, int cache, void* stream) {
  return repro_torch::launch_svd<true>(a, u, s, v, batch, m, n, sweeps,
                                       m * n, n, n * n, group, threads, cache,
                                       stamps, stream);
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
