// K11: blocked (compact-WY) fused least squares, one CTA per lane.
//
// Replaces: src/repro/pipelines/qr_solve.py, qr_solve_blocked
// (_qr_solve_blocked_kernel, _qr_panel_reflect_step, _wy_t_step): per
// bs-column panel, bs Householder reflectors built from and applied to the
// panel only, the compact-WY factor T built column by column (LAPACK larft,
// forward) from V^T V, and the block reflector I - V T^T V^T applied to the
// trailing columns and to the whole right-hand side; then the guarded back
// substitution on R[:n, :n] with the threshold max(1e-6 max |diag R|, tiny)
// taken over the finished R.  Q is never formed.
//
// What bounds it on an H100: per lane about 2 (m n^2 - n^3/3) + 4 m n k
// FLOPs and m n + m k + n k floats in and out, microseconds at a carrier's
// width; what holds it back is the order: three barrier-separated phases
// per reflector, bs per T column and n back-substitution steps.  At
// m = 260, n = 256 R is 266 KB, more than a CTA's shared memory, so:
//   * R lives in a per-lane slice of a device work buffer;
//   * the panel's rows o.. are staged in shared memory (pitch bs + 1) and
//     every reflector step touches only shared memory.  As in LAPACK's
//     geqr2, each reflector's entries below the diagonal stay where the
//     column was (v equals the column there) and only v[g] is kept aside,
//     so V costs no second panel;
//   * T (upper) and V^T V (strict lower) share one bs x bs tile;
//   * the block reflector runs over the trailing columns of R (read and
//     updated in place in device memory, through L1) and then over y (in
//     shared memory), 32 columns at a time: W = V^T C, W = T^T W,
//     C -= V W, each product an f32 FMA loop in the kernel, as the TPU
//     kernel computes its products in its own body, with register tiles
//     of 2 x 4 and 4 x 4 outputs a thread.  Nothing of R is staged, so an
//     n = 256 lane takes 104 KB and two CTAs fit on an SM.
// The rhs takes the block reflector, not one reflector at a time as in K4:
// a different float grouping, held at the reference's tolerance.
#include <cstddef>

#include "lane_common.cuh"
#include "tile_loops.cuh"

namespace repro_torch {
namespace {

constexpr int kQrThreads = 256;
constexpr int kChunk = 32;      // columns per block-reflector chunk

struct Layout {                 // float offsets into dynamic shared memory
  int pan, vd, taus, t, w1, w2, y, wv, scal, total;
};

__host__ __device__ inline Layout layout(int m, int n, int k, int bs) {
  Layout l;
  const int pc = bs + 1;
  l.pan = 0;                    // m * pc: the panel, V below its diagonal
  l.vd = l.pan + m * pc;        // bs: v[g] of each reflector
  l.taus = l.vd + bs;           // bs
  l.t = l.taus + bs;            // bs * pc: T (upper), V^T V (strict lower)
  l.w1 = l.t + bs * pc;         // bs * kChunk
  l.w2 = l.w1 + bs * kChunk;    // bs * kChunk
  l.y = l.w2 + bs * kChunk;     // m * k
  l.wv = l.y + m * k;           // bs + k: tau * v^T panel, x row
  l.scal = l.wv + bs + k;       // 1: the deficiency threshold
  l.total = l.scal + 1;
  return l;
}

// V[i][p] of the current panel (rows i >= o + p; zero above).
__device__ inline float vrow(const float* pan, const float* vd, int pc, int o,
                             int i, int p) {
  return i > o + p ? pan[i * pc + p] : (i == o + p ? vd[p] : 0.0f);
}

// The block reflector on columns [c0, c0 + cw) of the row-major matrix
// `src` (row pitch ld, rows o..m-1; device memory for R, shared for y):
// C -= V (T^T (V^T C)).  Each output is summed in row (then reflector)
// order; a thread keeps a register tile of outputs, the zero entries of V
// adding exact zeros, so the tiling changes no result.
__device__ inline void apply_block(float* src, int ld, int c0, int cw, int m,
                                   int o, int bs, const float* pan,
                                   const float* vd, const float* t, float* w1,
                                   float* w2) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int pc = bs + 1;
  const int qg = (cw + 3) / 4;          // groups of 4 columns
  // W1 = V^T C: 2 reflectors x 4 columns a thread; the pair count rounds
  // up, and an odd panel width's last pair has one reflector
  for (int e = tid; e < ceil_div(bs, 2) * qg; e += nt) {
    const int p0 = 2 * (e / qg);
    const int q0 = 4 * (e % qg);
    const bool pair = p0 + 1 < bs;
    float s0[4] = {}, s1[4] = {};
    for (int i = o + p0; i < m; ++i) {
      const float v0 = vrow(pan, vd, pc, o, i, p0);
      const float v1 = pair ? vrow(pan, vd, pc, o, i, p0 + 1) : 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q0 + q < cw) {
          const float x = src[i * ld + c0 + q0 + q];
          s0[q] += v0 * x;
          s1[q] += v1 * x;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q0 + q < cw) {
        w1[p0 * kChunk + q0 + q] = s0[q];
        if (pair) w1[(p0 + 1) * kChunk + q0 + q] = s1[q];
      }
    }
  }
  __syncthreads();
  // W2 = T^T W1  (T upper triangular)
  for (int e = tid; e < bs * cw; e += nt) {
    const int p = e / cw;
    const int q = e % cw;
    float s = 0.0f;
    for (int l = 0; l <= p; ++l) s += t[l * pc + p] * w1[l * kChunk + q];
    w2[p * kChunk + q] = s;
  }
  __syncthreads();
  // C -= V W2: 4 rows x 4 columns a thread
  const int rows = m - o;
  for (int e = tid; e < ((rows + 3) / 4) * qg; e += nt) {
    const int i0 = o + 4 * (e / qg);
    const int q0 = 4 * (e % qg);
    const int pend = min(bs, i0 + 3 - o + 1);
    float s[4][4] = {};
    for (int p = 0; p < pend; ++p) {
      float v[4], w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        v[r] = i0 + r < m ? vrow(pan, vd, pc, o, i0 + r, p) : 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = w2[p * kChunk + q0 + q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[r][q] += v[r] * w[q];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (i0 + r < m && q0 + q < cw)
          src[(i0 + r) * ld + c0 + q0 + q] -= s[r][q];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kQrThreads)
qr_solve_blocked_kernel(const float* __restrict__ A,
                        const float* __restrict__ B, float* __restrict__ X,
                        float* __restrict__ work, int m, int n, int k, int bs,
                        float tiny) {
  extern __shared__ float smem[];
  const Layout L = layout(m, n, k, bs);
  float* pan = smem + L.pan;
  float* vd = smem + L.vd;
  float* taus = smem + L.taus;
  float* t = smem + L.t;
  float* w1 = smem + L.w1;
  float* w2 = smem + L.w2;
  float* y = smem + L.y;
  float* wv = smem + L.wv;
  float* scal = smem + L.scal;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lid = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int pc = bs + 1;
  const size_t lane = blockIdx.x;
  float* r = work + lane * m * n;
  for (int e = tid; e < m * n; e += nt) r[e] = A[lane * m * n + e];
  for (int e = tid; e < m * k; e += nt) y[e] = B[lane * m * k + e];
  __syncthreads();

  for (int o = 0; o < n; o += bs) {
    const int prows = m - o;
    for (int e = tid; e < prows * bs; e += nt) {
      const int i = o + e / bs;
      const int jj = e % bs;
      pan[i * pc + jj] = r[i * n + o + jj];
    }
    __syncthreads();
    // ---- panel factor: bs reflectors applied to the panel only ----
    for (int j = 0; j < bs; ++j) {
      const int g = o + j;
      // householder region (warp 0): norm of the masked column, the sign
      // rule alpha = xk >= 0 ? -norm : norm, v[g], tau (0 if degenerate)
      if (warp == 0) {
        float s = 0.0f;
        for (int i = g + lid; i < m; i += 32) {
          const float x = pan[i * pc + j];
          s += x * x;
        }
        const float norm = sqrtf(warp_sum(s));
        const float xk = pan[g * pc + j];
        const float alpha = xk >= 0.0f ? -norm : norm;
        const float vg = xk - alpha;
        float s2 = 0.0f;
        for (int i = g + lid; i < m; i += 32) {
          const float v = i == g ? vg : pan[i * pc + j];
          s2 += v * v;
        }
        const float vnorm2 = fmaxf(warp_sum(s2), tiny);
        if (lid == 0) {
          vd[j] = vg;
          taus[j] = norm < tiny ? 0.0f : 2.0f / vnorm2;
        }
      }
      __syncthreads();
      // wv[jj] = tau * v^T panel[:, jj] for the columns j.. (a warp each)
      const float tau = taus[j];
      for (int jj = j + warp; jj < bs; jj += nwarps) {
        float s = 0.0f;
        for (int i = g + lid; i < m; i += 32)
          s += vrow(pan, vd, pc, o, i, j) * pan[i * pc + jj];
        s = warp_sum(s);
        if (lid == 0) wv[jj] = tau * s;
      }
      __syncthreads();
      // rank-1 update of columns j.. (rows g..), a row a thread; column j
      // keeps v below g
      for (int i = g + tid; i < m; i += nt) {
        const float v = i == g ? vd[j] : pan[i * pc + j];
        for (int jj = i == g ? j : j + 1; jj < bs; ++jj)
          pan[i * pc + jj] -= v * wv[jj];
      }
      __syncthreads();
    }
    // R's part of the panel (rows o..o+jj of column jj) back to the work
    // buffer; V^T V (strict upper, stored transposed) a warp per entry
    for (int e = tid; e < bs * bs; e += nt) {
      const int i = o + e / bs;
      const int jj = e % bs;
      if (i <= o + jj) r[i * n + o + jj] = pan[i * pc + jj];
    }
    for (int e = warp; e < bs * bs; e += nwarps) {
      const int i = e / bs;
      const int j = e % bs;
      if (i >= j) continue;
      float s = 0.0f;
      for (int row = o + j + lid; row < m; row += 32)
        s += pan[row * pc + i] * vrow(pan, vd, pc, o, row, j);
      s = warp_sum(s);
      if (lid == 0) t[j * pc + i] = s;
    }
    __syncthreads();
    // ---- T, forward column by column: T[:j, j] = -tau_j T[:j, :j]
    // (V^T v_j)[:j], T[j, j] = tau_j ----
    for (int j = 0; j < bs; ++j) {
      const float tau_j = taus[j];
      for (int i = tid; i < j; i += nt) {
        float s = 0.0f;
        for (int l = i; l < j; ++l) s += t[i * pc + l] * t[j * pc + l];
        t[i * pc + j] = -tau_j * s;
      }
      if (tid == 0) t[j * pc + j] = tau_j;
      __syncthreads();
    }
    // ---- block apply I - V T^T V^T: trailing columns of R, then y ----
    for (int c0 = o + bs; c0 < n; c0 += kChunk)
      apply_block(r, n, c0, min(kChunk, n - c0), m, o, bs, pan, vd, t, w1,
                  w2);
    for (int c0 = 0; c0 < k; c0 += kChunk)
      apply_block(y, k, c0, min(kChunk, k - c0), m, o, bs, pan, vd, t, w1,
                  w2);
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
    *scal = nan ? NAN : fmaxf(1e-6f * dmax, tiny);
  }
  __syncthreads();
  const float thresh = *scal;
  float* xk = wv + bs;
  for (int kk = n - 1; kk >= 0; --kk) {
    const float rkk = r[kk * n + kk];
    const bool ok = fabsf(rkk) > thresh;
    for (int q = tid; q < k; q += nt) xk[q] = ok ? y[kk * k + q] / rkk : 0.0f;
    __syncthreads();
    for (int e = tid; e < (kk + 1) * k; e += nt) {
      const int i = e / k;
      const int q = e % k;
      if (i == kk)
        y[e] = xk[q];
      else
        y[e] -= r[i * n + kk] * xk[q];
    }
    __syncthreads();
  }
  float* xl = X + lane * n * k;
  for (int e = tid; e < n * k; e += nt) xl[e] = y[e];
}

}  // namespace
}  // namespace repro_torch

extern "C" {

size_t qr_solve_blocked_smem(int m, int n, int k, int bs) {
  return sizeof(float) *
         static_cast<size_t>(repro_torch::layout(m, n, k, bs).total);
}

// a (batch, m, n) with m >= n, b (batch, m, k) -> x (batch, n, k), float32;
// work: batch * m * n floats; n % bs == 0.
int qr_solve_blocked_f32(const void* a, const void* b, void* x, void* work,
                         int batch, int m, int n, int k, int bs, float tiny,
                         void* stream) {
  using namespace repro_torch;
  const size_t smem = qr_solve_blocked_smem(m, n, k, bs);
  cudaError_t err = allow_smem(qr_solve_blocked_kernel, smem);
  if (err != cudaSuccess) return err;
  qr_solve_blocked_kernel<<<batch, kQrThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(x), static_cast<float*>(work), m, n, k, bs, tiny);
  return cudaGetLastError();
}

}  // extern "C"
