// The device-memory Cholesky chain of K1-K3's global forms, by panels.
//
// chol_chain (lane_common.cuh) walks the n columns one by one and, at
// each, updates the whole trailing lower triangle: on a lane in device
// memory that is n^3/6 elements read and written, once per column.  This
// routine computes the same chain a panel of bs columns at a time:
//
//   * the panel's rows o..n-1 and y's rows o..o+bs-1 are staged in shared
//     memory (pitch bs + 1, so a warp's rows fall in distinct banks), and
//     the panel's bs steps -- guarded rsqrt pivot, scaled column, solution
//     row, rank-1 update of the panel's remaining columns, forward-
//     substitution AXPY -- touch shared memory only;
//   * the panel's columns of L and rows of y go back to device memory, and
//     the trailing lower triangle (and y's rows below the panel) is
//     updated once: a thread loads a 4 x 4 register tile, subtracts the
//     panel's products from it one column at a time, in column order, and
//     stores it;
//   * back substitution on L^T runs by blocks of bs rows of L, last block
//     first: the block's rows of L and y are staged in shared memory and
//     its steps touch only them; y's rows above the block then take the
//     block's products once, one at a time in chol_chain's order.
//
// Each element of L and y sees the products chol_chain subtracts from it,
// in chol_chain's order, each as one FFMA (x -= p * q), and every pivot,
// column, solution row and quotient is chol_chain's expression.  So the
// result equals chol_chain's bit for bit at every panel width: bs only
// moves where an element waits between its updates.  At bs = 1 this is the
// per-column algorithm.  Device-memory traffic falls from n^3/6 to about
// n^3 / (6 bs) elements each way, and the back substitution waits on
// device memory once a block, not twice a row.
//
// The plan (threads, bs, shared memory) is pipelines/cholesky_solve.py's
// chol_panel_plan; the C entries check it with chol_panel_plan_ok.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "lane_common.cuh"
#include "tile_loops.cuh"

namespace repro_torch {

constexpr int kPanelThreads = 256;
constexpr int kPanelWarps = kPanelThreads / 32;
constexpr int kMaxPanelWidth = 64;
// The global instances ask for four lanes an SM, which keeps a thread
// within 64 registers: ptxas picked 75-78 at a bound of threads alone
// (three lanes an SM), and the panel steps, which wait at barriers, ran
// slower.  The shared instances of the same templates ask for none (0):
// a bound of 1 raised their registers (32 to 37-56) and their time.
constexpr int kPanelMinBlocks = 4;

// Dynamic shared memory of a lane: the panel (n x (bs + 1)), y's panel
// rows (bs x m), the threshold's per-warp partials and the threshold.
__host__ __device__ inline size_t chol_panel_smem_bytes(int n, int m,
                                                        int bs) {
  return sizeof(float) * (static_cast<size_t>(n) * (bs + 1) +
                          static_cast<size_t>(bs) * m + 2 * kPanelWarps + 1);
}

// Whether (threads, bs, smem) is a plan the routine was compiled for.
inline bool chol_panel_plan_ok(int n, int m, int threads, int bs, int smem) {
  return n >= 1 && m >= 1 && threads == kPanelThreads && bs >= 1 &&
         bs <= kMaxPanelWidth && smem >= 0 &&
         static_cast<size_t>(smem) == chol_panel_smem_bytes(n, m, bs);
}

// The guarded factor -> forward -> back chain of chol_chain on a lane in
// device memory.
//
//   a0    n x n row-major: the system's lower triangle (i >= j); the upper
//         triangle is never read.  May be a itself.
//   a     n x n row-major work: L's lower triangle on return (the upper
//         triangle is never read or written).
//   y     n x m row-major, the right-hand sides; holds x on return.
//   smem  chol_panel_smem_bytes(n, m, bs) of shared memory.
//
// Launched with kPanelThreads threads.  The threshold is diag_threshold's
// max(eps * max diag, 1e-30), reduced across the block (a maximum does not
// depend on its order; a NaN on the diagonal makes it NaN).
__device__ inline void chol_chain_panels(const float* a0, float* a, float* y,
                                         int n, int m, int bs, float eps,
                                         float* smem) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5;
  const int lid = tid & 31;
  const int pc = bs + 1;
  float* c = smem;                   // n * pc: the panel, rows o.. at 0..
  float* yp = c + n * pc;            // bs * m: y's panel rows
  float* red = yp + bs * m;          // 2 * kPanelWarps
  float* thresh_s = red + 2 * kPanelWarps;

  {
    float dmax = -INFINITY;
    bool nan = false;
    for (int i = tid; i < n; i += nt) {
      const float d = a0[i * n + i];
      nan |= isnan(d);
      dmax = fmaxf(dmax, d);
    }
    for (int off = 16; off > 0; off >>= 1)
      dmax = fmaxf(dmax, __shfl_xor_sync(0xffffffffu, dmax, off));
    nan = __any_sync(0xffffffffu, nan);
    if (lid == 0) {
      red[warp] = dmax;
      red[kPanelWarps + warp] = nan ? 1.0f : 0.0f;
    }
    __syncthreads();
    if (tid == 0) {
      float d = -INFINITY;
      bool any_nan = false;
      for (int w = 0; w < kPanelWarps; ++w) {
        d = fmaxf(d, red[w]);
        any_nan |= red[kPanelWarps + w] != 0.0f;
      }
      *thresh_s = any_nan ? NAN : fmaxf(eps * d, kPivotFloor);
    }
    __syncthreads();
  }
  const float thresh = *thresh_s;

  for (int o = 0; o < n; o += bs) {
    const float* src = o == 0 ? a0 : a;   // the first panel reads A
    const int pw = min(bs, n - o);        // the last panel may be ragged
    const int prows = n - o;
    // stage the panel (lower part; zero above) and y's panel rows
    for (int e = tid; e < prows * pw; e += nt) {
      const int r = e / pw;
      const int jj = e % pw;
      c[r * pc + jj] = r >= jj ? src[(o + r) * n + o + jj] : 0.0f;
    }
    for (int e = tid; e < pw * m; e += nt) yp[e] = y[o * m + e];
    __syncthreads();

    for (int j = 0; j < pw; ++j) {
      // point + vector region: guarded rsqrt pivot, scaled column below
      // it, solution row o + j
      const float piv = c[j * pc + j];
      const bool ok = piv > thresh;
      const float inv = ok ? rsqrtf(fmaxf(piv, thresh)) : 0.0f;
      for (int r = j + 1 + tid; r < prows; r += nt) c[r * pc + j] *= inv;
      for (int q = tid; q < m; q += nt) yp[j * m + q] *= inv;
      __syncthreads();
      // matrix region: the diagonal of L (every thread has read the
      // pivot), rank-1 update of the panel's remaining columns (lower
      // part) and the forward-substitution AXPY on y's panel rows
      if (tid == 0) c[j * pc + j] = ok ? piv * inv : 1.0f;
      for (int r = j + 1 + tid; r < prows; r += nt) {
        const float lr = c[r * pc + j];
        const int jend = min(pw, r + 1);
        for (int jj = j + 1; jj < jend; ++jj)
          c[r * pc + jj] -= lr * c[jj * pc + j];
        if (r < pw)
          for (int q = 0; q < m; ++q) yp[r * m + q] -= lr * yp[j * m + q];
      }
      __syncthreads();
    }

    // the panel's columns of L and rows of y back to device memory
    for (int e = tid; e < prows * pw; e += nt) {
      const int r = e / pw;
      const int jj = e % pw;
      if (r >= jj) a[(o + r) * n + o + jj] = c[r * pc + jj];
    }
    for (int e = tid; e < pw * m; e += nt) y[o * m + e] = yp[e];
    // the forward-substitution AXPYs of the panel's columns on y's rows
    // below it, in column order
    for (int e = tid; e < (prows - pw) * m; e += nt) {
      const int r = pw + e / m;
      const int q = e % m;
      float acc = y[(o + r) * m + q];
      for (int p = 0; p < pw; ++p) acc -= c[r * pc + p] * yp[p * m + q];
      y[(o + r) * m + q] = acc;
    }
    // the trailing lower triangle (rows, columns pw.. of the panel's
    // frame): a warp takes 16 rows x 32 columns, a thread rows i0 + 4 r
    // and columns j0 + 8 q, so a warp's loads and stores of a row are 8
    // consecutive floats and its shared loads fall in distinct banks or
    // broadcast.  Rows past the lane read the panel's last row and are
    // never stored; elements above the diagonal are never loaded or
    // stored.
    const int t = prows - pw;
    const int rb = ceil_div(t, 16);
    const int cb = ceil_div(t, 32);
    for (int st = warp; st < rb * cb; st += nt >> 5) {
      const int bi = st / cb;
      const int bj = st % cb;
      if (32 * bj > 16 * bi + 15) continue;   // wholly above the diagonal
      const int i0 = pw + 16 * bi + (lid >> 3);
      const int j0 = pw + 32 * bj + (lid & 7);
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + 4 * r;
          const int jc = j0 + 8 * q;
          acc[r][q] = (i < prows && jc <= i) ? src[(o + i) * n + o + jc]
                                             : 0.0f;
        }
      int xr[4], wr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        xr[r] = min(i0 + 4 * r, prows - 1) * pc;
        wr[r] = min(j0 + 8 * r, prows - 1) * pc;
      }
      for (int p = 0; p < pw; ++p) {
        float x[4], w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          x[r] = c[xr[r] + p];
          w[r] = c[wr[r] + p];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] -= x[r] * w[q];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + 4 * r;
          const int jc = j0 + 8 * q;
          if (i < prows && jc <= i) a[(o + i) * n + o + jc] = acc[r][q];
        }
    }
    __syncthreads();
  }

  // back substitution on U = L^T, x[k] = y[k] / l[k][k] and y[i < k] -=
  // l[k][i] x[k] for k = n-1 down to 0, by blocks of bs rows of L, the
  // last block first: the block's rows (left of and on the diagonal) and
  // y's rows are staged in shared memory and its steps touch only them;
  // then y's rows above the block take the block's products one at a
  // time, k descending, as chol_chain's steps give them.
  float* lb = c;                     // bs * n: rows k0..k1 of L
  for (int k1 = n - 1; k1 >= 0; k1 -= bs) {
    const int k0 = max(0, k1 - bs + 1);
    const int rows = k1 - k0 + 1;
    const int cols = k1 + 1;
    for (int e = tid; e < rows * cols; e += nt) {
      const int r = e / cols;
      const int i = e % cols;
      if (i <= k0 + r) lb[r * n + i] = a[(k0 + r) * n + i];
    }
    for (int e = tid; e < rows * m; e += nt) yp[e] = y[k0 * m + e];
    __syncthreads();
    for (int r = rows - 1; r >= 0; --r) {
      const float lkk = lb[r * n + k0 + r];
      for (int q = tid; q < m; q += nt) yp[r * m + q] = yp[r * m + q] / lkk;
      __syncthreads();
      for (int e = tid; e < r * m; e += nt)
        yp[e] -= lb[r * n + k0 + e / m] * yp[r * m + e % m];
      __syncthreads();
    }
    for (int e = tid; e < rows * m; e += nt) y[k0 * m + e] = yp[e];
    for (int e = tid; e < k0 * m; e += nt) {
      const int i = e / m;
      const int q = e % m;
      float acc = y[e];
      for (int r = rows - 1; r >= 0; --r)
        acc -= lb[r * n + i] * yp[r * m + q];
      y[e] = acc;
    }
    __syncthreads();
  }
}

}  // namespace repro_torch
