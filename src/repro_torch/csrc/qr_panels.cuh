// The device-memory Householder chain of K4's global form, by panels.
//
// qr_chain (qr_solve.cu) applies each of the min(n, m-1) reflections to
// the whole of [R | y] at once: on a lane in device memory that is three
// passes over rows kk.. of every column per reflection (the norm, the
// v^T [R | y] dot products, the rank-1 update).  This routine computes the
// same chain a panel of bs columns at a time, treating [R | y] as one
// m x (n + k) matrix:
//
//   * the panel's rows o..m-1 are staged in shared memory (pitch bs + 1,
//     so a warp's rows fall in distinct banks) and its bs reflections run
//     there: warp 0 builds each reflector (householder: qr_chain's 32-way
//     row split and warp_sum), v goes into V ((m - o) x bs, pitch bs + 1)
//     and tau into a bs-float array; one thread a panel column then takes
//     the previous reflector's update and this one's dot product in one
//     sweep, summed from row kk upward; column kk takes its own
//     reflector, so R's diagonal is the result of that update, not alpha;
//   * the columns right of the panel, y's k columns among them, are
//     updated once a panel: a thread owns a column at a time, stages its
//     rows o.. in a slot of shared memory (the tile: `tile` columns, a
//     thread each) while it sums v_0^T c, then sweeps the slot once per
//     reflector, the update of reflector p and the dot product of
//     reflector p+1 in the same pass (each element is read after its
//     update, as qr_chain reads it), and stores the column back with the
//     last reflector's update;
//   * back substitution runs by blocks of bs rows, last block first: the
//     block's columns of R and rows of y are staged in shared memory and
//     its steps touch only them; y's rows above the block then take the
//     block's products once, one FFMA at a time in qr_chain's descending
//     order.
//
// Every sum starts at 0 and adds rows from kk upward as qr_chain's does,
// every update is one FFMA (r -= v * w), and every norm, tau, quotient and
// zeroing guard is qr_chain's expression.  So the result equals qr_chain's
// bit for bit at every panel and tile width: bs and the tile only move
// where an element waits between its updates.  At bs = 1 and a one-column
// tile this is the per-column chain.  Device traffic falls from three
// passes over [R | y] per reflection to about one read and one write per
// panel.
//
// Columns left of the current panel are never touched again, and their
// rows below the diagonal are not even written back: nothing reads them.
// Back substitution reads only R's upper triangle, and no reflector reads
// a column left of its own, so qr_chain's updates of those entries change
// nothing it returns.
//
// The plan (threads, bs, tile, shared memory) is pipelines/qr_solve.py's
// qr_panel_plan; the C entry checks it with qr_panel_plan_ok.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "lane_common.cuh"

namespace repro_torch {

constexpr int kQrMaxPanel = 32;   // a thread a panel column, within warp 0
constexpr int kQrMaxTile = 128;   // a thread a tile column

// Threads of a lane: one a tile column, and a whole warp at least (warp 0
// builds the reflectors).
__host__ __device__ inline int qr_panel_threads(int tile) {
  return tile > 32 ? tile : 32;
}

// Dynamic shared memory of a lane: V (m x (bs + 1)); the panel (m x (bs +
// 1)), the tile (m x tile) or back substitution's block of R, which share
// one region; y's block rows (bs x k); tau and the panel's w (bs each);
// the threshold.
__host__ __device__ inline size_t qr_panel_smem_bytes(int m, int k, int bs,
                                                      int tile) {
  const size_t pc = static_cast<size_t>(bs) + 1;
  const size_t z = pc > static_cast<size_t>(tile) ? pc : tile;
  return sizeof(float) * (m * pc + m * z + static_cast<size_t>(bs) * k +
                          2 * static_cast<size_t>(bs) + 1);
}

// Whether (threads, bs, tile, smem) is a plan the routine was compiled for.
inline bool qr_panel_plan_ok(int m, int n, int k, int threads, int bs,
                             int tile, int smem) {
  return n >= 1 && m >= n && k >= 1 && tile >= 1 && tile <= kQrMaxTile &&
         threads == qr_panel_threads(tile) && bs >= 1 && bs <= kQrMaxPanel &&
         smem >= 0 &&
         static_cast<size_t>(smem) == qr_panel_smem_bytes(m, k, bs, tile);
}

// The Householder reflector of column x (x[i * ld] is row i) at rows
// k0..rows-1 with _qr_solve_kernel's expressions: the norm, the sign rule
// alpha = xk >= 0 ? -norm : norm, v (v[i * vld] for i >= k0) and tau (0
// for a degenerate column), which it returns.  Warp 0 only, all 32 lanes:
// lane t sums rows k0 + t, k0 + t + 32, ... and warp_sum adds the lanes.
__device__ inline float householder(const float* x, int ld, float* v,
                                    int vld, int k0, int rows, float tiny) {
  const int lid = threadIdx.x & 31;
  float s = 0.0f;
  for (int i = k0 + lid; i < rows; i += 32) s += x[i * ld] * x[i * ld];
  const float norm = sqrtf(warp_sum(s));
  const float xk = x[k0 * ld];
  const float alpha = xk >= 0.0f ? -norm : norm;
  for (int i = k0 + lid; i < rows; i += 32)
    v[i * vld] = i == k0 ? xk - alpha : x[i * ld];
  __syncwarp();
  float s2 = 0.0f;
  for (int i = k0 + lid; i < rows; i += 32) s2 += v[i * vld] * v[i * vld];
  const float vnorm2 = fmaxf(warp_sum(s2), tiny);
  return norm < tiny ? 0.0f : 2.0f / vnorm2;
}

// One sweep of column c (c[i * ld] is row i) over rows i0..rows-1: with
// kUpdate, each row first takes reflector p - 1's update (c -= v_{p-1} w);
// then v_p^T c is summed in row order from 0, as qr_chain's dot product.
// v_p[i] is v[i * vld + p].  Eight rows are loaded at a time, so only the
// sum's FFMAs wait on each other.
template <bool kUpdate>
__device__ inline float sweep(float* c, int ld, const float* v, int vld,
                              int p, int i0, int rows, float w) {
  float s = 0.0f;
  int i = i0;
  for (; i + 8 <= rows; i += 8) {
    float cr[8], va[8], vc[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      cr[u] = c[(i + u) * ld];
      vc[u] = v[(i + u) * vld + p];
      if (kUpdate) va[u] = v[(i + u) * vld + p - 1];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (kUpdate) cr[u] -= va[u] * w;
      s += vc[u] * cr[u];
    }
    if (kUpdate) {
#pragma unroll
      for (int u = 0; u < 8; ++u) c[(i + u) * ld] = cr[u];
    }
  }
  for (; i < rows; ++i) {
    float cr = c[i * ld];
    if (kUpdate) {
      cr -= v[i * vld + p - 1] * w;
      c[i * ld] = cr;
    }
    s += v[i * vld + p] * cr;
  }
  return s;
}

// The Householder least-squares chain of qr_chain on a lane in device
// memory.
//
//   a0, b0  m x n and m x k row-major: A and B, read by the first panel.
//   r, y    m x n and m x k row-major work: [R | y] as the chain leaves
//           them (R's entries below the diagonal are never written).
//   x       n x k row-major: the solution.
//   smem    qr_panel_smem_bytes(m, k, bs, tile) of shared memory.
//
// Launched with qr_panel_threads(tile) threads.  The threshold max(1e-6 *
// max |diag R|, tiny) is reduced across warp 0 (a maximum does not depend
// on its order; a NaN on the diagonal makes it NaN).
__device__ inline void qr_chain_panels(const float* a0, const float* b0,
                                       float* r, float* y, float* x, int m,
                                       int n, int k, int bs, int tile,
                                       float tiny, float* smem) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int pc = bs + 1;
  float* vb = smem;                   // m * pc: V, rows o.. at 0..
  float* z = vb + m * pc;             // m * max(pc, tile): panel / tile
  float* yb = z + m * max(pc, tile);  // bs * k: y's block rows
  float* tau = yb + bs * k;           // bs
  float* wp = tau + bs;               // bs: w of the panel's columns
  float* thresh_s = wp + bs;          // 1
  const int nref = m > 1 ? min(n, m - 1) : 0;
  const int cols = n + k;

  if (nref == 0) {                    // m = n = 1: no reflection
    for (int e = tid; e < m * n; e += nt) r[e] = a0[e];
    for (int e = tid; e < m * k; e += nt) y[e] = b0[e];
    __syncthreads();
  }
  for (int o = 0; o < nref; o += bs) {
    const float* ra = o == 0 ? a0 : r;   // where [R | y] lies before it
    const float* ya = o == 0 ? b0 : y;
    const int pw = min(bs, nref - o);    // the last panel may be ragged
    const int rows = m - o;              // rows o..m-1 at 0..rows-1
    for (int e = tid; e < rows * pw; e += nt) {
      const int i = e / pw;
      const int jj = e % pw;
      z[i * pc + jj] = ra[(o + i) * n + o + jj];
    }
    __syncthreads();

    for (int j = 0; j < pw; ++j) {
      // column j takes reflector j - 1 (rows j - 1..)
      if (j > 0) {
        const float w = wp[j];
        for (int i = j - 1 + tid; i < rows; i += nt)
          z[i * pc + j] -= vb[i * pc + j - 1] * w;
        __syncthreads();
      }
      // householder region (warp 0): reflector j from column j
      if (tid < 32) {
        const float t = householder(z + j, pc, vb + j, pc, j, rows, tiny);
        if (tid == 0) tau[j] = t;
      }
      __syncthreads();
      // a thread a column jj >= j: reflector j - 1's update (rows j - 1..,
      // columns past j) and w = tau v_j^T c (rows j..); column j then
      // takes its own reflector on the diagonal, the only entry of it
      // that is read again
      const int jj = j + tid;
      if (jj < pw) {
        float* c = z + jj;
        float s;
        if (jj == j || j == 0) {
          s = sweep<false>(c, pc, vb, pc, j, j, rows, 0.0f);
        } else {
          const float w = wp[jj];
          c[(j - 1) * pc] -= vb[(j - 1) * pc + j - 1] * w;
          s = sweep<true>(c, pc, vb, pc, j, j, rows, w);
        }
        const float w = tau[j] * s;
        if (jj == j)
          c[j * pc] -= vb[j * pc + j] * w;
        else
          wp[jj] = w;
      }
      __syncthreads();
    }

    // the panel's upper part (R's rows o..o+jj of column o+jj) back to
    // device memory
    for (int e = tid; e < pw * pw; e += nt) {
      const int i = e / pw;
      const int jj = e % pw;
      if (i <= jj) r[(o + i) * n + o + jj] = z[i * pc + jj];
    }
    __syncthreads();

    // the columns right of the panel: a thread a column, its rows o.. in
    // its slot of the tile, every reflector of the panel in order
    float* zt = z + tid;
    for (int jt = o + pw + tid; tid < tile && jt < cols; jt += tile) {
      const bool in_r = jt < n;
      const int ld = in_r ? n : k;
      const float* src = in_r ? ra + o * n + jt : ya + o * k + (jt - n);
      float* dst = in_r ? r + o * n + jt : y + o * k + (jt - n);
      // reflector 0's dot product while the column is staged
      float s = 0.0f;
      int i = 0;
      for (; i + 8 <= rows; i += 8) {
        float cr[8], vc[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          cr[u] = src[(i + u) * ld];
          vc[u] = vb[(i + u) * pc];
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          s += vc[u] * cr[u];
          zt[(i + u) * tile] = cr[u];
        }
      }
      for (; i < rows; ++i) {
        const float cr = src[i * ld];
        s += vb[i * pc] * cr;
        zt[i * tile] = cr;
      }
      float w = tau[0] * s;
      // reflector p - 1's update (row p - 1, then rows p.. with reflector
      // p's dot product)
      for (int p = 1; p < pw; ++p) {
        zt[(p - 1) * tile] -= vb[(p - 1) * pc + p - 1] * w;
        w = tau[p] * sweep<true>(zt, tile, vb, pc, p, p, rows, w);
      }
      // the last reflector's update (rows pw - 1..), to device memory
      for (i = 0; i < pw - 1; ++i) dst[i * ld] = zt[i * tile];
      for (; i < rows; ++i) dst[i * ld] = zt[i * tile] - vb[i * pc + pw - 1] * w;
    }
    __syncthreads();
  }

  // back substitution on R[:n, :n] with the relative deficiency threshold
  // max(1e-6 * max |diag R|, tiny): a component below it is zeroed
  if (tid < 32) {
    float dmax = 0.0f;
    bool nan = false;
    for (int i = tid; i < n; i += 32) {
      const float d = fabsf(r[i * n + i]);
      nan |= isnan(d);
      dmax = fmaxf(dmax, d);
    }
    for (int off = 16; off > 0; off >>= 1)
      dmax = fmaxf(dmax, __shfl_xor_sync(0xffffffffu, dmax, off));
    nan = __any_sync(0xffffffffu, nan);
    if (tid == 0) *thresh_s = nan ? NAN : fmaxf(1e-6f * dmax, tiny);
  }
  __syncthreads();
  const float thresh = *thresh_s;
  // by blocks of bs rows, the last first: rows 0..k1 of the block's
  // columns k0..k1 of R (upper part) and y's rows k0..k1 in shared memory
  float* rb = z;                      // (k1 + 1) x pc
  for (int k1 = n - 1; k1 >= 0; k1 -= bs) {
    const int k0 = max(0, k1 - bs + 1);
    const int nb = k1 - k0 + 1;
    for (int e = tid; e < (k1 + 1) * nb; e += nt) {
      const int i = e / nb;
      const int c = e % nb;
      if (i <= k0 + c) rb[i * pc + c] = r[i * n + k0 + c];
    }
    for (int e = tid; e < nb * k; e += nt) yb[e] = y[k0 * k + e];
    __syncthreads();
    for (int c = nb - 1; c >= 0; --c) {
      const float rkk = rb[(k0 + c) * pc + c];
      const bool ok = fabsf(rkk) > thresh;
      for (int q = tid; q < k; q += nt)
        yb[c * k + q] = ok ? yb[c * k + q] / rkk : 0.0f;
      __syncthreads();
      for (int e = tid; e < c * k; e += nt)
        yb[e] -= rb[(k0 + e / k) * pc + c] * yb[c * k + e % k];
      __syncthreads();
    }
    for (int e = tid; e < nb * k; e += nt) x[k0 * k + e] = yb[e];
    for (int e = tid; e < k0 * k; e += nt) {
      const int i = e / k;
      const int q = e % k;
      float acc = y[e];
      for (int c = nb - 1; c >= 0; --c) acc -= rb[i * pc + c] * yb[c * k + q];
      y[e] = acc;
    }
    __syncthreads();
  }
}

}  // namespace repro_torch
