// K13: slab-streamed compact-WY fused least squares, one CTA per lane.
//
// Replaces: src/repro/pipelines/qr_solve.py, qr_solve_tiled
// (_qr_solve_tiled_kernel, _qr_panel_reflect_step, _wy_t_step), the TPU
// kernel whose (lanes, steps + 1, tiles) grid streams one (m x bs) column
// slab of an HBM-resident matrix through VMEM a cell: panel cells build bs
// Householder reflectors on the panel slab, accumulate the compact-WY
// (V, T), apply the block reflector to the right-hand sides and fold
// max |diag R| into a running global maximum; trailing cells apply the
// block reflector to the slabs to the right; the last row of cells solves
// each slab's (bs x bs) diagonal block of R in reverse against the GLOBAL
// threshold max(1e-6 max |diag R|, tiny) and pushes the solved components
// to the rows above.  Q is never formed.
//
// What bounds it on an H100: per lane about 2 (m n^2 - n^3/3) + 4 m n k
// FLOPs and m n + m k + n k floats in and out.  At n = 512 the panel,
// (m - o) x bs, is 258-264 KB, so it cannot sit in a CTA's shared memory:
//   * R, V and the right-hand sides live in a per-lane slice of a device
//     work buffer, V below the panel's diagonal (where the column was, as
//     LAPACK's geqr2 keeps it) and v[g] aside in shared memory;
//   * each reflector is two passes over the rest of the panel in device
//     memory (L2 for a resident lane), a warp's lanes on consecutive
//     columns and eight of its rows in flight: the dot products tau v^T P,
//     then the rank-1 update, which also sums the next column's squares
//     below its head; only the norm, v's head, tau and the reductions go
//     through shared memory;
//   * V^T V, then T (larft, forward, column by column) in one bs x bs tile
//     of shared memory (T upper, V^T V strict lower);
//   * the block reflector I - V T^T V^T on 64-column chunks of the
//     trailing slabs and of the rhs: W = V^T C, W = T^T W, C -= V W, the
//     products in staged 64 x 64 tiles (tile_loops.cuh), each sum in
//     order.
// The CTA's shared memory depends on bs and k alone (qr_tiled_layout):
// 156 KB at bs = 128, k = 2, for every m and n, so one CTA a SM.
#include <cstddef>

#include "lane_common.cuh"
#include "tile_loops.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = kTileThreads / 32;
constexpr int kRowBatch = 8;    // rows a warp has in flight in the passes

struct QrTiledLayout {          // float offsets into dynamic shared memory
  int vd, taus, wv, t, w1, w2, stage, part, zt, xk, red, scal, total;
};

__host__ __device__ inline QrTiledLayout qr_tiled_layout(int k, int bs) {
  QrTiledLayout l;
  const int pc = bs + 1;
  l.vd = 0;                     // bs: v[g] of each reflector
  l.taus = l.vd + bs;           // bs
  l.wv = l.taus + bs;           // bs: tau * v^T panel
  l.t = l.wv + bs;              // bs * pc: T (upper), V^T V (strict lower);
                                // a diagonal block of R in the back-sub
  l.w1 = l.t + bs * pc;         // bs * kTile: V^T C
  l.w2 = l.w1 + bs * kTile;     // bs * kTile: T^T V^T C
  l.stage = align4(l.w2 + bs * kTile);  // the product tiles' staging
  l.part = l.stage + kTileSmemFloats;  // kWarps * bs: per-warp dot sums
  l.zt = l.part + kWarps * bs;  // bs * k: a slab's rows of the rhs
  l.xk = l.zt + bs * k;         // k: the solved row
  l.red = l.xk + k;             // 32: reduction scratch
  l.scal = l.red + 32;          // 1: the running max |diag R|
  l.total = l.scal + 1;
  return l;
}

// V[row][col] of the panel at column o: below the diagonal it is where
// the column was, v[g] sits aside, zero above.
__device__ inline float vget(const float* r, size_t ld, const float* vd,
                             int o, int row, int col) {
  return row > o + col ? r[row * ld + o + col]
                       : (row == o + col ? vd[col] : 0.0f);
}

// C -= V (T^T (V^T C)) on columns [c0, c0 + cw) (cw <= kTile) of the
// row-major matrix c (row pitch ldc), rows o..m-1.
__device__ inline void apply_block(float* c, size_t ldc, int c0, int cw,
                                   const float* r, size_t ld, int m, int o,
                                   int bs, const float* vd, const float* t,
                                   float* w1, float* w2, float* stage) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int pc = bs + 1;
  float* sa = stage;
  float* sb = stage + kDepthChunk * kTilePitch;
  // W1 = V^T C over the rows o.., 64 reflectors a tile
  for (int p0 = 0; p0 < bs; p0 += kTile) {
    const auto lv = [=](int p, int cc) {
      return p0 + cc < bs ? vget(r, ld, vd, o, o + p, p0 + cc) : 0.0f;
    };
    const auto lc = [=](int p, int cc) {
      return cc < cw ? c[(o + p) * ldc + c0 + cc] : 0.0f;
    };
    float acc[4][4];
    tile_product<false, false>(acc, m - o, lv, lc, sa, sb);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = tile_row(p0, u);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int q = tile_col(0, v);
        if (p < bs && q < cw) w1[p * kTile + q] = acc[u][v];
      }
    }
  }
  __syncthreads();
  // W2 = T^T W1 (T upper triangular)
  for (int e = tid; e < bs * cw; e += nt) {
    const int p = e / cw;
    const int q = e % cw;
    float s = 0.0f;
    for (int l = 0; l <= p; ++l) s += t[l * pc + p] * w1[l * kTile + q];
    w2[p * kTile + q] = s;
  }
  __syncthreads();
  // C -= V W2, 64 rows a tile
  for (int i0 = o; i0 < m; i0 += kTile) {
    const auto lv = [=](int p, int cc) {
      return i0 + cc < m && p < bs ? vget(r, ld, vd, o, i0 + cc, p) : 0.0f;
    };
    const auto lw = [=](int p, int cc) {
      return cc < cw ? w2[p * kTile + cc] : 0.0f;
    };
    float acc[4][4];
    tile_product<true, false>(acc, bs, lv, lw, sa, sb);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tile_row(i0, u);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int q = tile_col(0, v);
        if (i < m && q < cw) c[i * ldc + c0 + q] -= acc[u][v];
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kTileThreads)
qr_solve_tiled_kernel(const float* __restrict__ A,
                      const float* __restrict__ B, float* X, float* work,
                      int m, int n, int k, int bs, float tiny) {
  extern __shared__ float smem[];
  const QrTiledLayout L = qr_tiled_layout(k, bs);
  float* vd = smem + L.vd;
  float* taus = smem + L.taus;
  float* wv = smem + L.wv;
  float* t = smem + L.t;
  float* w1 = smem + L.w1;
  float* w2 = smem + L.w2;
  float* stage = smem + L.stage;
  float* part = smem + L.part;
  float* zt = smem + L.zt;
  float* xk = smem + L.xk;
  float* red = smem + L.red;
  float* dmax_s = smem + L.scal;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lid = tid & 31;
  const int warp = tid >> 5;
  const int pc = bs + 1;
  const size_t lane = blockIdx.x;
  const size_t ld = n;
  const size_t mn = static_cast<size_t>(m) * n;
  float* r = work + lane * (mn + static_cast<size_t>(m) * k);
  float* y = r + mn;
  for (size_t e = tid; e < mn; e += nt) r[e] = A[lane * mn + e];
  for (int e = tid; e < m * k; e += nt) y[e] = B[lane * m * k + e];
  if (tid == 0) *dmax_s = 0.0f;
  __syncthreads();

  for (int o = 0; o < n; o += bs) {
    // ---- panel: bs reflectors, each two passes over the panel's rest ----
    float tail = 0.0f;          // sum of squares of column 0 below its head
    for (int i = o + 1 + tid; i < m; i += nt) {
      const float x = r[i * ld + o];
      tail += x * x;
    }
    tail = block_sum(tail, red);
    for (int j = 0; j < bs; ++j) {
      const int g = o + j;
      const int ncol = bs - j;
      // householder region: the sign rule alpha = xk >= 0 ? -norm : norm,
      // v[g] and tau (0 for a degenerate column), the same in every thread
      const float xk0 = r[g * ld + o + j];
      const float norm = sqrtf(tail + xk0 * xk0);
      const float alpha = xk0 >= 0.0f ? -norm : norm;
      const float vg = xk0 - alpha;
      const float vnorm2 = fmaxf(tail + vg * vg, tiny);
      const float tau = norm < tiny ? 0.0f : 2.0f / vnorm2;
      // wv[jj] = tau v^T P[:, jj] for the columns j..: lanes on columns,
      // warps on rows (kRowBatch rows' loads issued before their FMAs),
      // then the warps' sums added in order
      for (int cg = 0; cg < ncol; cg += 32) {
        const int jj = j + cg + lid;
        float s = 0.0f;
        if (jj < bs) {
          if (warp == 0) s = vg * r[g * ld + o + jj];
          int i = g + 1 + warp;
          for (; i + (kRowBatch - 1) * kWarps < m; i += kRowBatch * kWarps) {
            float v[kRowBatch], x[kRowBatch];
#pragma unroll
            for (int u = 0; u < kRowBatch; ++u) {
              v[u] = r[(i + u * kWarps) * ld + o + j];
              x[u] = r[(i + u * kWarps) * ld + o + jj];
            }
#pragma unroll
            for (int u = 0; u < kRowBatch; ++u) s += v[u] * x[u];
          }
          for (; i < m; i += kWarps) s += r[i * ld + o + j] * r[i * ld + o + jj];
        }
        if (cg + lid < ncol) part[warp * bs + cg + lid] = s;
      }
      __syncthreads();
      for (int cc = tid; cc < ncol; cc += nt) {
        float s = 0.0f;
        for (int w = 0; w < kWarps; ++w) s += part[w * bs + cc];
        wv[j + cc] = tau * s;
      }
      __syncthreads();
      // rank-1 update of the columns j.. (rows g..; column j keeps v below
      // g), summing column j + 1's new squares below its head
      float sq = 0.0f;
      for (int cg = 0; cg < ncol; cg += 32) {
        const int jj = j + cg + lid;
        if (jj >= bs) continue;
        const float w = wv[jj];
        if (warp == 0) r[g * ld + o + jj] -= vg * w;
        if (jj == j) continue;
        const bool next = jj == j + 1;
        int i = g + 1 + warp;
        for (; i + (kRowBatch - 1) * kWarps < m; i += kRowBatch * kWarps) {
          float v[kRowBatch], x[kRowBatch];
#pragma unroll
          for (int u = 0; u < kRowBatch; ++u) {
            v[u] = r[(i + u * kWarps) * ld + o + j];
            x[u] = r[(i + u * kWarps) * ld + o + jj];
          }
#pragma unroll
          for (int u = 0; u < kRowBatch; ++u) {
            x[u] -= v[u] * w;
            r[(i + u * kWarps) * ld + o + jj] = x[u];
            if (next && i + u * kWarps > g + 1) sq += x[u] * x[u];
          }
        }
        for (; i < m; i += kWarps) {
          const float x = r[i * ld + o + jj] - r[i * ld + o + j] * w;
          r[i * ld + o + jj] = x;
          if (next && i > g + 1) sq += x * x;
        }
      }
      if (tid == 0) {
        vd[j] = vg;
        taus[j] = tau;
      }
      tail = block_sum(sq, red);
    }
    // ---- |diag R| of the panel into the running global maximum ----
    float d = 0.0f;
    for (int j = tid; j < bs; j += nt)
      d = nan_max(d, fabsf(r[(o + j) * ld + o + j]));
    d = block_max(d, red);
    if (tid == 0) *dmax_s = nan_max(*dmax_s, d);
    // ---- V^T V (strict upper, stored transposed in t) ----
    const int vt_tiles = ceil_div(bs, kTile);
    for (int ti = 0; ti < vt_tiles; ++ti) {
      for (int tj = ti; tj < vt_tiles; ++tj) {
        const int i0 = ti * kTile;
        const int j0 = tj * kTile;
        const auto la = [=](int p, int c) {
          return i0 + c < bs ? vget(r, ld, vd, o, o + p, i0 + c) : 0.0f;
        };
        const auto lb = [=](int p, int c) {
          return j0 + c < bs ? vget(r, ld, vd, o, o + p, j0 + c) : 0.0f;
        };
        float acc[4][4];
        tile_product<false, false>(acc, m - o, la, lb, stage,
                                   stage + kDepthChunk * kTilePitch);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = tile_row(i0, u);
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int jc = tile_col(j0, v);
            if (i < jc && jc < bs) t[jc * pc + i] = acc[u][v];
          }
        }
      }
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
    // ---- block reflector on the trailing slabs, then on the rhs ----
    for (int c0 = o + bs; c0 < n; c0 += kTile)
      apply_block(r, ld, c0, min(kTile, n - c0), r, ld, m, o, bs, vd, t, w1,
                  w2, stage);
    for (int c0 = 0; c0 < k; c0 += kTile)
      apply_block(y, k, c0, min(kTile, k - c0), r, ld, m, o, bs, vd, t, w1,
                  w2, stage);
  }

  // ---- back substitution, slabs in reverse: each diagonal block of R
  // against the global threshold, then the rows above ----
  const float dmax = *dmax_s;
  const float thresh = isnan(dmax) ? NAN : fmaxf(1e-6f * dmax, tiny);
  for (int o = n - bs; o >= 0; o -= bs) {
    for (int e = tid; e < bs * bs; e += nt) {
      const int i = e / bs;
      const int jj = e % bs;
      t[i * pc + jj] = jj >= i ? r[(o + i) * ld + o + jj] : 0.0f;
    }
    for (int e = tid; e < bs * k; e += nt) zt[e] = y[o * static_cast<size_t>(k) + e];
    __syncthreads();
    for (int kk = bs - 1; kk >= 0; --kk) {
      const float rkk = t[kk * pc + kk];
      const bool ok = fabsf(rkk) > thresh;
      for (int q = tid; q < k; q += nt)
        xk[q] = ok ? zt[kk * k + q] / rkk : 0.0f;
      __syncthreads();
      for (int e = tid; e < (kk + 1) * k; e += nt) {
        const int i = e / k;
        const int q = e % k;
        zt[e] = i == kk ? xk[q] : zt[e] - t[i * pc + kk] * xk[q];
      }
      __syncthreads();
    }
    for (int e = tid; e < bs * k; e += nt) y[o * static_cast<size_t>(k) + e] = zt[e];
    // y[i] -= R[i][o..o+bs) x_slab for the rows above, a warp a row
    for (int i = warp; i < o; i += kWarps) {
      for (int q = 0; q < k; ++q) {
        float s = 0.0f;
        for (int jj = lid; jj < bs; jj += 32)
          s += r[i * ld + o + jj] * zt[jj * k + q];
        s = warp_sum(s);
        if (lid == 0) y[i * static_cast<size_t>(k) + q] -= s;
      }
    }
    __syncthreads();
  }
  float* xl = X + lane * n * k;
  for (int e = tid; e < n * k; e += nt) xl[e] = y[e];
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// Independent of m and n: the slabs stream through device memory.
size_t qr_solve_tiled_smem(int m, int n, int k, int bs) {
  (void)m;
  (void)n;
  return sizeof(float) *
         static_cast<size_t>(repro_torch::qr_tiled_layout(k, bs).total);
}

// a (batch, m, n) with m >= n, b (batch, m, k) -> x (batch, n, k), float32;
// work: batch * m * (n + k) floats (R and V, then the rhs); n % bs == 0.
int qr_solve_tiled_f32(const void* a, const void* b, void* x, void* work,
                       int batch, int m, int n, int k, int bs, float tiny,
                       void* stream) {
  using namespace repro_torch;
  const size_t smem = qr_solve_tiled_smem(m, n, k, bs);
  cudaError_t err = allow_smem(qr_solve_tiled_kernel, smem);
  if (err != cudaSuccess) return err;
  qr_solve_tiled_kernel<<<batch, kTileThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(x), static_cast<float*>(work), m, n, k, bs, tiny);
  return cudaGetLastError();
}

}  // extern "C"
