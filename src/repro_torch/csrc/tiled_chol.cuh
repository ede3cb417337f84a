// The tiled Cholesky core of K10, K12 and K14 on a thread-block cluster,
// shared as the reference's tiled kernels share _tiled_factor_cell and
// _tiled_backsub_cell (src/repro/pipelines/cholesky_solve.py), and as its
// blocked kernel (K10's) runs the same panel factor.
//
// One lane (an n x n SPD working matrix, lower triangle only, and n x k
// right-hand sides) runs on a cluster of C = 1, 2, 4 or 8 CTAs of
// kTcThreads threads on neighbouring SMs, which meet at the cluster's
// hardware barrier (a block barrier where C = 1).  The working matrix
// lives in a per-lane slice of a device work buffer and the right-hand
// sides in the output (solved in place), so a CTA's shared memory depends
// on bs, k and the product tile only (tiled_layout).  Every exchange
// between ranks goes through device memory (L2): a rank writes, the
// cluster barrier (release / acquire at cluster scope) orders, another
// rank reads, bypassing its L1 (ld.global.cg, cp.async.cg).
//
// A panel of bs columns at o:
//   * the diagonal block: every rank loads it and factors it itself, the
//     same bits on every rank, by inner panels of kInner columns, four
//     columns a step: every thread finishes the 4 x 4 corner in registers
//     (the pivots' guarded rsqrt, the corner's columns, its rows of y),
//     each row below takes its four elements and its y row, then the
//     rank-4 update within the inner panel; two block barriers a step;
//     then the rank-kInner update of the block right of the inner panel;
//   * the rows of L21, kRowChunk at a time, the chunks dealt to the ranks
//     (chunk q to rank q % C): row r depends only on L11 and its own row,
//     so four threads of a warp own a row and walk its columns in order
//     with no block barrier; element j takes c[r][j] -= L[r][p] L[o+j][p]
//     for p = 0..j-1 in order, then the scale by the pivot's guarded rsqrt
//     (0 for a deficient pivot).  A finished row is written twice: to the
//     lower triangle (the back substitution reads it there) and transposed
//     into the upper triangle, row o + j of the work buffer (never read
//     as part of the matrix), where the trailing update's tiles read it
//     depth-major; its y row is forward-solved by the same rank;
//   * the trailing update of the rows and columns >= o + bs, lower
//     triangle only, in wide product tiles (tile_loops.cuh, kT x kT, kT =
//     64 or 128 by the plan) dealt to the ranks (tile idx to rank idx %
//     C), each element's sum over the panel's columns in order;
//   * a cluster barrier after the rows of L21 and after the trailing
//     update: two a panel.
// The first panel of K10 and K12 reads A in place of a copy
// (tiled_factor's a_in).  K10 then runs the back substitution in the order
// of the reference's chain (tiled_backsub_chain: a slab's diagonal block
// solved by every rank, then the rows above take its x one subtraction at
// a time, dealt to the ranks).  K12 and K14 run the back substitution over
// the slabs in reverse, left-looking: the
// slab's rows of z take the already-solved rows below through the slab's
// columns (each element one thread's serial sum over the rows in order,
// the rows staged in shared memory a chunk at a time, the slab's rows
// dealt to the ranks in contiguous blocks), a cluster
// barrier, then rank 0 solves the (bs x bs) diagonal block by sub-blocks
// of 32 rows, the last first: a warp a right-hand side solves the
// sub-block (a lane a row, x handed on by __shfl_sync, no block barrier
// a row), then the rows above take its x; each element's subtractions in
// descending order; a cluster barrier.
//
// So each element of L, y and x takes the same operations in the same
// order on every cluster size and product tile as on one CTA: every
// plan gives the same bits.  The pivot test, the guarded rsqrtf and the
// deficient pivot's path follow the plain version (cholesky_solve.py's
// panel_factor_forward_step).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>

#include "cluster_launch.cuh"
#include "lane_common.cuh"
#include "phase_clock.cuh"
#include "tile_loops.cuh"

namespace repro_torch {

namespace tc_cg = cooperative_groups;

constexpr int kTcThreads = kTileThreads;   // 256: the wide tile's block
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcMaxPanel = 256;           // bs: a thread left over in (B)
constexpr int kRowThreads = 4;  // threads of a warp that share a row of L21
constexpr int kRowChunk = kTcThreads / kRowThreads;  // rows of L21 a pass
constexpr int kInner = 16;      // columns of the diagonal block's inner panel

struct TiledLayout {            // float offsets into dynamic shared memory
  int pb, blk, inv, yb, ybf, chunk, ych, red, total;
};

// pb, the diagonal block's pitch, is a multiple of 4 (four consecutive
// columns of a row are one float4) and 4 more than bs rounded up, so
// eight threads on eight consecutive rows hit distinct banks.  below: the
// lane has rows below its first panel (n > bs); a lane of one panel has
// no rows of L21 and no trailing update, so no room for them, and its
// block takes the pitch bs rounded up (up to bs = 239 fits).
__host__ __device__ inline TiledLayout tiled_layout(int k, int bs, int kt,
                                                    bool below = true) {
  TiledLayout l;
  l.pb = align4(bs) + (below ? 4 : 0);
  const int chunk = below ? kRowChunk * l.pb : 0;
  const int wide = below ? wide_smem_floats(kt) : 0;
  l.blk = 0;                    // bs * pb: the diagonal block, then L11
  l.inv = l.blk + bs * l.pb;    // bs: the pivots' guarded rsqrt
  l.yb = l.inv + align4(bs);    // bs * k: the block's rows of y in work
  l.ybf = align4(l.yb + bs * k);    // bs * k: and finished
  l.chunk = align4(l.ybf + bs * k); // rows below the block, or staging
  l.ych = l.chunk + (chunk > wide ? chunk : wide);
  l.red = l.ych + (below ? kRowChunk * k : 0);  // 32: reduction scratch
  l.total = l.red + 32;
  return l;
}

// Whether (c, tile, smem) is a plan the kernels take at (n, k, bs).
inline bool tiled_plan_ok(int n, int k, int bs, int c, int tile, int smem) {
  if (!(n >= 1 && k >= 1 && bs >= 1 && bs <= kTcMaxPanel && n % bs == 0))
    return false;
  if (!(c == 1 || c == 2 || c == 4 || c == 8)) return false;
  if (!(tile == 64 || tile == 128)) return false;
  return smem == static_cast<int>(sizeof(float)) *
                     tiled_layout(k, bs, tile, n > bs).total;
}

// A lane's place on its cluster: its rank, the cluster size and the
// barrier between phases (a block barrier on one CTA: the cluster barrier
// costs ~900 cycles even there).
struct TcCluster {
  int rank, c;
  __device__ void sync() const {
    if (c > 1)
      tc_cg::this_cluster().sync();
    else
      __syncthreads();
  }
};

// The diagonal block of a panel, in shared memory (blk, pitch pb, lower
// part; yb its bs rows of y), factored with the forward substitution
// fused in; inv receives the pivots' guarded rsqrt and ybf the finished
// rows of y (a row of yb is read as a corner after the row's last
// update, so the corner's result goes elsewhere and no barrier guards
// it).  By inner panels of kInner columns: four columns a step within the
// inner panel, the rank-4 update only within it, then the rank-kInner
// update of the block right of it, each element's subtractions in the
// same ascending order as four rank-4 steps give.  kW4: bs a multiple of
// 4, so every step is four columns wide.  Ends on a barrier.
template <bool kW4, class Clock>
__device__ inline void tiled_diag_block(float* blk, float* inv, float* yb,
                                        float* ybf, int bs, int k, int pb,
                                        float thresh, Clock& clk) {
  const int tid = threadIdx.x;
  for (int j0 = 0; j0 < bs; j0 += kInner) {
    const int j1 = min(bs, j0 + kInner);    // the inner panel's end
    for (int j = j0; j < j1; j += kRowThreads) {
      const int w = kW4 ? kRowThreads : min(kRowThreads, bs - j);
      // (A) the corner, in every thread alike: cc[v][x] = blk[j+v][j+x]
      float cc[4][4], iv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float4 r4 =
            *reinterpret_cast<const float4*>(blk + (j + v) * pb + j);
        cc[v][0] = r4.x;
        cc[v][1] = r4.y;
        cc[v][2] = r4.z;
        cc[v][3] = r4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u < w) {
          const float piv = cc[u][u];
          const bool ok = piv > thresh;
          iv[u] = ok ? rsqrtf(fmaxf(piv, thresh)) : 0.0f;
          cc[u][u] = ok ? piv * iv[u] : 1.0f;
#pragma unroll
          for (int v = u + 1; v < 4; ++v)
            if (v < w) cc[v][u] *= iv[u];
#pragma unroll
          for (int v = u + 1; v < 4; ++v)
#pragma unroll
            for (int x = u + 1; x <= v; ++x)
              if (v < w) cc[v][x] -= cc[v][u] * cc[x][u];
        }
      }
      // the corner's rows of y for right-hand side q, from yb
      const auto corner_y = [&](int q, float (&yc)[4]) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          yc[u] = u < w ? yb[(j + u) * k + q] : 0.0f;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (u < w) {
            const float yg = yc[u] * iv[u];
            yc[u] = yg;
#pragma unroll
            for (int v = u + 1; v < 4; ++v)
              if (v < w) yc[v] -= cc[v][u] * yg;
          }
        }
      };
      // (B) each row below the corner: its four elements, then its y
      // row; the last thread, which has no row here (bs <= kTcMaxPanel),
      // writes the corner's rows of y and pivots out (its L after the
      // barrier: a slower warp may still be reading the corner for (A))
      for (int r = j + w + tid; r < bs; r += kTcThreads) {
        const float4 r4 = *reinterpret_cast<const float4*>(blk + r * pb + j);
        const float f0[4] = {r4.x, r4.y, r4.z, r4.w};
        float l[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (u < w) {
            float f = f0[u];
#pragma unroll
            for (int p = 0; p < u; ++p) f -= l[p] * cc[u][p];
            l[u] = f * iv[u];
            blk[r * pb + j + u] = l[u];
          }
        }
        for (int q = 0; q < k; ++q) {
          float yc[4];
          corner_y(q, yc);
          float y0 = yb[r * k + q];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (u < w) y0 -= l[u] * yc[u];
          yb[r * k + q] = y0;
        }
      }
      const bool last = tid == kTcThreads - 1;
      if (last) {               // (constant indices: the arrays stay in
        for (int q = 0; q < k; ++q) {   // registers)
          float yc[4];
          corner_y(q, yc);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (u < w) ybf[(j + u) * k + q] = yc[u];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (u < w) inv[j + u] = iv[u];
      }
      __syncthreads();
      clk.mark(kTpDiag);
      if (last) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int x = 0; x <= u; ++x)
            if (u < w) blk[(j + u) * pb + j + x] = cc[u][x];
      }
      // (C) the rank-4 update within the inner panel: column x (a thread
      // each, j + w <= x < j1) of the rows r >= x, each element's four
      // subtractions in order; two rows' loads before their FMAs
      const int x = j + w + (tid & 15);
      if (x < j1) {
        const float4 b4 = *reinterpret_cast<const float4*>(blk + x * pb + j);
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
        int r = j + w + (tid >> 4);
        r += (x - r + 15) / 16 * 16 * (r < x);      // the first r >= x
        for (; r + 16 < bs; r += 32) {
          const float4 l0 =
              *reinterpret_cast<const float4*>(blk + r * pb + j);
          const float4 l1 =
              *reinterpret_cast<const float4*>(blk + (r + 16) * pb + j);
          float c0 = blk[r * pb + x];
          float c1 = blk[(r + 16) * pb + x];
          const float e0[4] = {l0.x, l0.y, l0.z, l0.w};
          const float e1[4] = {l1.x, l1.y, l1.z, l1.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (u < w) {
              c0 -= e0[u] * b[u];
              c1 -= e1[u] * b[u];
            }
          }
          blk[r * pb + x] = c0;
          blk[(r + 16) * pb + x] = c1;
        }
        if (r < bs) {
          const float4 l0 = *reinterpret_cast<const float4*>(blk + r * pb + j);
          const float e0[4] = {l0.x, l0.y, l0.z, l0.w};
          float c0 = blk[r * pb + x];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (u < w) c0 -= e0[u] * b[u];
          blk[r * pb + x] = c0;
        }
      }
      __syncthreads();
      clk.mark(kTpUpdate);
    }
    // (D) the rank-(j1 - j0) update of the block right of the inner
    // panel: element (r, x), j1 <= x <= r, takes c -= L[r][p] L[x][p] for
    // p = j0..j1-1 in order, as the inner panel's rank-4 steps would
    if (j1 < bs) {
      const int ib = j1 - j0;
      for (int r = j1 + (tid >> 4); r < bs; r += 16) {
        float lr[kInner];
#pragma unroll
        for (int p = 0; p < kInner; p += 4) {
          if (kW4) {
            const float4 l4 =
                p < ib ? *reinterpret_cast<const float4*>(blk + r * pb + j0 + p)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            lr[p] = l4.x;
            lr[p + 1] = l4.y;
            lr[p + 2] = l4.z;
            lr[p + 3] = l4.w;
          } else {
#pragma unroll
            for (int t = 0; t < 4; ++t)
              lr[p + t] = p + t < ib ? blk[r * pb + j0 + p + t] : 0.0f;
          }
        }
        for (int x = j1 + (tid & 15); x <= r; x += 16) {
          float c = blk[r * pb + x];
#pragma unroll
          for (int p = 0; p < kInner; p += 4) {
            if (p < ib) {
              float e[4];
              if (kW4) {
                const float4 b4 = *reinterpret_cast<const float4*>(
                    blk + x * pb + j0 + p);
                e[0] = b4.x;
                e[1] = b4.y;
                e[2] = b4.z;
                e[3] = b4.w;
              } else {
#pragma unroll
                for (int t = 0; t < 4; ++t)
                  e[t] = p + t < ib ? blk[x * pb + j0 + p + t] : 0.0f;
              }
#pragma unroll
              for (int t = 0; t < 4; ++t)
                if (p + t < ib) c -= lr[p + t] * e[t];
            }
          }
          blk[r * pb + x] = c;
        }
      }
      __syncthreads();
      clk.mark(kTpUpdate);
    }
  }
}

// One step of the column walk of a row c of L21 (in shared memory) by
// its four threads, thread q0 owning columns q0 + 4 t: the four threads
// finish columns j..j+kW-1 alike (c[j] is final when the step reads it;
// each later one takes its subtractions from the step's earlier columns
// in order), their owners keep the finished values, and every column
// further right takes the step's kW subtractions in order (a few
// columns' loads before their FMAs).  Rows past the chunk (live false)
// walk along without a store.
template <int kW>
__device__ inline void tiled_walk_step(float* c, const float* blk,
                                       const float* inv, int pb, int bs,
                                       int q0, bool live, int j) {
  constexpr int kG = 16 / kW;   // columns a thread updates at once
  float l[kW], f[kW];
  if (live) {
#pragma unroll
    for (int u = 0; u < kW; ++u) f[u] = c[j + u];
#pragma unroll
    for (int u = 0; u < kW; ++u) {
#pragma unroll
      for (int p = 0; p < u; ++p) f[u] -= l[p] * blk[(j + u) * pb + j + p];
      l[u] = f[u] * inv[j + u];
    }
  }
  __syncwarp();
  if (live) {
#pragma unroll
    for (int h = 0; h < kW / kRowThreads; ++h) {
      const int u = kRowThreads * h;
      const float fv = q0 == 0   ? f[u]
                       : q0 == 1 ? f[u + 1]
                       : q0 == 2 ? f[u + 2]
                                 : f[u + 3];
      if (q0 > 0 || h > 0) c[j + u + q0] = fv;
    }
    int jj = j + kW + q0;
    for (; jj + (kG - 1) * kRowThreads < bs; jj += kG * kRowThreads) {
      float x[kG], e[kG][kW];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        x[g] = c[jj + g * kRowThreads];
#pragma unroll
        for (int h = 0; h < kW; h += 4) {
          const float4 b4 = *reinterpret_cast<const float4*>(
              blk + (jj + g * kRowThreads) * pb + j + h);
          e[g][h] = b4.x;
          e[g][h + 1] = b4.y;
          e[g][h + 2] = b4.z;
          e[g][h + 3] = b4.w;
        }
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
#pragma unroll
        for (int p = 0; p < kW; ++p) x[g] -= l[p] * e[g][p];
        c[jj + g * kRowThreads] = x[g];
      }
    }
    for (; jj < bs; jj += kRowThreads) {
      float x = c[jj];
#pragma unroll
      for (int h = 0; h < kW; h += 4) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(blk + jj * pb + j + h);
        x -= l[h] * b4.x;
        x -= l[h + 1] * b4.y;
        x -= l[h + 2] * b4.z;
        x -= l[h + 3] * b4.w;
      }
      c[jj] = x;
    }
  }
  __syncwarp();
}

// The column walk of a row of L21: eight columns a step (each column's
// subtractions in the same order as four-column steps give, half the
// steps and a load of c a column to eight FMAs), a four-column step where
// bs is 4 past a multiple of 8, a column at a time past a multiple of 4;
// the scale by inv[j] follows the walk.  Not inlined, like the product
// tiles: the kernel's other phases do not crowd its registers.
static __device__ __noinline__ void tiled_walk(float* c, const float* blk,
                                               const float* inv, int pb,
                                               int bs, int q0, bool live) {
  int j = 0;
  for (; j + 2 * kRowThreads <= bs; j += 2 * kRowThreads)
    tiled_walk_step<2 * kRowThreads>(c, blk, inv, pb, bs, q0, live, j);
  if (j + kRowThreads <= bs) {
    tiled_walk_step<kRowThreads>(c, blk, inv, pb, bs, q0, live, j);
    j += kRowThreads;
  }
  for (; j < bs; ++j) {         // a width that is not a multiple of 4
    if (live) {
      const float l = c[j] * inv[j];
      const int jj0 = j + 1 + ((q0 - j - 1) % kRowThreads + kRowThreads)
                                  % kRowThreads;
      for (int jj = jj0; jj < bs; jj += kRowThreads)
        c[jj] -= l * blk[jj * pb + j];
    }
    __syncwarp();
  }
}

// One kT x kT tile of the trailing update at (i0, j0): a[i][j] = src[i][j]
// - sum_p L[i][o + p] L[j][o + p] over the panel's bs columns in order
// (lt: the panel's L^T rows), lower triangle only.  Not inlined, so its
// registers (the tile's sums) are its own and not the whole kernel's.
template <int kT>
__device__ __noinline__ void tiled_trail_tile(float* a, const float* src,
                                              const float* lt, int n,
                                              int bs, int i0, int j0,
                                              bool vec4, float* sm) {
  const size_t ld = n;
  float acc[kT / 16][kT / 16];
  wide_product<kT>(acc, bs, lt + i0, n, n - i0, lt + j0, n, n - j0, vec4,
                   sm);
  // a -= acc, 16 elements' loads in flight before their stores (a
  // store to a may alias a later load of src, so the compiler would
  // otherwise wait out each load in turn)
  const int ry = wide_ry();
  const int cx = wide_cx();
  constexpr int kR = kT / 16;
  constexpr int kRows = 16 / kR;     // rows of acc a round
#pragma unroll
  for (int u0 = 0; u0 < kR; u0 += kRows) {
    float old[kRows][kR];
#pragma unroll
    for (int du = 0; du < kRows; ++du) {
      const int i = i0 + wide_off(ry, u0 + du);
#pragma unroll
      for (int v = 0; v < kR; ++v) {
        const int jc = j0 + wide_off(cx, v);
        old[du][v] = i < n && jc <= i ? __ldcg(src + i * ld + jc) : 0.0f;
      }
    }
#pragma unroll
    for (int du = 0; du < kRows; ++du) {
      const int i = i0 + wide_off(ry, u0 + du);
#pragma unroll
      for (int v = 0; v < kR; ++v) {
        const int jc = j0 + wide_off(cx, v);
        if (i < n && jc <= i) a[i * ld + jc] = old[du][v] - acc[u0 + du][v];
      }
    }
  }
}

// The right-looking factor with the forward substitution fused in, on the
// lane's cluster.
//   a     n x n row-major, device memory; L on return (and L21's panels
//         transposed in the upper triangle)
//   a_in  n x n row-major, the matrix's lower triangle on entry: a itself
//         (K14's G) or the input (K12's A, which the first panel reads in
//         place of a copy: its diagonal block element by element below
//         the diagonal, its rows of L21, and the trailing update's a_in -
//         sum; nothing right of A's diagonal is read)
//   y     n x k row-major, device memory; forward-solved in place
// A pivot at or below thresh takes the rank-deficient path: unit
// diagonal, zeroed column below it, zeroed solution component.  Entered
// after a cluster barrier that made y whole; leaves after one.  vec4: n
// and bs multiples of 4 (and y's base 16-byte aligned), so every row the
// phases copy from a starts on 16 bytes; vec4_in the same of a_in.
// below: n > bs (tiled_layout; K12 and K14 always have rows below).
template <int kT, class Clock>
__device__ inline void tiled_factor(float* a, const float* a_in, float* y,
                                    int n, int k, int bs, float thresh,
                                    bool vec4, bool vec4_in,
                                    const TcCluster& cl, float* smem,
                                    Clock& clk, bool below = true) {
  const TiledLayout L = tiled_layout(k, bs, kT, below);
  const int pb = L.pb;
  float* blk = smem + L.blk;
  float* inv = smem + L.inv;
  float* yb = smem + L.yb;
  float* ybf = smem + L.ybf;
  float* ch = smem + L.chunk;
  float* ych = smem + L.ych;
  const int tid = threadIdx.x;
  const int nt = kTcThreads;
  const size_t ld = n;
  const size_t kk = k;
  for (int o = 0; o < n; o += bs) {
    // ---- the diagonal block and its rows of y, every rank (the block's
    //      upper part comes along and is never read) ----
    const bool first = o == 0;
    const float* src = first ? a_in : a;      // the panel's columns
    const bool src4 = first ? vec4_in : vec4;
    if (first && a_in != a) {
      for (GridStep g(bs); g.r < bs; g.next())
        blk[g.r * pb + g.c] =
            g.c <= g.r ? __ldcg(a_in + g.r * ld + g.c) : 0.0f;
    } else {
      copy_block(blk, pb, src + o * ld + o, ld, bs, bs, src4);
    }
    copy_block(yb, bs * k, y + o * kk, 0, 1, bs * k, vec4);
    cp_async_wait_all();
    __syncthreads();
    if (bs % kRowThreads == 0)
      tiled_diag_block<true>(blk, inv, yb, ybf, bs, k, pb, thresh, clk);
    else
      tiled_diag_block<false>(blk, inv, yb, ybf, bs, k, pb, thresh, clk);

    // ---- the rows of L21 and their rows of y, chunks dealt to ranks ----
    const int rr = tid / kRowThreads;   // this thread's row of the chunk
    const int q0 = tid % kRowThreads;   // and its first column
    const int nch = ceil_div(n - o - bs, kRowChunk);
    for (int qc = cl.rank; qc < nch; qc += cl.c) {
      const int r0 = o + bs + qc * kRowChunk;
      const int nr = min(kRowChunk, n - r0);
      __syncthreads();          // the previous chunk's readers are done
      copy_block(ch, pb, src + r0 * ld + o, ld, nr, bs, src4);
      copy_block(ych, nr * k, y + r0 * kk, 0, 1, nr * k, vec4);
      cp_async_wait_all();
      __syncthreads();
      clk.mark(kTpRows);
      // every thread walks its row's columns, so a warp's barriers stay
      // whole
      tiled_walk(ch + rr * pb, blk, inv, pb, bs, q0, rr < nr);
      __syncthreads();
      clk.mark(kTpWalk);
      for (GridStep g(bs); g.r < nr; g.next()) {
        const float l = ch[g.r * pb + g.c] * inv[g.c];
        ch[g.r * pb + g.c] = l;
        a[(r0 + g.r) * ld + o + g.c] = l;
      }
      __syncthreads();
      for (GridStep g(nr); g.r < bs; g.next())   // L^T, rows o + jj
        a[(o + g.r) * ld + r0 + g.c] = ch[g.c * pb + g.r];
      for (GridStep g(k); g.r < nr; g.next()) {
        float s = ych[g.r * k + g.c];
        for (int jj = 0; jj < bs; ++jj)
          s -= ch[g.r * pb + jj] * ybf[jj * k + g.c];
        y[(r0 + g.r) * kk + g.c] = s;
      }
    }
    cl.sync();                  // L21, both copies, and its y rows whole
    clk.mark(kTpRows);
    if (cl.rank == 0) {         // L11 and its rows of y, for the back-sub
      for (GridStep g(bs); g.r < bs; g.next())
        if (g.c <= g.r) a[(o + g.r) * ld + o + g.c] = blk[g.r * pb + g.c];
      for (int e = tid; e < bs * k; e += nt) y[o * kk + e] = ybf[e];
    }

    // ---- trailing update: a[i][j] -= sum_p L[i][o + p] L[j][o + p] for
    //      o + bs <= j <= i, in kT x kT tiles over the lower triangle, the
    //      panel's L^T rows (o + p, columns >= o + bs) as both operands ----
    const int t0 = o + bs;
    const int tiles = ceil_div(n - t0, kT);
    const float* lt = a + o * ld;
    for (int ti = 0, idx = 0; ti < tiles; ++ti) {
      for (int tj = 0; tj <= ti; ++tj, ++idx) {
        if (idx % cl.c != cl.rank) continue;
        const int i0 = t0 + ti * kT;
        const int j0 = t0 + tj * kT;
        tiled_trail_tile<kT>(a, src, lt, n, bs, i0, j0, vec4, ch);
      }
    }
    cl.sync();                  // the trailing matrix whole
    clk.mark(kTpTrail);
  }
}

// The solve of a slab's (bs x bs) diagonal block on U = L^T, on one CTA:
// blk the block's L (pitch pb, lower part), zt its z (bs x k), x on
// return.  By sub-blocks of 32 rows, the last first: a warp a right-hand
// side solves the sub-block (a lane a row, x[r] = z[r] / l[r][r] handed on
// by shuffle, no block barrier a row), then each row above takes the
// sub-block's x; so each element's subtractions z[i] -= l[r][i] x[r] come
// for r descending, directly into z.  Ends on a barrier.
__device__ __forceinline__ void tiled_diag_solve(const float* blk, float* zt,
                                                 int bs, int k, int pb) {
  const int tid = threadIdx.x;
  const int lid = tid & 31;
  const int warp = tid >> 5;
  for (int b0 = (bs - 1) / 32 * 32; b0 >= 0; b0 -= 32) {
    const int nb = min(32, bs - b0);
    const float* lb = blk + b0 * pb + b0;
    for (int q = warp; q < k; q += kTcWarps) {
      float z = lid < nb ? zt[(b0 + lid) * k + q] : 0.0f;
      for (int r = nb - 1; r >= 0; --r) {
        const float xr = __shfl_sync(0xffffffffu, z, r) / lb[r * pb + r];
        if (lid == r)
          z = xr;
        else if (lid < r)
          z = z - lb[r * pb + lid] * xr;
      }
      if (lid < nb) zt[(b0 + lid) * k + q] = z;
    }
    __syncthreads();
    for (GridStep g(k); g.r < b0; g.next()) {
      float z = zt[g.r * k + g.c];
      for (int r = b0 + nb - 1; r >= b0; --r)
        z = z - blk[r * pb + g.r] * zt[r * k + g.c];
      zt[g.r * k + g.c] = z;
    }
    __syncthreads();
  }
}

// The back substitution of K12 and K14 on U = L^T over the slabs in
// reverse, left-looking: for the slab at columns o..o+bs, z[o + j] =
// y[o + j] - sum over rows r >= o + bs of L[r][o + j] x[r] (the slab's
// rows dealt to the ranks in contiguous blocks; the rows r staged
// kRowChunk at a time, each element's partial sum kept in shared memory
// between stages), then rank 0 solves the diagonal block
// (tiled_diag_solve).  y holds x on return.  Entered after a cluster
// barrier; leaves after one.
template <int kT, class Clock>
__device__ inline void tiled_backsub(const float* a, float* y, int n, int k,
                                     int bs, bool vec4, const TcCluster& cl,
                                     float* smem, Clock& clk) {
  const TiledLayout L = tiled_layout(k, bs, kT);
  const int pb = L.pb;
  float* blk = smem + L.blk;
  float* zs = smem + L.yb;      // the rank's partial sums
  float* ch = smem + L.chunk;
  float* ych = smem + L.ych;
  const int tid = threadIdx.x;
  const int nt = kTcThreads;
  const size_t ld = n;
  const size_t kk = k;
  const int per = ceil_div(bs, cl.c);
  const int j0 = min(bs, cl.rank * per);
  const int nel = (min(bs, j0 + per) - j0) * k;
  for (int o = n - bs; o >= 0; o -= bs) {
    for (int e = tid; e < nel; e += nt) zs[e] = 0.0f;
    for (int r0 = o + bs; r0 < n; r0 += kRowChunk) {
      const int nr = min(kRowChunk, n - r0);
      __syncthreads();          // the previous stage's readers are done
      copy_block(ch, pb, a + r0 * ld + o, ld, nr, bs, vec4);
      copy_block(ych, nr * k, y + r0 * kk, 0, 1, nr * k, vec4);
      cp_async_wait_all();
      __syncthreads();
      for (GridStep g(k); g.r < nel / k; g.next()) {
        const int e = g.r * k + g.c;
        float s = zs[e];
        for (int i = 0; i < nr; ++i)
          s += ch[i * pb + j0 + g.r] * ych[i * k + g.c];
        zs[e] = s;
      }
    }
    for (GridStep g(k); g.r < nel / k; g.next()) {
      const size_t at = (o + j0 + g.r) * kk + g.c;
      y[at] = __ldcg(y + at) - zs[g.r * k + g.c];
    }
    cl.sync();                  // the slab's z whole
    clk.mark(kTpSums);
    if (cl.rank == 0) {
      float* zt = zs;           // the slab's z, then x (bs x k)
      copy_block(blk, pb, a + o * ld + o, ld, bs, bs, vec4);
      copy_block(zt, bs * k, y + o * kk, 0, 1, bs * k, vec4);
      cp_async_wait_all();
      __syncthreads();
      tiled_diag_solve(blk, zt, bs, k, pb);
      for (int e = tid; e < bs * k; e += nt) y[o * kk + e] = zt[e];
    }
    cl.sync();                  // the slab's x whole
    clk.mark(kTpBacksub);
  }
}

// K10's back substitution on U = L^T in the order of the reference's
// chain (back_substitution_step), by slabs in reverse.  Every rank holds
// the slab's diagonal block (blk) and z (zs) in shared memory and solves
// it itself (tiled_diag_solve: subtractions descending, directly into z;
// the same bits on every rank); rank 0 stores x.  Then every row i above
// the slab takes the slab's x one subtraction at a time, y[i] -= L[r][i]
// x[r] for r = o + bs - 1 down to o: the next slab's bs rows by every rank
// into its own shared memory (zn, the next z, with no trip through
// device memory), the rows above those dealt to the ranks' threads
// (element e to thread e % (C x kTcThreads) of the cluster) directly into
// y, while the next block's L flies in by cp.async; a cluster barrier, one
// a slab.  So each element of x takes exactly the chain's operations in
// the chain's order, on every plan.  Row i's L[r][i] are read from the
// transposed copy the factor left in the upper triangle (row i, columns
// o..o+bs: contiguous).  y holds x on return.  Entered after a cluster
// barrier.
template <int kT, class Clock>
__device__ inline void tiled_backsub_chain(const float* a, float* y, int n,
                                           int k, int bs, bool vec4,
                                           const TcCluster& cl, float* smem,
                                           Clock& clk) {
  const TiledLayout L = tiled_layout(k, bs, kT, n > bs);
  const int pb = L.pb;
  float* blk = smem + L.blk;
  float* zs = smem + L.yb;      // the slab's z, then its x (bs x k)
  float* zn = smem + L.ybf;     // the next slab's z
  const size_t ld = n;
  const size_t kk = k;
  const int tid = threadIdx.x;
  const int me = cl.rank * kTcThreads + tid;
  const int all = cl.c * kTcThreads;
  // row i's subtractions of the slab's x, r descending
  const auto chain = [&](int o, int i, int q, float z) {
    const float* lt = a + i * ld + o;       // L[o..o+bs)[i]
    int r = bs - 1;
    if (vec4) {                 // bs % 4 == 0: r - 3 on 16 bytes
#pragma unroll 4
      for (; r >= 3; r -= 4) {
        const float4 l4 = __ldcg(reinterpret_cast<const float4*>(lt + r - 3));
        z = z - l4.w * zs[r * k + q];
        z = z - l4.z * zs[(r - 1) * k + q];
        z = z - l4.y * zs[(r - 2) * k + q];
        z = z - l4.x * zs[(r - 3) * k + q];
      }
    }
    for (; r >= 0; --r) z = z - __ldcg(lt + r) * zs[r * k + q];
    return z;
  };
  int o = n - bs;
  copy_block(blk, pb, a + o * ld + o, ld, bs, bs, vec4);
  copy_block(zs, bs * k, y + o * kk, 0, 1, bs * k, vec4);
  cp_async_wait_all();
  __syncthreads();
  for (;; o -= bs) {
    tiled_diag_solve(blk, zs, bs, k, pb);
    clk.mark(kTpBacksub);
    if (cl.rank == 0)
      for (int e = tid; e < bs * k; e += kTcThreads) y[o * kk + e] = zs[e];
    if (o == 0) break;
    const int on = o - bs;      // the next slab
    copy_block(blk, pb, a + on * ld + on, ld, bs, bs, vec4);
    for (int e = tid; e < bs * k; e += kTcThreads) {
      const int i = on + e / k;
      const int q = e % k;
      zn[e] = chain(o, i, q, __ldcg(y + i * kk + q));
    }
    for (int e = me; e < on * k; e += all) {
      const int i = e / k;
      y[e] = chain(o, i, e - i * k, __ldcg(y + e));
    }
    cp_async_wait_all();
    cl.sync();                  // the rows above whole, zn and blk in
    clk.mark(kTpChain);
    float* z = zs;
    zs = zn;
    zn = z;
  }
}

// One lane of K10, K12 or K14 on its cluster: the stamps' clock, the cluster's
// place, and the threshold's block maximum.
template <bool kStamp>
struct TiledLane {
  TcCluster cl;
  size_t lane;
  PhaseClock<kStamp, kTiledPhases> clk;
  __device__ explicit TiledLane(int c)
      : cl{c > 1 ? static_cast<int>(tc_cg::this_cluster().block_rank()) : 0,
           c},
        lane(blockIdx.x / c),
        clk(cl.rank == 0) {}
};

}  // namespace repro_torch
