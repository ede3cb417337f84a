// The tiled Cholesky phases of K12, shared with K14 as the reference's
// tiled kernels share _tiled_factor_cell and _tiled_backsub_cell
// (src/repro/pipelines/cholesky_solve.py).
//
// One CTA of kTileThreads threads per lane.  The lane's working matrix
// (n x n, lower triangle only; the upper triangle is never read) lives in
// a per-lane slice of a device work buffer and its right-hand sides
// (n x k) in device memory too (the output buffer, solved in place), so
// the shared memory of a CTA depends on bs and k only (tiled_layout):
//   * the (bs x bs) diagonal block of a panel, pitch bs + 1, and its rows
//     of y, where the bs fused factor + forward steps run four columns at
//     a time (three barriers a step), each element's subtractions in the
//     plain version's order;
//   * kRowChunk rows of the panel below the diagonal block at a time: row
//     r of L21 depends only on L11 and its own row, so four threads of a
//     warp own a row (columns j = q mod 4 each) and walk its columns in
//     order, four at a time, with no block barrier: element j takes
//     c[r][j] -= L[r][p] L[o + j][p] for p = 0..j-1 in order, as
//     panel_factor_forward_step's rank-1 updates do, then the scale by
//     the pivot's guarded rsqrt (0 for a deficient pivot);
//   * the trailing update of the rows and columns >= o + bs, lower
//     triangle only, in staged 64 x 64 tiles summed over the panel's
//     columns in order (tile_loops.cuh);
//   * the back substitution over the slabs in reverse, left-looking: z of
//     the slab's rows takes the already-solved rows below through the
//     slab's columns, then its (bs x bs) diagonal block is solved.
// The reference's double-buffered panel carry and DMA semaphores hide
// latency on a TPU; here a slab is re-read from device memory or L2.
#pragma once

#include <cstddef>

#include "lane_common.cuh"
#include "tile_loops.cuh"

namespace repro_torch {

constexpr int kRowThreads = 4;  // threads of a warp that share a row of L21
constexpr int kRowChunk = kTileThreads / kRowThreads;  // rows of L21 a pass

struct TiledLayout {            // float offsets into dynamic shared memory
  int blk, inv, yb, yk, chunk, ych, red, total;
};

__host__ __device__ inline TiledLayout tiled_layout(int k, int bs) {
  TiledLayout l;
  const int pc = bs + 1;
  const int chunk = kRowChunk * (bs + kRowThreads);
  l.blk = 0;                    // bs * pc: the diagonal block, then L11
  l.inv = l.blk + bs * pc;      // bs: the pivots' guarded rsqrt
  l.yb = l.inv + bs;            // bs * k: the block's rows of y (z)
  l.yk = l.yb + bs * k;         // k: a solved row of the back-sub
  l.chunk = align4(l.yk + k);   // rows below the block (pitch bs + 4, so
                                // a warp's 8 rows x 4 columns fall in
                                // distinct banks), or tile staging
  l.ych = l.chunk + (chunk > kTileSmemFloats ? chunk : kTileSmemFloats);
  l.red = l.ych + kRowChunk * k;  // 32: reduction scratch
  l.total = l.red + 32;
  return l;
}

// The right-looking factor with the forward substitution fused in.
//   a  n x n row-major, device memory; lower triangle valid, L on return
//   y  n x k row-major, device memory; forward-solved in place
// A pivot at or below thresh takes the rank-deficient path: unit
// diagonal, zeroed column below it, zeroed solution component.
__device__ inline void tiled_factor(float* a, float* y, int n, int k, int bs,
                                    float thresh, float* smem) {
  const TiledLayout L = tiled_layout(k, bs);
  float* blk = smem + L.blk;
  float* inv = smem + L.inv;
  float* yb = smem + L.yb;
  float* ch = smem + L.chunk;
  float* ych = smem + L.ych;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int pc = bs + 1;
  const size_t ld = n;
  for (int o = 0; o < n; o += bs) {
    // ---- the diagonal block (lower part) and its rows of y ----
    for (int e = tid; e < bs * bs; e += nt) {
      const int r = e / bs;
      const int jj = e % bs;
      blk[r * pc + jj] = jj <= r ? a[(o + r) * ld + o + jj] : 0.0f;
    }
    for (int e = tid; e < bs * k; e += nt) yb[e] = y[o * static_cast<size_t>(k) + e];
    __syncthreads();
    // ---- bs fused factor + forward steps on the block, four columns a
    //      step: (A) one thread finishes the 4 x 4 corner (pivots, their
    //      columns inside it, its rows of y), (B) each row below takes its
    //      four elements and its y row in order, (C) the rank-4 update of
    //      the block's trailing triangle, each element's four subtractions
    //      in order ----
    for (int j = 0; j < bs; j += kRowThreads) {
      const int w = min(kRowThreads, bs - j);
      if (tid == 0) {
        for (int u = 0; u < w; ++u) {
          const int g = j + u;
          const float piv = blk[g * pc + g];
          const bool ok = piv > thresh;
          const float iv = ok ? rsqrtf(fmaxf(piv, thresh)) : 0.0f;
          inv[g] = iv;
          blk[g * pc + g] = ok ? piv * iv : 1.0f;
          for (int v = u + 1; v < w; ++v) blk[(j + v) * pc + g] *= iv;
          for (int v = u + 1; v < w; ++v)
            for (int x = u + 1; x <= v; ++x)
              blk[(j + v) * pc + j + x] -=
                  blk[(j + v) * pc + g] * blk[(j + x) * pc + g];
          for (int q = 0; q < k; ++q) {
            const float yg = yb[g * k + q] * iv;
            yb[g * k + q] = yg;
            for (int v = u + 1; v < w; ++v)
              yb[(j + v) * k + q] -= blk[(j + v) * pc + g] * yg;
          }
        }
      }
      __syncthreads();
      for (int r = j + w + tid; r < bs; r += nt) {
        float l[kRowThreads];
#pragma unroll
        for (int u = 0; u < kRowThreads; ++u) {
          if (u < w) {
            float f = blk[r * pc + j + u];
#pragma unroll
            for (int p = 0; p < u; ++p) f -= l[p] * blk[(j + u) * pc + j + p];
            l[u] = f * inv[j + u];
            blk[r * pc + j + u] = l[u];
          }
        }
        for (int q = 0; q < k; ++q) {
          float y0 = yb[r * k + q];
#pragma unroll
          for (int u = 0; u < kRowThreads; ++u)
            if (u < w) y0 -= l[u] * yb[(j + u) * k + q];
          yb[r * k + q] = y0;
        }
      }
      __syncthreads();
      for (int r = j + w + (tid >> 4); r < bs; r += 16) {
        float lr[kRowThreads];
#pragma unroll
        for (int u = 0; u < kRowThreads; ++u)
          lr[u] = u < w ? blk[r * pc + j + u] : 0.0f;
        for (int x = j + w + (tid & 15); x <= r; x += 16) {
          float c = blk[r * pc + x];
#pragma unroll
          for (int u = 0; u < kRowThreads; ++u)
            if (u < w) c -= lr[u] * blk[x * pc + j + u];
          blk[r * pc + x] = c;
        }
      }
      __syncthreads();
    }
    for (int e = tid; e < bs * bs; e += nt) {
      const int r = e / bs;
      const int jj = e % bs;
      if (jj <= r) a[(o + r) * ld + o + jj] = blk[r * pc + jj];
    }
    for (int e = tid; e < bs * k; e += nt) y[o * static_cast<size_t>(k) + e] = yb[e];
    // ---- the panel rows below the block (L21) and their rows of y ----
    const int cp = bs + kRowThreads;
    const int rr = tid / kRowThreads;   // this thread's row of the chunk
    const int q0 = tid % kRowThreads;   // and its first column
    for (int r0 = o + bs; r0 < n; r0 += kRowChunk) {
      const int nr = min(kRowChunk, n - r0);
      __syncthreads();          // the previous chunk's readers are done
      for (int e = tid; e < nr * bs; e += nt) {
        const int i = e / bs;
        const int jj = e % bs;
        ch[i * cp + jj] = a[(r0 + i) * ld + o + jj];
      }
      for (int e = tid; e < nr * k; e += nt) ych[e] = y[r0 * static_cast<size_t>(k) + e];
      __syncthreads();
      // every thread walks the columns, so a warp's barriers stay whole.
      // Four columns a step: the four threads of a row finish columns
      // j..j+3 alike (c[j] is final when the step reads it), their owners
      // keep the finished values, and every column further right takes
      // the four subtractions in order; the scale by inv[j] follows the
      // walk.
      const bool live = rr < nr;
      float* c = ch + rr * cp;
      int j = 0;
      for (; j + kRowThreads <= bs; j += kRowThreads) {
        float l[kRowThreads], f[kRowThreads];
        if (live) {
#pragma unroll
          for (int u = 0; u < kRowThreads; ++u) f[u] = c[j + u];
#pragma unroll
          for (int u = 0; u < kRowThreads; ++u) {
#pragma unroll
            for (int p = 0; p < u; ++p)
              f[u] -= l[p] * blk[(j + u) * pc + j + p];
            l[u] = f[u] * inv[j + u];
          }
        }
        __syncwarp();
        if (live) {
          if (q0 > 0) c[j + q0] = f[q0];
          for (int jj = j + kRowThreads + q0; jj < bs; jj += kRowThreads) {
            float x = c[jj];
#pragma unroll
            for (int p = 0; p < kRowThreads; ++p)
              x -= l[p] * blk[jj * pc + j + p];
            c[jj] = x;
          }
        }
        __syncwarp();
      }
      for (; j < bs; ++j) {     // a width that is not a multiple of 4
        if (live) {
          const float l = c[j] * inv[j];
          const int jj0 = j + 1 + ((q0 - j - 1) % kRowThreads + kRowThreads)
                                      % kRowThreads;
          for (int jj = jj0; jj < bs; jj += kRowThreads)
            c[jj] -= l * blk[jj * pc + j];
        }
        __syncwarp();
      }
      __syncthreads();
      for (int e = tid; e < nr * bs; e += nt) {
        const int i = e / bs;
        const int jj = e % bs;
        const float l = ch[i * cp + jj] * inv[jj];
        ch[i * cp + jj] = l;
        a[(r0 + i) * ld + o + jj] = l;
      }
      __syncthreads();
      for (int e = tid; e < nr * k; e += nt) {
        const int i = e / k;
        const int q = e % k;
        float s = ych[e];
        for (int j = 0; j < bs; ++j) s -= ch[i * cp + j] * yb[j * k + q];
        y[(r0 + i) * static_cast<size_t>(k) + q] = s;
      }
    }
    // ---- trailing update: a[i][j] -= sum_p L[i][o + p] L[j][o + p] for
    //      o + bs <= j <= i, in 64 x 64 tiles over the lower triangle ----
    const int t0 = o + bs;
    const int tiles = ceil_div(n - t0, kTile);
    for (int ti = 0; ti < tiles; ++ti) {
      for (int tj = 0; tj <= ti; ++tj) {
        const int i0 = t0 + ti * kTile;
        const int j0 = t0 + tj * kTile;
        const auto la = [=](int p, int c) {
          return i0 + c < n ? a[(i0 + c) * ld + o + p] : 0.0f;
        };
        const auto lb = [=](int p, int c) {
          return j0 + c < n ? a[(j0 + c) * ld + o + p] : 0.0f;
        };
        float acc[4][4];
        tile_product<true, true>(acc, bs, la, lb, ch,
                                 ch + kDepthChunk * kTilePitch);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = tile_row(i0, u);
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int j = tile_col(j0, v);
            if (i < n && j <= i) a[i * ld + j] -= acc[u][v];
          }
        }
      }
    }
    __syncthreads();
  }
}

// The back substitution on U = L^T over the slabs in reverse: for the
// slab at columns o..o+bs, z[o + j] -= sum over rows r >= o + bs of
// L[r][o + j] z[r], then x[kk] = z[kk] / l[kk][kk], z[i < kk] -= l[kk][i]
// x[kk] inside the (bs x bs) diagonal block.  y holds x on return.
__device__ inline void tiled_backsub(const float* a, float* y, int n, int k,
                                     int bs, float* smem) {
  const TiledLayout L = tiled_layout(k, bs);
  float* blk = smem + L.blk;
  float* zt = smem + L.yb;
  float* xk = smem + L.yk;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int pc = bs + 1;
  const size_t ld = n;
  for (int o = n - bs; o >= 0; o -= bs) {
    for (int e = tid; e < bs * k; e += nt) {
      const int j = e / k;
      const int q = e % k;
      float s = 0.0f;
      for (int r = o + bs; r < n; ++r)
        s += a[r * ld + o + j] * y[r * static_cast<size_t>(k) + q];
      zt[e] = y[(o + j) * static_cast<size_t>(k) + q] - s;
    }
    for (int e = tid; e < bs * bs; e += nt) {
      const int r = e / bs;
      const int jj = e % bs;
      blk[r * pc + jj] = jj <= r ? a[(o + r) * ld + o + jj] : 0.0f;
    }
    __syncthreads();
    for (int kk = bs - 1; kk >= 0; --kk) {
      const float lkk = blk[kk * pc + kk];
      for (int q = tid; q < k; q += nt) xk[q] = zt[kk * k + q] / lkk;
      __syncthreads();
      for (int e = tid; e < (kk + 1) * k; e += nt) {
        const int i = e / k;
        const int q = e % k;
        zt[e] = i == kk ? xk[q] : zt[e] - blk[kk * pc + i] * xk[q];
      }
      __syncthreads();
    }
    for (int e = tid; e < bs * k; e += nt) y[o * static_cast<size_t>(k) + e] = zt[e];
    __syncthreads();
  }
}

}  // namespace repro_torch
