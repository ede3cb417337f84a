// The large-n Householder least squares of K11 and K13 on a thread-block
// cluster: one lane (an m x n matrix A, m x k right-hand sides B) spread
// over a cluster of C = 1, 2, 4 or 8 CTAs on neighbouring SMs, which read
// each other's shared memory (distributed shared memory, DSMEM) and meet
// at the cluster's hardware barrier.
//
// The algorithm is the reference's compact-WY blocked Householder QR with
// Q^T b applied on the way (qr_solve_blocked / qr_solve_tiled): per panel
// of bs columns, bs reflectors built from and applied to the panel only,
// T from V^T V (LAPACK larft, forward), the block reflector I - V T^T V^T
// on the trailing columns and on y; then the back substitution on R[:n,
// :n] against the threshold max(1e-6 max |diag R|, tiny), a NaN on the
// diagonal propagating into it.  Q is never formed.
//
// The layout of a lane:
//   * [R | y] is one m x (n + k) row-major matrix in the lane's device
//     work buffer.  R's columns are dealt to the cluster's CTAs in blocks
//     of kQcCols columns, block q to rank q % C (block-cyclic, so each
//     rank's share of the trailing update stays even as the panels move
//     right); y goes to rank ceil(n / kQcCols) % C, the next in the cycle.
//   * The panel's rows o..m-1 are cut into groups of G rows (G = 32 up to
//     m = 2048, qc_group_rows) and the groups into one contiguous band a
//     rank (qc_band_rows), in the rank's shared memory (column-major, so
//     a lane's rows are consecutive words) or, where the plan says so, in
//     the work buffer (row-major, so a warp's 32 columns of a row
//     coalesce; the template's kBandsInWork).  The two band forms differ
//     in addresses and in how the product tiles fetch V, never in
//     arithmetic: the same operations on the same values.
//   * Each reflector's sums over rows are summed a group at a time, a
//     lane's serial FFMA chain over the group's rows, and the groups'
//     partials are added in ascending order by every rank from the owners'
//     exchange slots (DSMEM).  No sum depends on C or on which rank holds
//     a group, so every cluster size and both band forms give the same
//     bits.
//   * Per reflector j: gather its partials (column norms below the head,
//     the dot products with the panel's columns to its right) and the
//     head row; every thread derives alpha, v's head, tau and w =
//     tau v^T P itself; then one pass, a warp a row group and 32 columns,
//     a lane a column walking the group's rows: the columns right of j + 1
//     take the reflector, column j + 1's new values are computed by every
//     lane from its old ones (its owner keeps them in a side column, so
//     the column is never written while it is read), and the same pass
//     sums reflector j + 1's partials.  One block barrier and one cluster
//     barrier a reflector (a block barrier where C = 1: the cluster
//     barrier costs ~900 cycles even on one CTA).
//   * V^T V is built in staged 64 x 64 product tiles (tile_loops.cuh)
//     dealt to the ranks, reading V from the bands through DSMEM, a warp's
//     loads on 32 consecutive words of a band column (DSMEM moves
//     scattered words several times slower); every rank reads the tiles
//     it did not make and builds T itself (for a panel of 64-128 by
//     halves: both diagonal blocks at once, then the corner);
//     then each rank applies the block reflector to the columns it owns
//     (W = V^T C, W = T^T W in place, the last rows first, C -= V W, in
//     product tiles), and y's owner to y by matrix-vector products.
//   * The back substitution, on y's owner: blocks of 32 rows of R, the
//     last first; a block's 32 x 32 diagonal block is staged in shared
//     memory and solved by a warp a right-hand side (a lane a row, x
//     handed on by __shfl_sync, no block barrier), then the rows above
//     take the block's products in one pass, each in descending column
//     order.
//
// What bounds it on an H100: per lane 2 (m n^2 - n^3/3) + 4 m n k FLOPs
// and m n + m k + n k floats in and out; what holds it back is the order
// of the reflectors.  The plan (qr_cluster_plan in pipelines/qr_solve.py)
// picks C and the bands' place from the batch and the clusters the card
// holds at once (qc_max_clusters).
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

namespace qc_cg = cooperative_groups;

constexpr int kQcThreads = kTileThreads;   // 256: tile_product's block
constexpr int kQcWarps = kQcThreads / 32;
constexpr int kQcCols = 64;                // a column block
constexpr int kQcMaxCluster = 8;
constexpr int kQcMaxGroups = 64;           // row groups of a panel, at most
constexpr int kQcMaxPanel = kQcThreads;    // a thread a panel column
constexpr int kGather = 16;                // partials a thread has in flight

// Rows of a group: 32, or a multiple of it that keeps the groups <= 64.
__host__ __device__ inline int qc_group_rows(int m) {
  return 32 * ceil_div(ceil_div(m, 32), kQcMaxGroups);
}

// Groups a rank holds of the first (tallest) panel.
__host__ __device__ inline int qc_rank_groups(int m, int c) {
  return ceil_div(ceil_div(m, qc_group_rows(m)), c);
}

// A rank's band: bs + 2 columns (the panel's, then two slots for v's next
// column) of this many words, one more than its rows, so that in shared
// memory (column-major) a warp's lanes on 32 columns of one row hit 32
// banks; in the work buffer the same floats hold it row-major.
__host__ __device__ inline int qc_band_rows(int m, int c) {
  return qc_rank_groups(m, c) * qc_group_rows(m) + 1;
}

struct QcLayout {               // float offsets into dynamic shared memory
  int stage, t, w, vd, taus, dsum, prow, exch, band, total;
};

__host__ __device__ inline QcLayout qc_layout(int m, int bs, int c,
                                              bool band_shared) {
  QcLayout l;
  const int gpr = qc_rank_groups(m, c);
  l.stage = 0;                              // the product tiles' staging
  l.t = kTileSmemFloats;                    // bs (bs + 1): T, V^T V
  l.w = l.t + bs * (bs + 1);                // bs x 64: W of the apply
  l.vd = l.w + bs * kQcCols;                // bs: v's heads
  l.taus = l.vd + bs;                       // bs
  l.dsum = l.taus + bs;                     // bs: a reflector's sums
  l.prow = l.dsum + bs;                     // bs: its head row
  l.exch = l.prow + bs;                     // 2 x (gpr + 1) x bs
  l.band = l.exch + 2 * (gpr + 1) * bs;
  l.total = l.band + (band_shared ? (bs + 2) * qc_band_rows(m, c) : 0);
  return l;
}

// Floats of a lane's device work buffer: [R | y], then the bands unless
// they are in shared memory (rounded up to 16 bytes a lane).
__host__ __device__ inline size_t qc_work_floats(int m, int n, int k, int bs,
                                                 int c, bool band_shared) {
  const size_t bands = band_shared ? 0
                                   : static_cast<size_t>(c) * (bs + 2) *
                                         qc_band_rows(m, c);
  return align4(align4(m * (n + k)) + bands);
}

// Whether (c, band_shared, smem) is a plan the kernel takes.
inline bool qc_plan_ok(int m, int n, int k, int bs, int c, int band_shared,
                       int smem) {
  if (!(m >= n && n >= 1 && k >= 1 && bs >= 1 && bs <= kQcMaxPanel &&
        n % bs == 0))
    return false;
  if (!(c == 1 || c == 2 || c == 4 || c == 8)) return false;
  const QcLayout l = qc_layout(m, bs, c, band_shared);
  return smem == static_cast<int>(sizeof(float)) * l.total;
}

template <bool kStamp, bool kBandsInWork>
__device__ inline void qr_cluster_solve(const float* __restrict__ A,
                                        const float* __restrict__ B,
                                        float* __restrict__ X, float* work,
                                        unsigned long long* stamps, int m,
                                        int n, int k, int bs, int C,
                                        float tiny, float* smem) {
  constexpr bool band_shared = !kBandsInWork;
  __shared__ float* s_band[kQcMaxCluster];
  __shared__ float* s_exch[kQcMaxCluster];
  __shared__ float* s_group[kQcMaxGroups];  // a group's first band row
  __shared__ float* s_part[kQcMaxGroups];   // a group's exchange slot
  qc_cg::cluster_group cl = qc_cg::this_cluster();
  const int rank = C > 1 ? static_cast<int>(cl.block_rank()) : 0;
  const size_t lane = blockIdx.x / C;
  PhaseClock<kStamp> clk(rank == 0);
  const auto csync = [&]() {
    if (C > 1)
      cl.sync();
    else
      __syncthreads();
  };
  const int tid = threadIdx.x;
  const int lid = tid & 31;
  const int warp = tid >> 5;
  const int G = qc_group_rows(m);
  const int gpr = qc_rank_groups(m, C);
  const QcLayout L = qc_layout(m, bs, C, band_shared);
  const int pc = bs + 1;                    // T's pitch
  const int vslot = bs;                     // the band's two v slots
  const int rp = qc_band_rows(m, C);        // a band column's words
  // band element (p, c) at c * cs + p * ps: column-major in shared memory,
  // row-major in the work buffer (a warp's 32 columns of a row coalesce)
  const int cs = kBandsInWork ? 1 : rp;
  const int ps = kBandsInWork ? bs + 2 : 1;
  const int nk = n + k;
  const int nblk = ceil_div(n, kQcCols);
  const int yowner = nblk % C;
  const int xstride = (gpr + 1) * bs;       // an exchange buffer
  float* t = smem + L.t;
  float* wbuf = smem + L.w;
  float* vd = smem + L.vd;
  float* taus = smem + L.taus;
  float* dsum = smem + L.dsum;
  float* prow = smem + L.prow;
  float* stage = smem + L.stage;
  float* lwork = work + lane * qc_work_floats(m, n, k, bs, C, band_shared);
  if (tid < C) {
    const auto map = [&](float* p) {
      return C > 1 ? cl.map_shared_rank(p, tid) : p;
    };
    s_band[tid] = band_shared ? map(smem + L.band)
                              : lwork + align4(m * nk) +
                                    static_cast<size_t>(tid) * (bs + 2) * rp;
    s_exch[tid] = map(smem + L.exch);
  }
  const int ypitch = nk;
  csync();                      // every rank running, the tables filled
  // R[row][c] in the work buffer
  const auto relem = [&](int row, int c) -> float* {
    return lwork + static_cast<size_t>(row) * nk + c;
  };
  float* const y = lwork + n;

  // ---- load: each rank its own blocks of A, y's owner B ----
  for (int q = rank; q < nblk; q += C) {
    const int c0 = q * kQcCols;
    const int cw = min(kQcCols, n - c0);
    for (int e = tid; e < m * cw; e += kQcThreads) {
      const int i = e / cw;
      const int c = e % cw;
      *relem(i, c0 + c) =
          A[lane * m * n + static_cast<size_t>(i) * n + c0 + c];
    }
  }
  if (rank == yowner)
    for (int e = tid; e < m * k; e += kQcThreads)
      y[(e / k) * ypitch + e % k] = B[lane * m * k + e];
  float dmax = 0.0f;            // max |diag R|, the same in every thread
  csync();
  clk.mark(kPhaseLoad);

  for (int o = 0; o < n; o += bs) {
    // ---- the panel's bands: rows o + p, p in [p_lo, p_hi) on this rank ----
    const int pr = m - o;
    const int ngp = ceil_div(pr, G);
    const int gprp = ceil_div(ngp, C);
    const int rpr = gprp * G;
    const int p_lo = rank * rpr;
    const int p_hi = min(pr, p_lo + rpr);
    const int g_lo = rank * gprp;
    const int g_hi = min(ngp, g_lo + gprp);
    float* band = s_band[rank];
    float* exch = smem + L.exch;
    if (tid < ngp) {            // each group's band rows and partials
      const int r = tid / gprp;
      s_group[tid] = s_band[r] + (tid - r * gprp) * G * ps;
      s_part[tid] = s_exch[r] + (tid - r * gprp) * bs;
    }
    for (int e = tid; e < (p_hi - p_lo) * bs; e += kQcThreads) {
      const int p = e / bs;
      const int c = e % bs;
      band[c * cs + p * ps] = *relem(o + p_lo + p, o + c);
    }
    __syncthreads();
    // V[p][col] of the panel (panel-relative row p), from its band
    const auto vget = [&](int p, int col) -> float {
      if (p < col) return 0.0f;
      if (p == col) return vd[col];
      const int gi = G == 32 ? p >> 5 : p / G;
      return s_group[gi][col * cs + (p - gi * G) * ps];
    };

    // Reflector j's pass, a warp a (row group, 32 columns), a lane a
    // column c >= j + 1 walking the group's rows: the columns right of
    // j + 1 take reflector j (head vg; w from tau, dsum, prow); column
    // j + 1's new values u are computed by every lane from its old ones
    // (so nobody writes it while it is read: its owner keeps them in
    // slot column vslot + (j + 1) % 2, v_{j+1} for the next pass, and
    // copies v_j from slot vslot + j % 2 into column j); and the same pass
    // sums reflector j + 1's partials (rows p > j + 1 of u times each
    // column c >= j + 1) into exchange buffer (j + 1) & 1 and its head row
    // into that buffer's row slot.  j = -1 is the first pass: no
    // reflector, column 0 as it is.  The band is column-major, so a lane's
    // rows are consecutive words.
    const auto pass = [&](int j, float vg, float tau) {
      const int jn = j + 1;
      const bool update = j >= 0;
      const int nqc = ceil_div(bs - jn, 32);
      const int g0 = max(g_lo, max(j, 0) / G);
      float* xb = exch + (jn & 1) * xstride;
      float* colu = band + jn * cs;                       // column jn
      const float* colv = band + (vslot + (j & 1)) * cs;  // v_j (j >= 0)
      float* coln = band + (vslot + (jn & 1)) * cs;       // u's slot
      float* colj = band + max(j, 0) * cs;
      const float w1 = update ? tau * (vg * prow[jn] + dsum[jn]) : 0.0f;
      for (int task = warp; task < (g_hi - g0) * nqc; task += kQcWarps) {
        const int gi = g0 + task / nqc;
        const int c = jn + (task % nqc) * 32 + lid;
        if (c >= bs) continue;
        const bool own = c == jn;
        float* colc = band + c * cs;
        // column jn takes w1, so its x is u, bit for bit
        const float w = !update ? 0.0f
                        : own   ? w1
                                : tau * (vg * prow[c] + dsum[c]);
        const int r1 = min(pr, gi * G + G) - p_lo;   // band rows
        int pl = max(gi * G, max(j, 0)) - p_lo;
        float d = 0.0f;
        // the head rows j and j + 1
        for (; pl < r1 && pl + p_lo <= jn; ++pl) {
          const int p = pl + p_lo;
          const float v = update && p > j ? colv[pl * ps] : vg;
          float x = colc[pl * ps];
          if (update) x -= v * w;
          if (own) {
            if (p == j) {
              colu[pl * ps] = x;                   // R[j][j + 1]
            } else {
              coln[pl * ps] = x;
              if (update) colj[pl * ps] = v;
            }
          } else if (update) {
            colc[pl * ps] = x;
          }
          if (p == jn) xb[gpr * bs + c] = x;  // the row slot
        }
        // the rows below, eight rows' loads before their FMAs; every lane
        // stores its x (column jn's owner to its slot; the first pass
        // stores the others' unchanged), so the warp does not diverge
        float* dst = own ? coln : colc;
        const bool copy_v = own && update;
        for (; pl + 8 <= r1; pl += 8) {
          float x[8], u[8], v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            x[i] = colc[(pl + i) * ps];
            u[i] = colu[(pl + i) * ps];
            v[i] = update ? colv[(pl + i) * ps] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            u[i] -= v[i] * w1;
            x[i] -= v[i] * w;
            dst[(pl + i) * ps] = x[i];
            if (copy_v) colj[(pl + i) * ps] = v[i];
            d += u[i] * x[i];
          }
        }
        for (; pl < r1; ++pl) {
          const float v = update ? colv[pl * ps] : 0.0f;
          const float u = colu[pl * ps] - v * w1;
          const float x = colc[pl * ps] - v * w;
          dst[pl * ps] = x;
          if (copy_v) colj[pl * ps] = v;
          d += u * x;
        }
        xb[(gi - g_lo) * bs + c] = d;
      }
    };
    pass(-1, 0.0f, 0.0f);
    csync();

    for (int j = 0; j < bs; ++j) {
      // gather reflector j's partials in ascending group order (kGather
      // groups' loads in flight: a DSMEM load takes ~230 cycles), and its
      // head row from the row's owner
      if (tid < bs - j) {
        const int jj = j + tid;
        const int gstart = (j + 1) / G;
        const int buf = (j & 1) * xstride + jj;
        float s = 0.0f;
        for (int g0 = gstart; g0 < ngp; g0 += kGather) {
          float part[kGather];
#pragma unroll
          for (int i = 0; i < kGather; ++i)
            part[i] = g0 + i < ngp ? s_part[g0 + i][buf] : 0.0f;
#pragma unroll
          for (int i = 0; i < kGather; ++i)
            if (g0 + i < ngp) s += part[i];
        }
        dsum[jj] = s;
        prow[jj] = s_exch[j / rpr][(j & 1) * xstride + gpr * bs + jj];
      }
      __syncthreads();
      clk.mark(kPhaseGather);
      // householder region, the same in every thread of every rank
      const float tail = dsum[j];
      const float xk = prow[j];
      const float norm = sqrtf(tail + xk * xk);
      const float alpha = xk >= 0.0f ? -norm : norm;
      const float vg = xk - alpha;
      const float vnorm2 = fmaxf(tail + vg * vg, tiny);
      const float tau = norm < tiny ? 0.0f : 2.0f / vnorm2;
      const float rdiag = xk - vg * (tau * (vg * xk + tail));
      dmax = nan_max(dmax, fabsf(rdiag));
      if (tid == 0) {
        vd[j] = vg;
        taus[j] = tau;
        if (j >= p_lo && j < p_hi) band[j * cs + (j - p_lo) * ps] = rdiag;
      }
      if (j + 1 == bs) break;
      pass(j, vg, tau);
      if (kStamp) __syncthreads();    // the pass's end, for the stamp
      clk.mark(kPhaseDots);
      csync();
    }
    // v_{bs-1} from its slot into column bs - 1
    for (int p = max(bs, p_lo) + tid; p < p_hi; p += kQcThreads)
      band[(bs - 1) * cs + (p - p_lo) * ps] =
          band[(vslot + ((bs - 1) & 1)) * cs + (p - p_lo) * ps];
    csync();                    // every band final
    clk.mark(kPhasePanel);

    // R's rows o..o+bs-1 of the panel (upper triangle) to R's blocks
    for (int e = tid; e < (min(p_hi, bs) - p_lo) * bs; e += kQcThreads) {
      const int p = p_lo + e / bs;
      const int c = e % bs;
      if (c >= p) *relem(o + p, o + c) = band[c * cs + (p - p_lo) * ps];
    }
    // ---- V^T V (strict upper, stored transposed in t), its 64 x 64
    // tiles dealt to the ranks; then each rank reads the tiles others made
    const int vt_tiles = ceil_div(bs, kTile);
    for (int ti = 0, idx = 0; ti < vt_tiles; ++ti) {
      for (int tj = ti; tj < vt_tiles; ++tj, ++idx) {
        if (idx % C != rank) continue;
        const int i0 = ti * kTile;
        const int j0 = tj * kTile;
        const auto la = [&](int p, int c) {
          return i0 + c < bs ? vget(p, i0 + c) : 0.0f;
        };
        const auto lb = [&](int p, int c) {
          return j0 + c < bs ? vget(p, j0 + c) : 0.0f;
        };
        float acc[4][4];
        tile_product<!kBandsInWork, !kBandsInWork>(acc, pr, la, lb, stage,
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
    if (C > 1) {
      csync();
      for (int ti = 0, idx = 0; ti < vt_tiles; ++ti) {
        for (int tj = ti; tj < vt_tiles; ++tj, ++idx) {
          if (idx % C == rank) continue;
          const float* src = cl.map_shared_rank(t, idx % C);
          for (int e = tid; e < kTile * kTile; e += kQcThreads) {
            const int jc = tj * kTile + e / kTile;
            const int i = ti * kTile + e % kTile;
            if (i < jc && jc < bs) t[jc * pc + i] = src[jc * pc + i];
          }
        }
      }
    }
    __syncthreads();
    // T (LAPACK larft, forward): for bs of 64 to 128 by halves, T =
    // [[T1, -T1 (V1^T V2) T2], [0, T2]], T1 and T2 built at once column
    // by column by the two halves of the block (T[:j, j] = -tau_j T[:j,
    // :j] (V^T v_j)[:j], T[j, j] = tau_j, a thread a row), the corner by
    // two product tiles; otherwise column by column over the whole panel
    const int h = bs >= 64 && bs <= 2 * kTile ? bs / 2 : bs;
    {
      const int half = h < bs ? kQcThreads / 2 : kQcThreads;
      const int part = tid / half;               // 0: T1 (or all of T)
      const int b0 = part ? h : 0;               // the block's first column
      const int bn = part ? bs - h : h;          // and its width
      for (int jl = 0; jl < max(h, bs - h); ++jl) {
        if (jl < bn) {
          const int j = b0 + jl;
          const float tau_j = taus[j];
          for (int i = b0 + tid - part * half; i < j; i += half) {
            float s = 0.0f;
            for (int l = i; l < j; ++l) s += t[i * pc + l] * t[j * pc + l];
            t[i * pc + j] = -tau_j * s;
          }
          if (tid == part * half) t[j * pc + j] = tau_j;
        }
        __syncthreads();
      }
    }
    if (h < bs) {
      // M = (V1^T V2) T2 into W, then T12 = -T1 M
      const auto lg = [&](int l, int c) {        // (V^T V)[c][h + l]
        return c < h ? t[(h + l) * pc + c] : 0.0f;
      };
      const auto lt2 = [&](int l, int c) {       // T2[l][c]
        return c < bs - h && l <= c ? t[(h + l) * pc + h + c] : 0.0f;
      };
      float acc[4][4];
      tile_product<false, false>(acc, bs - h, lg, lt2, stage,
                                 stage + kDepthChunk * kTilePitch);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = tile_row(0, u);
          const int c = tile_col(0, v);
          if (i < h && c < bs - h) wbuf[i * kQcCols + c] = acc[u][v];
        }
      __syncthreads();
      const auto lt1 = [&](int l, int c) {       // T1[c][l]
        return c < h && l >= c ? t[c * pc + l] : 0.0f;
      };
      const auto lm = [&](int l, int c) {
        return c < bs - h ? wbuf[l * kQcCols + c] : 0.0f;
      };
      tile_product<false, false>(acc, h, lt1, lm, stage,
                                 stage + kDepthChunk * kTilePitch);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = tile_row(0, u);
          const int c = tile_col(0, v);
          if (i < h && c < bs - h) t[i * pc + h + c] = -acc[u][v];
        }
      __syncthreads();
    }
    clk.mark(kPhaseVt);

    // ---- the block reflector on this rank's columns right of the panel,
    // and on y at its owner: C -= V (T^T (V^T C)) ----
    const auto apply = [&](auto celem, int c0, int cw) {
      // W = V^T C, 64 reflectors a tile
      for (int p0 = 0; p0 < bs; p0 += kTile) {
        const auto lv = [&](int p, int cc) {
          return p0 + cc < bs ? vget(p, p0 + cc) : 0.0f;
        };
        const auto lc = [&](int p, int cc) {
          return cc < cw ? *celem(o + p, c0 + cc) : 0.0f;
        };
        float acc[4][4];
        tile_product<!kBandsInWork, false>(acc, pr, lv, lc, stage,
                                  stage + kDepthChunk * kTilePitch);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int p = tile_row(p0, u);
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int q = tile_col(0, v);
            if (p < bs && q < cw) wbuf[p * kQcCols + q] = acc[u][v];
          }
        }
      }
      __syncthreads();
      // W = T^T W in place, 64 rows a tile, the last tile first: rows p of
      // T^T W read W's rows l <= p only (T upper), so each tile reads
      // rows no later tile overwrites
      for (int p0 = (ceil_div(bs, kTile) - 1) * kTile; p0 >= 0; p0 -= kTile) {
        const auto lt = [&](int l, int cc) {
          return p0 + cc < bs && l <= p0 + cc ? t[l * pc + p0 + cc] : 0.0f;
        };
        const auto lw = [&](int l, int cc) {
          return cc < cw ? wbuf[l * kQcCols + cc] : 0.0f;
        };
        float acc[4][4];
        tile_product<false, false>(acc, min(bs, p0 + kTile), lt, lw, stage,
                                   stage + kDepthChunk * kTilePitch);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int p = tile_row(p0, u);
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int q = tile_col(0, v);
            if (p < bs && q < cw) wbuf[p * kQcCols + q] = acc[u][v];
          }
        }
        __syncthreads();
      }
      // C -= V W, 64 rows a tile
      for (int i0 = 0; i0 < pr; i0 += kTile) {
        const auto lv = [&](int p, int cc) {
          return i0 + cc < pr && p < bs ? vget(i0 + cc, p) : 0.0f;
        };
        const auto lw = [&](int p, int cc) {
          return cc < cw ? wbuf[p * kQcCols + cc] : 0.0f;
        };
        float acc[4][4];
        tile_product<kBandsInWork, false>(acc, bs, lv, lw, stage,
                                   stage + kDepthChunk * kTilePitch);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = tile_row(i0, u);
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int q = tile_col(0, v);
            if (i < pr && q < cw) *celem(o + i, c0 + q) -= acc[u][v];
          }
        }
      }
      __syncthreads();
    };
    for (int q = rank; q < nblk; q += C) {
      const int c0 = max(q * kQcCols, o + bs);
      const int c1 = min(n, (q + 1) * kQcCols);
      if (c0 < c1) apply(relem, c0, c1 - c0);
    }
    // y, a column at a time as matrix-vector products: W = V^T y (a warp
    // a reflector, a lane every 32nd row, its sums added by a fixed
    // shuffle tree), W = T^T W (a thread a reflector), y -= V W (a thread
    // a row), each sum in one order whatever the cluster
    if (rank == yowner) {
      float* w1 = wbuf;
      float* w2 = wbuf + bs;
      for (int q = 0; q < k; ++q) {
        float* yq = y + o * ypitch + q;
        for (int p = warp; p < bs; p += kQcWarps) {
          float s = 0.0f;
          // four rows' loads (DSMEM for V) in flight before their FMAs
          for (int r0 = p + lid; r0 < pr; r0 += 4 * 32) {
            float v[4], yv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int row = r0 + 32 * i;
              v[i] = row < pr ? vget(row, p) : 0.0f;
              yv[i] = row < pr ? yq[row * ypitch] : 0.0f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (r0 + 32 * i < pr) s += v[i] * yv[i];
          }
          s = warp_sum(s);
          if (lid == 0) w1[p] = s;
        }
        __syncthreads();
        for (int p = tid; p < bs; p += kQcThreads) {
          float s = 0.0f;
          for (int l = 0; l <= p; ++l) s += t[l * pc + p] * w1[l];
          w2[p] = s;
        }
        __syncthreads();
        for (int row = tid; row < pr; row += kQcThreads) {
          const int np = min(bs, row + 1);
          float s = 0.0f;
          for (int p0 = 0; p0 < np; p0 += 8) {
            float v[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
              v[i] = p0 + i < np ? vget(row, p0 + i) : 0.0f;
#pragma unroll
            for (int i = 0; i < 8; ++i)
              if (p0 + i < np) s += v[i] * w2[p0 + i];
          }
          yq[row * ypitch] -= s;
        }
        __syncthreads();
      }
    }
    clk.mark(kPhaseApply);
    csync();                    // R, y final for the panel; bands free
  }

  // ---- back substitution on y's owner, blocks of 32 rows, last first ----
  if (rank == yowner) {
    const float thresh = isnan(dmax) ? NAN : fmaxf(1e-6f * dmax, tiny);
    float* db = stage;          // the block's 32 x 32 diagonal, pitch 33
    float* xl = X + lane * n * k;
    for (int k0 = (ceil_div(n, 32) - 1) * 32; k0 >= 0; k0 -= 32) {
      const int nb = min(32, n - k0);
      for (int e = tid; e < nb * nb; e += kQcThreads) {
        const int i = e / nb;
        const int c = e % nb;
        db[i * 33 + c] = c >= i ? *relem(k0 + i, k0 + c) : 0.0f;
      }
      __syncthreads();
      // a warp a right-hand side, a lane a row; x_c handed on by shuffle
      for (int q = warp; q < k; q += kQcWarps) {
        float z = lid < nb ? y[(k0 + lid) * ypitch + q] : 0.0f;
        for (int c = nb - 1; c >= 0; --c) {
          const float rcc = db[c * 33 + c];
          const float zc = __shfl_sync(0xffffffffu, z, c);
          const float xc = fabsf(rcc) > thresh ? zc / rcc : 0.0f;
          if (lid == c)
            z = xc;
          else if (lid < c)
            z -= db[lid * 33 + c] * xc;
        }
        if (lid < nb) {
          y[(k0 + lid) * ypitch + q] = z;
          xl[(k0 + lid) * k + q] = z;
        }
      }
      __syncthreads();
      // the rows above take the block's products, descending columns
      for (int e = tid; e < k0 * k; e += kQcThreads) {
        const int i = e / k;
        const int q = e % k;
        const float* ri = relem(i, k0);
        float acc = y[i * ypitch + q];
        for (int c0 = nb - 1; c0 >= 0; c0 -= 8) {
          float r[8], x[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int c = c0 - u;
            r[u] = c >= 0 ? ri[c] : 0.0f;
            x[u] = c >= 0 ? y[(k0 + c) * ypitch + q] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (c0 - u >= 0) acc -= r[u] * x[u];
        }
        y[i * ypitch + q] = acc;
      }
      __syncthreads();
    }
  }
  csync();                      // no rank leaves while its memory is read
  clk.mark(kPhaseBacksub);
  if (kStamp) clk.write(stamps + lane * kQrStampWords);
}

// The kernel of K11 (kMinBlocks = 2: two CTAs an SM where shared memory
// allows) and K13 (1); kStamp compiles the phase stamps in, kBandsInWork
// keeps the panel's bands in the work buffer.
template <bool kStamp, bool kBandsInWork, int kMinBlocks>
__global__ void __launch_bounds__(kQcThreads, kMinBlocks)
qr_cluster_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ X, float* work,
                  unsigned long long* stamps, int m, int n, int k, int bs,
                  int c, float tiny) {
  extern __shared__ float4 smem4[];
  qr_cluster_solve<kStamp, kBandsInWork>(A, B, X, work, stamps, m, n, k, bs,
                                         c, tiny,
                                         reinterpret_cast<float*>(smem4));
}

// One launch of qr_cluster_kernel on batch lanes of c CTAs each
// (cudaLaunchKernelEx with the cluster dimension), smem bytes of dynamic
// shared memory a CTA; refuses a plan off qc_plan_ok.
template <bool kStamp, int kMinBlocks>
inline int qc_launch(const void* a, const void* b, void* x, void* work,
                     unsigned long long* stamps, int batch, int m, int n,
                     int k, int bs, float tiny, int c, int band_shared,
                     int smem, void* stream) {
  if (!qc_plan_ok(m, n, k, bs, c, band_shared, smem))
    return cudaErrorInvalidValue;
  const auto kernel = band_shared
                          ? qr_cluster_kernel<kStamp, false, kMinBlocks>
                          : qr_cluster_kernel<kStamp, true, kMinBlocks>;
  return cluster_launch(kernel, batch, c, kQcThreads, smem, stream,
                        static_cast<const float*>(a),
                        static_cast<const float*>(b), static_cast<float*>(x),
                        static_cast<float*>(work), stamps, m, n, k, bs, c,
                        tiny);
}

// cudaOccupancyMaxActiveClusters of the served instance of a plan (c,
// band_shared, smem): how many clusters the card holds at once; -1 where
// the query fails.
template <int kMinBlocks>
inline int qc_max_clusters(int c, int band_shared, int smem) {
  const auto kernel = band_shared
                          ? qr_cluster_kernel<false, false, kMinBlocks>
                          : qr_cluster_kernel<false, true, kMinBlocks>;
  return cluster_occupancy(kernel, c, kQcThreads, smem);
}

}  // namespace repro_torch
