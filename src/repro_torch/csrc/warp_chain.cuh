// The fused Cholesky chain of one lane on one warp: K2's, K3's, K5's and
// K6's warp forms (n <= 32; K3's 2n x 2n real embedding takes two rows a
// thread).
//
// The lane's system lives in its CTA's shared memory, row-major
// at a pitch 4 modulo 8 (warp_pitch), so that the threads, which each own
// whole rows, read and write 16 bytes of eight rows in distinct banks at
// every pass of their walk.  Thread t owns row t and, past 32
// rows, row rows - 1 - t (warp_row): at step k the longest row left is
// the only bound on a thread's trailing update, rows - 1 - k elements,
// the least any schedule of whole rows can take.  A step is ordered by
// one __syncwarp, never a block barrier, and no shuffle (warp_factor):
// the owners publish the step's raw column, pivot and solution row to the
// warp's scratch; after the __syncwarp every thread takes the guarded
// rsqrt and col[j] = a[j][k] * inv itself, scales its rows' column-k
// elements, updates its right-hand sides (held in registers) and
// subtracts col[i] * col[j] from its rows for j = k+1 .. i, each pass's
// loads ahead of the last pass's stores.
//
// Every element keeps the expressions and order of chol_chain
// (lane_common.cuh): the same selects of the pivot guard, the threshold
// of diag_threshold (max is exact, so its reduction order is free; a NaN
// on the diagonal gives a NaN threshold), the same roundings (col[j] is
// one rounded product wherever it is taken), the same contractions and
// the same division by l[k][k] in back substitution.  So a warp form
// gives the CTA form's bits.
//
// warp_equalize is K2's lane on the warp (K2's warp form, and K6's second
// stage on the H its first stage made): the Gram's lower tiles and the
// matched filter, then the chain with the symbols in registers.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "lane_common.cuh"

namespace repro_torch {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpMaxRhs = 8;       // right-hand sides held in registers

// Row ``slot`` of thread t in a lane of ``rows`` rows (-1: none).
__device__ __forceinline__ int warp_row(int rows, int t, int slot) {
  if (slot == 0) return t < rows ? t : -1;
  const int r = rows - 1 - t;
  return r >= 32 ? r : -1;
}

// The thread that owns row r.
__device__ __forceinline__ int warp_owner(int rows, int r) {
  return r < 32 ? r : rows - 1 - r;
}

// diag_threshold over the rows the warp owns, every thread the answer.
template <int kSlots>
__device__ __forceinline__ float warp_threshold(const float* a, int pitch,
                                                int rows, float eps) {
  const int t = threadIdx.x & 31;
  float dmax = -INFINITY;
  bool nan = false;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int r = warp_row(rows, t, s);
    if (r >= 0) {
      const float d = a[r * pitch + r];
      nan |= isnan(d);
      dmax = fmaxf(dmax, d);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    dmax = fmaxf(dmax, __shfl_xor_sync(kFullMask, dmax, off));
  nan = __any_sync(kFullMask, nan);
  return nan ? NAN : fmaxf(eps * dmax, kPivotFloor);
}

// The row pitch of a lane's system: a multiple of 4 past rows + 3, so
// that a 16-byte pass of the walk never leaves its row, and 4 modulo 8,
// so that eight consecutive rows' 16-byte loads fall in distinct banks.
__host__ __device__ constexpr int warp_pitch(int rows) {
  return (rows + 7) / 8 * 8 + 4;
}

// The stride of a raw column in the scratch (16-byte passes past rows).
__host__ __device__ constexpr int warp_raw_stride(int rows) {
  return (rows + 3) / 4 * 4 + 4;
}

// Floats of the shared scratch warp_factor and warp_back take: the raw
// column of a step and its pivot, and the solution row of a step, each
// twice (the steps alternate between the two).
__host__ __device__ constexpr int warp_scratch_floats(int rows, int nrhs) {
  return 2 * warp_raw_stride(rows) + 2 + 2 * nrhs;
}

// x - c * col elementwise, one FFMA each: a pass of the walk, col[j] =
// raw[j] * inv taken beforehand as one rounded product, as
// factor_forward_step's.
__device__ __forceinline__ float4 walk4(float4 x, float4 col, float c) {
  return make_float4(x.x - c * col.x, x.y - c * col.y, x.z - c * col.z,
                     x.w - c * col.w);
}

// Guarded factor of a (rows x rows, pitch, lower triangle) with the
// forward substitution of the kK-column register rows y (the first nrhs
// columns live) interleaved, as factor_forward_step.  One __syncwarp a
// step and no shuffle: before it, the owners publish the step's column
// unscaled, its pivot a[k][k] and its solution row y[k] into scratch
// (warp_scratch_floats, two buffers in turn); after it every thread takes
// the guarded rsqrt and each col[j] = a[j][k] * inv itself (the same
// roundings as one thread's), scales its rows' column-k elements and
// walks its rows.  dinv (optional): each step's rsqrt, for a solve after
// the factor.  Ends on a __syncwarp: L and dinv are the warp's to read.
//
// zs (optional, kSlots = 1): mz more right-hand-side columns held in shared
// memory, a row a thread (row pitch ldz, a multiple of 4, 16-byte
// aligned).  Each step every thread takes y[k] = z[k] * inv from row k as
// its owner left it and updates its own row in 16-byte passes; row k
// itself is scaled by its rsqrt only once the factor is done (its last
// forward update), so nobody reads a row while its owner writes it.
template <int kSlots, int kK>
__device__ __forceinline__ void warp_factor(float* a, int pitch, int rows,
                                            float thresh, float* scratch,
                                            float* dinv,
                                            float (&y)[kSlots][kK],
                                            int nrhs, float* zs = nullptr,
                                            int ldz = 0, int mz = 0) {
  const int t = threadIdx.x & 31;
  const int stride = warp_raw_stride(rows);
  float* raw = scratch;                  // 2 x stride
  float* piv = scratch + 2 * stride;     // 2
  float* ypub = piv + 2;                 // 2 x nrhs
  int r[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    r[s] = warp_row(rows, t, s);
    if (r[s] >= 0) raw[r[s]] = a[r[s] * pitch];
  }
  if (t == 0) {
    piv[0] = a[0];
#pragma unroll
    for (int q = 0; q < kK; ++q)
      if (q < nrhs) ypub[q] = y[0][q];
  }
  __syncwarp();
  for (int k = 0; k < rows; ++k) {
    const int b = k & 1;
    const float* rk = raw + b * stride;
    const float akk = piv[b];
    const bool ok = akk > thresh;
    const float inv = ok ? rsqrtf(fmaxf(akk, thresh)) : 0.0f;
    if (dinv != nullptr && t == 0) dinv[k] = inv;
    float c[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      c[s] = 0.0f;
      if (r[s] >= k) {
        c[s] = (r[s] == k) ? (ok ? akk * inv : 1.0f) : rk[r[s]] * inv;
        a[r[s] * pitch + k] = c[s];
      }
    }
#pragma unroll
    for (int q = 0; q < kK; ++q) {
      if (q < nrhs) {
        const float yk = ypub[b * nrhs + q] * inv;
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          if (r[s] == k)
            y[s][q] = yk;
          else if (r[s] > k)
            y[s][q] -= c[s] * yk;
        }
      }
    }
    if (zs != nullptr && r[0] > k) {
      const float* zk = zs + k * ldz;
      float* zr = zs + r[0] * ldz;
      float4 v = *reinterpret_cast<const float4*>(zk);
      float4 w = *reinterpret_cast<const float4*>(zr);
      for (int q = 0; q < mz; q += 4) {
        const float4 yk = make_float4(v.x * inv, v.y * inv, v.z * inv,
                                      v.w * inv);
        const float4 nw = walk4(w, yk, c[0]);
        if (q + 4 < mz) {
          v = *reinterpret_cast<const float4*>(zk + q + 4);
          w = *reinterpret_cast<const float4*>(zr + q + 4);
        }
        *reinterpret_cast<float4*>(zr + q) = nw;
      }
    }
    // trailing update of this thread's rows, j = k+1 .. row: the longer
    // row's walk carries the shorter's (both take col[j]), 16 bytes of
    // each a pass from the aligned column at or below k+1 (the first
    // pass keeps the columns up to k), each pass's loads issued ahead of
    // the last pass's stores; columns past a row's end are its padding
    const bool two = kSlots > 1 && r[kSlots - 1] > k;
    const int rl = two ? r[kSlots - 1] : r[0];
    const bool live = two && r[0] > k;
    const float cl = two ? c[kSlots - 1] : c[0];
    const float cs = c[0];
    if (rl > k) {
      float* pl = a + rl * pitch;
      float* ps = a + (live ? r[0] : rl) * pitch;
      int j0 = (k + 1) & ~3;
      float4 rw = *reinterpret_cast<const float4*>(rk + j0);
      float4 al = *reinterpret_cast<const float4*>(pl + j0);
      float4 as = *reinterpret_cast<const float4*>(ps + j0);
      while (true) {
        const float4 col = make_float4(rw.x * inv, rw.y * inv, rw.z * inv,
                                       rw.w * inv);
        float4 nl = walk4(al, col, cl);
        float4 ns = walk4(as, col, cs);
        if (j0 <= k) {                   // the first pass: keep j <= k
          if (j0 + 0 <= k) nl.x = al.x, ns.x = as.x;
          if (j0 + 1 <= k) nl.y = al.y, ns.y = as.y;
          if (j0 + 2 <= k) nl.z = al.z, ns.z = as.z;
        }
        const int j1 = j0 + 4;
        if (j1 <= rl) {
          rw = *reinterpret_cast<const float4*>(rk + j1);
          al = *reinterpret_cast<const float4*>(pl + j1);
          as = *reinterpret_cast<const float4*>(ps + j1);
        }
        *reinterpret_cast<float4*>(pl + j0) = nl;
        if (live) *reinterpret_cast<float4*>(ps + j0) = ns;
        if (j1 > rl) break;
        j0 = j1;
      }
    }
    // publish step k + 1: its column as the walk left it, its pivot and
    // its solution row
    if (k + 1 < rows) {
      float* rn = raw + (b ^ 1) * stride;
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        if (r[s] > k) rn[r[s]] = a[r[s] * pitch + k + 1];
      if (t == warp_owner(rows, k + 1)) {
        piv[b ^ 1] = a[(k + 1) * pitch + k + 1];
#pragma unroll
        for (int q = 0; q < kK; ++q)
          if (q < nrhs)
            ypub[(b ^ 1) * nrhs + q] = k + 1 < 32 ? y[0][q] : y[kSlots - 1][q];
      }
    }
    __syncwarp();
  }
  if (zs != nullptr && r[0] >= 0) {      // each row's last forward update
    const float v = dinv[r[0]];
    float* zr = zs + r[0] * ldz;
    for (int q = 0; q < mz; ++q) zr[q] = zr[q] * v;
  }
  __syncwarp();
}

// Back substitution on L^T for the kK-column register rows y, as
// back_substitution_step: the owner of row k publishes y[k] (scratch, two
// buffers in turn), every thread divides it by l[k][k] itself, and the
// rows above take row k of L; one __syncwarp a step.
template <int kSlots, int kK>
__device__ __forceinline__ void warp_back(const float* a, int pitch, int rows,
                                          float* scratch,
                                          float (&y)[kSlots][kK], int nrhs) {
  const int t = threadIdx.x & 31;
  int r[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) r[s] = warp_row(rows, t, s);
  if (t == warp_owner(rows, rows - 1)) {
#pragma unroll
    for (int q = 0; q < kK; ++q)
      if (q < nrhs) scratch[q] = rows - 1 < 32 ? y[0][q] : y[kSlots - 1][q];
  }
  __syncwarp();
  for (int k = rows - 1; k >= 0; --k) {
    const int b = (rows - 1 - k) & 1;
    const float lkk = a[k * pitch + k];
    float lk[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      lk[s] = (r[s] >= 0 && r[s] < k) ? a[k * pitch + r[s]] : 0.0f;
#pragma unroll
    for (int q = 0; q < kK; ++q) {
      if (q < nrhs) {
        const float xk = scratch[b * nrhs + q] / lkk;
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          if (r[s] == k)
            y[s][q] = xk;
          else if (r[s] >= 0 && r[s] < k)
            y[s][q] -= lk[s] * xk;
        }
      }
    }
    if (k > 0 && t == warp_owner(rows, k - 1)) {
#pragma unroll
      for (int q = 0; q < kK; ++q)
        if (q < nrhs)
          scratch[(b ^ 1) * nrhs + q] = k - 1 < 32 ? y[0][q] : y[kSlots - 1][q];
    }
    __syncwarp();
  }
}

// z1[i] -= w[i * lw] * s1 and z2[i] -= w[i * lw] * s2 (row pitch ldz) for
// i in [lo, hi): four rows a pass, one load of w for both columns, each
// pass's loads issued ahead of the last pass's stores.  z2 == z1 with
// two = false updates one column.
__device__ __forceinline__ void column_pass(float* z1, float* z2, bool two,
                                            int ldz, const float* w, int lw,
                                            int lo, int hi, float s1,
                                            float s2) {
  float v1[4], v2[4], wv[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = lo + u;
    v1[u] = i < hi ? z1[i * ldz] : 0.0f;
    v2[u] = i < hi ? z2[i * ldz] : 0.0f;
    wv[u] = i < hi ? w[i * lw] : 0.0f;
  }
  for (int i0 = lo; i0 < hi; i0 += 4) {
    float n1[4], n2[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      n1[u] = v1[u] - wv[u] * s1;
      n2[u] = v2[u] - wv[u] * s2;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + 4 + u;
      v1[u] = i < hi ? z1[i * ldz] : 0.0f;
      v2[u] = i < hi ? z2[i * ldz] : 0.0f;
      wv[u] = i < hi ? w[i * lw] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i0 + u < hi) {
        z1[(i0 + u) * ldz] = n1[u];
        if (two) z2[(i0 + u) * ldz] = n2[u];
      }
    }
  }
}

// Back substitution on L^T of right-hand-side columns held in shared
// memory (z, n x m, row pitch ldz), as back_substitution_step, after the
// forward substitution: two columns a thread, x[k] = y[k] / l[k][k],
// the row above taken first into a register, so a step waits on one
// division and one FFMA.
__device__ __forceinline__ void warp_columns_back(const float* a, int pitch,
                                                  int n, float* z, int ldz,
                                                  int m) {
  for (int c = threadIdx.x & 31; c < m; c += 64) {
    float* z1 = z + c;
    const bool two = c + 32 < m;
    float* z2 = two ? z1 + 32 : z1;
    float next1 = z1[(n - 1) * ldz];
    float next2 = z2[(n - 1) * ldz];
    for (int k = n - 1; k >= 0; --k) {
      const float* lk = a + k * pitch;
      const float x1 = next1 / lk[k];
      const float x2 = next2 / lk[k];
      z1[k * ldz] = x1;
      if (two) z2[k * ldz] = x2;
      if (k > 0) {
        next1 = z1[(k - 1) * ldz] - lk[k - 1] * x1;
        next2 = z2[(k - 1) * ldz] - lk[k - 1] * x2;
      }
      column_pass(z1, z2, two, ldz, lk, 1, 0, k - 1, x1, x2);
    }
  }
}

// A 4 x 4 tile of row products, acc[q * 4 + w] += x[(i0 + q) * ldx + t] *
// y[(j0 + w) * ldy + t] for t = 0, 1, ... < len in order (from acc = 0,
// the sums of the CTA forms' Gram loops; a sum staged in chunks of t
// continues in the same order).  Rows past ni / nj are read at the last
// row (their sums are never stored).
__device__ __forceinline__ void row_tile(const float* x, int ldx, int i0,
                                         int ni, const float* y, int ldy,
                                         int j0, int nj, int len,
                                         float (&acc)[16]) {
  const float* xr[4];
  const float* yr[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    xr[q] = x + min(i0 + q, ni - 1) * ldx;
    yr[q] = y + min(j0 + q, nj - 1) * ldy;
  }
#pragma unroll 2
  for (int t = 0; t < len; ++t) {
    float xv[4], yv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      xv[q] = xr[q][t];
      yv[q] = yr[q][t];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int w = 0; w < 4; ++w) acc[q * 4 + w] += xv[q] * yv[w];
  }
}

// A 4 x 4 tile of column products, acc[q * 4 + w] += x[t * ldx + i0 + q] *
// y[t * ldy + j0 + w] for t = 0, 1, ... < len in order, a 16-byte slice of
// row t of each (ldx, ldy, i0 and j0 multiples of 4, the slices within
// the rows' padding): the sums of the CTA forms' Gram loops over a
// row-major H, one FFMA each.
__device__ __forceinline__ void col_tile(const float* x, int ldx, int i0,
                                         const float* y, int ldy, int j0,
                                         int len, float (&acc)[16]) {
  const float* xr = x + i0;
  const float* yr = y + j0;
#pragma unroll 2
  for (int t = 0; t < len; ++t) {
    const float4 xv = *reinterpret_cast<const float4*>(xr + t * ldx);
    const float4 yv = *reinterpret_cast<const float4*>(yr + t * ldy);
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
    const float ys[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int w = 0; w < 4; ++w) acc[q * 4 + w] += xs[q] * ys[w];
  }
}

// Copies rows x len floats of device memory (row pitch spitch, len by
// default) into the warp's shared memory at row `pitch` by cp.async, every
// copy of a thread in flight at once; stage_wait() ends them for the warp.
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           float* dst, int rows, int len,
                                           int pitch, int spitch = -1) {
  if (spitch < 0) spitch = len;
  for (int r = 0; r < rows; ++r)
    for (int c = threadIdx.x & 31; c < len; c += 32) {
      const unsigned d = static_cast<unsigned>(
          __cvta_generic_to_shared(dst + r * pitch + c));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                   "l"(src + r * spitch + c)
                   : "memory");
    }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// The (i, j) tile of unit u of a lower triangle of T x T tiles.
__device__ __forceinline__ void tri_tile(int u, int& i, int& j) {
  i = 0;
  while ((i + 1) * (i + 2) / 2 <= u) ++i;
  j = u - i * (i + 1) / 2;
}

// K2's chain on the warp, from H (m x n) in shared memory: the lower 4 x 4
// tiles of G = H^T H + sigma2 I (at most two a thread) written into a
// (n x pitch), the matched filter of thread t's row, H^T y, into y, then
// the guarded factor with the forward substitution and the back
// substitution, the k <= kK symbols in registers; on return y[0][c] is
// row t of x.  H is read as it arrives, row-major (kHt = false: h is m x n
// at ldh, each Gram tile a 16-byte slice of a row, col_tile), or as its
// transpose Z = H^T (kHt = true: h is n x m at ldh, row_tile; K6's first
// stage leaves Z so).  yv: the m x k symbols at row pitch k.  Every sum
// runs over r = 0 .. m-1 in order, one FFMA each, as the CTA form's.  The
// clock marks phase0 (the Gram and filter), phase0 + 1 (the factor) and
// phase0 + 2 (the back substitution).
template <int kK, bool kHt, class Clock>
__device__ __forceinline__ void warp_equalize(const float* h, int ldh,
                                              const float* yv, float* a,
                                              int pitch, float* scratch,
                                              int n, int m, int k,
                                              float sigma2, float eps,
                                              float (&y)[1][kK], Clock& clk,
                                              int phase0) {
  const int t = threadIdx.x & 31;
  const int tiles = (n + 3) / 4;
  const int units = tiles * (tiles + 1) / 2;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int u = t + 32 * s;
    if (u >= units) continue;
    int i0, j0;
    tri_tile(u, i0, j0);
    float acc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0.0f;
    if (kHt)
      row_tile(h, ldh, 4 * i0, n, h, ldh, 4 * j0, n, m, acc);
    else
      col_tile(h, ldh, 4 * i0, h, ldh, 4 * j0, m, acc);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int i = 4 * i0 + q;
        const int j = 4 * j0 + v;
        if (i < n && j <= i) {
          const float g = acc[q * 4 + v];
          a[i * pitch + j] = (i == j) ? g + sigma2 : g;
        }
      }
  }
#pragma unroll
  for (int c = 0; c < kK; ++c) {
    y[0][c] = 0.0f;
    if (t >= n || c >= k) continue;
    float s = 0.0f;
    for (int r = 0; r < m; ++r)
      s += (kHt ? h[t * ldh + r] : h[r * ldh + t]) * yv[r * k + c];
    y[0][c] = s;
  }
  __syncwarp();
  clk.mark(phase0);
  warp_factor<1, kK>(a, pitch, n, warp_threshold<1>(a, pitch, n, eps),
                     scratch, nullptr, y, k);
  clk.mark(phase0 + 1);
  warp_back<1, kK>(a, pitch, n, scratch, y, k);
  clk.mark(phase0 + 2);
}

// A warp form's kernel attributes, set once an instance: the shared
// memory carve-out at its most, so that an SM holds as many lanes as its
// shared memory allows, and the 227 KB a CTA may opt into.
template <auto kKernel>
inline cudaError_t allow_warp_smem() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  }();
  return err;
}

}  // namespace repro_torch
