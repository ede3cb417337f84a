// K10: right-looking blocked fused SPD solve, one CTA per lane.
//
// Replaces: src/repro/pipelines/cholesky_solve.py, cholesky_solve_blocked
// (_cholesky_solve_blocked_kernel, _panel_factor_forward_step), the TPU
// kernel whose (lanes, n / bs) grid walks panel steps in order ("arbitrary")
// with the matrix and right-hand sides resident in VMEM scratch: each step
// factors one bs-wide panel with the forward substitution fused in, then
// applies the panel to the trailing submatrix as one rank-bs SYRK; the back
// substitution on L^T follows the last panel.
//
// What bounds it on an H100: per lane n^3/3 + 2 n^2 m FLOPs and
// n (n + 1) / 2 + 2 n m floats in and out, a few microseconds of either at
// a carrier's width; what holds it back is the order: 2 bs barrier-
// separated steps per panel, n / bs SYRK phases and n back-substitution
// steps.  A lane at n = 256 is 256 KB, more than a CTA's shared memory, so
// the ordered grid axis becomes a loop inside one CTA per lane and:
//   * the working matrix (the reference's a_scr) lives in a per-lane slice
//     of a device work buffer, lower triangle only (the upper half of A is
//     never loaded, so garbage there cannot leak);
//   * the (n x bs) panel is staged in shared memory (pitch bs + 1, so a
//     warp's rows fall in distinct banks) with y, and every panel step
//     touches only shared memory;
//   * the SYRK is computed in the kernel with f32 FMAs from the panel in
//     shared memory onto the trailing lower triangle in device memory (the
//     chain never reads the upper half), each output summed in panel-column
//     order, in 4 x 4 register tiles (8 shared loads per 16 FMAs).
#include <cstddef>

#include "lane_common.cuh"
#include "tile_loops.cuh"

namespace repro_torch {
namespace {

constexpr int kBlockedThreads = 256;

__global__ void __launch_bounds__(kBlockedThreads)
cholesky_solve_blocked_kernel(const float* __restrict__ A,
                              const float* __restrict__ B,
                              float* __restrict__ X, float* __restrict__ work,
                              int n, int m, int bs, float eps) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int pc = bs + 1;
  const size_t lane = blockIdx.x;
  float* c = smem;              // n * pc: the panel (rows o.. in use)
  float* y = c + n * pc;        // n * m
  float* col = y + n * m;       // n: the finished column of L
  float* yk = col + n;          // m: the finished solution row
  float* thresh_s = yk + m;     // 1
  float* a = work + lane * n * n;
  const float* al = A + lane * n * n;
  const float* bl = B + lane * n * m;
  for (int e = tid; e < n * n; e += nt)
    if (e % n <= e / n) a[e] = al[e];   // lower triangle only
  for (int e = tid; e < n * m; e += nt) y[e] = bl[e];
  if (tid == 0) *thresh_s = diag_threshold(al, n, n, eps, kPivotFloor);
  __syncthreads();
  const float thresh = *thresh_s;

  for (int o = 0; o < n; o += bs) {
    const int prows = n - o;
    // stage the panel: columns o..o+bs, rows o.., lower part (zero above)
    for (int e = tid; e < prows * bs; e += nt) {
      const int r = o + e / bs;
      const int jj = e % bs;
      c[r * pc + jj] = r >= o + jj ? a[r * n + o + jj] : 0.0f;
    }
    __syncthreads();
    for (int j = 0; j < bs; ++j) {
      // point + vector region: guarded rsqrt pivot, scaled column,
      // solution row g
      const int g = o + j;
      const float piv = c[g * pc + j];
      const bool ok = piv > thresh;
      const float inv = ok ? rsqrtf(fmaxf(piv, thresh)) : 0.0f;
      for (int r = g + tid; r < n; r += nt)
        col[r] = (r == g) ? (ok ? piv * inv : 1.0f) : c[r * pc + j] * inv;
      for (int q = tid; q < m; q += nt) yk[q] = y[g * m + q] * inv;
      __syncthreads();
      // rank-1 update of the remaining panel columns (their lower part),
      // column j of L stored, and the forward-substitution AXPY
      for (int r = g + tid; r < n; r += nt) {
        const float lr = col[r];
        c[r * pc + j] = lr;
        if (r == g) {
          for (int q = 0; q < m; ++q) y[g * m + q] = yk[q];
          continue;
        }
        const int jend = min(bs, r - o + 1);
        for (int jj = j + 1; jj < jend; ++jj)
          c[r * pc + jj] -= lr * col[o + jj];
        for (int q = 0; q < m; ++q) y[r * m + q] -= lr * yk[q];
      }
      __syncthreads();
    }
    // the panel's columns of L back to the work buffer, and the rank-bs
    // SYRK onto the trailing lower triangle (rows, columns >= o + bs)
    for (int e = tid; e < prows * bs; e += nt) {
      const int r = o + e / bs;
      const int jj = e % bs;
      if (r >= o + jj) a[r * n + o + jj] = c[r * pc + jj];
    }
    // SYRK tiles: a thread sums a 4 x 4 block of outputs, each over the
    // panel columns in order; a warp takes 4 x 8 blocks (16 rows x 32
    // columns), so its row and column loads fall in distinct banks
    // (pitch bs + 1) or are broadcasts.  The block and warp-tile counts
    // round up, so the tiles cover a trailing block of any size: rows
    // past n are loaded from row n - 1 and never stored.
    const int t0 = o + bs;
    const int nb = ceil_div(n - t0, 4);
    const int si = ceil_div(nb, 4);
    const int sj = ceil_div(nb, 8);
    const int warp = tid >> 5;
    const int lid = tid & 31;
    for (int st = warp; st < si * sj; st += nt >> 5) {
      const int bi = (st / sj) * 4 + (lid >> 3);
      const int bj = (st % sj) * 8 + (lid & 7);
      if (bi >= nb || bj > bi) continue;
      const int i0 = t0 + 4 * bi;
      const int j0 = t0 + 4 * bj;
      float s[4][4] = {};
      for (int p = 0; p < bs; ++p) {
        float x[4], w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          x[r] = c[min(i0 + r, n - 1) * pc + p];
          w[r] = c[min(j0 + r, n - 1) * pc + p];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) s[r][q] += x[r] * w[q];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (i0 + r < n && j0 + q <= i0 + r)
            a[(i0 + r) * n + j0 + q] -= s[r][q];
    }
    __syncthreads();
  }

  // back substitution on U = L^T: x[k] = y[k] / l[k][k];
  // y[j < k] -= l[k][j] * x[k]  (row k of L, left of the diagonal)
  for (int k = n - 1; k >= 0; --k) {
    const float lkk = a[k * n + k];
    for (int q = tid; q < m; q += nt) yk[q] = y[k * m + q] / lkk;
    __syncthreads();
    for (int e = tid; e < (k + 1) * m; e += nt) {
      const int i = e / m;
      const int q = e % m;
      if (i == k)
        y[e] = yk[q];
      else
        y[e] -= a[k * n + i] * yk[q];
    }
    __syncthreads();
  }
  float* xl = X + lane * n * m;
  for (int e = tid; e < n * m; e += nt) xl[e] = y[e];
}

size_t smem_bytes(int n, int m, int bs) {
  return sizeof(float) *
         (static_cast<size_t>(n) * (bs + 1) + n * m + n + m + 1);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

size_t cholesky_solve_blocked_smem(int n, int m, int bs) {
  return repro_torch::smem_bytes(n, m, bs);
}

// a (batch, n, n), b (batch, n, m) -> x (batch, n, m), all float32;
// work: batch * n * n floats; n % bs == 0.
int cholesky_solve_blocked_f32(const void* a, const void* b, void* x,
                               void* work, int batch, int n, int m, int bs,
                               float eps, void* stream) {
  using namespace repro_torch;
  const size_t smem = smem_bytes(n, m, bs);
  cudaError_t err = allow_smem(cholesky_solve_blocked_kernel, smem);
  if (err != cudaSuccess) return err;
  cholesky_solve_blocked_kernel<<<batch, kBlockedThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(x), static_cast<float*>(work), n, m, bs, eps);
  return cudaGetLastError();
}

}  // extern "C"
