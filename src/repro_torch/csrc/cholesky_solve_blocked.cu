// K10: right-looking blocked fused SPD solve, a lane on a cluster.
//
// Replaces: src/repro/pipelines/cholesky_solve.py, cholesky_solve_blocked
// (_cholesky_solve_blocked_kernel, _panel_factor_forward_step), the TPU
// kernel whose (lanes, n / bs) grid walks panel steps in order ("arbitrary")
// with the matrix and right-hand sides resident in VMEM scratch: each step
// factors one bs-wide panel with the forward substitution fused in, then
// applies the panel to the trailing submatrix as one rank-bs SYRK; the back
// substitution on L^T follows the last panel.
//
// What bounds it on an H100: per lane n^3/3 + 2 n^2 k FLOPs and
// n (n + 1) / 2 + 2 n k floats in and out, a few microseconds of either at
// a carrier's width; what holds it back is the order: the panel's columns
// one after another, n / bs trailing updates and an n-step back
// substitution.  A lane at n = 256 is 256 KB, more than a CTA's shared
// memory, so the ordered grid axis becomes a loop inside the lane, which
// runs on the tiled Cholesky core (tiled_chol.cuh) on a thread-block
// cluster of C CTAs:
//   * the working matrix (the reference's a_scr) lives in a per-lane slice
//     of a device work buffer, lower triangle only; the first panel reads
//     A's lower triangle in place (nothing right of A's diagonal is read,
//     so garbage there cannot leak), and the right-hand sides are solved
//     in place in the output;
//   * tiled_factor: the panel's diagonal block factored in shared memory
//     by every rank, the rows of L21 and the trailing update's tiles dealt
//     to the ranks; each element of L and y takes the panel step's rank-1
//     updates in column order and the trailing update's sum over the
//     panel's columns, as the reference's blocked kernel does;
//   * tiled_backsub_chain: the back substitution in the order of the
//     reference's n-step chain (back_substitution_step), a slab's diagonal
//     block solved by every rank, the rows above taking its x dealt to the
//     ranks, one cluster barrier a slab.
// The plan (C, the product tile, shared memory) is
// pipelines/cholesky_solve.py's chol_tiled_plan(..., kernel
// "cholesky_solve_blocked"); every plan gives the same bits.  The threshold max(eps max diag A,
// 1e-30) comes from the raw diagonal.
#include <cstddef>
#include <cstdint>

#include "tiled_chol.cuh"

namespace repro_torch {
namespace {

template <bool kStamp, int kT>
__global__ void __launch_bounds__(kTcThreads, 2)
cholesky_solve_blocked_kernel(const float* __restrict__ A,
                              const float* __restrict__ B, float* X,
                              float* work, unsigned long long* stamps, int n,
                              int k, int bs, int c, float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  TiledLane<kStamp> ln(c);
  const TiledLayout L = tiled_layout(k, bs, kT, n > bs);
  const int tid = threadIdx.x;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* al = A + ln.lane * nn;
  float* a = work + ln.lane * nn;
  float* y = X + ln.lane * n * k;
  const bool vec4 = n % 4 == 0 && bs % 4 == 0;
  const bool a16 = vec4 && (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  for (int e = ln.cl.rank * kTcThreads + tid; e < n * k; e += kTcThreads * c)
    y[e] = B[ln.lane * n * k + e];
  float dmax = -INFINITY;       // every rank, from A's raw diagonal
  for (int i = tid; i < n; i += kTcThreads)
    dmax = nan_max(dmax, al[i * static_cast<size_t>(n) + i]);
  dmax = block_max(dmax, smem + L.red);
  const float thresh = isnan(dmax) ? NAN : fmaxf(eps * dmax, kPivotFloor);
  ln.cl.sync();
  ln.clk.mark(kTpLoad);
  tiled_factor<kT>(a, al, y, n, k, bs, thresh, vec4, a16, ln.cl, smem,
                   ln.clk, n > bs);
  tiled_backsub_chain<kT>(a, y, n, k, bs, vec4, ln.cl, smem, ln.clk);
  if (kStamp) ln.clk.write(stamps + ln.lane * kTiledStampWords);
}

template <bool kStamp>
int launch(const void* a, const void* b, void* x, void* work,
           unsigned long long* stamps, int batch, int n, int k, int bs,
           float eps, int c, int tile, int smem, void* stream) {
  if (!tiled_plan_ok(n, k, bs, c, tile, smem)) return cudaErrorInvalidValue;
  const auto kernel = tile == 128
                          ? cholesky_solve_blocked_kernel<kStamp, 128>
                          : cholesky_solve_blocked_kernel<kStamp, 64>;
  return cluster_launch(kernel, batch, c, kTcThreads, smem, stream,
                        static_cast<const float*>(a),
                        static_cast<const float*>(b), static_cast<float*>(x),
                        static_cast<float*>(work), stamps, n, k, bs, c, eps);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// a (batch, n, n), b (batch, n, k) -> x (batch, n, k), all float32;
// work: batch * n * n floats; n % bs == 0; the plan (c, tile, smem) must be
// chol_tiled_plan's formula.
int cholesky_solve_blocked_f32(const void* a, const void* b, void* x,
                               void* work, int batch, int n, int k, int bs,
                               float eps, int c, int tile, int smem,
                               void* stream) {
  return repro_torch::launch<false>(a, b, x, work, nullptr, batch, n, k, bs,
                                    eps, c, tile, smem, stream);
}

// The same solve with the phase stamps (phase_clock.cuh): stamps holds
// batch * kTiledStampWords words.  Only scripts/chol_tiled_phases.py
// launches it.
int cholesky_solve_blocked_phases_f32(const void* a, const void* b, void* x,
                                      void* work, void* stamps, int batch,
                                      int n, int k, int bs, float eps, int c,
                                      int tile, int smem, void* stream) {
  return repro_torch::launch<true>(
      a, b, x, work, static_cast<unsigned long long*>(stamps), batch, n, k,
      bs, eps, c, tile, smem, stream);
}

// cudaOccupancyMaxActiveClusters of the served instance of a plan.
int cholesky_solve_blocked_clusters(int c, int tile, int smem) {
  using namespace repro_torch;
  const auto kernel = tile == 128 ? cholesky_solve_blocked_kernel<false, 128>
                                  : cholesky_solve_blocked_kernel<false, 64>;
  return cluster_occupancy(kernel, c, kTcThreads, smem);
}

}  // extern "C"
