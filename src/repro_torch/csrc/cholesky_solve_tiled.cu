// K12: slab-streamed right-looking fused SPD solve, a lane on a cluster.
//
// Replaces: src/repro/pipelines/cholesky_solve.py, cholesky_solve_tiled
// (_cholesky_solve_tiled_kernel, _tiled_factor_cell, _tiled_trailing_update,
// _tiled_backsub_cell), the TPU kernel whose (lanes, steps + 1, tiles) grid
// streams one (n x bs) column slab of an HBM-resident matrix through VMEM a
// cell: panel cells factor a slab with the forward substitution fused in,
// trailing cells apply the panel's rank-bs SYRK to the slabs to its right,
// and the last row of cells back-substitutes the slabs in reverse.
//
// What bounds it on an H100: per lane n^3/3 + 2 n^2 k FLOPs and
// n (n + 1) / 2 + 2 n k floats in and out.  At n = 512, bs = 128 one slab is
// 256 KB, more than a CTA's 227 KB of shared memory, so the ordered grid
// axes become loops inside the lane (tiled_chol.cuh): the first panel reads
// A's lower triangle (its upper triangle is never read) and the trailing
// update writes A less the panel's product into a per-lane work buffer
// where the later panels work, the right-hand sides are solved in place in
// the output, and only the panel's diagonal block, a chunk of the rows
// below it and the product tiles' stages pass through shared memory, whose
// size depends on bs, k and the tile alone: 102 KB at bs = 128, k = 2, so
// two CTAs share an SM (the kernel is held to 128 registers).  What holds it back is the
// order of the panels and, at the 32 lanes the HBM-scale mix serves, the
// SMs one CTA a lane leaves idle; so a lane runs on a thread-block cluster
// of C CTAs that deal the rows of L21, the trailing tiles and the back
// substitution's sums among them, and the products run in wide tiles
// staged by cp.async.  The plan (C, the tile, shared memory) is
// pipelines/cholesky_solve.py's chol_tiled_plan; every plan gives the same
// bits.  The threshold max(eps max diag A, 1e-30) comes from the raw
// diagonal, as the reference computes it outside its kernel.
#include <cstddef>
#include <cstdint>

#include "tiled_chol.cuh"

namespace repro_torch {
namespace {

template <bool kStamp, int kT>
__global__ void __launch_bounds__(kTcThreads, 2)
cholesky_solve_tiled_kernel(const float* __restrict__ A,
                            const float* __restrict__ B, float* X,
                            float* work, unsigned long long* stamps, int n,
                            int k, int bs, int c, float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  TiledLane<kStamp> ln(c);
  const TiledLayout L = tiled_layout(k, bs, kT);
  const int tid = threadIdx.x;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* al = A + ln.lane * nn;
  float* a = work + ln.lane * nn;
  float* y = X + ln.lane * n * k;
  // A is read in place: the first panel reads its lower triangle where
  // later panels read the work buffer (tiled_factor's a_in)
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
                   ln.clk);
  tiled_backsub<kT>(a, y, n, k, bs, vec4, ln.cl, smem, ln.clk);
  if (kStamp) ln.clk.write(stamps + ln.lane * kTiledStampWords);
}

template <bool kStamp>
int launch(const void* a, const void* b, void* x, void* work,
           unsigned long long* stamps, int batch, int n, int k, int bs,
           float eps, int c, int tile, int smem, void* stream) {
  if (!tiled_plan_ok(n, k, bs, c, tile, smem)) return cudaErrorInvalidValue;
  const auto kernel = tile == 128 ? cholesky_solve_tiled_kernel<kStamp, 128>
                                  : cholesky_solve_tiled_kernel<kStamp, 64>;
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
int cholesky_solve_tiled_f32(const void* a, const void* b, void* x,
                             void* work, int batch, int n, int k, int bs,
                             float eps, int c, int tile, int smem,
                             void* stream) {
  return repro_torch::launch<false>(a, b, x, work, nullptr, batch, n, k, bs,
                                    eps, c, tile, smem, stream);
}

// The same solve with the phase stamps (phase_clock.cuh): stamps holds
// batch * kTiledStampWords words.  Only scripts/chol_tiled_phases.py
// launches it.
int cholesky_solve_tiled_phases_f32(const void* a, const void* b, void* x,
                                    void* work, void* stamps, int batch,
                                    int n, int k, int bs, float eps, int c,
                                    int tile, int smem, void* stream) {
  return repro_torch::launch<true>(
      a, b, x, work, static_cast<unsigned long long*>(stamps), batch, n, k,
      bs, eps, c, tile, smem, stream);
}

// cudaOccupancyMaxActiveClusters of the served instance of a plan.
int cholesky_solve_tiled_clusters(int c, int tile, int smem) {
  using namespace repro_torch;
  const auto kernel = tile == 128 ? cholesky_solve_tiled_kernel<false, 128>
                                  : cholesky_solve_tiled_kernel<false, 64>;
  return cluster_occupancy(kernel, c, kTcThreads, smem);
}

}  // extern "C"
