// K12: slab-streamed right-looking fused SPD solve, one CTA per lane.
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
// axes become loops inside one CTA per lane (tiled_chol.cuh): the lower
// triangle of A is copied into a per-lane work buffer (the upper triangle
// is never loaded), the right-hand sides are solved in place in the output,
// and only the panel's diagonal block, a chunk of the rows below it and
// the staged product tiles pass through shared memory.  The CTA's shared
// memory depends on bs and k alone: 102 KB at bs = 128, k = 2, for every n,
// and the kernel is held to 128 registers, so two CTAs share an SM.
// The threshold max(eps max diag A, 1e-30) comes from the raw diagonal, as
// the reference computes it outside its kernel.
#include <cstddef>

#include "tiled_chol.cuh"

namespace repro_torch {
namespace {

__global__ void __launch_bounds__(kTileThreads, 2)
cholesky_solve_tiled_kernel(const float* __restrict__ A,
                            const float* __restrict__ B, float* X,
                            float* work, int n, int k, int bs, float eps) {
  extern __shared__ float smem[];
  const TiledLayout L = tiled_layout(k, bs);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t lane = blockIdx.x;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* al = A + lane * nn;
  float* a = work + lane * nn;
  float* y = X + lane * n * k;
  for (int i = tid >> 5; i < n; i += nt >> 5)      // a warp a row
    for (int j = tid & 31; j <= i; j += 32)
      a[i * static_cast<size_t>(n) + j] = al[i * static_cast<size_t>(n) + j];
  for (int e = tid; e < n * k; e += nt) y[e] = B[lane * n * k + e];
  float dmax = -INFINITY;
  for (int i = tid; i < n; i += nt)
    dmax = nan_max(dmax, al[i * static_cast<size_t>(n) + i]);
  dmax = block_max(dmax, smem + L.red);
  const float thresh = isnan(dmax) ? NAN : fmaxf(eps * dmax, kPivotFloor);
  tiled_factor(a, y, n, k, bs, thresh, smem);
  tiled_backsub(a, y, n, k, bs, smem);
}

size_t smem_bytes(int k, int bs) {
  return sizeof(float) * static_cast<size_t>(tiled_layout(k, bs).total);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// Independent of n: the slabs stream through device memory.
size_t cholesky_solve_tiled_smem(int n, int k, int bs) {
  (void)n;
  return repro_torch::smem_bytes(k, bs);
}

// a (batch, n, n), b (batch, n, k) -> x (batch, n, k), all float32;
// work: batch * n * n floats; n % bs == 0.
int cholesky_solve_tiled_f32(const void* a, const void* b, void* x,
                             void* work, int batch, int n, int k, int bs,
                             float eps, void* stream) {
  using namespace repro_torch;
  const size_t smem = smem_bytes(k, bs);
  cudaError_t err = allow_smem(cholesky_solve_tiled_kernel, smem);
  if (err != cudaSuccess) return err;
  cholesky_solve_tiled_kernel<<<batch, kTileThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(x), static_cast<float*>(work), n, k, bs, eps);
  return cudaGetLastError();
}

}  // extern "C"
