// K14: slab-streamed fused MMSE equalizer, one CTA per lane.
//
// Replaces: src/repro/pipelines/mmse.py, mmse_equalize_tiled
// (_mmse_tiled_kernel), the TPU kernel whose (lanes, 2 steps + 1, tiles)
// grid first builds the lower (bs x bs) blocks of G = H^T H + sigma2 I
// from pairs of (m x bs) channel slabs into an HBM work buffer, with the
// matched filter H_r^T y and the running maximum of G's diagonal beside
// the diagonal blocks, then runs the tiled Cholesky's panel, trailing and
// back-substitution cells over that buffer.
//
// What bounds it on an H100: per lane m n (n + 1) + 2 m n k FLOPs for the
// Gram and the matched filter (the lower triangle of G only) on top of the
// tiled solve's n^3/3 + 2 n^2 k, and m n + m k + n k floats in and out.
// The Gram is computed in the kernel, in staged 64 x 64 tiles over the
// lower triangle streaming row chunks of H (tile_loops.cuh), each sum over
// H's rows in order, sigma2 added to the diagonal after the sum; only the
// lower triangle of the work buffer is written, and the factor never reads
// above it.  Then K12's phases (tiled_chol.cuh) run over G with the
// threshold max(eps max diag G, 1e-30).  The CTA's shared memory depends
// on bs and k alone, as K12's.
#include <cstddef>

#include "tiled_chol.cuh"

namespace repro_torch {
namespace {

__global__ void __launch_bounds__(kTileThreads, 2)
mmse_equalize_tiled_kernel(const float* __restrict__ H,
                           const float* __restrict__ Y, float* X,
                           float* work, int m, int n, int k, int bs,
                           float sigma2, float eps) {
  extern __shared__ float smem[];
  const TiledLayout L = tiled_layout(k, bs);
  float* stage = smem + L.chunk;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t lane = blockIdx.x;
  const size_t ld = n;
  const float* h = H + lane * m * ld;
  const float* yl = Y + lane * m * k;
  float* g = work + lane * ld * n;
  float* z = X + lane * n * k;
  // ---- Gram: the lower 64 x 64 tiles of G = H^T H + sigma2 I ----
  const int tiles = ceil_div(n, kTile);
  for (int ti = 0; ti < tiles; ++ti) {
    for (int tj = 0; tj <= ti; ++tj) {
      const int i0 = ti * kTile;
      const int j0 = tj * kTile;
      const auto la = [=](int p, int c) {
        return i0 + c < n ? h[p * ld + i0 + c] : 0.0f;
      };
      const auto lb = [=](int p, int c) {
        return j0 + c < n ? h[p * ld + j0 + c] : 0.0f;
      };
      float acc[4][4];
      tile_product<false, false>(acc, m, la, lb, stage,
                                 stage + kDepthChunk * kTilePitch);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = tile_row(i0, u);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int j = tile_col(j0, v);
          if (i < n && j <= i)
            g[i * ld + j] = i == j ? acc[u][v] + sigma2 : acc[u][v];
        }
      }
    }
  }
  // ---- matched filter z = H^T y, each sum over H's rows in order ----
  for (int e = tid; e < n * k; e += nt) {
    const int i = e % n;
    const int q = e / n;
    float s = 0.0f;
    for (int p = 0; p < m; ++p) s += h[p * ld + i] * yl[p * static_cast<size_t>(k) + q];
    z[i * static_cast<size_t>(k) + q] = s;
  }
  __syncthreads();
  // ---- threshold from G's diagonal (the reference's running maximum
  //      starts at 0) ----
  float dmax = 0.0f;
  for (int i = tid; i < n; i += nt) dmax = nan_max(dmax, g[i * ld + i]);
  dmax = block_max(dmax, smem + L.red);
  const float thresh = isnan(dmax) ? NAN : fmaxf(eps * dmax, kPivotFloor);
  tiled_factor(g, z, n, k, bs, thresh, smem);
  tiled_backsub(g, z, n, k, bs, smem);
}

size_t smem_bytes(int k, int bs) {
  return sizeof(float) * static_cast<size_t>(tiled_layout(k, bs).total);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// Independent of m and n: H and G stream through device memory.
size_t mmse_equalize_tiled_smem(int m, int n, int k, int bs) {
  (void)m;
  (void)n;
  return repro_torch::smem_bytes(k, bs);
}

// h (batch, m, n) with m >= n, y (batch, m, k) -> x (batch, n, k), float32;
// work: batch * n * n floats; n % bs == 0.
int mmse_equalize_tiled_f32(const void* h, const void* y, void* x,
                            void* work, int batch, int m, int n, int k,
                            int bs, float sigma2, float eps, void* stream) {
  using namespace repro_torch;
  const size_t smem = smem_bytes(k, bs);
  cudaError_t err = allow_smem(mmse_equalize_tiled_kernel, smem);
  if (err != cudaSuccess) return err;
  mmse_equalize_tiled_kernel<<<batch, kTileThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(y),
      static_cast<float*>(x), static_cast<float*>(work), m, n, k, bs,
      sigma2, eps);
  return cudaGetLastError();
}

}  // extern "C"
