// K14: slab-streamed fused MMSE equalizer, a lane on a cluster.
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
// tiled solve's n^3/3 + 2 n^2 k, and m n + m k + n k floats in and out;
// the Gram is three quarters of the FLOPs.  The Gram is computed in the
// kernel in wide product tiles over the lower triangle (tile_loops.cuh:
// kT x kT, H's rows staged by cp.async), each sum over H's rows in order,
// sigma2 added to the diagonal after the sum; only the lower triangle of
// the work buffer is written.  The lane runs on a thread-block cluster of
// C CTAs (tiled_chol.cuh): the Gram's tiles and the matched filter's
// elements are dealt to the ranks, then K12's phases run over G with the
// threshold max(eps max diag G, 1e-30).  The plan (C, the tile, shared
// memory) is pipelines/cholesky_solve.py's chol_tiled_plan; every plan
// gives the same bits, and the CTA's shared memory depends on bs, k and
// the tile alone, as K12's.
#include <cstddef>
#include <cstdint>

#include "tiled_chol.cuh"

namespace repro_torch {
namespace {

// One kT x kT tile of G = H^T H + sigma2 I at (i0, j0), each sum over H's
// rows in order, sigma2 added to the diagonal after the sum; lower
// triangle only.  Not inlined, so its registers (the tile's sums) are its
// own and not the whole kernel's.
template <int kT>
__device__ __noinline__ void gram_tile(float* g, const float* h, int n,
                                       int m, int i0, int j0, float sigma2,
                                       bool h16, float* stage) {
  const size_t ld = n;
  float acc[kT / 16][kT / 16];
  wide_product<kT>(acc, m, h + i0, n, n - i0, h + j0, n, n - j0, h16,
                   stage);
  const int ry = wide_ry();
  const int cx = wide_cx();
#pragma unroll
  for (int u = 0; u < kT / 16; ++u) {
    const int i = i0 + wide_off(ry, u);
#pragma unroll
    for (int v = 0; v < kT / 16; ++v) {
      const int j = j0 + wide_off(cx, v);
      if (i < n && j <= i)
        g[i * ld + j] = i == j ? acc[u][v] + sigma2 : acc[u][v];
    }
  }
}

template <bool kStamp, int kT>
__global__ void __launch_bounds__(kTcThreads, 2)
mmse_equalize_tiled_kernel(const float* __restrict__ H,
                           const float* __restrict__ Y, float* X,
                           float* work, unsigned long long* stamps, int m,
                           int n, int k, int bs, int c, float sigma2,
                           float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  TiledLane<kStamp> ln(c);
  const TiledLayout L = tiled_layout(k, bs, kT);
  float* stage = smem + L.chunk;
  const int tid = threadIdx.x;
  const size_t ld = n;
  const float* h = H + ln.lane * m * ld;
  const float* yl = Y + ln.lane * m * k;
  float* g = work + ln.lane * ld * n;
  float* z = X + ln.lane * n * k;
  const bool vec4 = n % 4 == 0 && bs % 4 == 0;   // the work buffer's rows
  const bool h16 = n % 4 == 0 && (reinterpret_cast<uintptr_t>(H) & 15) == 0;
  // ---- Gram: the lower kT x kT tiles of G = H^T H + sigma2 I, dealt ----
  const int tiles = ceil_div(n, kT);
  for (int ti = 0, idx = 0; ti < tiles; ++ti) {
    for (int tj = 0; tj <= ti; ++tj, ++idx) {
      if (idx % c != ln.cl.rank) continue;
      gram_tile<kT>(g, h, n, m, ti * kT, tj * kT, sigma2, h16, stage);
    }
  }
  if (kStamp) __syncthreads();
  ln.clk.mark(kTpGram);
  // ---- matched filter z = H^T y, each sum over H's rows in order, the
  //      elements dealt ----
  const int stride = kTcThreads * c;   // four elements a thread at once
  for (int e0 = ln.cl.rank * kTcThreads + tid; e0 < n * k;
       e0 += 4 * stride) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int i[4], q[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int e = min(e0 + g * stride, n * k - 1);
      i[g] = e % n;
      q[g] = e / n;
    }
    for (int p = 0; p < m; ++p) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        s[g] += h[p * ld + i[g]] * yl[p * static_cast<size_t>(k) + q[g]];
    }
#pragma unroll
    for (int g = 0; g < 4; ++g)
      if (e0 + g * stride < n * k) z[i[g] * static_cast<size_t>(k) + q[g]] = s[g];
  }
  ln.cl.sync();                 // G and z whole
  ln.clk.mark(kTpFilter);
  // ---- threshold from G's diagonal (the reference's running maximum
  //      starts at 0), every rank ----
  float dmax = 0.0f;
  for (int i = tid; i < n; i += kTcThreads)
    dmax = nan_max(dmax, __ldcg(g + i * ld + i));
  dmax = block_max(dmax, smem + L.red);
  const float thresh = isnan(dmax) ? NAN : fmaxf(eps * dmax, kPivotFloor);
  ln.clk.mark(kTpLoad);
  tiled_factor<kT>(g, g, z, n, k, bs, thresh, vec4, vec4, ln.cl, smem,
                   ln.clk);
  tiled_backsub<kT>(g, z, n, k, bs, vec4, ln.cl, smem, ln.clk);
  if (kStamp) ln.clk.write(stamps + ln.lane * kTiledStampWords);
}

template <bool kStamp>
int launch(const void* h, const void* y, void* x, void* work,
           unsigned long long* stamps, int batch, int m, int n, int k,
           int bs, float sigma2, float eps, int c, int tile, int smem,
           void* stream) {
  if (m < n || !tiled_plan_ok(n, k, bs, c, tile, smem))
    return cudaErrorInvalidValue;
  const auto kernel = tile == 128 ? mmse_equalize_tiled_kernel<kStamp, 128>
                                  : mmse_equalize_tiled_kernel<kStamp, 64>;
  return cluster_launch(kernel, batch, c, kTcThreads, smem, stream,
                        static_cast<const float*>(h),
                        static_cast<const float*>(y), static_cast<float*>(x),
                        static_cast<float*>(work), stamps, m, n, k, bs, c,
                        sigma2, eps);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// h (batch, m, n) with m >= n, y (batch, m, k) -> x (batch, n, k), float32;
// work: batch * n * n floats; n % bs == 0; the plan (c, tile, smem) must be
// chol_tiled_plan's formula.
int mmse_equalize_tiled_f32(const void* h, const void* y, void* x,
                            void* work, int batch, int m, int n, int k,
                            int bs, float sigma2, float eps, int c, int tile,
                            int smem, void* stream) {
  return repro_torch::launch<false>(h, y, x, work, nullptr, batch, m, n, k,
                                    bs, sigma2, eps, c, tile, smem, stream);
}

// The same solve with the phase stamps (phase_clock.cuh): stamps holds
// batch * kTiledStampWords words.  Only scripts/chol_tiled_phases.py
// launches it.
int mmse_equalize_tiled_phases_f32(const void* h, const void* y, void* x,
                                   void* work, void* stamps, int batch,
                                   int m, int n, int k, int bs, float sigma2,
                                   float eps, int c, int tile, int smem,
                                   void* stream) {
  return repro_torch::launch<true>(
      h, y, x, work, static_cast<unsigned long long*>(stamps), batch, m, n,
      k, bs, sigma2, eps, c, tile, smem, stream);
}

// cudaOccupancyMaxActiveClusters of the served instance of a plan.
int mmse_equalize_tiled_clusters(int c, int tile, int smem) {
  using namespace repro_torch;
  const auto kernel = tile == 128 ? mmse_equalize_tiled_kernel<false, 128>
                                  : mmse_equalize_tiled_kernel<false, 64>;
  return cluster_occupancy(kernel, c, kTcThreads, smem);
}

}  // extern "C"
