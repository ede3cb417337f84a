// Tile loops shared by the blocked and tiled kernels (K10-K14): ceiling
// divisions that cover a remainder, block-wide reductions, and the staged
// 64 x 64 product tile the tiled kernels build their SYRKs, Gram blocks
// and block reflectors from.
//
// Every loop here covers a ragged edge itself: a panel width, a row count
// or a column count need not be a multiple of any tile edge.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace repro_torch {

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// A float offset rounded up to 16 bytes, for float4 access.
__host__ __device__ inline int align4(int x) { return (x + 3) & ~3; }

// max(m, d) with a NaN in either propagating, as jnp.max / torch.amax do.
__device__ inline float nan_max(float m, float d) {
  return (isnan(m) || isnan(d)) ? NAN : fmaxf(m, d);
}

// The maximum of v over the block (a NaN anywhere gives NaN); every
// thread receives it.  red: 32 floats of shared scratch.
__device__ inline float block_max(float v, float* red) {
  const bool nan = __syncthreads_or(isnan(v));
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = -INFINITY;
  for (int w = 0; w < static_cast<int>(blockDim.x + 31) >> 5; ++w)
    r = fmaxf(r, red[w]);
  __syncthreads();
  return nan ? NAN : r;
}

// The sum of v over the block, warps added in order, so every thread
// receives the same value.  red: 32 floats of shared scratch.
__device__ inline float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < static_cast<int>(blockDim.x + 31) >> 5; ++w)
    s += red[w];
  __syncthreads();
  return s;
}

// ---- the staged product tile ----
//
// A block of kTileThreads threads computes a kTile x kTile tile of
//   acc[a][b] = sum over p < depth, in order, of
//               lda(p, 4 ty + a) * ldb(p, 4 tx + b),
// (ty, tx) = (tid / 16, tid % 16), with f32 FMAs.  The operands are
// staged kDepthChunk depth steps at a time into shared memory, depth-major
// at pitch kTile + 4, so each depth step is one 16-byte load of A (two
// addresses a warp) and one of B (a warp's 16 reading 256 consecutive
// bytes) for 16 FMAs.  Each thread fetches its
// kChunkLoads elements of the next chunk into registers before it
// computes on the current one, so the loads' latency hides behind the
// FMAs.  A loader is called for every (p, c) of a chunk and returns 0
// outside its operand, which is how a tile covers a ragged edge (depth
// steps past the end are staged as 0 and never read).  kADepth / kBDepth
// say that the operand is contiguous in memory along p (a warp fetches 32
// consecutive p of one c, so its loads coalesce) rather than along c (a
// warp fetches 32 consecutive c of one p).  sa and sb hold kDepthChunk *
// kTilePitch floats each; the tile leaves them free (it ends on a
// barrier) and must be 16-byte aligned (align4 of a float offset).
constexpr int kTileThreads = 256;
constexpr int kTile = 64;
constexpr int kDepthChunk = 32;
constexpr int kTilePitch = kTile + 4;   // a multiple of 4: float4 rows
constexpr int kTileSmemFloats = 2 * kDepthChunk * kTilePitch;
constexpr int kChunkLoads = kDepthChunk * kTile / kTileThreads;
static_assert(kDepthChunk == 32 && kTile == 64 && kTileThreads == 256,
              "chunk_p / chunk_c assume these shapes");

// The (p, c) of a thread's i-th element of a staged chunk.
template <bool kDepthFastest>
__device__ inline int chunk_p(int i) {
  const int tid = threadIdx.x;
  return kDepthFastest ? (tid & 31) : (tid >> 6) + 4 * i;
}
template <bool kDepthFastest>
__device__ inline int chunk_c(int i) {
  const int tid = threadIdx.x;
  return kDepthFastest ? (tid >> 5) + 8 * i : (tid & 63);
}

template <bool kDepthFastest, class Load>
__device__ inline void fetch_chunk(float (&r)[kChunkLoads], int p0, int dp,
                                   const Load& ld) {
#pragma unroll
  for (int i = 0; i < kChunkLoads; ++i) {
    const int p = chunk_p<kDepthFastest>(i);
    r[i] = p < dp ? ld(p0 + p, chunk_c<kDepthFastest>(i)) : 0.0f;
  }
}

template <bool kDepthFastest>
__device__ inline void store_chunk(float* s, const float (&r)[kChunkLoads]) {
#pragma unroll
  for (int i = 0; i < kChunkLoads; ++i)
    s[chunk_p<kDepthFastest>(i) * kTilePitch + chunk_c<kDepthFastest>(i)] =
        r[i];
}

template <bool kADepth, bool kBDepth, class LoadA, class LoadB>
__device__ inline void tile_product(float (&acc)[4][4], int depth,
                                    const LoadA& lda, const LoadB& ldb,
                                    float* sa, float* sb) {
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
  float ra[kChunkLoads], rb[kChunkLoads];
  fetch_chunk<kADepth>(ra, 0, min(kDepthChunk, depth), lda);
  fetch_chunk<kBDepth>(rb, 0, min(kDepthChunk, depth), ldb);
  for (int p0 = 0; p0 < depth; p0 += kDepthChunk) {
    const int dp = min(kDepthChunk, depth - p0);
    __syncthreads();            // the previous chunk's readers are done
    store_chunk<kADepth>(sa, ra);
    store_chunk<kBDepth>(sb, rb);
    __syncthreads();
    const int next = p0 + kDepthChunk;
    if (next < depth) {         // in flight while this chunk computes
      fetch_chunk<kADepth>(ra, next, min(kDepthChunk, depth - next), lda);
      fetch_chunk<kBDepth>(rb, next, min(kDepthChunk, depth - next), ldb);
    }
    for (int p = 0; p < dp; ++p) {
      const float4 x4 =
          *reinterpret_cast<const float4*>(sa + p * kTilePitch + 4 * ty);
      const float4 w4 =
          *reinterpret_cast<const float4*>(sb + p * kTilePitch + 4 * tx);
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(x[a], w[b], acc[a][b]);
    }
  }
  __syncthreads();
}

// The output coordinates of a thread's acc[a][b] in a tile at (i0, j0).
__device__ inline int tile_row(int i0, int a) {
  return i0 + 4 * static_cast<int>(threadIdx.x >> 4) + a;
}
__device__ inline int tile_col(int j0, int b) {
  return j0 + 4 * static_cast<int>(threadIdx.x & 15) + b;
}

}  // namespace repro_torch
