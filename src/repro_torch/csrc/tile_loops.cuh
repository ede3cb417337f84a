// Tile loops shared by the blocked and tiled kernels (K10-K14): ceiling
// divisions that cover a remainder, block-wide reductions, the staged
// 64 x 64 product tile K10, K11 and K13 build their SYRKs and block
// reflectors from, and the wide tile (64 or 128 square, cp.async-staged)
// of K12's and K14's Gram blocks and trailing updates.
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

// ---- the wide product tile (K12, K14) ----
//
// A block of kTileThreads threads computes a kT x kT tile (kT = 64 or 128)
// of
//   acc[u][v] = sum over p < depth, in order, of A(p, row u) * B(p, col v)
// with f32 FMAs, where the operands lie in device memory depth-major: A(p,
// c) = pa[p * lda + c] for c < ca, 0 past it (B likewise).  A thread owns
// kR = kT / 16 rows and as many columns: rows 4 ry + (u & 3) + 64 (u >> 2)
// and columns 4 cx + (v & 3) + 64 (v >> 2), a warp's 32 threads on 4
// values of ry and 8 of cx (wide_ry, wide_cx).  The operands are copied
// wide_depth steps at a time into shared memory by cp.async (16
// bytes a copy where vec4 says that every row start is 16-byte aligned
// and ca a multiple of 4, else 4 bytes through registers), two stages
// deep, so one stage's copies fly while the other's FMAs run.  A depth
// step is then two (kT = 64) or four 16-byte loads a thread, each a
// single wavefront (a warp reads 4 consecutive float4 of A, 8 of B), for
// kR^2 FMAs: at kT = 128 one shared-memory wavefront a warp-FFMA, where
// tile_product's 64 x 64 tile pays three a four.  A stage is wide_depth
// steps (32 at kT = 64, 16 at 128: 32 KB for the two stages either way),
// so one stage's FMAs outlast the next one's copies from L2.  Each
// element's sum keeps tile_product's order over p, so the two tiles give
// the same bits.  sm holds wide_smem_floats floats, 16-byte aligned; the
// tile leaves it free (it ends on a barrier).
__host__ __device__ constexpr int wide_depth(int kt) { return 2048 / kt; }

__host__ __device__ constexpr int wide_smem_floats(int kt) {
  return 2 * 2 * wide_depth(kt) * kt;       // two stages of A and B
}

__device__ inline int wide_ry() {
  const int w = threadIdx.x >> 5;
  return (w >> 1) * 4 + ((threadIdx.x & 31) >> 3);
}
__device__ inline int wide_cx() {
  const int w = threadIdx.x >> 5;
  return (w & 1) * 8 + (threadIdx.x & 7);
}
__device__ inline int wide_off(int base, int u) {   // row or column u
  return 4 * base + (u & 3) + 64 * (u >> 2);
}

__device__ __forceinline__ void cp_async_16(float* dst, const float* src,
                                            bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Thread threadIdx.x's cells of a rows x cols grid, the cells e = tid +
// kTileThreads i in order, row r = e / cols and column c = e % cols found
// without a division a step:
//   for (GridStep g(cols); g.r < rows; g.next()) ... g.r, g.c ...
struct GridStep {
  int r, c, cols, dr, dc;
  __device__ explicit GridStep(int cols_)
      : r(static_cast<int>(threadIdx.x) / cols_),
        c(static_cast<int>(threadIdx.x) % cols_), cols(cols_),
        dr(kTileThreads / cols_), dc(kTileThreads % cols_) {}
  __device__ void next() {
    c += dc;
    r += dr;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// Copy rows x cols floats from device memory (row pitch ld) into shared
// memory (row pitch dp), by cp.async 16 bytes a copy where vec4 says that
// every row start is 16-byte aligned on both sides and cols a multiple of
// 4, else 4 bytes a load through registers (ld.global.cg, past L1: the
// source may have been written by another SM of the cluster).  The
// caller waits (cp_async_wait_all) and meets at a barrier.
__device__ inline void copy_block(float* dst, int dp, const float* src,
                                  size_t ld, int rows, int cols, bool vec4) {
  if (rows < 1 || cols < 1) return;
  if (vec4) {
    for (GridStep g(cols / 4); g.r < rows; g.next())
      cp_async_16(dst + g.r * dp + 4 * g.c, src + g.r * ld + 4 * g.c, true);
  } else {
    for (GridStep g(cols); g.r < rows; g.next())
      dst[g.r * dp + g.c] = __ldcg(src + g.r * ld + g.c);
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage rows p0.. of one operand into s (wide_depth x kT, depth-major).
template <int kT>
__device__ inline void wide_stage(float* s, const float* pm, int ld, int cm,
                                  int p0, int depth, bool vec4) {
  constexpr int kQuads = kT / 4;
  constexpr int kDepth = wide_depth(kT);
  for (int e = threadIdx.x; e < kDepth * kQuads; e += kTileThreads) {
    const int p = e / kQuads;
    const int c = (e % kQuads) * 4;
    if (p0 + p >= depth) continue;
    const float* src = pm + static_cast<size_t>(p0 + p) * ld + c;
    float* dst = s + p * kT + c;
    if (vec4) {
      cp_async_16(dst, c < cm ? src : pm, c < cm);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) dst[t] = c + t < cm ? __ldcg(src + t) : 0.0f;
    }
  }
}

template <int kT>
__device__ inline void wide_product(float (&acc)[kT / 16][kT / 16],
                                    int depth, const float* pa, int lda,
                                    int ca, const float* pb, int ldb, int cb,
                                    bool vec4, float* sm) {
  constexpr int kR = kT / 16;
  constexpr int kDepth = wide_depth(kT);
  constexpr int kStage = 2 * kDepth * kT;
  constexpr int kUnroll = kT == 128 ? 4 : kDepth;
  const int ry = wide_ry();
  const int cx = wide_cx();
#pragma unroll
  for (int u = 0; u < kR; ++u)
#pragma unroll
    for (int v = 0; v < kR; ++v) acc[u][v] = 0.0f;
  const int chunks = ceil_div(depth, kDepth);
  wide_stage<kT>(sm, pa, lda, ca, 0, depth, vec4);
  wide_stage<kT>(sm + kDepth * kT, pb, ldb, cb, 0, depth, vec4);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int s = 0; s < chunks; ++s) {
    if (s + 1 < chunks) {       // the next stage in flight
      float* nx = sm + ((s + 1) & 1) * kStage;
      wide_stage<kT>(nx, pa, lda, ca, (s + 1) * kDepth, depth, vec4);
      wide_stage<kT>(nx + kDepth * kT, pb, ldb, cb,
                     (s + 1) * kDepth, depth, vec4);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* sa = sm + (s & 1) * kStage;
    const float* sb = sa + kDepth * kT;
    const auto step = [&](int p) {
      float x[kR], w[kR];
#pragma unroll
      for (int h = 0; h < kR / 4; ++h) {
        const float4 a4 = *reinterpret_cast<const float4*>(
            sa + p * kT + 64 * h + 4 * ry);
        const float4 b4 = *reinterpret_cast<const float4*>(
            sb + p * kT + 64 * h + 4 * cx);
        x[4 * h] = a4.x;
        x[4 * h + 1] = a4.y;
        x[4 * h + 2] = a4.z;
        x[4 * h + 3] = a4.w;
        w[4 * h] = b4.x;
        w[4 * h + 1] = b4.y;
        w[4 * h + 2] = b4.z;
        w[4 * h + 3] = b4.w;
      }
#pragma unroll
      for (int u = 0; u < kR; ++u)
#pragma unroll
        for (int v = 0; v < kR; ++v) acc[u][v] = fmaf(x[u], w[v], acc[u][v]);
    };
    const int dp = min(kDepth, depth - s * kDepth);
    if (dp == kDepth) {
      // at kT = 128 the 64 sums fill half the registers ptxas may give a
      // thread at two CTAs an SM: four steps' loads in flight, not all
#pragma unroll kUnroll
      for (int p = 0; p < kDepth; ++p) step(p);
    } else {
      for (int p = 0; p < dp; ++p) step(p);
    }
    __syncthreads();            // the stage's readers done before its refill
  }
}

}  // namespace repro_torch
