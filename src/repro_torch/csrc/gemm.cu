// K18: GEMM, (M, K) @ (K, N) -> (M, N), accumulated in float32.
//
// Replaces: src/repro/kernels/gemm.py, gemm_pallas (_gemm_kernel): a grid of
// 128 x 128 output tiles, each accumulating x[i, kk] @ y[kk, j] over the
// sequential ("arbitrary") k axis in a float32 VMEM scratch, written out in
// x's dtype at the last k step.
//
// What bounds it on an H100: operations.  A float32 product does 2 M N K
// FLOPs on 4 (M K + K N + M N) bytes; at the registry's 64 x 64 and 128 x 128
// squares and at 4096^3 it lies above the card's 67 TFLOP/s / 3.35 TB/s ridge
// (about 20 FLOPs a byte) once M, N, K pass ~60.  The reference's numbers
// are IEEE float32 products (rtol 1e-4), so the tensor cores' TF32 is out;
// this kernel runs on the SIMT FMA pipes, as cuBLAS's SGEMM does.  A
// bfloat16 product widens each element to float32 (the product of two bf16
// values is exact in float32), accumulates in float32 and rounds once to
// bf16 at the end, the reference's preferred_element_type=float32.
//
// Design: the sequential k axis is a loop inside one CTA per 128 x 128
// output tile (CUDA blocks are unordered and share nothing, so it cannot be
// a grid axis).  256 threads each hold an 8 x 8 block of the accumulator in
// registers (two 4 x 4 quadrants 64 rows / columns apart, so each warp's
// shared loads are conflict-free float4s); 8-deep k tiles of x (transposed)
// and y are staged in double-buffered shared memory, the next tile loaded
// into registers while the current one is multiplied.  Every edge is masked
// (zero-filled loads, guarded stores), so the kernel takes any M, N, K;
// ops.gemm still pads as the reference's does.  wgmma, TMA and the tensor
// cores for bf16 are later work.
#include <cuda_bf16.h>

#include <cstddef>

#include "lane_common.cuh"

namespace repro_torch {
namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kGemmThreads = 256;

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const T* __restrict__ X, const T* __restrict__ Y,
            T* __restrict__ O, int m, int n, int k) {
  __shared__ __align__(16) float xs[2][kBK][kBM];   // x tile, transposed
  __shared__ __align__(16) float ys[2][kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  // loader coordinates: x tile 128 rows x 8 k (4 a thread), y tile 8 k x
  // 128 columns (4 a thread, consecutive columns: coalesced)
  const int xr = tid / 2;
  const int xk = (tid % 2) * 4;
  const int yk = tid / 32;
  const int yc = (tid % 32) * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float xv[4], yv[4];
  auto fetch = [&](int k0) {
    const int gr = row0 + xr;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gk = k0 + xk + e;
      xv[e] = gr < m && gk < k
                  ? to_f32(X[static_cast<size_t>(gr) * k + gk]) : 0.0f;
    }
    const int gk = k0 + yk;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gc = col0 + yc + e;
      yv[e] = gk < k && gc < n
                  ? to_f32(Y[static_cast<size_t>(gk) * n + gc]) : 0.0f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int e = 0; e < 4; ++e) xs[buf][xk + e][xr] = xv[e];
#pragma unroll
    for (int e = 0; e < 4; ++e) ys[buf][yk][yc + e] = yv[e];
  };

  const int steps = (k + kBK - 1) / kBK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) fetch((s + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ys[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ys[buf][kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (s + 1 < steps) stash(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c < n) store(&O[static_cast<size_t>(r) * n + c], acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, void* o, int m, int n, int k,
           void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  gemm_kernel<T><<<grid, kGemmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(o),
      m, n, k);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// Shared memory of one CTA (static: two stages of the x and y tiles); the
// argument is unused.
size_t gemm_smem(int) {
  using namespace repro_torch;
  return sizeof(float) * 2 * kBK * (kBM + kBN);
}

// x (m, k) @ y (k, n) -> o (m, n), row-major and contiguous, all float32
// (bf16 = 0) or all bfloat16 (bf16 = 1); accumulated in float32.
int gemm_run(const void* x, const void* y, void* o, int m, int n, int k,
             int bf16, void* stream) {
  using namespace repro_torch;
  return bf16 ? launch<__nv_bfloat16>(x, y, o, m, n, k, stream)
              : launch<float>(x, y, o, m, n, k, stream);
}

}  // extern "C"
