// K19: valid-mode centro-symmetric FIR, one CTA per 256-output tile.
//
// Replaces: src/repro/kernels/fir.py, fir_pallas (_fir_kernel): each output
// y[i] = sum_{j < m/2} h[j] * (x[i+j] + x[i+m-1-j]), the pairs summed in
// order of j, then h[m/2] * x[i+m/2] when m is odd.  The TPU kernel holds
// the whole signal in VMEM and slices each tile's overlapping window; its
// grid needs whole tiles, so ops.fir padded the signal.
//
// What bounds it on an H100: device bytes.  A call reads N + m floats and
// writes N - m + 1, and does about 1.5 m FLOPs per output, far below the
// card's 67 TFLOP/s per byte moved.  The design reads the signal once,
// coalesced: each block stages its window of 256 + m - 1 floats and the
// taps in shared memory, one thread per output walks the taps from there,
// and the block masks the ragged last tile itself, so no caller pads.
// Every sum and product is rounded separately (__fadd_rn, __fmul_rn), as
// the plain version's are, so the two agree bit for bit.
#include <cstddef>

#include "lane_common.cuh"

namespace repro_torch {
namespace {

constexpr int kTile = 256;

__global__ void __launch_bounds__(kTile)
fir_kernel(const float* __restrict__ X, const float* __restrict__ H,
           float* __restrict__ Y, int n, int m) {
  extern __shared__ float smem[];
  float* h = smem;                      // m
  float* win = smem + m;                // kTile + m - 1
  const int out = n - m + 1;
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile;
  for (int e = threadIdx.x; e < m; e += kTile) h[e] = H[e];
  for (int e = threadIdx.x; e < kTile + m - 1; e += kTile)
    win[e] = base + e < static_cast<size_t>(n) ? X[base + e] : 0.0f;
  __syncthreads();
  const int t = threadIdx.x;
  if (base + t >= static_cast<size_t>(out)) return;
  const int half = m / 2;
  float acc = 0.0f;
  for (int j = 0; j < half; ++j)
    acc = __fadd_rn(acc, __fmul_rn(h[j], __fadd_rn(win[t + j],
                                                   win[t + m - 1 - j])));
  if (m % 2 == 1) acc = __fadd_rn(acc, __fmul_rn(h[half], win[t + half]));
  Y[base + t] = acc;
}

size_t smem_bytes(int m) {
  return sizeof(float) * (static_cast<size_t>(m) + kTile + m - 1);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

size_t fir_smem(int m) { return repro_torch::smem_bytes(m); }

// x (n,), h (m,) with 1 <= m <= n -> y (n - m + 1,), float32.
int fir_f32(const void* x, const void* h, void* y, int n, int m,
            void* stream) {
  using namespace repro_torch;
  const auto s = static_cast<cudaStream_t>(stream);
  const int out = n - m + 1;
  const int blocks = (out + kTile - 1) / kTile;
  const size_t smem = smem_bytes(m);
  cudaError_t err = allow_smem(fir_kernel, smem);
  if (err != cudaSuccess) return err;
  fir_kernel<<<blocks, kTile, smem, s>>>(static_cast<const float*>(x),
                                         static_cast<const float*>(h),
                                         static_cast<float*>(y), n, m);
  return cudaGetLastError();
}

}  // extern "C"
