// K7: batched radix-2 FFT on separate re/im planes, several rows per CTA.
//
// Replaces: src/repro/kernels/fft.py, fft_pallas (_fft_kernel, fft_tables),
// also served through pipelines/pusch.py pusch_fft_pallas.  Iterative
// Cooley-Tukey: the row is loaded through the bit-reversal table, then
// log2 N butterfly stages run in order, stage s pairing i = ((b >> s) <<
// (s+1)) | (b & (half-1)) with j = i + half and twiddle (half-1) + off of
// the chunked table (stage s at offset 2^s - 1).  The permutation and the
// twiddles are read from the same host-built tables the plain version and
// the reference use -- never recomputed with sin/cos on the card -- so all
// three multiply by identical twiddles.
//
// What bounds it on an H100: bytes.  A row reads and writes 2 N floats
// (16 N bytes) and does 5 N log2 N FLOPs, far below the card's 67 TFLOP/s
// per byte moved.  The design keeps each row in shared memory for all its
// stages (one trip to device memory each way, coalesced, the permutation
// applied on the shared-memory side), gives a row N/2 threads up to 512 and
// packs 256 / (N/2) rows into a CTA at small N, so a 64-point row is one
// warp, whose stages are separated by __syncwarp alone; from 128 points up
// the stages are separated by __syncthreads.
#include <cstddef>

#include "lane_common.cuh"

namespace repro_torch {
namespace {

// Threads per row and rows per CTA for an n-point transform.
void fft_config(int n, int* tpr, int* rpc) {
  *tpr = n / 2 < 512 ? n / 2 : 512;
  *rpc = *tpr < 256 ? 256 / *tpr : 1;
}

__device__ inline void stage_sync(int tpr) {
  if (tpr <= 32)
    __syncwarp();
  else
    __syncthreads();
}

__global__ void __launch_bounds__(512)
fft_kernel(const float* __restrict__ XR, const float* __restrict__ XI,
           const int* __restrict__ rev, const float* __restrict__ WR,
           const float* __restrict__ WI, float* __restrict__ YR,
           float* __restrict__ YI, int rows, int n, int stages, int tpr,
           int group, int group_stride) {
  extern __shared__ float smem[];
  const int rpc = blockDim.x / tpr;
  const int local = threadIdx.x / tpr;
  const int t = threadIdx.x % tpr;
  const size_t row = static_cast<size_t>(blockIdx.x) * rpc + local;
  const bool live = row < static_cast<size_t>(rows);
  float* sr = smem + static_cast<size_t>(local) * 2 * n;
  float* si = sr + n;
  if (live) {
    // coalesced read; rev is an involution, so x_perm[rev[e]] = x[e]
    const float* xr = XR + row * n;
    const float* xi = XI + row * n;
    for (int e = t; e < n; e += tpr) {
      const int d = rev[e];
      sr[d] = xr[e];
      si[d] = xi[e];
    }
  }
  stage_sync(tpr);
  for (int s = 0; s < stages; ++s) {
    const int half = 1 << s;
    if (live) {
      for (int b = t; b < n / 2; b += tpr) {
        const int off = b & (half - 1);
        const int i = ((b >> s) << (s + 1)) | off;
        const int j = i + half;
        const float wr = WR[half - 1 + off];
        const float wi = WI[half - 1 + off];
        const float ur = sr[i], ui = si[i];
        const float vr = sr[j], vi = si[j];
        // twiddle multiply (critical vector region)
        const float tr = wr * vr - wi * vi;
        const float ti = wr * vi + wi * vr;
        sr[i] = ur + tr;
        si[i] = ui + ti;
        sr[j] = ur - tr;
        si[j] = ui - ti;
      }
    }
    stage_sync(tpr);
  }
  if (live) {
    const size_t base = (row / group) * static_cast<size_t>(group_stride) +
                        (row % group) * static_cast<size_t>(n);
    for (int e = t; e < n; e += tpr) {
      YR[base + e] = sr[e];
      YI[base + e] = si[e];
    }
  }
}

}  // namespace
}  // namespace repro_torch

extern "C" {

size_t fft_smem(int n) {
  int tpr, rpc;
  repro_torch::fft_config(n, &tpr, &rpc);
  return sizeof(float) * 2 * static_cast<size_t>(n) * rpc;
}

// xr, xi (rows, n) -> out_re, out_im, float32; rev (n) int32, wr, wi (n-1)
// the chunked twiddles.  Output row r lands at (r / group) * group_stride +
// (r % group) * n floats from out_re / out_im, so a caller can write the
// (B, 2, A, n) stacked layout directly (group = A, group_stride = 2 A n).
int fft_f32(const void* xr, const void* xi, const void* rev, const void* wr,
            const void* wi, void* out_re, void* out_im, int rows, int n,
            int group, int group_stride, void* stream) {
  using namespace repro_torch;
  int tpr, rpc;
  fft_config(n, &tpr, &rpc);
  int stages = 0;
  while ((1 << stages) < n) ++stages;
  const size_t smem = fft_smem(n);
  cudaError_t err = allow_smem(fft_kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (rows + rpc - 1) / rpc;
  fft_kernel<<<blocks, tpr * rpc, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const int*>(rev), static_cast<const float*>(wr),
      static_cast<const float*>(wi), static_cast<float*>(out_re),
      static_cast<float*>(out_im), rows, n, stages, tpr, group,
      group_stride);
  return cudaGetLastError();
}

}  // extern "C"
