// K20: causal GQA flash attention with an online softmax, one CTA per
// (batch, head, 64 query rows).
//
// Replaces: src/repro/kernels/attention.py, flash_attention_pallas
// (_flash_kernel): q (B, H, S, D), k / v (B, Hkv, S, D), the kv head of query
// head h being h / (H / Hkv); per q tile a running max m and sum l in
// float32 (m from -1e30), kv tiles of bkv = min(128, S) visited in order --
// only tiles 0..iq when causal, the inductive trip count of the paper's RI
// stream -- each giving s = (q k^T) * scale in float32, -1e30 where kv > q,
// m' = max(m, rowmax s), p = exp(s - m'), l = l exp(m - m') + rowsum p,
// acc = acc exp(m - m') + p v with p rounded to v's dtype first; out = acc /
// max(l, 1e-30) in q's dtype.
//
// What bounds it on an H100: at the model's shapes (D = 128, S = 512) the
// causal work, 2 B H S^2 D FLOPs, on bfloat16 bytes moved once lies below
// the tensor cores' ridge (about 295 FLOPs a byte), so the bound is bytes;
// this first kernel is far from it, limited by its SIMT FMAs (the float32
// registry case has to stay IEEE float32 anyway).  mma.sync / wgmma and TMA
// are later work.
//
// Design: the sequential kv grid axis becomes a loop inside the CTA, which
// keeps m, l and the 64 x D accumulator in registers (4 rows x 8 columns a
// thread) across kv tiles; each kv tile is staged in shared memory as float32
// (K transposed, so a thread's 8 score columns are two float4 loads), the
// 64 x bkv scores are computed in registers, reduced across the 16 threads
// that share a row with shuffles, and the probabilities go through shared
// memory to the P V product.  A causal CTA stops at the last kv tile its
// rows reach: tiles above the diagonal are never loaded.  Masking uses
// global indices, so a CTA whose rows straddle two q tiles (bq < 64) may
// visit a tile that is wholly masked for some rows, which leaves their m, l
// and accumulator unchanged.
#include <cuda_bf16.h>

#include <cstddef>

#include "lane_common.cuh"

namespace repro_torch {
namespace {

constexpr int kRows = 64;          // query rows of one CTA
constexpr int kMaxKv = 128;        // the widest kv tile (bkv <= 128)
constexpr int kLd = kMaxKv + 4;    // row pitch of the K^T and P tiles
constexpr int kFlashThreads = 256;
constexpr float kNeg = -1e30f;

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// p rounded to v's dtype before the P V product (a no-op for float32)
__device__ inline float round_as(float v, const float*) { return v; }
__device__ inline float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ inline float row_max(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ inline float row_sum(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kFlashThreads)
flash_kernel(const T* __restrict__ Q, const T* __restrict__ K,
             const T* __restrict__ V, T* __restrict__ O, int h, int hkv,
             int sq, int skv, int d, int bkv, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                  // d x kRows, Q transposed
  float* kt = qt + d * kRows;        // d x kLd, K transposed
  float* vs = kt + d * kLd;          // kMaxKv x d
  float* ps = vs + kMaxKv * d;       // kRows x kLd, probabilities
  const int tid = threadIdx.x;
  const int tc = tid % 16;           // score columns tc*8.., d columns tc*4..
  const int ty = tid / 16;           // rows ty*4..ty*4+3
  const int q0 = blockIdx.x * kRows;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hh / (h / hkv);
  const T* qg = Q + (static_cast<size_t>(b) * h + hh) * sq * d;
  const T* kg = K + (static_cast<size_t>(b) * hkv + hk) * skv * d;
  const T* vg = V + (static_cast<size_t>(b) * hkv + hk) * skv * d;
  T* og = O + (static_cast<size_t>(b) * h + hh) * sq * d;

  for (int e = tid; e < kRows * d; e += kFlashThreads) {
    const int r = e / d;
    const int c = e % d;
    qt[c * kRows + r] =
        q0 + r < sq ? to_f32(qg[static_cast<size_t>(q0 + r) * d + c]) : 0.0f;
  }
  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  // the inductive trip count: a causal CTA visits kv tiles up to the one
  // holding its last row's diagonal
  const int last = min(q0 + kRows, sq) - 1;
  const int tiles = causal ? last / bkv + 1 : skv / bkv;
  const int bkv4 = (bkv + 3) & ~3;

  for (int t = 0; t < tiles; ++t) {
    __syncthreads();   // the previous tile's P V is done with kt, vs, ps
    const int k0 = t * bkv;
    for (int e = tid; e < bkv4 * d; e += kFlashThreads) {
      const int r = e / d;
      const int c = e % d;
      const bool live = r < bkv;
      const size_t g = static_cast<size_t>(k0 + r) * d + c;
      kt[c * kLd + r] = live ? to_f32(kg[g]) : 0.0f;
      vs[r * d + c] = live ? to_f32(vg[g]) : 0.0f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
    for (int c = 0; c < d; ++c) {
      const float4 qv = *reinterpret_cast<const float4*>(&qt[c * kRows + ty * 4]);
      const float4 ka = *reinterpret_cast<const float4*>(&kt[c * kLd + tc * 8]);
      const float4 kb =
          *reinterpret_cast<const float4*>(&kt[c * kLd + tc * 8 + 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float kk[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
    }

    // online softmax, one row at a time across its 16 threads
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tc * 8 + j;
        float v = s[i][j] * scale;
        if (causal && k0 + col > qi) v = kNeg;
        s[i][j] = v;
        if (col < bkv) mx = fmaxf(mx, v);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = tc * 8 + j < bkv ? expf(s[i][j] - m_new) : 0.0f;
        sum += p;
        s[i][j] = round_as(p, K);
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= corr;
      float* prow = &ps[(ty * 4 + i) * kLd + tc * 8];
      *reinterpret_cast<float4*>(prow) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      *reinterpret_cast<float4*>(prow + 4) =
          make_float4(s[i][4], s[i][5], s[i][6], s[i][7]);
    }
    __syncthreads();

    // acc += P V over the tile (rows past bkv are zero in both)
    for (int kv = 0; kv < bkv4; kv += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(&ps[(ty * 4 + i) * kLd + kv]);
        p[i][0] = p4.x; p[i][1] = p4.y; p[i][2] = p4.z; p[i][3] = p4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[8];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int dd = half * 64 + tc * 4;
          float4 v4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (dd < d)
            v4 = *reinterpret_cast<const float4*>(&vs[(kv + u) * d + dd]);
          vv[half * 4 + 0] = v4.x;
          vv[half * 4 + 1] = v4.y;
          vv[half * 4 + 2] = v4.z;
          vv[half * 4 + 3] = v4.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(p[i][u], vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int dd = (j / 4) * 64 + tc * 4 + j % 4;
      if (dd < d) store(&og[static_cast<size_t>(qi) * d + dd], acc[i][j] / li);
    }
  }
}

size_t smem_bytes(int d) {
  return sizeof(float) * (static_cast<size_t>(d) * kRows +
                          static_cast<size_t>(d) * kLd +
                          static_cast<size_t>(kMaxKv) * d +
                          static_cast<size_t>(kRows) * kLd);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int hkv, int sq, int skv, int d, int bkv, int causal,
           float scale, void* stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = allow_smem(flash_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kRows - 1) / kRows, h, b);
  flash_kernel<T><<<grid, kFlashThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), h, hkv, sq, skv, d, bkv,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

extern "C" {

size_t flash_attention_smem(int d) { return repro_torch::smem_bytes(d); }

// q (b, h, sq, d), k / v (b, hkv, skv, d) -> o (b, h, sq, d), contiguous,
// all float32 (bf16 = 0) or all bfloat16 (bf16 = 1); d <= 128 and d % 4 ==
// 0, h % hkv == 0, kv tiles of bkv <= 128 dividing skv, sq == skv when
// causal.
int flash_attention_run(const void* q, const void* k, const void* v, void* o,
                        int b, int h, int hkv, int sq, int skv, int d,
                        int bkv, int causal, float scale, int bf16,
                        void* stream) {
  using namespace repro_torch;
  return bf16 ? launch<__nv_bfloat16>(q, k, v, o, b, h, hkv, sq, skv, d, bkv,
                                      causal, scale, stream)
              : launch<float>(q, k, v, o, b, h, hkv, sq, skv, d, bkv, causal,
                              scale, stream);
}

}  // extern "C"
