// K20: causal GQA flash attention with an online softmax, in two forms:
// float32 on SIMT FMAs, bfloat16 on the tensor cores.
//
// Replaces: src/repro/kernels/attention.py, flash_attention_pallas
// (_flash_kernel): q (B, H, S, D), k / v (B, Hkv, S, D), the kv head of query
// head h being h / (H / Hkv); per q tile a running max m and sum l in
// float32 (m from -1e30), kv tiles visited in order -- only tiles up to the
// diagonal when causal, the inductive trip count of the paper's RI stream --
// each giving s = (q k^T) * scale in float32, -1e30 where kv > q, m' =
// max(m, rowmax s), p = exp(s - m'), l = l exp(m - m') + rowsum p, acc = acc
// exp(m - m') + p v with p rounded to v's dtype first; out = acc / max(l,
// 1e-30) in q's dtype.
//
// Both forms read q, k, v and write out through element strides (batch,
// head, row; the last axis contiguous), so the models' (B, S, H, D) layout
// needs no copy on either side.  One CTA owns 64 query rows of one (batch,
// head); the sequential kv grid axis is a loop inside it that keeps m, l
// and the accumulator in registers, and a causal CTA never loads a kv tile
// above its diagonal.  Masking uses global indices.
//
// What bounds it on an H100: at the models' shapes (D = 80 / 128, S = 512)
// the causal work, 2 B H S^2 D FLOPs, over bfloat16 bytes moved once lies
// below the tensor cores' ridge (about 295 FLOPs a byte), so the bound is
// bytes (0.0100 ms at phi4-mini's (4, 24, 512, 128)); in practice the limit
// is how fast the products and the softmax's exponentials issue.
//
// The bfloat16 form (flash_tc_kernel, FlashAttention-2's design): 4 warps, 16
// query rows each.  The Q tile arrives once by cp.async and stays in registers
// as mma A fragments (ldmatrix.x4).  K and V tiles of 128 rows -- the
// reference's kv tile, so p is rounded to bf16 against the same running max as
// there -- sit in bf16 shared memory, two K buffers and one V buffer, filled by
// cp.async (16-byte copies, 8-byte where D % 8 == 4): K(t + 1) loads during all
// of step t, V(t) while S(t) and its softmax compute.  The V buffer holds the Q
// tile before V(0) arrives and the output tile after the last P V.  Rows have a
// pitch of D' + 8 halves (D' = D rounded up to 16, the k dimension
// zero-filled), an odd number of 16-byte units, so every ldmatrix is free of
// bank conflicts.  S = Q K^T is mma.sync m16n8k16 (bf16 in, float32 accumulate)
// with K through ldmatrix, the k-steps outermost and no branch in the product
// loops, so the compiler keeps independent mma chains in flight (8 warps an SM
// leave little else to hide latency).  The online softmax runs on the
// accumulator fragments (row max and sum over the 4 threads of a quad, the sum
// kept per thread and reduced once at the end); p is rounded to bf16 in
// registers, where the accumulator pairs are already the A fragments of P V,
// and V goes in through ldmatrix.trans.  Scores are scaled by scale * log2(e)
// and exponentiated with exp2f, which is exp of the reference's scores.  The
// -1e30 mask is applied only on the diagonal tile and a ragged last tile
// (columns past Skv, whose K and V rows are zero-filled); on the diagonal of a
// q tile in the first half of its 128-row block the tile's last 64 columns are
// skipped (p = 0 there).  The grid walks the causal q tiles heaviest first, and
// the epilogue stores through shared memory in 16-byte pieces.  At D' = 128 a
// CTA holds 102 KB of shared memory, so two fit on an SM (243 registers a
// thread, no spill).
//
// The float32 form (flash_kernel) keeps IEEE float32 products, as the
// float32 registry case needs: kv tiles of bkv = min(128, S) staged in
// shared memory as float32 (K transposed), 4 rows x 8 columns of scores a
// thread, the probabilities through shared memory to the P V product.
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

#include "lane_common.cuh"

namespace repro_torch {
namespace {

constexpr float kNeg = -1e30f;

// element strides of q, k, v and out: batch, head, row
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// ---------------- the float32 form (SIMT) ----------------

constexpr int kRows = 64;          // query rows of one CTA
constexpr int kMaxKv = 128;        // the widest kv tile (bkv <= 128)
constexpr int kLd = kMaxKv + 4;    // row pitch of the K^T and P tiles
constexpr int kFlashThreads = 256;

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

__global__ void __launch_bounds__(kFlashThreads)
flash_kernel(const float* __restrict__ Q, const float* __restrict__ K,
             const float* __restrict__ V, float* __restrict__ O, int h,
             int hkv, int sq, int skv, int d, int bkv, int causal,
             float scale, Strides st) {
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
  const float* qg = Q + b * st.q[0] + hh * st.q[1];
  const float* kg = K + b * st.k[0] + hk * st.k[1];
  const float* vg = V + b * st.v[0] + hk * st.v[1];
  float* og = O + b * st.o[0] + hh * st.o[1];

  for (int e = tid; e < kRows * d; e += kFlashThreads) {
    const int r = e / d;
    const int c = e % d;
    qt[c * kRows + r] = q0 + r < sq ? qg[(q0 + r) * st.q[2] + c] : 0.0f;
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
      kt[c * kLd + r] = live ? kg[(k0 + r) * st.k[2] + c] : 0.0f;
      vs[r * d + c] = live ? vg[(k0 + r) * st.v[2] + c] : 0.0f;
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
        s[i][j] = p;
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
      if (dd < d) og[qi * st.o[2] + dd] = acc[i][j] / li;
    }
  }
}

size_t smem_f32(int d) {
  return sizeof(float) * (static_cast<size_t>(d) * kRows +
                          static_cast<size_t>(d) * kLd +
                          static_cast<size_t>(kMaxKv) * d +
                          static_cast<size_t>(kRows) * kLd);
}

// ---------------- the bfloat16 form (tensor cores) ----------------

constexpr int kTcRows = 64;       // query rows of a CTA, 16 a warp
constexpr int kTcKv = 128;        // kv rows of a tile: the reference's bkv
constexpr int kTcThreads = 128;   // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

// shared-memory row pitch in halves: D' + 8, an odd number of 16-byte units
__host__ __device__ constexpr int tc_pitch(int dp) { return dp + 8; }

size_t smem_tc(int d) {
  const int dp = (d + 15) / 16 * 16;
  // two K tiles and one V tile (which holds the Q tile before V(0) and
  // the output tile after the last P V)
  return sizeof(__nv_bfloat16) * 3 * kTcKv * tc_pitch(dp);
}

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16- or 8-byte asynchronous copies global -> shared; a dead chunk copies
// no byte and is zero-filled (its source is any valid address)
__device__ inline void cp_async16(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(live ? 16 : 0));
}

__device__ inline void cp_async8(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(live ? 8 : 0));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy this thread issued has landed
__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// all but the newest group of copies have landed
__device__ inline void cp_async_wait_but1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ inline void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ inline void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a b, a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c 16 x 8 float32
__device__ inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ inline float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ inline float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ROWS rows x D' columns of a bf16 tile into shared memory (pitch D' + 8):
// rows past `rows` and columns past d are zero-filled
template <int DP, int ROWS>
__device__ inline void load_tile(__nv_bfloat16* s, const __nv_bfloat16* g,
                                 long long row_stride, int rows, int d,
                                 bool vec16) {
  constexpr int kP = tc_pitch(DP);
  const int tid = threadIdx.x;
  if (vec16) {
    constexpr int kChunks = DP / 8;
    for (int c = tid; c < ROWS * kChunks; c += kTcThreads) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 8;
      const bool live = r < rows && col < d;
      cp_async16(smem_addr(s + r * kP + col),
                 live ? g + r * row_stride + col : g, live);
    }
  } else {
    constexpr int kChunks = DP / 4;
    for (int c = tid; c < ROWS * kChunks; c += kTcThreads) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 4;
      const bool live = r < rows && col < d;
      cp_async8(smem_addr(s + r * kP + col),
                live ? g + r * row_stride + col : g, live);
    }
  }
}

// One warp's 16 rows against the first 8 NT columns of a kv tile: S = Q K^T
// (mma.sync, the k-steps outermost so the NT accumulators of a step are
// independent products in flight), scaled into log2 units, masked where
// `mask` (columns past skv; past the row when causal), then the online
// softmax on the fragments -- rows g (elements 0, 1) and g + 8 (2, 3), max
// over the quad -- m, l and acc rescaled, and p rounded to bf16 into pf,
// where the fragment pairs of columns 16 kk .. 16 kk + 15 are the A
// fragments of the kk-th k-step of P V.  l takes the unrounded p.
template <int DP, int NT>
__device__ __forceinline__ void scores_softmax(
    const uint32_t (&qf)[DP / 16][4], const __nv_bfloat16* ks, bool mask,
    int k0, int row0, int skv, int causal, float scale_log2, float& m0,
    float& m1, float& l0, float& l1, float (&acc)[DP / 8][4],
    uint32_t (&pf)[kTcKv / 16][4]) {
  constexpr int kP = tc_pitch(DP);
  const int lane = threadIdx.x % 32;
  const int c2 = (lane % 4) * 2;
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      const int r = jj * 16 + (lane % 8) + (lane / 16) * 8;
      uint32_t kb[4];
      ldmatrix_x4(kb, smem_addr(ks + r * kP + kk * 16 + ((lane / 8) % 2) * 8));
      mma_bf16(s[2 * jj], qf[kk], kb[0], kb[1]);
      mma_bf16(s[2 * jj + 1], qf[kk], kb[2], kb[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
  if (mask) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + c2 + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        if (col >= skv || (causal && col > row)) s[j][e] = kNeg;
      }
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  const float corr0 = exp2f(m0 - mx0);
  const float corr1 = exp2f(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float p0 = exp2f(s[j][0] - m0);
    const float p1 = exp2f(s[j][1] - m0);
    const float p2 = exp2f(s[j][2] - m1);
    const float p3 = exp2f(s[j][3] - m1);
    sum0 += p0 + p1;
    sum1 += p2 + p3;
    pf[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
    pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
  }
  l0 = l0 * corr0 + sum0;
  l1 = l1 * corr1 + sum1;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    acc[n][0] *= corr0;
    acc[n][1] *= corr0;
    acc[n][2] *= corr1;
    acc[n][3] *= corr1;
  }
}

// acc += P V over the tile's first 8 NT rows, V through ldmatrix.trans
template <int DP, int NT>
__device__ __forceinline__ void pv_product(const uint32_t (&pf)[kTcKv / 16][4],
                                           const __nv_bfloat16* vs,
                                           float (&acc)[DP / 8][4]) {
  constexpr int kP = tc_pitch(DP);
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const int r = kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
    for (int nn = 0; nn < DP / 16; ++nn) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, smem_addr(vs + r * kP + nn * 16 + (lane / 16) * 8));
      mma_bf16(acc[2 * nn], pf[kk], vb[0], vb[1]);
      mma_bf16(acc[2 * nn + 1], pf[kk], vb[2], vb[3]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_tc_kernel(const __nv_bfloat16* __restrict__ Q,
                const __nv_bfloat16* __restrict__ K,
                const __nv_bfloat16* __restrict__ V,
                __nv_bfloat16* __restrict__ O, int h, int hkv, int sq,
                int skv, int d, int causal, float scale_log2, Strides st,
                int vec16) {
  constexpr int kP = tc_pitch(DP);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // two
  __nv_bfloat16* sv = sk + 2 * kTcKv * kP;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh % h;
  const int hk = hh / (h / hkv);
  // heaviest causal q tiles first: blockIdx.y is the slowest grid axis
  const int iq = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = iq * kTcRows;
  const __nv_bfloat16* qg = Q + b * st.q[0] + hh * st.q[1] + q0 * st.q[2];
  const __nv_bfloat16* kg = K + b * st.k[0] + hk * st.k[1];
  const __nv_bfloat16* vg = V + b * st.v[0] + hk * st.v[1];
  // the inductive trip count: a causal CTA stops at its diagonal tile
  const int last = min(q0 + kTcRows, sq) - 1;
  const int tiles = causal ? last / kTcKv + 1 : (skv + kTcKv - 1) / kTcKv;

  load_tile<DP, kTcRows>(sv, qg, st.q[2], sq - q0, d, vec16);
  load_tile<DP, kTcKv>(sk, kg, st.k[2], skv, d, vec16);
  cp_async_commit();

  uint32_t qf[DP / 16][4];
  uint32_t pf[kTcKv / 16][4];
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m0 = kNeg, m1 = kNeg;      // rows g and g + 8 of the warp
  float l0 = 0.0f, l1 = 0.0f;      // this thread's share of their sums
  const int row0 = q0 + warp * 16 + lane / 4;

  // K(t + 1) loads during all of step t, V(t) while S(t) and its softmax
  // compute (one V buffer: P V(t - 1) must be done with it first)
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kTcKv;
    const __nv_bfloat16* ks = sk + (t & 1) * kTcKv * kP;
    cp_async_wait_all();
    __syncthreads();               // K(t) (and Q) landed; V's buffer free
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int r = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        ldmatrix_x4(qf[kk], smem_addr(sv + r * kP + kk * 16 + (lane / 16) * 8));
      }
      __syncthreads();             // every warp holds its Q before V(0)
    }
    load_tile<DP, kTcKv>(sv, vg + k0 * st.v[2], st.v[2], skv - k0, d, vec16);
    cp_async_commit();
    if (t + 1 < tiles)
      load_tile<DP, kTcKv>(sk + ((t + 1) & 1) * kTcKv * kP,
                           kg + (k0 + kTcKv) * st.k[2], st.k[2],
                           skv - k0 - kTcKv, d, vec16);
    cp_async_commit();             // (an empty group on the last tile)
    const bool diag = causal && t == tiles - 1;
    const bool mask = diag || k0 + kTcKv > skv;
    // on the diagonal of a q tile in the first half of its 128-row block,
    // the tile's last 64 columns lie above every row: p = 0 there exactly
    const bool half = diag && q0 + kTcRows <= k0 + kTcKv / 2;
    if (half)
      scores_softmax<DP, 8>(qf, ks, mask, k0, row0, skv, causal, scale_log2,
                            m0, m1, l0, l1, acc, pf);
    else
      scores_softmax<DP, 16>(qf, ks, mask, k0, row0, skv, causal,
                             scale_log2, m0, m1, l0, l1, acc, pf);
    cp_async_wait_but1();
    __syncthreads();               // V(t) landed (K(t + 1) may be in flight)
    if (half)
      pv_product<DP, 8>(pf, sv, acc);
    else
      pv_product<DP, 16>(pf, sv, acc);
  }
  __syncthreads();                 // every warp is done reading V

  // out = acc / max(l, 1e-30) in bf16, staged in this warp's 16 rows of the
  // V buffer, then stored in 16- or 8-byte pieces
  l0 = fmaxf(quad_sum(l0), 1e-30f);
  l1 = fmaxf(quad_sum(l1), 1e-30f);
  __nv_bfloat16* so = sv + warp * 16 * kP;
  const int g = lane / 4;
  const int c2 = (lane % 4) * 2;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + c2;
    *reinterpret_cast<uint32_t*>(so + g * kP + col) =
        pack_bf16(acc[n][0] / l0, acc[n][1] / l0);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * kP + col) =
        pack_bf16(acc[n][2] / l1, acc[n][3] / l1);
  }
  __syncwarp();
  __nv_bfloat16* og = O + b * st.o[0] + hh * st.o[1];
  const int rbase = q0 + warp * 16;
  if (vec16) {
    constexpr int kChunks = DP / 8;
    for (int c = lane; c < 16 * kChunks; c += 32) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 8;
      if (rbase + r < sq && col < d)
        *reinterpret_cast<uint4*>(og + (rbase + r) * st.o[2] + col) =
            *reinterpret_cast<const uint4*>(so + r * kP + col);
    }
  } else {
    constexpr int kChunks = DP / 4;
    for (int c = lane; c < 16 * kChunks; c += 32) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 4;
      if (rbase + r < sq && col < d)
        *reinterpret_cast<uint2*>(og + (rbase + r) * st.o[2] + col) =
            *reinterpret_cast<const uint2*>(so + r * kP + col);
    }
  }
}

template <int DP>
int launch_tc(const void* q, const void* k, const void* v, void* o, int b,
              int h, int hkv, int sq, int skv, int d, int causal,
              float scale, const Strides& st, int vec16, void* stream) {
  const size_t smem = smem_tc(d);
  cudaError_t err = allow_smem(flash_tc_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (sq + kTcRows - 1) / kTcRows);
  flash_tc_kernel<DP><<<grid, kTcThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      h, hkv, sq, skv, d, causal, scale * kLog2e, st, vec16);
  return cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int h, int hkv, int sq, int skv, int d, int bkv, int causal,
               float scale, const Strides& st, void* stream) {
  const size_t smem = smem_f32(d);
  cudaError_t err = allow_smem(flash_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kRows - 1) / kRows, h, b);
  flash_kernel<<<grid, kFlashThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), h, hkv, sq, skv,
      d, bkv, causal, scale, st);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

extern "C" {

size_t flash_attention_smem(int d, int bf16) {
  return bf16 ? repro_torch::smem_tc(d) : repro_torch::smem_f32(d);
}

// q (b, h, sq, d), k / v (b, hkv, skv, d) -> o (b, h, sq, d), each read or
// written through its element strides (batch, head, row; the last axis
// contiguous), all float32 (bf16 = 0: the SIMT form, kv tiles of bkv <= 128
// dividing skv) or all bfloat16 (bf16 = 1: the tensor-core form, kv tiles
// of 128 rows, any skv; vec16 = 1 when every pointer and stride allows
// 16-byte copies, else 8-byte ones).  d <= 128 and d % 4 == 0, h % hkv ==
// 0, sq == skv when causal.  *tc is set to the form launched (1 the
// tensor-core form, 0 the SIMT form) when the launch succeeds, and left
// as it was when it fails.
int flash_attention_run(const void* q, const void* k, const void* v, void* o,
                        int b, int h, int hkv, int sq, int skv, int d,
                        int bkv, int causal, float scale, int bf16,
                        long long q_sb, long long q_sh, long long q_ss,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        long long o_sb, long long o_sh, long long o_ss,
                        int vec16, int* tc, void* stream) {
  using namespace repro_torch;
  const Strides st = {{q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss},
                      {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss}};
  if (!bf16) {
    const int err = launch_f32(q, k, v, o, b, h, hkv, sq, skv, d, bkv,
                               causal, scale, st, stream);
    if (err == cudaSuccess) *tc = 0;
    return err;
  }
  // the tensor-core form compiled for each D' = D rounded up to 16
  using Launch = int (*)(const void*, const void*, const void*, void*, int,
                         int, int, int, int, int, int, float,
                         const Strides&, int, void*);
  static constexpr Launch kForms[] = {
      launch_tc<16>, launch_tc<32>, launch_tc<48>, launch_tc<64>,
      launch_tc<80>, launch_tc<96>, launch_tc<112>, launch_tc<128>};
  const int form = (d + 15) / 16 - 1;
  if (form < 0 || form >= 8) return cudaErrorInvalidValue;
  const int err = kForms[form](q, k, v, o, b, h, hkv, sq, skv, d, causal,
                               scale, st, vec16, stream);
  if (err == cudaSuccess) *tc = 1;
  return err;
}

}  // extern "C"
