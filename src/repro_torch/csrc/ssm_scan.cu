// K21: the chunked SSD (Mamba2) scan, one CTA per (batch, head, 32 columns
// of P).
//
// Replaces: src/repro/kernels/ssm_scan.py, ssm_scan_pallas (_ssm_kernel):
// x (B, H, S, P), a (B, H, S), b / c (B, S, N) shared across heads or
// (B, H, S, N) per head; over chunks of cs rows in order, in float32:
//   la = cumsum(log(max(a, 1e-20)))                       (cs)
//   M  = tril((C B^T) * exp(la_i - la_j))                 (cs x cs)
//   y  = M x + exp(la) * (C h)                            (cs x P)
//   h <- exp(la_last) h + (B * exp(la_last - la))^T x     (N x P)
// with h = 0 before the first chunk; y and the final h in x's dtype.
//
// What bounds it on an H100: the least work, cs(cs+1) N + cs(cs+1) P + 4 cs
// N P FLOPs a chunk (the triangle of C B^T, M x, C h and the state update),
// against bytes read and written once, puts the model shapes (zamba2: N =
// 64, P = 160, cs = 128; xLSTM: N = 192, P = 385, cs = 64) on the operations
// side of the float32 roofline (67 TFLOP/s: the kernel computes in IEEE
// float32 on FMAs, as the reference's kernel upcasts every input).  The
// kernel stays well above that bound: each CTA rebuilds M for its own 32
// columns of P (5 times over at zamba2's P, 13 at xLSTM's), one CTA fits an
// SM (156 KB of shared memory at zamba2's shapes), and the products read
// shared memory once every four FMAs.  Tensor cores, one M per (batch,
// head) and chunks in parallel (the state passed between them afterwards)
// are later work.
//
// Design: the reference's sequential chunk axis ("arbitrary") becomes a loop
// inside the CTA, as K20's kv axis did; the columns of P are independent
// given M, so they are a grid axis, which also keeps the state h (N x P, 296
// KB at xLSTM's 192 x 385 in float32) within reach: the CTA's N x 32 of it
// stays in registers across chunks, with a copy in shared memory for the
// C h product.  Per chunk the CTA stages C^T, B^T (row pitch cs16 + 1, so
// the transposing stores are free of bank conflicts), the x tile and the
// log-decays in shared memory, each thread issuing kStage loads before it
// stores any; warp 0 scans the decays; a 16 x 16 thread grid computes C B^T
// with up to 8 x 8 entries a thread in registers, skipping the entries a
// thread's row and column offsets put above the diagonal, and writes M; then
// y and, after B^T is scaled by exp(la_last - la) in place, the state, each
// thread holding 4 adjacent columns (one float4 of the x tile or of h per
// row) of rows tr, tr + 32, ...; M x skips the 32-column blocks above a
// row's diagonal block.  Rows past cs (cs rounded up to 16) and columns past
// P are zero, so no product needs a mask; only the stores do.  The chunk
// sizes the models use (zamba2's 128, xLSTM's 64) get a kernel compiled for
// their cs16, whose loops unroll fully; other chunks take the general one.
// Inputs are read through strides (the last axis contiguous), so the (B, S,
// H, P) layout of ops.ssm_scan and a shared B / C (head stride 0) need no
// copy.
#include <cuda_bf16.h>

#include <cstddef>

#include "lane_common.cuh"

namespace repro_torch {
namespace {

constexpr int kCols = 32;                       // columns of P in one CTA
constexpr int kScanThreads = 256;
constexpr int kColVec = 4;                      // columns of y / h a thread
constexpr int kColGroups = kCols / kColVec;             // 8
constexpr int kRowGroups = kScanThreads / kColGroups;   // 32
constexpr int kMaxChunk = 128;
constexpr int kMaxState = 256;
constexpr int kGramSide = 16;                   // C B^T on a 16 x 16 grid
constexpr int kGramTile = kMaxChunk / kGramSide;        // <= 8 x 8 a thread
constexpr int kYRows = kMaxChunk / kRowGroups;          // <= 4 rows of y
constexpr int kHRows = kMaxState / kRowGroups;          // <= 8 rows of h
constexpr int kStage = 8;                       // loads in flight a thread

struct Strides {   // in elements, over (batch, head, sequence)
  long long b, h, s;
};

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__host__ __device__ inline int round16(int cs) { return (cs + 15) / 16 * 16; }

// Shared memory, in floats: the x tile (cs16 x kCols), h (n x kCols) and la
// (cs16), 16-byte aligned for float4 reads, then C^T and B^T (n x ld each)
// and M (cs16 x ld), ld = cs16 + 1.
size_t smem_floats(int cs, int n) {
  const size_t cs16 = round16(cs);
  const size_t ld = cs16 + 1;
  return cs16 * kCols + static_cast<size_t>(n) * kCols + cs16 + 2 * n * ld +
         cs16 * ld;
}

// CS16: the chunk rounded up to 16 when it is compiled in, 0 for any chunk.
template <typename T, int CS16>
__global__ void __launch_bounds__(kScanThreads)
ssm_scan_kernel(const T* __restrict__ X, const T* __restrict__ A,
                const T* __restrict__ B, const T* __restrict__ C,
                T* __restrict__ Y, T* __restrict__ H, int heads, int s, int p,
                int n, int cs, Strides xst, Strides ast, Strides bst,
                Strides cst, Strides yst) {
  extern __shared__ __align__(16) float smem[];
  const int cs16 = CS16 ? CS16 : round16(cs);
  const int ld = cs16 + 1;
  float* xt = smem;                  // cs16 x kCols, the x tile
  float* hs = xt + cs16 * kCols;     // n x kCols, h
  float* la = hs + n * kCols;        // cs16, the cumulative log-decay
  float* ct = la + cs16;             // n x ld, C^T
  float* bt = ct + n * ld;           // n x ld, B^T (then scaled)
  float* mm = bt + n * ld;           // cs16 x ld, M

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kCols;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int tc = (tid % kColGroups) * kColVec;   // columns tc .. tc + 3
  const int tr = tid / kColGroups;               // rows tr, tr + 32, ...
  const int gx = tid % kGramSide;    // M columns gx, gx + 16, ...
  const int gy = tid / kGramSide;    // M rows gy, gy + 16, ...
  const int gt = cs16 / kGramSide;   // M rows (columns) a thread
  const int yr = (cs16 + kRowGroups - 1) / kRowGroups;   // y rows a thread
  const int hr = (n + kRowGroups - 1) / kRowGroups;      // h rows a thread

  const T* xg = X + bb * xst.b + hh * xst.h + p0;
  const T* ag = A + bb * ast.b + hh * ast.h;
  const T* bg = B + bb * bst.b + hh * bst.h;
  const T* cg = C + bb * cst.b + hh * cst.h;
  T* yg = Y + bb * yst.b + hh * yst.h + p0;

  float hreg[kHRows][kColVec];
#pragma unroll
  for (int k = 0; k < kHRows; ++k)
#pragma unroll
    for (int q = 0; q < kColVec; ++q) hreg[k][q] = 0.0f;
  for (int e = tid; e < n * kCols; e += kScanThreads) hs[e] = 0.0f;

  for (int c0 = 0; c0 < s; c0 += cs) {
    __syncthreads();   // the previous chunk is done with every buffer
    // stage the chunk; rows past cs are zero (log-decay 0: la stays flat)
    for (int i = tid; i < cs16; i += kScanThreads)
      la[i] = i < cs ? logf(fmaxf(to_f32(ag[(c0 + i) * ast.s]), 1e-20f)) : 0.0f;
    for (int base = tid; base < cs16 * n; base += kScanThreads * kStage) {
      float cv[kStage], bv[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int e = base + u * kScanThreads;
        const int i = e / n;
        const int k = e - i * n;
        const bool live = e < cs16 * n && i < cs;
        cv[u] = live ? to_f32(cg[(c0 + i) * cst.s + k]) : 0.0f;
        bv[u] = live ? to_f32(bg[(c0 + i) * bst.s + k]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int e = base + u * kScanThreads;
        if (e < cs16 * n) {
          const int i = e / n;
          const int k = e - i * n;
          ct[k * ld + i] = cv[u];
          bt[k * ld + i] = bv[u];
        }
      }
    }
    for (int base = tid; base < cs16 * kCols; base += kScanThreads * kStage) {
      float xv[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int e = base + u * kScanThreads;
        const int j = e / kCols;
        const int q = e % kCols;
        xv[u] = e < cs16 * kCols && j < cs && p0 + q < p
                    ? to_f32(xg[(c0 + j) * xst.s + q]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int e = base + u * kScanThreads;
        if (e < cs16 * kCols) xt[e] = xv[u];
      }
    }
    __syncthreads();

    // the non-critical region: warp 0 scans the log-decays, each lane a run
    // of consecutive entries, then the lanes' sums across the warp
    if (tid < 32) {
      const int per = (cs16 + 31) / 32;
      const int i0 = tid * per;
      float run = 0.0f;
      for (int k = 0; k < per && i0 + k < cs16; ++k) {
        run += la[i0 + k];
        la[i0 + k] = run;
      }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) before = 0.0f;
      for (int k = 0; k < per && i0 + k < cs16; ++k) la[i0 + k] += before;
    }
    __syncthreads();

    // critical region 1: M = tril(C B^T * exp(la_i - la_j)); entry (u, v)
    // of a thread is row gy + 16 u, column gx + 16 v, above the diagonal
    // wherever v > u
    {
      float acc[kGramTile][kGramTile];
#pragma unroll
      for (int u = 0; u < kGramTile; ++u)
#pragma unroll
        for (int v = 0; v < kGramTile; ++v) acc[u][v] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        float cr[kGramTile], br[kGramTile];
#pragma unroll
        for (int u = 0; u < kGramTile; ++u) {
          cr[u] = u < gt ? ct[k * ld + gy + kGramSide * u] : 0.0f;
          br[u] = u < gt ? bt[k * ld + gx + kGramSide * u] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kGramTile; ++u)
#pragma unroll
          for (int v = 0; v <= u; ++v)
            acc[u][v] = fmaf(cr[u], br[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < kGramTile; ++u)
#pragma unroll
        for (int v = 0; v < kGramTile; ++v) {
          if (u >= gt || v >= gt) continue;
          const int i = gy + kGramSide * u;
          const int j = gx + kGramSide * v;
          mm[i * ld + j] = v <= u && j <= i ? acc[u][v] * expf(la[i] - la[j])
                                            : 0.0f;
        }
    }
    __syncthreads();

    // critical region 2: y = M x + exp(la) (C h), h the carried state; and
    // B^T scaled by exp(la_last - la) for the state update (not read here)
    const float total = la[cs16 - 1];
    {
      float acc[kYRows][kColVec], ch[kYRows][kColVec];
#pragma unroll
      for (int k = 0; k < kYRows; ++k)
#pragma unroll
        for (int q = 0; q < kColVec; ++q) acc[k][q] = ch[k][q] = 0.0f;
      // M is lower triangular: row tr + 32 k reads the 32-column blocks
      // jb <= k only
      for (int jb = 0; jb < yr; ++jb) {
        const int jend = min(cs16, (jb + 1) * kRowGroups);
#pragma unroll 4
        for (int j = jb * kRowGroups; j < jend; ++j) {
          const float4 xv =
              *reinterpret_cast<const float4*>(&xt[j * kCols + tc]);
#pragma unroll
          for (int k = 0; k < kYRows; ++k) {
            const int i = tr + kRowGroups * k;
            if (k < yr && k >= jb && i < cs16) {
              const float m = mm[i * ld + j];
              acc[k][0] = fmaf(m, xv.x, acc[k][0]);
              acc[k][1] = fmaf(m, xv.y, acc[k][1]);
              acc[k][2] = fmaf(m, xv.z, acc[k][2]);
              acc[k][3] = fmaf(m, xv.w, acc[k][3]);
            }
          }
        }
      }
#pragma unroll 4
      for (int r = 0; r < n; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(&hs[r * kCols + tc]);
#pragma unroll
        for (int k = 0; k < kYRows; ++k) {
          const int i = tr + kRowGroups * k;
          if (k < yr && i < cs16) {
            const float c = ct[r * ld + i];
            ch[k][0] = fmaf(c, hv.x, ch[k][0]);
            ch[k][1] = fmaf(c, hv.y, ch[k][1]);
            ch[k][2] = fmaf(c, hv.z, ch[k][2]);
            ch[k][3] = fmaf(c, hv.w, ch[k][3]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kYRows; ++k) {
        const int i = tr + kRowGroups * k;
        if (k >= yr || i >= cs) continue;
        const float e = expf(la[i]);
#pragma unroll
        for (int q = 0; q < kColVec; ++q)
          if (p0 + tc + q < p)
            store(&yg[(c0 + i) * yst.s + tc + q], acc[k][q] + e * ch[k][q]);
      }
      for (int e = tid; e < n * cs16; e += kScanThreads) {
        const int r = e / cs16;
        const int j = e % cs16;
        bt[r * ld + j] *= expf(total - la[j]);
      }
    }
    __syncthreads();

    // the ordered dependence: h <- exp(la_last) h + (B w)^T x
    {
      float acc[kHRows][kColVec];
#pragma unroll
      for (int k = 0; k < kHRows; ++k)
#pragma unroll
        for (int q = 0; q < kColVec; ++q) acc[k][q] = 0.0f;
#pragma unroll 4
      for (int j = 0; j < cs16; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(&xt[j * kCols + tc]);
#pragma unroll
        for (int k = 0; k < kHRows; ++k) {
          const int r = tr + kRowGroups * k;
          if (k < hr && r < n) {
            const float bw = bt[r * ld + j];
            acc[k][0] = fmaf(bw, xv.x, acc[k][0]);
            acc[k][1] = fmaf(bw, xv.y, acc[k][1]);
            acc[k][2] = fmaf(bw, xv.z, acc[k][2]);
            acc[k][3] = fmaf(bw, xv.w, acc[k][3]);
          }
        }
      }
      const float decay = expf(total);
#pragma unroll
      for (int k = 0; k < kHRows; ++k) {
        const int r = tr + kRowGroups * k;
        if (k < hr && r < n) {
#pragma unroll
          for (int q = 0; q < kColVec; ++q)
            hreg[k][q] = fmaf(decay, hreg[k][q], acc[k][q]);
          *reinterpret_cast<float4*>(&hs[r * kCols + tc]) =
              make_float4(hreg[k][0], hreg[k][1], hreg[k][2], hreg[k][3]);
        }
      }
    }
  }

  T* hg = H + (static_cast<size_t>(bb) * heads + hh) * n * p + p0;
#pragma unroll
  for (int k = 0; k < kHRows; ++k) {
    const int r = tr + kRowGroups * k;
    if (k >= hr || r >= n) continue;
#pragma unroll
    for (int q = 0; q < kColVec; ++q)
      if (p0 + tc + q < p)
        store(&hg[static_cast<size_t>(r) * p + tc + q], hreg[k][q]);
  }
}

template <typename T>
int launch(const void* x, const void* a, const void* b, const void* c,
           void* y, void* h, int batch, int heads, int s, int p, int n,
           int cs, Strides xst, Strides ast, Strides bst, Strides cst,
           Strides yst, void* stream) {
  if (cs < 1 || cs > kMaxChunk || n < 1 || n > kMaxState || s % cs)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(cs, n);
  const int cs16 = round16(cs);
  auto kernel = cs16 == 128 ? ssm_scan_kernel<T, 128>
                : cs16 == 64 ? ssm_scan_kernel<T, 64>
                             : ssm_scan_kernel<T, 0>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p + kCols - 1) / kCols, heads, batch);
  kernel<<<grid, kScanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(y),
      static_cast<T*>(h), heads, s, p, n, cs, xst, ast, bst, cst, yst);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

extern "C" {

size_t ssm_scan_smem(int cs, int n) {
  return sizeof(float) * repro_torch::smem_floats(cs, n);
}

// x (batch, heads, s, p), a (batch, heads, s), b / c (batch, heads, s, n)
// -> y (batch, heads, s, p), h (batch, heads, n, p) contiguous; x, a, b, c
// and y are read and written through the (batch, head, sequence) strides
// given, in elements (a head stride of 0 shares b / c across heads), each
// with a contiguous last axis.  All float32 (bf16 = 0) or all bfloat16
// (bf16 = 1); 1 <= cs <= 128 dividing s, 1 <= n <= 256, and the block's
// shared memory (ssm_scan_smem) within the card's 227 KB: n <= 128 at
// cs = 128, n <= 256 at cs <= 64.
int ssm_scan_run(const void* x, const void* a, const void* b, const void* c,
                 void* y, void* h, int batch, int heads, int s, int p, int n,
                 int cs, long long x_sb, long long x_sh, long long x_ss,
                 long long a_sb, long long a_sh, long long a_ss,
                 long long b_sb, long long b_sh, long long b_ss,
                 long long c_sb, long long c_sh, long long c_ss,
                 long long y_sb, long long y_sh, long long y_ss, int bf16,
                 void* stream) {
  using namespace repro_torch;
  const Strides xst{x_sb, x_sh, x_ss}, ast{a_sb, a_sh, a_ss},
      bst{b_sb, b_sh, b_ss}, cst{c_sb, c_sh, c_ss}, yst{y_sb, y_sh, y_ss};
  return bf16 ? launch<__nv_bfloat16>(x, a, b, c, y, h, batch, heads, s, p,
                                      n, cs, xst, ast, bst, cst, yst, stream)
              : launch<float>(x, a, b, c, y, h, batch, heads, s, p, n, cs,
                              xst, ast, bst, cst, yst, stream);
}

}  // extern "C"
