// K7: batched radix-2 FFT on separate re/im planes, the stages in
// registers.
//
// Replaces: src/repro/kernels/fft.py, fft_pallas (_fft_kernel, fft_tables),
// also served through pipelines/pusch.py pusch_fft_pallas.  Iterative
// Cooley-Tukey after the bit-reversal permutation: stage s pairs i =
// ((b >> s) << (s+1)) | off with j = i + 2^s and multiplies by entry
// 2^s - 1 + off of the host-built chunked twiddle table (fft_tables), never
// by a sin/cos computed on the card.  Each butterfly is fft_plain's four
// products and four sums, written with __fmul_rn / __fadd_rn / __fsub_rn so
// that nvcc cannot contract them into FMAs, and it multiplies by the
// table's 1 and 0 too (a non-finite input spreads as in the plain version):
// the kernel equals fft_plain bit for bit.
//
// What bounds it on an H100: bytes.  A row reads and writes 2 n floats (16 n
// bytes) and does 5 n log2 n FLOPs, far below the card's 67 TFLOP/s per
// byte moved.  The bytes are already minimal (one read, one write, in
// place in the stacked PUSCH layout), so the design removes latency: the
// stages run in registers, and no twiddle is read on a stage's dependent
// chain.
//
// The plan is kernels/fft.py's fft_plan: the wrapper passes threads a row,
// rows a CTA, staged batches a warp (the depth) and shared memory.  This
// file holds only what has to be compiled: a template instance a size and
// depth (0 or kStagedDepth on the warp route), whose threads a row fix the
// registers a thread holds, and the launch bounds; the entry refuses a plan
// that is not a compiled instance's.
//
// Rows of up to 1024 points (the warp route, fft_kernel): n = 2^L points
// on T = 2^floor(L/2) threads of one warp, P = n / T points a thread.
//   * Staging (from 256 points, the plan's depth 2).  A carrier's 3,276
//     rows of 1024 fill the card about once, so rows loaded, computed and
//     stored in lockstep left the memory idle while every SM computed.
//     Here a warp takes batches of 32 / T rows and keeps two of them in
//     flight, copied by cp.async (16 bytes a copy, in natural order) into
//     its shared-memory slots: the next batch arrives while this one runs.
//     The grid holds as many CTAs as the launch's device keeps resident
//     (occupancy asked at each launch); each warp loops over its batches.  Below 256 points (depth 0) a thread loads
//     its points straight into registers, all 2 P issued before the first
//     butterfly: 64 B a thread at 64 points, 96 KB an SM at twelve CTAs an
//     SM, about 3.8 us of an SM's share of 3.35 TB/s, well past the
//     memory's latency; the PUSCH shape's 117,936 rows fill the card
//     several times over, so CTAs in other phases keep the memory busy
//     while one computes.  Staging these rows too cost 1.3 % at the PUSCH
//     shape (PERF.md, K7 findings).
//   * Load.  After bit reversal, thread g's point j is x_perm[g P + j] =
//     x[T rev_P(j) + rev_T(g)]: for each j the T threads of a row read T
//     contiguous floats (of device memory, or of the staged slot).
//   * Pass 1: stages 0 .. log2 P - 1 pair points inside blocks of P
//     consecutive indices, all in one thread's registers.  Their twiddles
//     (entries 0 .. P - 2, the same in every thread) travel by value as a
//     kernel argument and are read as constant-bank operands.
//   * One exchange, the row transposed through its slot (a row's, or the
//     staged row's), padded by one
//     float a P block (thread g writes point g P + j at g (P + 1) + j,
//     reads point c + P t at t (P + 1) + c; slots n + T floats apart;
//     every access of a warp hits 32 banks, as tests/test_torch_fft_plan.py
//     checks for every plan).  A row lies within a warp, so __syncwarp
//     orders it: no CTA-wide barrier.
//   * Pass 2: stages log2 P .. L - 1 pair points c + P t and c + P (t +
//     2^s') for a fixed c < P, a T-point transform over t.  Thread g takes
//     the P / T groups c = g + T q in registers; their T - 1 twiddles a
//     group (entries 2^s - 1 + c + P (t mod 2^s'); 7 at 64 points, 31 at
//     1024) are loaded into registers once, before the first batch (held
//     in local memory they cost about a fifth of the time at 1024 points).
//   * Store: for each register, the T threads of a row write T contiguous
//     floats of the output row, which group / group_stride place (the
//     stacked (B, 2, A, n) layout of pusch_fft_fused).
//   At most 170 registers, so three CTAs of four warps share an SM at 1024
//   points with 24 rows (about 200 KB) in flight.
//
// Rows of 2048 to 16384 points (the wide route, fft_wide_kernel): a row
// spans n / 16 threads, one CTA, 16 points a thread; its stages run in
// passes of up to four in registers.  Pass k gives thread u the 16 points
// whose index varies in bits b .. b + 3 (b = min(4 k, L - 4)), the other
// bits being u's, so each of the pass's stages pairs two points of one
// thread.  Pass 0 loads from device memory in bit-reversed order (thread
// u is g = rev_{L-4}(u), so for each register the CTA reads contiguous
// floats), the last pass stores contiguous floats, and between two passes
// the row goes through shared memory (both planes, 8 n bytes; the low five
// bits of an index XORed with its top five, so every access of a warp
// hits 32 banks but the second pass's, 2 to a bank) with one
// __syncthreads: a barrier a pass, none between the stages of a pass.
#include <cstddef>
#include <cstdint>

#include "lane_common.cuh"

namespace repro_torch {
namespace {

constexpr int kFftMaxLog = 14;        // rows up to 2^14 points
constexpr int kWarpCtaThreads = 128;  // launch bounds of the warp route
constexpr int kStagedDepth = 2;       // the compiled staged depth
constexpr int kWideLogP = 4;          // the wide route: 16 points a thread

template <int BITS>
__host__ __device__ constexpr int reverse_bits(int v) {
  int r = 0;
  for (int b = 0; b < BITS; ++b) r |= ((v >> b) & 1) << (BITS - 1 - b);
  return r;
}

// v's low BITS bits reversed (0 for BITS = 0).
template <int BITS>
__device__ __forceinline__ int brev_low(int v) {
  if constexpr (BITS == 0)
    return 0;
  else
    return static_cast<int>(__brev(static_cast<unsigned>(v)) >> (32 - BITS));
}

// One radix-2 butterfly in fft_plain's order: t = w v, u' = u + t,
// v' = u - t, each product and sum rounded on its own.
__device__ __forceinline__ void butterfly(float& ur, float& ui, float& vr,
                                          float& vi, float wr, float wi) {
  const float tr = __fsub_rn(__fmul_rn(wr, vr), __fmul_rn(wi, vi));
  const float ti = __fadd_rn(__fmul_rn(wr, vi), __fmul_rn(wi, vr));
  vr = __fsub_rn(ur, tr);
  vi = __fsub_rn(ui, ti);
  ur = __fadd_rn(ur, tr);
  ui = __fadd_rn(ui, ti);
}

// The first log2 P stages' twiddles, entries 0 .. P - 2 of the table,
// passed by value: the same in every thread, read as constant-bank
// operands.
template <int P>
struct Pass1Twiddles {
  float re[P - 1 > 0 ? P - 1 : 1];
  float im[P - 1 > 0 ? P - 1 : 1];
};

// Stages 0 .. LOG_P - 1 inside a thread's P points x_perm[g P + j].
template <int LOG_P, int P = 1 << LOG_P>
__device__ __forceinline__ void pass1(float (&re)[P], float (&im)[P],
                                      const Pass1Twiddles<P>& w1) {
#pragma unroll
  for (int s = 0; s < LOG_P; ++s) {
    const int half = 1 << s;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (j & half) continue;
      const int w = half - 1 + (j & (half - 1));
      butterfly(re[j], im[j], re[j + half], im[j + half], w1.re[w],
                w1.im[w]);
    }
  }
}

// The warp route's compiled shape of an n = 2^LOG_N point row.
template <int LOG_N>
struct Plan {
  static constexpr int N = 1 << LOG_N;
  static constexpr int LOG_T = LOG_N / 2;
  static constexpr int T = 1 << LOG_T;            // threads a row
  static constexpr int LOG_P = LOG_N - LOG_T;
  static constexpr int P = 1 << LOG_P;            // points a thread
  static constexpr int G = P / T;                 // pass-2 groups (1, 2)
  static constexpr int W2 = T > 1 ? T - 1 : 1;    // pass-2 twiddles a group
  static constexpr int R = 32 / T;                // rows a warp a batch
  // a row's slot in shared memory, each plane: the staged row, then its
  // exchange, padded by one float a P block (so N + T floats)
  static constexpr int SLOT = N + T;
  // staging copies 16 bytes, so rows and slots of whole 16-byte pieces
  // (from 16 points up)
  static constexpr bool STAGEABLE = N % 4 == 0 && SLOT % 4 == 0;
};

template <int LOG_N>
using Regs = float[Plan<LOG_N>::P];
template <int LOG_N>
using Twiddles2 = float[Plan<LOG_N>::G * Plan<LOG_N>::W2];

__host__ __device__ constexpr int floor_log2(int v) {
  return v > 1 ? 1 + floor_log2(v / 2) : 0;
}

// Pass 2's twiddles of a thread's groups, the same for every row it
// takes: slot q W2 + k holds stage LOG_P + s2 at offset m of group c = g
// + T q (k = 2^s2 - 1 + m), table entry (P << s2) - 1 + c + P m.
template <int LOG_N>
__device__ __forceinline__ void load_twiddles2(
    const float* __restrict__ WR, const float* __restrict__ WI, int g,
    Twiddles2<LOG_N>& w2r, Twiddles2<LOG_N>& w2i) {
  using Q = Plan<LOG_N>;
  if constexpr (Q::T > 1) {
#pragma unroll
    for (int q = 0; q < Q::G; ++q) {
#pragma unroll
      for (int k = 0; k < Q::W2; ++k) {
        const int s2 = floor_log2(k + 1);
        const int m = k + 1 - (1 << s2);
        const int w = (Q::P << s2) - 1 + g + Q::T * q + Q::P * m;
        w2r[q * Q::W2 + k] = __ldg(WR + w);
        w2i[q * Q::W2 + k] = __ldg(WI + w);
      }
    }
  }
}

// The exchange through the row's slot (sr, si): thread g's points g P + j
// out, its groups c = g + T q (points c + P t) in.  Point a P + b sits at
// a (P + 1) + b, so each access of the warp hits 32 banks.
template <int LOG_N>
__device__ __forceinline__ void exchange(Regs<LOG_N>& re, Regs<LOG_N>& im,
                                         float* sr, float* si, int g) {
  using Q = Plan<LOG_N>;
  constexpr int T = Q::T, P = Q::P;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    sr[g * (P + 1) + j] = re[j];
    si[g * (P + 1) + j] = im[j];
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < Q::G; ++q) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      re[q * T + t] = sr[t * (P + 1) + g + T * q];
      im[q * T + t] = si[t * (P + 1) + g + T * q];
    }
  }
}

// Pass 2: stages LOG_P .. LOG_N - 1, a T-point transform a group.
template <int LOG_N>
__device__ __forceinline__ void pass2(Regs<LOG_N>& re, Regs<LOG_N>& im,
                                      const Twiddles2<LOG_N>& w2r,
                                      const Twiddles2<LOG_N>& w2i) {
  using Q = Plan<LOG_N>;
#pragma unroll
  for (int s2 = 0; s2 < Q::LOG_T; ++s2) {
    const int half = 1 << s2;
#pragma unroll
    for (int q = 0; q < Q::G; ++q) {
#pragma unroll
      for (int t = 0; t < Q::T; ++t) {
        if (t & half) continue;
        const int w = q * Q::W2 + half - 1 + (t & (half - 1));
        const int i = q * Q::T + t;
        butterfly(re[i], im[i], re[i + half], im[i + half], w2r[w],
                  w2i[w]);
      }
    }
  }
}

// Output row `row`'s first float: rows of `group` at group_stride apart.
__device__ __forceinline__ size_t out_row(int row, int n, int group,
                                          int group_stride) {
  return static_cast<size_t>(row / group) * group_stride +
         static_cast<size_t>(row % group) * n;
}

// The thread's registers after pass 2 into the output row: for each
// register the T threads of the row write T contiguous floats.
template <int LOG_N>
__device__ __forceinline__ void store_row(
    float* __restrict__ YR, float* __restrict__ YI, int row, int rows,
    int group, int group_stride, int g, const Regs<LOG_N>& re,
    const Regs<LOG_N>& im) {
  using Q = Plan<LOG_N>;
  if (row >= rows) return;
  const size_t out = out_row(row, Q::N, group, group_stride);
#pragma unroll
  for (int q = 0; q < Q::G; ++q) {
#pragma unroll
    for (int t = 0; t < Q::T; ++t) {
      YR[out + g + Q::T * q + Q::P * t] = re[q * Q::T + t];
      YI[out + g + Q::T * q + Q::P * t] = im[q * Q::T + t];
    }
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// One batch's rows (R rows of the warp) copied into a buffer of the warp
// by cp.async, 16 bytes a copy, in natural order: row r of plane p at
// p R SLOT + r SLOT; nothing past the last row.  One commit group.
template <int LOG_N>
__device__ __forceinline__ void stage_batch(const float* __restrict__ XR,
                                            const float* __restrict__ XI,
                                            int batch, int rows, float* buf,
                                            int lane) {
  using Q = Plan<LOG_N>;
  constexpr int PIECES = Q::N / 4;             // copies a row
  constexpr int CHUNKS = Q::R * PIECES;        // copies a plane
#pragma unroll
  for (int i = 0; i < 2 * CHUNKS / 32; ++i) {
    const int c = lane + 32 * i;
    const int plane = c / CHUNKS;
    const int r = c % CHUNKS / PIECES;
    const int k = c % PIECES;
    const int row = batch * Q::R + r;
    if (row < rows)
      cp_async16(buf + (plane * Q::R + r) * Q::SLOT + 4 * k,
                 (plane ? XI : XR) + static_cast<size_t>(row) * Q::N +
                     4 * k);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The warp route with rows loaded straight into registers (DEPTH 0): one
// row a group of T threads, its P points a thread read from device memory
// in bit-reversed order, all 2 P loads issued before any butterfly; the
// row's slot serves the exchange alone.
template <int LOG_N>
__device__ __forceinline__ void direct_rows(
    const float* __restrict__ XR, const float* __restrict__ XI,
    const float* __restrict__ WR, const float* __restrict__ WI,
    const Pass1Twiddles<Plan<LOG_N>::P>& w1, float* __restrict__ YR,
    float* __restrict__ YI, int rows, int group, int group_stride,
    float* smem) {
  using Q = Plan<LOG_N>;
  constexpr int T = Q::T, P = Q::P;
  const int rpc = blockDim.x / T;
  const int local = threadIdx.x / T;
  const int g = threadIdx.x % T;
  const int row = blockIdx.x * rpc + local;
  Regs<LOG_N> re, im;
  if (row < rows) {
    const int rg = brev_low<Q::LOG_T>(g);
    const float* xr = XR + static_cast<size_t>(row) * Q::N + rg;
    const float* xi = XI + static_cast<size_t>(row) * Q::N + rg;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      re[j] = __ldg(xr + T * reverse_bits<Q::LOG_P>(j));
      im[j] = __ldg(xi + T * reverse_bits<Q::LOG_P>(j));
    }
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) re[j] = im[j] = 0.0f;
  }
  // pass 2's twiddles (7 at 64 points), in flight with the row
  Twiddles2<LOG_N> w2r, w2i;
  load_twiddles2<LOG_N>(WR, WI, g, w2r, w2i);
  pass1<Q::LOG_P>(re, im, w1);
  if constexpr (T > 1) {
    float* sr = smem + local * Q::SLOT;
    exchange<LOG_N>(re, im, sr, sr + rpc * Q::SLOT, g);
  }
  pass2<LOG_N>(re, im, w2r, w2i);
  store_row<LOG_N>(YR, YI, row, rows, group, group_stride, g, re, im);
}

// The warp route with staged rows (DEPTH > 0): a warp takes batches of R =
// 32 / T rows, batch warp + k * (warps of the grid), and keeps DEPTH in
// flight in its shared-memory buffers: the next batch's rows arrive by
// cp.async while this one runs its stages.  A thread reads its points from
// the buffer in bit-reversed order (row slots N + T floats apart, so the R
// rows of a warp fall on other banks), and the exchange reuses the slot.
// The batch loop is the same in every lane, so every __syncwarp sees the
// whole warp.
template <int LOG_N, int DEPTH>
__device__ __forceinline__ void staged_rows(
    const float* __restrict__ XR, const float* __restrict__ XI,
    const float* __restrict__ WR, const float* __restrict__ WI,
    const Pass1Twiddles<Plan<LOG_N>::P>& w1, float* __restrict__ YR,
    float* __restrict__ YI, int rows, int group, int group_stride,
    float* smem) {
  using Q = Plan<LOG_N>;
  constexpr int T = Q::T, P = Q::P, R = Q::R;
  constexpr int BUF = 2 * R * Q::SLOT;        // one batch, both planes
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int local = lane / T;
  const int g = lane % T;
  const int rg = brev_low<Q::LOG_T>(g);
  const int batches = (rows + R - 1) / R;
  const int stride = gridDim.x * (blockDim.x / 32);
  float* const bufs = smem + warp * DEPTH * BUF;
  int batch = blockIdx.x * (blockDim.x / 32) + warp;
#pragma unroll
  for (int d = 0; d < DEPTH; ++d)
    stage_batch<LOG_N>(XR, XI, batch + d * stride, rows, bufs + d * BUF,
                       lane);
  Twiddles2<LOG_N> w2r, w2i;
  load_twiddles2<LOG_N>(WR, WI, g, w2r, w2i);
  for (int cur = 0; batch < batches;
       batch += stride, cur = cur + 1 < DEPTH ? cur + 1 : 0) {
    float* const buf = bufs + cur * BUF;
    float* const sr = buf + local * Q::SLOT;
    float* const si = sr + R * Q::SLOT;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(DEPTH - 1) : "memory");
    __syncwarp();                     // every lane's copies have landed
    Regs<LOG_N> re, im;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      re[j] = sr[T * reverse_bits<Q::LOG_P>(j) + rg];
      im[j] = si[T * reverse_bits<Q::LOG_P>(j) + rg];
    }
    pass1<Q::LOG_P>(re, im, w1);
    if constexpr (T > 1) {
      __syncwarp();                   // every lane has read its points
      exchange<LOG_N>(re, im, sr, si, g);
    }
    pass2<LOG_N>(re, im, w2r, w2i);
    store_row<LOG_N>(YR, YI, batch * R + local, rows, group, group_stride,
                     g, re, im);
    __syncwarp();                     // the slot's reads are done
    stage_batch<LOG_N>(XR, XI, batch + DEPTH * stride, rows, buf, lane);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The warp route, DEPTH staged batches a warp (0: rows loaded straight
// into registers).  Staged rows keep to 170 registers, so three CTAs of
// 128 threads share an SM (as many as their slots allow at 1024 points).
template <int LOG_N, int DEPTH>
__global__ void __launch_bounds__(kWarpCtaThreads, DEPTH ? 3 : 1)
fft_kernel(const float* __restrict__ XR, const float* __restrict__ XI,
           const float* __restrict__ WR, const float* __restrict__ WI,
           const Pass1Twiddles<Plan<LOG_N>::P> w1, float* __restrict__ YR,
           float* __restrict__ YI, int rows, int group, int group_stride) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (DEPTH > 0)
    staged_rows<LOG_N, DEPTH>(XR, XI, WR, WI, w1, YR, YI, rows, group,
                              group_stride, smem);
  else
    direct_rows<LOG_N>(XR, XI, WR, WI, w1, YR, YI, rows, group,
                       group_stride, smem);
}

// Where point i of a wide row sits in its shared-memory plane: its low
// five bits XORed with its top five (a permutation of the row).
template <int LOG_N>
__device__ __forceinline__ int wide_slot(int i) {
  return i ^ ((i >> (LOG_N - 5)) & 31);
}

// The wide route's pass K >= 1 and those after it.  Register j of
// thread u holds, in pass K, point at(K) + (j << B(K)): B(K) = min(4 K,
// L - 4) and at(K) = (u mod 2^B) | (u >> B) << (B + 4); in pass 0 (B = 0)
// thread u is g = rev_{L-4}(u), so at(0) = 16 g.  Pass K - 1's points go
// back where they came from, one barrier, then pass K's come in; each
// thread rewrites only the slots it read, so no barrier is needed before
// the writes.
template <int LOG_N, int K>
__device__ __forceinline__ void wide_passes(
    float (&re)[1 << kWideLogP], float (&im)[1 << kWideLogP], float* sr,
    float* si, int u, int at, const float* __restrict__ WR,
    const float* __restrict__ WI) {
  constexpr int LOG_P = kWideLogP, P = 1 << LOG_P;
  constexpr int PASSES = (LOG_N + LOG_P - 1) / LOG_P;
  constexpr int B_PREV = K == 1 ? 0
                         : LOG_P * (K - 1) < LOG_N - LOG_P ? LOG_P * (K - 1)
                                                           : LOG_N - LOG_P;
  constexpr int B = LOG_P * K < LOG_N - LOG_P ? LOG_P * K : LOG_N - LOG_P;
  constexpr int END = LOG_P * (K + 1) < LOG_N ? LOG_P * (K + 1) : LOG_N;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    sr[wide_slot<LOG_N>(at + (j << B_PREV))] = re[j];
    si[wide_slot<LOG_N>(at + (j << B_PREV))] = im[j];
  }
  __syncthreads();
  const int lo = u & ((1 << B) - 1);
  at = lo | (u >> B) << (B + LOG_P);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    re[j] = sr[wide_slot<LOG_N>(at + (j << B))];
    im[j] = si[wide_slot<LOG_N>(at + (j << B))];
  }
  // stages 4 K .. END - 1; stage s pairs j and j + 2^(s - B) at table
  // entry 2^s - 1 + lo + ((j mod 2^(s - B)) << B)
#pragma unroll
  for (int s = LOG_P * K; s < END; ++s) {
    const int half = 1 << (s - B);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (j & half) continue;
      const int w = (1 << s) - 1 + lo + ((j & (half - 1)) << B);
      butterfly(re[j], im[j], re[j + half], im[j + half], __ldg(WR + w),
                __ldg(WI + w));
    }
  }
  if constexpr (K + 1 < PASSES)
    wide_passes<LOG_N, K + 1>(re, im, sr, si, u, at, WR, WI);
}

// The wide route: one row a CTA of T = n / 16 threads (see the note).
template <int LOG_N>
__global__ void __launch_bounds__(1024)
fft_wide_kernel(const float* __restrict__ XR, const float* __restrict__ XI,
                const float* __restrict__ WR, const float* __restrict__ WI,
                const Pass1Twiddles<1 << kWideLogP> w1,
                float* __restrict__ YR, float* __restrict__ YI, int rows,
                int group, int group_stride) {
  constexpr int N = 1 << LOG_N, LOG_P = kWideLogP, P = 1 << LOG_P;
  constexpr int LOG_T = LOG_N - LOG_P, T = 1 << LOG_T;
  extern __shared__ __align__(16) float smem[];
  const int u = threadIdx.x;
  const int row = blockIdx.x;
  if (row >= rows) return;
  float re[P], im[P];
  const float* xr = XR + static_cast<size_t>(row) * N + u;
  const float* xi = XI + static_cast<size_t>(row) * N + u;
#pragma unroll
  for (int j = 0; j < P; ++j) {       // x_perm[16 g + j] = x[T rev_4(j) + u]
    re[j] = __ldg(xr + T * reverse_bits<LOG_P>(j));
    im[j] = __ldg(xi + T * reverse_bits<LOG_P>(j));
  }
  pass1<LOG_P>(re, im, w1);
  wide_passes<LOG_N, 1>(re, im, smem, smem + N, u,
                        brev_low<LOG_T>(u) << LOG_P, WR, WI);
  // the last pass has B = L - 4 and at = u: contiguous floats a register
  const size_t out = out_row(row, N, group, group_stride) + u;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    YR[out + j * T] = re[j];
    YI[out + j * T] = im[j];
  }
}

template <int P>
Pass1Twiddles<P> pass1_twiddles(const float* host_wr, const float* host_wi) {
  Pass1Twiddles<P> w1;
  for (int i = 0; i < P - 1; ++i) {
    w1.re[i] = host_wr[i];
    w1.im[i] = host_wi[i];
  }
  return w1;
}

struct Launch {
  const float *xr, *xi, *wr, *wi, *host_wr, *host_wi;
  float *yr, *yi;
  int rows, tpr, rpc, depth, group, group_stride;
  size_t smem;
  cudaStream_t stream;
};

// The warp route at DEPTH: one row a group of T threads for DEPTH 0; with
// staged rows as many CTAs as the launch's device keeps resident at once
// (each warp loops over its batches), fewer where the rows need fewer.
template <int LOG_N, int DEPTH>
cudaError_t launch_warp_at(const Launch& a) {
  using Q = Plan<LOG_N>;
  const int threads = a.tpr * a.rpc;
  const auto kernel = fft_kernel<LOG_N, DEPTH>;
  cudaError_t err = allow_smem(kernel, a.smem);
  if (err != cudaSuccess) return err;
  int blocks = (a.rows + a.rpc - 1) / a.rpc;
  if (DEPTH > 0) {
    int device, sms, per_sm;
    if ((err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, threads, a.smem)) != cudaSuccess)
      return err;
    if (blocks > sms * per_sm) blocks = sms * per_sm;
  }
  kernel<<<blocks, threads, a.smem, a.stream>>>(
      a.xr, a.xi, a.wr, a.wi, pass1_twiddles<Q::P>(a.host_wr, a.host_wi),
      a.yr, a.yi, a.rows, a.group, a.group_stride);
  return cudaGetLastError();
}

// The warp route: the plan's depth, 0 (rows straight into registers) or
// kStagedDepth (from 16 points up), each a compiled instance.
template <int LOG_N>
cudaError_t launch_warp(const Launch& a) {
  const int threads = a.tpr * a.rpc;
  if (a.tpr != Plan<LOG_N>::T || threads > kWarpCtaThreads || threads % 32)
    return cudaErrorInvalidValue;
  if (a.depth == 0) return launch_warp_at<LOG_N, 0>(a);
  if constexpr (Plan<LOG_N>::STAGEABLE)
    if (a.depth == kStagedDepth)
      return launch_warp_at<LOG_N, kStagedDepth>(a);
  return cudaErrorInvalidValue;
}

// The wide route: one row a CTA.
template <int LOG_N>
cudaError_t launch_wide(const Launch& a) {
  constexpr int P = 1 << kWideLogP;
  if (a.tpr != (1 << LOG_N) / P || a.rpc != 1 || a.depth)
    return cudaErrorInvalidValue;
  const auto kernel = fft_wide_kernel<LOG_N>;
  const cudaError_t err = allow_smem(kernel, a.smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.rows, a.tpr, a.smem, a.stream>>>(
      a.xr, a.xi, a.wr, a.wi, pass1_twiddles<P>(a.host_wr, a.host_wi), a.yr,
      a.yi, a.rows, a.group, a.group_stride);
  return cudaGetLastError();
}

// by log2 n: the warp route up to 2^10 points, the wide route past it
constexpr cudaError_t (*kLaunch[kFftMaxLog + 1])(const Launch&) = {
    nullptr,         launch_warp<1>,  launch_warp<2>,  launch_warp<3>,
    launch_warp<4>,  launch_warp<5>,  launch_warp<6>,  launch_warp<7>,
    launch_warp<8>,  launch_warp<9>,  launch_warp<10>, launch_wide<11>,
    launch_wide<12>, launch_wide<13>, launch_wide<14>};

}  // namespace
}  // namespace repro_torch

extern "C" {

// xr, xi (rows, n) -> out_re, out_im, float32; wr, wi (n-1) the chunked
// twiddles on the card and host_wr, host_wi the same table on the host
// (the first stages' entries travel as a kernel argument).  The plan is
// kernels/fft.py fft_plan's: tpr threads a row, rpc rows a CTA, depth
// staged batches a warp (the warp route), smem bytes of shared memory a
// CTA; a plan that is not a compiled instance's (threads a row, depth) is
// refused.  Output row r lands at (r / group) * group_stride + (r % group)
// * n floats from out_re / out_im, so a caller can write the (B, 2, A, n)
// stacked layout directly (group = A, group_stride = 2 A n).
int fft_f32(const void* xr, const void* xi, const void* wr, const void* wi,
            const void* host_wr, const void* host_wi, void* out_re,
            void* out_im, int rows, int n, int tpr, int rpc, int depth,
            int smem, int group, int group_stride, void* stream) {
  using namespace repro_torch;
  int log_n = 0;
  while (log_n <= kFftMaxLog && (1 << log_n) < n) ++log_n;
  if (n < 2 || log_n > kFftMaxLog || (1 << log_n) != n || rows < 1 ||
      group < 1 || smem < 0)
    return cudaErrorInvalidValue;
  const Launch a{static_cast<const float*>(xr),
                 static_cast<const float*>(xi),
                 static_cast<const float*>(wr),
                 static_cast<const float*>(wi),
                 static_cast<const float*>(host_wr),
                 static_cast<const float*>(host_wi),
                 static_cast<float*>(out_re),
                 static_cast<float*>(out_im),
                 rows, tpr, rpc, depth, group, group_stride,
                 static_cast<size_t>(smem),
                 static_cast<cudaStream_t>(stream)};
  return kLaunch[log_n](a);
}

}  // extern "C"
