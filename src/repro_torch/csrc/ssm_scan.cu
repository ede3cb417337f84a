// K21: the chunked SSD (Mamba2) scan, the chunks of a lane at once on a
// thread-block cluster with the state passed down it in order.
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
// What bounds it on an H100: the least work, cs(cs+1) N FLOPs a chunk for
// the triangle of C B^T (once per (batch, chunk) where B and C are shared
// across heads) and cs(cs+1) P + 4 cs N P a chunk and head for M x, C h and
// the state, against bytes read and written once, puts the model shapes
// (zamba2: N = 64, P = 160, cs = 128; xLSTM: N = 192, P = 385, cs = 64) on
// the operations side of the float32 roofline (67 TFLOP/s: the kernel
// computes in IEEE float32 on FMAs, as the reference's kernel upcasts every
// input).
//
// Design.  Only the N x P state passes from chunk to chunk: a chunk's M x
// and its own state (B w)^T x do not depend on it.  So the chunks of a lane
// (one batch, head and tw tiles of qt columns of P) run at once on a
// thread-block cluster of cl CTAs, rank r taking chunks r, r + cl, ... in
// order, and only the state goes down the cluster, in order, tile by tile.
//   * The gram once: a first pass (ssm_gram_kernel) writes the lower
//     triangle of G = C B^T of each (batch, chunk), and of each head where
//     B and C are per head, into a float32 work buffer that stays in L2,
//     beside C^T and B in float32; so a scan CTA stages all three by
//     cp.async (16 bytes a copy, all in flight, no registers), and C's
//     transposing loads are taken once a (batch, chunk) where B and C are
//     shared.  The scan grid launches while the pass runs (programmatic
//     dependent launch): a scan CTA stages its first x tile and its
//     log-decays, then waits for the pass (griddepcontrol.wait).
//   * One M per (batch, head, chunk): the chunk's CTA builds M^T = (G *
//     exp(la_i - la_j))^T in place, la by one warp's scan, scales B
//     by exp(la_last - la) (one expf a row), and keeps them for every tile
//     of columns it owns.
//   * Per tile of qt columns: the chunk's own state (SR x 4 a thread on
//     every thread, its rounds of tiles compiled in, so its loads run
//     ahead of their FMAs); the wait on an mbarrier for h_{c-1}'s tile
//     from rank r - 1 (in this
//     CTA's shared memory); h_c = exp(total) h_{c-1} + its own state stored
//     straight into rank r + 1's slot (st.shared::cluster, then a remote
//     arrive); and only then M x and C h_{c-1} (4 x 4 a thread: a float4
//     of M^T or C^T and one of x or h a step, 16 FMAs) and y = M x +
//     exp(la) (C h_{c-1}), the next tile's x loaded into registers over
//     them.  The state's sums and y's never live at once.
//     Rank r works on tile t while rank r + 1 takes tile t - 1's state: a
//     wavefront down the cluster.  The producer waits on an "empty"
//     mbarrier before it fills a slot again; ns slots a CTA (2 where each
//     rank takes one chunk, a tile each where ranks take more, so the ring
//     from the last rank back to rank 0 cannot close on itself).
// Every output element is one fmaf chain over its reduction index
// ascending from 0.0f (the gram over k; M x over j to the end of the row's
// 32-row block, the zeros above the diagonal included; C h over r; the
// state over j), then h = fmaf(decay, h, acc) and y = acc + e * ch, after
// one fixed scan, padding (rows past cs and columns past P zero) and
// rounding.  No plan changes that order, so every plan gives the same
// bits.  A first chunk's C h over h = 0 is +0, or NaN on a row of C that
// holds a value that is not finite, as that chain over zeros gives; it is
// not summed.  Inputs are read through strides (the last axis
// contiguous), so the (B, S, H, P) layout of ops.ssm_scan and a shared
// B / C (head stride 0) need no copy.  kernels/ssm_scan.py
// ssm_plan owns the plan (cl, tw, ns); the C entry refuses one off its
// formula.  An instance compiled with kOn stamps its phases
// (phase_clock.cuh); only ssm_scan_phases_f32 launches it.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

#include "cluster_launch.cuh"
#include "phase_clock.cuh"

namespace repro_torch {
namespace {

namespace ss_cg = cooperative_groups;

constexpr int kScanThreads = 256;
constexpr int kMaxChunk = 128;
constexpr int kMaxState = 256;
constexpr int kGramRows = 32;       // rows of G a CTA of the gram pass
constexpr int kStage = 16;          // loads in flight a thread
constexpr int kXPer = 16;           // x tile elements a thread: cs16 qt / 256
constexpr int kMaxSmem = 232448;    // dynamic shared memory a block may use

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
__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }
// Columns of P a tile: 64 at a 64-row chunk (a 64 x 64 tile of y on 256
// threads), else 32.
__host__ __device__ inline int tile_cols(int cs16) {
  return cs16 == 64 ? 64 : 32;
}
// The pitch of B's rows: N up to 4, and 4 more where that is a multiple of
// 32 floats (the gram's float4 reads of 8 rows at once then miss no bank).
__host__ __device__ inline int b_pitch(int n) {
  const int n4 = round4(n);
  return n4 % 32 ? n4 : n4 + 4;
}
// The mbarriers ahead of a scan CTA's floats: full and empty a slot.
__host__ __device__ inline size_t bar_bytes(int ns) {
  return 16 * static_cast<size_t>(ns);
}

// A scan CTA's floats: la (cs16), M^T (cs16 x cs16), C^T (n x cs16), B w
// (cs16 x b_pitch), the x tile (cs16 x qt) and ns slots of h's tiles
// (n x qt).
size_t scan_smem(int cs, int n, int ns) {
  const size_t cs16 = round16(cs), qt = tile_cols(cs16);
  return bar_bytes(ns) +
         sizeof(float) * (cs16 + cs16 * cs16 + n * cs16 + cs16 * b_pitch(n) +
                          cs16 * qt + static_cast<size_t>(ns) * n * qt);
}

// A gram CTA's: C^T's 32 columns of its rows (n x 32) and B's rows up to
// its last (at most cs16 x b_pitch(n)).
size_t gram_smem(int cs, int n) {
  return sizeof(float) * (static_cast<size_t>(n) * kGramRows +
                          static_cast<size_t>(round16(cs)) * b_pitch(n));
}

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The same shared-memory location in CTA rank of the cluster.
__device__ inline uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ inline void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Wait for the phase of this parity to complete, acquiring at cluster scope
// what the arriving threads released.
__device__ inline void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Arrive on a barrier of a CTA of the cluster (a shared::cluster address),
// releasing this thread's earlier reads and writes at cluster scope.
__device__ inline void mbar_arrive_cluster(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
      :: "r"(bar) : "memory");
}

__device__ inline void st_cluster(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// 16 bytes from device memory into shared memory, in flight until
// cp_async_wait_all.
__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ inline void cluster_sync(int cl) {
  if (cl > 1)
    ss_cg::this_cluster().sync();
  else
    __syncthreads();
}

__device__ inline float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ inline float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// acc[a][q] = fmaf(u[a], v[q], acc[a][q]): one step of 4 x 4 (or 2 x 4)
// chains.
__device__ inline void fma_tile(float (&acc)[4][4], float4 u, float4 v) {
  const float ur[4] = {u.x, u.y, u.z, u.w}, vr[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(ur[a], vr[q], acc[a][q]);
}

__device__ inline void fma_tile(float (&acc)[2][4], float2 u, float4 v) {
  const float ur[2] = {u.x, u.y}, vr[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(ur[a], vr[q], acc[a][q]);
}

// SR floats of the state's rows at p: a float4 or a float2.
template <int SR>
__device__ inline auto ld_rows(const float* p) {
  if constexpr (SR == 4)
    return ld4(p);
  else
    return ld2(p);
}

// G's 4 x 4 at rows i0 .., columns j0 .. over k < n ascending: C from C^T
// (a float4 over i a step), B from its rows (a float4 over k for 4 steps).
__device__ inline void gram_tile(float (&acc)[4][4], const float* ct,
                                 int ldc, const float* b, int ldb, int i0,
                                 int j0, int n) {
  int k = 0;
  for (; k + 4 <= n; k += 4) {
    float4 cv[4], bv[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) cv[kk] = ld4(&ct[(k + kk) * ldc + i0]);
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = ld4(&b[(j0 + q) * ldb + k]);
    const float br[4][4] = {{bv[0].x, bv[1].x, bv[2].x, bv[3].x},
                            {bv[0].y, bv[1].y, bv[2].y, bv[3].y},
                            {bv[0].z, bv[1].z, bv[2].z, bv[3].z},
                            {bv[0].w, bv[1].w, bv[2].w, bv[3].w}};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      fma_tile(acc, cv[kk],
               make_float4(br[kk][0], br[kk][1], br[kk][2], br[kk][3]));
  }
  for (; k < n; ++k)
    fma_tile(acc, ld4(&ct[k * ldc + i0]),
             make_float4(b[j0 * ldb + k], b[(j0 + 1) * ldb + k],
                         b[(j0 + 2) * ldb + k], b[(j0 + 3) * ldb + k]));
}

// A lane's floats in the work buffer: G (cs16 x cs16, j-major, its lower
// triangle), C^T (n x cs16) and B (cs16 x b_pitch(n)), rows past cs and
// columns past n zero.
__host__ __device__ inline size_t lane_floats(int cs16, int n) {
  return static_cast<size_t>(cs16) * cs16 + static_cast<size_t>(n) * cs16 +
         static_cast<size_t>(cs16) * b_pitch(n);
}

// The gram pass: for one (batch, head where B and C are per head, chunk),
// rows i0 = 32 rb .. i0 + 31 of G = C B^T, its lower triangle, each entry
// one fmaf chain over k ascending from 0.0f (gram_tile, 4 x 4 a thread),
// written into the lane's G, and the same rows of the lane's C^T and B in
// float32, so a scan CTA stages all three by cp.async.  A CTA stages C^T's
// 32 columns of its rows and B's rows up to its last.  It lets the scan
// grid launch at once (griddepcontrol): the scan's CTAs wait for this grid
// only before they copy its output.
template <typename T, bool kOn>
__global__ void __launch_bounds__(kScanThreads)
ssm_gram_kernel(const T* __restrict__ B, const T* __restrict__ C,
                float* __restrict__ W, int hg, int chunks, int n, int cs,
                Strides bst, Strides cst,
                unsigned long long* __restrict__ stamps) {
  extern __shared__ __align__(16) float gsm[];
  const long long t0 = kOn && threadIdx.x == 0 ? clock64() : 0;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x;
  const int cs16 = round16(cs);
  const int ldb = b_pitch(n);
  const int lane = blockIdx.x;                  // (batch, head, chunk)
  const int c = lane % chunks;
  const int hh = lane / chunks % hg;
  const int bb = lane / chunks / hg;
  const int i0 = blockIdx.y * kGramRows;
  const int jn = min(cs16, i0 + kGramRows);     // rows of B 0 .. jn - 1
  float* ct = gsm;                              // n x 32, C^T's columns
  float* bw = ct + n * kGramRows;               // jn x ldb, B's rows
  const long long c0 = static_cast<long long>(c) * cs;
  const T* cg = C + bb * cst.b + hh * cst.h + c0 * cst.s;
  const T* bg = B + bb * bst.b + hh * bst.h + c0 * bst.s;
  // C^T with i fastest (conflict-free stores; the loads stride C's rows),
  // then B row by row; kStage loads in flight
  for (int base = tid; base < n * kGramRows;
       base += kScanThreads * kStage) {
    float v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = base + u * kScanThreads;
      const int r = e / kGramRows, i = i0 + e % kGramRows;
      v[u] = e < n * kGramRows && i < cs ? to_f32(cg[i * cst.s + r]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = base + u * kScanThreads;
      if (e < n * kGramRows) ct[e] = v[u];
    }
  }
  for (int base = tid; base < jn * ldb; base += kScanThreads * kStage) {
    float v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = base + u * kScanThreads;
      const int j = e / ldb, r = e - j * ldb;
      v[u] = e < jn * ldb && j < cs && r < n ? to_f32(bg[j * bst.s + r])
                                             : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = base + u * kScanThreads;
      if (e < jn * ldb) bw[e] = v[u];
    }
  }
  __syncthreads();
  float* wl = W + static_cast<size_t>(lane) * lane_floats(cs16, n);
  const int ir = 4 * (tid % (kGramRows / 4));   // rows i0 + ir .. + 3
  const int jc = 4 * (tid / (kGramRows / 4));   // columns jc .. jc + 3
  if (jc < jn && jc <= i0 + ir + 3 && i0 + ir < cs) {
    float acc[4][4] = {};
    gram_tile(acc, ct, kGramRows, bw, ldb, ir, jc, n);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ir + a, j = jc + q;
        if (j <= i && i < cs) wl[j * cs16 + i] = acc[a][q];
      }
  }
  // the CTA's rows of C^T (32 columns of each row) and of B, float32
  const int rows = min(kGramRows, cs16 - i0);
  float* wct = wl + cs16 * cs16;
  for (int e = tid; e < n * rows / 4; e += kScanThreads) {
    const int r = e / (rows / 4), q = e - r * (rows / 4);
    *reinterpret_cast<float4*>(&wct[r * cs16 + i0 + 4 * q]) =
        ld4(&ct[r * kGramRows + 4 * q]);
  }
  float4* wb = reinterpret_cast<float4*>(wct + n * cs16 + i0 * ldb);
  const float4* sb = reinterpret_cast<const float4*>(bw + i0 * ldb);
  for (int e = tid; e < rows * ldb / 4; e += kScanThreads) wb[e] = sb[e];
  if (kOn && tid == 0) {
    unsigned long long* out =
        stamps + 2 * (static_cast<size_t>(lane) * gridDim.y + blockIdx.y);
    out[0] = static_cast<unsigned long long>(t0);
    out[1] = static_cast<unsigned long long>(clock64());
  }
}

// The x tile of columns q0 .. q0 + qt - 1 into registers (loads only: its
// stores wait for store_x, after the products that read the current tile).
template <typename T, int QT>
__device__ inline void load_x(T (&xn)[kXPer], const T* xg, long long c0,
                              int q0, int cs, int cs16, int p, long long ss) {
#pragma unroll
  for (int u = 0; u < kXPer; ++u) {
    const int e = threadIdx.x + u * kScanThreads;
    const int j = e / QT, q = e % QT;
    if (e < cs16 * QT && j < cs && q0 + q < p)
      xn[u] = xg[(c0 + j) * ss + q0 + q];
  }
}

template <typename T, int QT>
__device__ inline void store_x(float* xs, const T (&xn)[kXPer], int q0,
                               int cs, int cs16, int p) {
#pragma unroll
  for (int u = 0; u < kXPer; ++u) {
    const int e = threadIdx.x + u * kScanThreads;
    const int j = e / QT, q = e % QT;
    if (e < cs16 * QT) xs[e] = j < cs && q0 + q < p ? to_f32(xn[u]) : 0.0f;
  }
}

// The chunk's own state, KK rounds of SR x 4 tiles a thread: ls[k][a][q]
// over j < cs16 ascending, B w's rows at off[k] and x's columns 4 yc ..;
// no branch in the loop, so its loads are issued ahead of their FMAs.
template <int KK, int QT, int KS, int SR>
__device__ __forceinline__ void own_state(float (&ls)[KS][SR][4],
                                          const float* bw, int ldb,
                                          const float* xs, int cs16, int yc,
                                          const int (&off)[KS]) {
  constexpr int kUnroll = KK <= 2 ? 4 : 2;
#pragma unroll kUnroll
  for (int j = 0; j < cs16; ++j) {
    const float4 xv = ld4(&xs[j * QT + 4 * yc]);
#pragma unroll
    for (int k = 0; k < KK; ++k)
      fma_tile(ls[k], ld_rows<SR>(&bw[j * ldb + off[k]]), xv);
  }
}

// CS16: the chunk rounded up to 16 where it is compiled in, 0 for any
// chunk; QT = tile_cols(CS16); the state's tiles are SR rows x 4 columns,
// KS of them a thread at most.
template <typename T, int CS16, int QT, int SR, int KS, bool kOn>
__global__ void __launch_bounds__(kScanThreads, 1)
ssm_scan_kernel(const T* __restrict__ X, const T* __restrict__ A,
                const T* __restrict__ B, const T* __restrict__ C,
                const float* __restrict__ G, T* __restrict__ Y,
                T* __restrict__ H, int heads, int hg, int s, int p, int n,
                int cs, int groups, int tw, int ns, int cl, Strides xst,
                Strides ast, Strides bst, Strides cst, Strides yst,
                unsigned long long* __restrict__ stamps) {
  extern __shared__ __align__(16) unsigned char raw[];
  constexpr int kQv = QT / 4;                   // column groups of a tile
  const int cs16 = CS16 ? CS16 : round16(cs);
  const int n4 = round4(n);
  const int ldb = b_pitch(n);
  uint64_t* full = reinterpret_cast<uint64_t*>(raw);   // h_{c-1}'s slots in
  uint64_t* empty = full + ns;                  // the next rank's slots free
  float* la = reinterpret_cast<float*>(raw + bar_bytes(ns));   // cs16
  float* mt = la + cs16;                        // cs16 x cs16, M^T
  float* ct = mt + cs16 * cs16;                 // n x cs16, C^T
  float* bw = ct + n * cs16;                    // cs16 x ldb, B (then B w)
  float* xs = bw + cs16 * ldb;                  // cs16 x QT, the x tile
  float* slots = xs + cs16 * QT;                // ns x (n x QT), h_{c-1}

  const int tid = threadIdx.x;
  const int chunks = s / cs;
  const int rank =
      cl > 1 ? static_cast<int>(ss_cg::this_cluster().block_rank()) : 0;
  const int lane = blockIdx.x / cl;
  const int g = lane % groups;
  const int hh = lane / groups % heads;
  const int bb = lane / groups / heads;
  const int p0 = g * tw * QT;
  const int ntile = min(tw, (p - p0 + QT - 1) / QT);
  PhaseClock<kOn, kScanPhases> clk(true);

  if (tid == 0) {
    for (int k = 0; k < ns; ++k) {
      mbar_init(smem_addr(&full[k]), kScanThreads);
      mbar_init(smem_addr(&empty[k]), kScanThreads);
    }
    if (cl > 1)
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync(cl);

  // a thread's 4 x 4 of y: rows i0 .. i0 + 3 (within one 32-row block,
  // so M x runs j < jy, the block's end, for all four), columns 4 yc ..; its
  // state tiles st = tid + 256 k: rows SR (st / kQv) .., the same columns
  const int yc = tid % kQv;
  const int i0 = 4 * (tid / kQv);
  const bool ylive = i0 < cs16;
  const int jy = min(cs16, 32 * (i0 / 32 + 1));
  const int stiles = n4 / SR * kQv;
  const int rounds = (stiles + kScanThreads - 1) / kScanThreads;
  int soff[KS];     // a state tile's first row; a thread past the tiles
  for (int k = 0; k < KS; ++k)   // reads the last tile's (sums unused)
    soff[k] = SR * (min(tid + kScanThreads * k, stiles - 1) / kQv);

  const T* xg = X + bb * xst.b + hh * xst.h;
  const T* ag = A + bb * ast.b + hh * ast.h;
  const T* bg = B + bb * bst.b + hh * bst.h;
  const T* cg = C + bb * cst.b + hh * cst.h;
  T* yg = Y + bb * yst.b + hh * yst.h;
  T* hout = H + (static_cast<size_t>(bb) * heads + hh) * n * p;
  const int src = (rank + cl - 1) % cl, dst = (rank + 1) % cl;
  unsigned rcv = 0, snd = 0;    // tiles of state received, sent
  T xn[kXPer];

  for (int c = rank; c < chunks; c += cl) {
    const long long c0 = static_cast<long long>(c) * cs;
    // stage the chunk: the first x tile and the log-decays (rows past cs
    // zero, so la stays flat) through registers, and the gram pass's G,
    // C^T and B by cp.async, 16 bytes a copy, all in flight
    load_x<T, QT>(xn, xg, c0, p0, cs, cs16, p, xst.s);
    for (int i = tid; i < cs16; i += kScanThreads)
      la[i] = i < cs ? logf(fmaxf(to_f32(ag[(c0 + i) * ast.s]), 1e-20f))
                     : 0.0f;
    // the gram pass's output: complete and visible once its grid is done
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    {
      const float* wl =
          G + (static_cast<size_t>(bb * hg + (hg > 1 ? hh : 0)) * chunks + c) *
                  lane_floats(cs16, n);
      const int total4 = static_cast<int>(lane_floats(cs16, n) / 4);
      for (int e = tid; e < total4; e += kScanThreads)
        cp_async16(&mt[4 * e], &wl[4 * e]);     // mt, ct and bw in a row
    }
    store_x<T, QT>(xs, xn, p0, cs, cs16, p);
    cp_async_wait_all();
    __syncthreads();
    clk.mark(kSpLoad);

    // the non-critical region: warp 0 scans the log-decays, each lane a run
    // of consecutive entries, then the lanes' sums across the warp
    if (tid < 32) {
      const int per = (cs16 + 31) / 32;
      const int li = tid * per;
      float run = 0.0f;
      for (int k = 0; k < per && li + k < cs16; ++k) {
        run += la[li + k];
        la[li + k] = run;
      }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) before = 0.0f;
      for (int k = 0; k < per && li + k < cs16; ++k) la[li + k] += before;
    }
    __syncthreads();
    clk.mark(kSpScan);

    // M^T from G, in place (rows past cs and the upper triangle zero)
    const float total = la[cs16 - 1];
    const float decay = expf(total);
    for (int e = tid; e < cs16 * cs16; e += kScanThreads) {
      const int j = e / cs16, i = e - j * cs16;
      float m = 0.0f;
      if (j <= i && i < cs) m = mt[e] * expf(la[i] - la[j]);
      mt[e] = m;
    }
    // B w: B's rows scaled by exp(la_last - la), a warp a row
    for (int j = tid / 32; j < cs16; j += kScanThreads / 32) {
      const float w = expf(total - la[j]);
      for (int r = tid % 32; r < n4; r += 32) bw[j * ldb + r] *= w;
    }
    __syncthreads();
    clk.mark(kSpM);

    for (int t = 0; t < ntile; ++t) {
      const int q0 = p0 + t * QT;
      const bool more = t + 1 < ntile;

      // the chunk's own state (B w)^T x, its rounds of tiles compiled in
      float ls[KS][SR][4] = {};
      switch (rounds) {
        case 1:
          own_state<1, QT>(ls, bw, ldb, xs, cs16, yc, soff);
          break;
        case 2:
          if constexpr (KS >= 2)
            own_state<2, QT>(ls, bw, ldb, xs, cs16, yc, soff);
          break;
        case 3:
          if constexpr (KS >= 3)
            own_state<3, QT>(ls, bw, ldb, xs, cs16, yc, soff);
          break;
        default:
          if constexpr (KS >= 4)
            own_state<4, QT>(ls, bw, ldb, xs, cs16, yc, soff);
      }
      clk.mark(kSpState);

      // the ordered dependence: h_c = exp(total) h_{c-1} + the own state,
      // h_{c-1}'s tile from the previous rank, h_c's to the next
      const float* hin = slots + (rcv % ns) * n * QT;
      if (c > 0) mbar_wait(smem_addr(&full[rcv % ns]), (rcv / ns) & 1);
      const bool send = c + 1 < chunks;
      if (send && snd >= static_cast<unsigned>(ns))
        mbar_wait(smem_addr(&empty[snd % ns]), (snd / ns - 1) & 1);
      clk.mark(kSpWait);
      const uint32_t out =
          send ? cluster_addr(smem_addr(slots + (snd % ns) * n * QT), dst)
               : 0u;
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const int st = tid + kScanThreads * k;
        if (st >= stiles) continue;
        const int r0 = SR * (st / kQv);
#pragma unroll
        for (int a = 0; a < SR; ++a) {
          const int r = r0 + a;
          if (r >= n) continue;
          const float4 hp = c > 0 ? ld4(&hin[r * QT + 4 * yc])
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const float4 hv = make_float4(fmaf(decay, hp.x, ls[k][a][0]),
                                        fmaf(decay, hp.y, ls[k][a][1]),
                                        fmaf(decay, hp.z, ls[k][a][2]),
                                        fmaf(decay, hp.w, ls[k][a][3]));
          if (send) {
            st_cluster(out + 4u * (r * QT + 4 * yc), hv);
          } else {
            const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int col = q0 + 4 * yc + q;
              if (col < p)
                store(&hout[static_cast<size_t>(r) * p + col], hr[q]);
            }
          }
        }
      }
      if (send) {
        mbar_arrive_cluster(cluster_addr(smem_addr(&full[snd % ns]), dst));
        ++snd;
      }
      clk.mark(kSpChain);
      // the next tile's x, in flight over M x and C h
      if (more) load_x<T, QT>(xn, xg, c0, q0 + QT, cs, cs16, p, xst.s);

      // critical region: y = M x + exp(la) (C h_{c-1}), M lower triangular
      // (j < jy: the zeros above the diagonal to the block's end)
      if (ylive) {
        float acc[4][4] = {};
#pragma unroll 4
        for (int j = 0; j < jy; ++j)
          fma_tile(acc, ld4(&mt[j * cs16 + i0]), ld4(&xs[j * QT + 4 * yc]));
        clk.mark(kSpMx);
        float ch[4][4] = {};
        if (c > 0) {
#pragma unroll 4
          for (int r = 0; r < n; ++r)
            fma_tile(ch, ld4(&ct[r * cs16 + i0]), ld4(&hin[r * QT + 4 * yc]));
        } else {   // h_{-1} = 0: +0, or NaN on a row of C not all finite
          bool bad[4] = {};
          for (int r = 0; r < n; ++r) {
            const float4 cv = ld4(&ct[r * cs16 + i0]);
            bad[0] |= !isfinite(cv.x);
            bad[1] |= !isfinite(cv.y);
            bad[2] |= !isfinite(cv.z);
            bad[3] |= !isfinite(cv.w);
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              ch[a][q] = bad[a] ? __int_as_float(0x7fffffff) : 0.0f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + a;
          if (i >= cs) continue;
          const float e = expf(la[i]);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int col = q0 + 4 * yc + q;
            if (col < p)
              store(&yg[(c0 + i) * yst.s + col], acc[a][q] + e * ch[a][q]);
          }
        }
      } else {
        clk.mark(kSpMx);
      }
      if (c > 0) {     // h_{c-1}'s tile read: the slot is the producer's
        mbar_arrive_cluster(cluster_addr(smem_addr(&empty[rcv % ns]), src));
        ++rcv;
      }
      clk.mark(kSpCh);
      __syncthreads();   // every thread is done with the x tile
      if (more) store_x<T, QT>(xs, xn, q0 + QT, cs, cs16, p);
      __syncthreads();
      clk.mark(kSpX);
    }
  }
  cluster_sync(cl);   // no CTA leaves while another may still reach it
  clk.write(stamps + static_cast<size_t>(blockIdx.x) * kScanStampWords);
}

// The gram pass where B and C are shared (hg = 1), then the scan on batch *
// heads * groups lanes of cl CTAs.
template <typename T, int CS16, int QT, int SR, int KS, bool kOn>
int launch_instance(const void* x, const void* a, const void* b,
                    const void* c, void* y, void* h, float* work, int batch,
                    int heads, int hg, int s, int p, int n, int cs,
                    Strides xst, Strides ast, Strides bst, Strides cst,
                    Strides yst, int cl, int tw, int ns, int smem,
                    unsigned long long* stamps,
                    unsigned long long* gram_stamps, void* stream) {
  const int cs16 = round16(cs);
  const int chunks = s / cs;
  auto gram = ssm_gram_kernel<T, kOn>;
  const int gsmem = static_cast<int>(gram_smem(cs, n));
  cudaError_t err = cudaFuncSetAttribute(
      gram, cudaFuncAttributeMaxDynamicSharedMemorySize, gsmem);
  if (err != cudaSuccess) return err;
  gram<<<dim3(batch * hg * chunks, (cs16 + kGramRows - 1) / kGramRows),
         kScanThreads, gsmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(b), static_cast<const T*>(c), work, hg, chunks,
      n, cs, bst, cst, gram_stamps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int qt = tile_cols(cs16);
  const int groups = ((p + qt - 1) / qt + tw - 1) / tw;
  const auto kernel = ssm_scan_kernel<T, CS16, QT, SR, KS, kOn>;
  // the scan may launch while the gram pass runs (programmatic dependent
  // launch); a lane of more than one CTA is a cluster
  const auto go = [&](auto... args) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr[2];
    cudaLaunchConfig_t cfg =
        cluster_config(batch * heads * groups, cl, kScanThreads, smem, attr);
    const int k = cl > 1 ? 1 : 0;   // after the cluster's, or in its place
    attr[k].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[k].val.programmaticStreamSerializationAllowed = 1;
    cfg.numAttrs = k + 1;
    cfg.stream = static_cast<cudaStream_t>(stream);
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  };
  return go(static_cast<const T*>(x), static_cast<const T*>(a),
            static_cast<const T*>(b), static_cast<const T*>(c),
            static_cast<const float*>(work), static_cast<T*>(y),
            static_cast<T*>(h), heads, hg, s, p, n, cs, groups, tw, ns, cl,
            xst, ast, bst, cst, yst, stamps);
}

// Whether (cl, tw, ns, smem) is a plan of kernels/ssm_scan.py's formula:
// cl = 1 for one chunk, else 2, 4 or 8 up to the chunks; ns = tw where a
// rank takes more than one chunk, else 1 or 2 up to tw; smem its formula
// within 227 KB.
bool plan_ok(int s, int p, int n, int cs, int cl, int tw, int ns,
             int smem) {
  const int chunks = s / cs;
  const bool cl_ok = chunks == 1 ? cl == 1
                                 : (cl == 2 || cl == 4 || cl == 8) &&
                                       cl <= chunks;
  const int tiles = (p + tile_cols(round16(cs)) - 1) /
                    tile_cols(round16(cs));
  const bool ns_ok = chunks > cl ? ns == tw : ns >= 1 && ns <= 2 && ns <= tw;
  return cl_ok && tw >= 1 && tw <= tiles && ns_ok &&
         static_cast<size_t>(smem) == scan_smem(cs, n, ns) &&
         smem <= kMaxSmem && gram_smem(cs, n) <= kMaxSmem;
}

// The instances: chunk 128 (32-column tiles, the state 2 x 4 a thread,
// N <= 128 by shared memory: at most 2 tiles a thread), chunk 64 (64-column
// tiles, 4 x 4, N <= 256: 4), any other chunk (32-column tiles, 2 x 4:
// 4).
template <typename T, bool kOn>
int launch(const void* x, const void* a, const void* b, const void* c,
           void* y, void* h, void* work, int batch, int heads, int hg,
           int s, int p, int n, int cs, Strides xst, Strides ast,
           Strides bst, Strides cst, Strides yst, int cl, int tw, int ns,
           int smem, unsigned long long* stamps,
           unsigned long long* gram_stamps, void* stream) {
  if (cs < 1 || cs > kMaxChunk || n < 1 || n > kMaxState || s < cs ||
      s % cs || p < 1 || batch < 1 || heads < 1 ||
      !(hg == heads || (hg == 1 && bst.h == 0 && cst.h == 0)) ||
      work == nullptr ||
      !plan_ok(s, p, n, cs, cl, tw, ns, smem))
    return cudaErrorInvalidValue;
  float* w = static_cast<float*>(work);
  const int cs16 = round16(cs);
  if (cs16 == 128)
    return n <= 128
               ? launch_instance<T, 128, 32, 2, 2, kOn>(
                     x, a, b, c, y, h, w, batch, heads, hg, s, p, n, cs,
                     xst, ast, bst, cst, yst, cl, tw, ns, smem, stamps,
                     gram_stamps, stream)
               : cudaErrorInvalidValue;
  if (cs16 == 64)
    return launch_instance<T, 64, 64, 4, 4, kOn>(
        x, a, b, c, y, h, w, batch, heads, hg, s, p, n, cs, xst, ast, bst,
        cst, yst, cl, tw, ns, smem, stamps, gram_stamps, stream);
  return launch_instance<T, 0, 32, 2, 4, kOn>(
      x, a, b, c, y, h, w, batch, heads, hg, s, p, n, cs, xst, ast, bst,
      cst, yst, cl, tw, ns, smem, stamps, gram_stamps, stream);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// x (batch, heads, s, p), a (batch, heads, s), b / c (batch, heads, s, n)
// -> y (batch, heads, s, p), h (batch, heads, n, p) contiguous; x, a, b, c
// and y are read and written through the (batch, head, sequence) strides
// given, in elements (a head stride of 0 shares b / c across heads: hg = 1,
// else hg = heads), each with a contiguous last axis; work holds batch * hg
// * (s / cs) lanes of lane_floats(cs16, n) floats, the gram pass's G, C^T
// and B (kernels/ssm_scan.py ssm_work_floats).  All float32 (bf16 = 0) or
// all bfloat16 (bf16 = 1); 1 <= cs <= 128 dividing s, 1 <= n <= 256, and
// the plan (cl, tw, ns, smem) of kernels/ssm_scan.py ssm_plan.
int ssm_scan_run(const void* x, const void* a, const void* b, const void* c,
                 void* y, void* h, void* work, int batch, int heads, int hg,
                 int s, int p, int n, int cs, long long x_sb, long long x_sh,
                 long long x_ss, long long a_sb, long long a_sh,
                 long long a_ss, long long b_sb, long long b_sh,
                 long long b_ss, long long c_sb, long long c_sh,
                 long long c_ss, long long y_sb, long long y_sh,
                 long long y_ss, int cl, int tw, int ns, int smem, int bf16,
                 void* stream) {
  using namespace repro_torch;
  const Strides xst{x_sb, x_sh, x_ss}, ast{a_sb, a_sh, a_ss},
      bst{b_sb, b_sh, b_ss}, cst{c_sb, c_sh, c_ss}, yst{y_sb, y_sh, y_ss};
  return bf16 ? launch<__nv_bfloat16, false>(
                    x, a, b, c, y, h, work, batch, heads, hg, s, p, n, cs,
                    xst, ast, bst, cst, yst, cl, tw, ns, smem, nullptr,
                    nullptr, stream)
              : launch<float, false>(x, a, b, c, y, h, work, batch, heads,
                                     hg, s, p, n, cs, xst, ast, bst, cst,
                                     yst, cl, tw, ns, smem, nullptr, nullptr,
                                     stream);
}

// The same scan with the phase stamps (phase_clock.cuh), float32 and
// contiguous (batch, heads, s, ...) tensors: stamps holds kScanStampWords
// words a scan CTA, gram_stamps two (start, end) a gram CTA.  Only
// scripts/ssm_phases.py and the gpu tests launch it.
int ssm_scan_phases_f32(const void* x, const void* a, const void* b,
                        const void* c, void* y, void* h, void* work,
                        void* stamps, void* gram_stamps, int batch,
                        int heads, int hg, int s, int p, int n, int cs,
                        int cl, int tw, int ns, int smem, void* stream) {
  using namespace repro_torch;
  const long long bh = hg == 1 ? 0 : static_cast<long long>(s) * n;
  const Strides xst{static_cast<long long>(heads) * s * p,
                    static_cast<long long>(s) * p, p},
      ast{static_cast<long long>(heads) * s, s, 1},
      bst{hg == 1 ? static_cast<long long>(s) * n : heads * bh, bh, n};
  return launch<float, true>(
      x, a, b, c, y, h, work, batch, heads, hg, s, p, n, cs, xst, ast, bst,
      bst, xst, cl, tw, ns, smem, static_cast<unsigned long long*>(stamps),
      static_cast<unsigned long long*>(gram_stamps), stream);
}

// cudaOccupancyMaxActiveClusters of the served float32 instance at chunk
// cs, clusters of cl CTAs of smem bytes.
int ssm_scan_clusters(int cs, int cl, int smem) {
  using namespace repro_torch;
  const int cs16 = round16(cs);
  if (cs16 == 128)
    return cluster_occupancy(ssm_scan_kernel<float, 128, 32, 2, 2, false>,
                             cl, kScanThreads, smem);
  if (cs16 == 64)
    return cluster_occupancy(ssm_scan_kernel<float, 64, 64, 4, 4, false>,
                             cl, kScanThreads, smem);
  return cluster_occupancy(ssm_scan_kernel<float, 0, 32, 2, 4, false>, cl,
                           kScanThreads, smem);
}

}  // extern "C"
