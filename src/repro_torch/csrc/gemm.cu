// K18: GEMM, (M, K) @ (K, N) -> (M, N), accumulated in float32, in two
// forms picked by the dtype: bfloat16 on the tensor cores (wgmma fed by
// TMA), float32 on the SIMT FMA pipes.
//
// Replaces: src/repro/kernels/gemm.py, gemm_pallas (_gemm_kernel): a grid of
// 128 x 128 output tiles, each accumulating x[i, kk] @ y[kk, j] over the
// sequential ("arbitrary") k axis in a float32 VMEM scratch, written out in
// x's dtype at the last k step.  Both forms compute that: a float32
// accumulator over the whole k axis, rounded once to x's dtype.  A product of
// two bf16 values is exact in float32, so the forms differ from the
// reference (and from the plain version's 128-deep k tiles) only in the
// order of the float32 sum.
//
// What bounds it on an H100: operations.  In bf16, 2 M N K FLOPs on 2 (M K +
// K N + M N) bytes is ~1365 FLOPs a byte at 4096^3, far above the tensor
// cores' ridge (989 TFLOP/s over 3.35 TB/s, ~295), so the bound is 0.139 ms
// there.  The reference's float32 numbers are IEEE products (rtol 1e-4), so
// TF32 is out and float32 runs on the SIMT pipes (67 TFLOP/s, ridge ~20
// FLOPs a byte, passed once M, N, K pass ~60), as cuBLAS's SGEMM does.
//
// The bfloat16 form (gemm_tc_kernel): one CTA of three warpgroups per 128 x
// 256 output tile, k tiles of 64 (a 64-element bf16 row is 128 bytes, one
// row of the 128-byte swizzle).  A 128 x 128 tile would make the CTAs pull
// ~2.1 GB from L2 at 4096^3; 128 x 256 cuts that to ~1.6 GB.  Where 128 x
// 256 tiles give fewer CTAs than the card has SMs (1000 x 700: 24 of 132),
// tiles are 128 x 128 instead, the wrapper's choice (gemm.tc_tile).
// Warpgroup 0 is the producer: one thread issues TMA tile loads
// (cp.async.bulk.tensor, 128-byte swizzle, completion on an mbarrier) into a
// ring of 4 stages of x (128 x 64) and y (four 64 k x 64 n boxes), 48 KB a
// stage, 192 KB in all (32 KB and 128 KB at 128 columns), so one CTA an SM;
// it gives its registers up with setmaxnreg.  Warpgroups 1 and 2 each own 64
// rows x 256 columns of the tile and issue wgmma.m64n256k16 (bf16 in,
// float32 accumulate; m64n128k16 at 128 columns), 4 per k tile, with 128
// accumulators a thread (setmaxnreg raises them to 232 registers).  x is read
// K-major and y, row-major (K, N), N-major through wgmma's transpose bit, so
// neither operand is copied.  A consumer keeps one k tile's products in
// flight (wgmma.wait_group 1) and hands the stage before it back to the
// producer on an "empty" mbarrier.  The tensor maps are encoded on the host
// for each call (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library links no -lcuda) and passed as
// __grid_constant__ parameters.  Tiles run grouped 16 rows of tiles at a
// time, so CTAs in flight together share rows of x and columns of y in L2
// (x and y together pass the 50 MB L2 at 4096^3).  Edges: TMA zero-fills the
// ragged M, N and K edges of a box; a y box wholly past N is not loaded (its
// columns are never stored), and the epilogue's stores (4-byte bf16x2 where
// N is even) are masked.  TMA needs 16-byte row strides and base pointers,
// so K % 8 == 0, 16-byte aligned x and y, and y's rows a multiple of 8
// long: the wrapper (kernels/gemm.py) zero-pads copies of any other shape
// before the launch, and the answer is written at its own width N.
//
// The float32 form (gemm_simt_kernel): one CTA per BM x BN output tile,
// 128 x 128 (256 threads) where those tiles give at least one CTA an SM,
// else 64 x 64 (64 threads), the wrapper's choice (gemm.simt_tile).  Each
// thread holds an 8 x 8 block of the accumulator in registers (two 4 x 4
// quadrants BM / 2 rows and BN / 2 columns apart, so each warp's shared
// loads are conflict-free float4s).  k tiles 16 deep of x (transposed, rows
// padded by 4 floats) and y sit in double-buffered shared memory; the next
// tile is loaded into registers by 16-byte float4 loads (where K % 4 == 0, N
// % 4 == 0 and both pointers are 16-byte aligned; else element by element)
// while the current one is multiplied, and the ragged edges are zero-filled.
// At 128 x 128 the registers are capped at 128 a thread, so two CTAs share
// an SM (at 130 registers one did, and an H100 SXM took 3.42 ms at 4096^3
// against 3.10).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "lane_common.cuh"

namespace repro_torch {
namespace {

// ---------------- the float32 form (SIMT) ----------------

constexpr int kBK = 16;            // k tile depth

template <int BM, int BN>
struct Simt {
  static constexpr int kThreads = BM * BN / 64;      // 8 x 8 a thread
  static constexpr int kTx = BN / 8;                 // threads along n
  static constexpr int kLdx = BM + 4;                // pitch of x^T rows
  static constexpr int kXLoads = BM * kBK / 4 / kThreads;   // float4s
  static constexpr int kYLoads = kBK * BN / 4 / kThreads;
  static constexpr size_t kSmem = sizeof(float) * 2 * kBK * (kLdx + BN);
  // CTAs an SM must hold: two of 256 threads (registers capped at 128)
  static constexpr int kCtas = kThreads >= 256 ? 2 : 1;
};

// 4 consecutive elements of row r of a row-major (rows, cols) matrix from
// column c, zero past its edges: one 16-byte load when kVec (cols % 4 ==
// 0, c % 4 == 0, a 16-byte aligned base), else element by element.
template <bool kVec>
__device__ inline float4 load4(const float* __restrict__ p, int r, int c,
                               int rows, int cols) {
  if (r >= rows) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* row = p + static_cast<size_t>(r) * cols;
  if (kVec)
    return c < cols ? *reinterpret_cast<const float4*>(row + c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(c < cols ? row[c] : 0.f, c + 1 < cols ? row[c + 1] : 0.f,
                     c + 2 < cols ? row[c + 2] : 0.f,
                     c + 3 < cols ? row[c + 3] : 0.f);
}

template <int BM, int BN, bool kVec>
__global__ void __launch_bounds__(Simt<BM, BN>::kThreads, Simt<BM, BN>::kCtas)
gemm_simt_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                 float* __restrict__ O, int m, int n, int k) {
  using S = Simt<BM, BN>;
  __shared__ __align__(16) float xs[2][kBK][S::kLdx];   // x tile, transposed
  __shared__ __align__(16) float ys[2][kBK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % S::kTx;
  const int ty = tid / S::kTx;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // loader coordinates: float4 q of the x tile is row q / 4, k columns
  // 4 (q % 4) ..; of the y tile k row q / (BN / 4), columns 4 (q % (BN /
  // 4)) .. (consecutive threads on consecutive addresses)
  float4 xv[S::kXLoads], yv[S::kYLoads];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < S::kXLoads; ++j) {
      const int q = tid + j * S::kThreads;
      xv[j] = load4<kVec>(X, row0 + q / 4, k0 + (q % 4) * 4, m, k);
    }
#pragma unroll
    for (int j = 0; j < S::kYLoads; ++j) {
      const int q = tid + j * S::kThreads;
      yv[j] = load4<kVec>(Y, k0 + q / (BN / 4), col0 + (q % (BN / 4)) * 4,
                          k, n);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int j = 0; j < S::kXLoads; ++j) {
      const int q = tid + j * S::kThreads;
      const int r = q / 4;
      const int kq = (q % 4) * 4;
      xs[buf][kq][r] = xv[j].x;
      xs[buf][kq + 1][r] = xv[j].y;
      xs[buf][kq + 2][r] = xv[j].z;
      xs[buf][kq + 3][r] = xv[j].w;
    }
#pragma unroll
    for (int j = 0; j < S::kYLoads; ++j) {
      const int q = tid + j * S::kThreads;
      *reinterpret_cast<float4*>(&ys[buf][q / (BN / 4)][(q % (BN / 4)) * 4]) =
          yv[j];
    }
  };

  const int steps = (k + kBK - 1) / kBK;
  if (steps > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) fetch((s + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[buf][kk][BM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ys[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ys[buf][kk][BN / 2 + tx * 4]);
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
    const int r = row0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (r >= m) continue;
    float* orow = O + static_cast<size_t>(r) * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + h * (BN / 2) + tx * 4;
      if (kVec) {
        if (c < n)
          *reinterpret_cast<float4*>(orow + c) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                          acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < n) orow[c + e] = acc[i][4 * h + e];
      }
    }
  }
}

template <int BM, int BN, bool kVec>
int launch_simt(const void* x, const void* y, void* o, int m, int n, int k,
                cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_simt_kernel<BM, BN, kVec><<<grid, Simt<BM, BN>::kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(o), m, n, k);
  return cudaGetLastError();
}

template <int BM, int BN>
int launch_simt(const void* x, const void* y, void* o, int m, int n, int k,
                cudaStream_t stream) {
  const bool vec = k % 4 == 0 && n % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(y) |
                    reinterpret_cast<uintptr_t>(o)) % 16 == 0;
  return vec ? launch_simt<BM, BN, true>(x, y, o, m, n, k, stream)
             : launch_simt<BM, BN, false>(x, y, o, m, n, k, stream);
}

// ---------------- the bfloat16 form (tensor cores) ----------------

constexpr int kTcBM = 128;                      // output tile rows
constexpr int kTcBK = 64;                       // k tile: one 128-byte row
constexpr int kStages = 4;
constexpr int kTcThreads = 384;                 // producer + 2 consumers
constexpr int kGroupM = 16;                     // rows of tiles in a group
constexpr uint32_t kABytes = kTcBM * kTcBK * 2;         // 16 KB
constexpr uint32_t kBBoxBytes = kTcBK * 64 * 2;         // 8 KB: 64 k x 64 n

// BN output columns a tile (256, or 128 where 256 leaves SMs idle)
template <int BN>
struct Tc {
  static constexpr int kBoxes = BN / 64;                // y boxes a stage
  static constexpr uint32_t kStageBytes = kABytes + kBoxes * kBBoxBytes;
  // the ring (1024-byte aligned for the 128-byte swizzle), then the full
  // and empty barriers
  static constexpr size_t kSmem =
      1024 + kStages * kStageBytes + 2 * kStages * 8;
  static constexpr int kAcc = BN / 2;                   // floats a thread
};

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ inline void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ inline void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ inline void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// box (c0 columns, c1 rows) of a 2-D tensor map into shared memory at dst,
// its bytes counted on bar
__device__ inline void tma_load(uint32_t dst, const CUtensorMap* map,
                                uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at addr:
// lbo / sbo the byte strides between the swizzle atoms (64 elements along
// the contiguous axis) and between groups of 8 rows
__device__ inline uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                     uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma that writes them
template <int N>
__device__ inline void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 256, float32) += A (64 x 16, K-major) B (16 x 256, N-major), both
// read from shared memory through their descriptors
__device__ inline void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128, float32) += A (64 x 16, K-major) B (16 x 128, N-major)
__device__ inline void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ inline void wgmma_tile(float (&d)[128], uint64_t da, uint64_t db) {
  wgmma_m64n256k16(d, da, db);
}

__device__ inline void wgmma_tile(float (&d)[64], uint64_t da, uint64_t db) {
  wgmma_m64n128k16(d, da, db);
}

template <int BN>
__global__ void __launch_bounds__(kTcThreads, 1)
gemm_tc_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_y,
               __nv_bfloat16* __restrict__ O, int m, int n, int k,
               int tiles_m, int tiles_n) {
  using T = Tc<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + kStages * T::kStageBytes;   // kStages of them
  const uint32_t empty = full + kStages * 8;               // kStages of them
  // the tile, grouped: kGroupM rows of tiles walked column by column
  const int per_group = kGroupM * tiles_n;
  const int first = (blockIdx.x / per_group) * kGroupM;
  const int rows_in_group = min(tiles_m - first, kGroupM);
  const int in_group = blockIdx.x % per_group;
  const int row0 = (first + in_group % rows_in_group) * kTcBM;
  const int col0 = (in_group / rows_in_group) * BN;
  const int steps = (k + kTcBK - 1) / kTcBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);          // the producer's expect_tx
      mbar_init(empty + 8 * s, 2);         // one arrival a consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      // y boxes that hold a column below n (the rest are never stored)
      const int boxes = min(T::kBoxes, (n - col0 + 63) / 64);
      const uint32_t bytes = kABytes + boxes * kBBoxBytes;
      for (int s = 0; s < steps; ++s) {
        const int st = s % kStages;
        const uint32_t phase = (s / kStages) & 1;
        mbar_wait(empty + 8 * st, phase ^ 1);
        const uint32_t a = ring + st * T::kStageBytes;
        mbar_expect_tx(full + 8 * st, bytes);
        tma_load(a, &map_x, full + 8 * st, s * kTcBK, row0);
        for (int c = 0; c < boxes; ++c)
          tma_load(a + kABytes + c * kBBoxBytes, &map_y, full + 8 * st,
                   col0 + 64 * c, s * kTcBK);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows x BN columns each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128 - 1;
    float d[T::kAcc];
#pragma unroll
    for (int i = 0; i < T::kAcc; ++i) d[i] = 0.0f;
    for (int s = 0; s < steps; ++s) {
      const int st = s % kStages;
      mbar_wait(full + 8 * st, (s / kStages) & 1);
      const uint32_t a = ring + st * T::kStageBytes + wg * 64 * 128;
      const uint32_t b = ring + st * T::kStageBytes + kABytes;
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk)
        // x: 16 k columns (32 bytes) on along its swizzled rows; y: 16 k
        // rows (2 KB) down, its 64-column boxes kBBoxBytes apart
        wgmma_tile(d, smem_desc(a + 32 * kk, 16, 1024),
                   smem_desc(b + 2048 * kk, kBBoxBytes, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(d);
      // the k tile before this one is multiplied: its stage goes back
      if (s > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(empty + 8 * ((s - 1) % kStages));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);

    // d[4 j + e]: row 16 warp + lane / 4 (+ 8 for e >= 2), column 8 j +
    // 2 (lane % 4) + e % 2
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x / 32) % 4;
    const int r = row0 + wg * 64 + warp * 16 + lane / 4;
    const int c0 = col0 + 2 * (lane % 4);
    const bool pairs = n % 2 == 0;        // 4-byte aligned column pairs
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = c0 + 8 * j;
      if (c >= n) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + 8 * h;
        if (rr >= m) continue;
        __nv_bfloat16* out = O + static_cast<size_t>(rr) * n + c;
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(out) = v;
        } else {
          out[0] = v.x;
          if (c + 1 < n) out[1] = v.y;
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, or nullptr
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// a row-major bf16 (rows, cols) matrix as boxes of box_rows x 64 columns,
// 128-byte swizzled, zero-filled past its edges
bool tile_map(CUtensorMap* map, const void* p, int rows, int cols,
              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(p), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch_tc(const void* x, const void* y, void* o, int m, int n, int k,
              int ldy, cudaStream_t stream) {
  if (k % 8 || ldy % 8 || ldy < n ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap map_x, map_y;
  if (!tile_map(&map_x, x, m, k, kTcBM) ||
      !tile_map(&map_y, y, k, ldy, kTcBK))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(gemm_tc_kernel<BN>, Tc<BN>::kSmem);
  if (err != cudaSuccess) return err;
  const int tiles_m = (m + kTcBM - 1) / kTcBM;
  const int tiles_n = (n + BN - 1) / BN;
  gemm_tc_kernel<BN><<<tiles_m * tiles_n, kTcThreads, Tc<BN>::kSmem,
                       stream>>>(
      map_x, map_y, static_cast<__nv_bfloat16*>(o), m, n, k, tiles_m,
      tiles_n);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// Shared memory of one CTA of the form asked about: the tensor-core form's
// ring and barriers at tile columns (bf16 = 1, tile 256 or 128, dynamic),
// or the SIMT form's two k-tile stages at its square tile (bf16 = 0, tile
// 128 or 64, static).
size_t gemm_smem(int bf16, int tile) {
  using namespace repro_torch;
  if (bf16) return tile == 128 ? Tc<128>::kSmem : Tc<256>::kSmem;
  return tile == 64 ? Simt<64, 64>::kSmem : Simt<128, 128>::kSmem;
}

// x (m, k) @ y (k, n) -> o (m, n), row-major and contiguous, accumulated in
// float32; y's rows are ldy >= n elements long (its first n columns are y).
// All bfloat16 (bf16 = 1): the tensor-core form at 128 x tile output tiles
// (256 or 128), which needs k % 8 == 0, ldy % 8 == 0 and 16-byte aligned x
// and y.  All float32 (bf16 = 0): the SIMT form at tile x tile output
// tiles (128 or 64), ldy == n.  *tc is set
// to the form launched (1 the tensor-core form, 0 the SIMT form) when the
// launch succeeds, and left as it was when it fails.
int gemm_run(const void* x, const void* y, void* o, int m, int n, int k,
             int ldy, int bf16, int tile, int* tc, void* stream) {
  using namespace repro_torch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (bf16 && tile == 256)
    err = launch_tc<256>(x, y, o, m, n, k, ldy, s);
  else if (bf16 && tile == 128)
    err = launch_tc<128>(x, y, o, m, n, k, ldy, s);
  else if (bf16 || ldy != n)
    return cudaErrorInvalidValue;
  else if (tile == 128)
    err = launch_simt<128, 128>(x, y, o, m, n, k, s);
  else if (tile == 64)
    err = launch_simt<64, 64>(x, y, o, m, n, k, s);
  else
    return cudaErrorInvalidValue;
  if (err == cudaSuccess) *tc = bf16;
  return err;
}

}  // extern "C"
