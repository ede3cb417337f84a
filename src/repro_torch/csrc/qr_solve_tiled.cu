// K13: slab-streamed compact-WY fused least squares, a lane on a cluster.
//
// Replaces: src/repro/pipelines/qr_solve.py, qr_solve_tiled
// (_qr_solve_tiled_kernel, _qr_panel_reflect_step, _wy_t_step), the TPU
// kernel whose (lanes, steps + 1, tiles) grid streams one (m x bs) column
// slab of an HBM-resident matrix through VMEM a cell: panel cells build bs
// Householder reflectors on the panel slab, accumulate the compact-WY
// (V, T), apply the block reflector to the right-hand sides and fold
// max |diag R| into a running global maximum; trailing cells apply the
// block reflector to the slabs to the right; the last row of cells solves
// each slab's (bs x bs) diagonal block of R in reverse against the GLOBAL
// threshold max(1e-6 max |diag R|, tiny) and pushes the solved components
// to the rows above.  Q is never formed.
//
// What bounds it on an H100: per lane about 2 (m n^2 - n^3/3) + 4 m n k
// FLOPs and m n + m k + n k floats in and out.  At n = 512 the panel,
// (m - o) x bs, is up to 264 KB, more than a CTA's shared memory, and the
// HBM-scale mix serves 32 lanes, which one CTA a lane would leave 100 of
// 132 SMs idle.  So a lane runs on a thread-block cluster
// (csrc/qr_cluster.cuh): the panel in row bands across the cluster's
// shared memory, one cluster barrier a reflector, the trailing columns
// dealt to the CTAs in 64-column blocks; the plan (C, where the bands
// live, shared memory) is pipelines/qr_solve.py's qr_cluster_plan.  The slabs'
// running maximum of |diag R| is the maximum over R's diagonal, which the
// cluster form keeps as it goes.
#include "qr_cluster.cuh"

// K13's instances: qr_cluster_kernel<*, *, 1>, one CTA an SM asked of ptxas.
constexpr int kMinBlocks = 1;

extern "C" {

// a (batch, m, n) with m >= n, b (batch, m, k) -> x (batch, n, k), float32;
// work: batch * qc_work_floats floats; the plan (c, band_shared, smem)
// must be qr_cluster_plan's formula.
int qr_solve_tiled_f32(const void* a, const void* b, void* x, void* work,
    int batch, int m, int n, int k, int bs, float tiny, int c,
    int band_shared, int smem, void* stream) {
  return repro_torch::qc_launch<false, kMinBlocks>(
      a, b, x, work, nullptr, batch, m, n, k, bs, tiny, c, band_shared, smem,
      stream);
}

// The same solve with the phase stamps (phase_clock.cuh): stamps holds
// batch * kQrStampWords words.  Only scripts/qr_phases.py launches it.
int qr_solve_tiled_phases_f32(const void* a, const void* b, void* x,
    void* work, void* stamps, int batch, int m, int n, int k, int bs,
    float tiny, int c, int band_shared, int smem, void* stream) {
  return repro_torch::qc_launch<true, kMinBlocks>(
      a, b, x, work, static_cast<unsigned long long*>(stamps), batch, m, n, k,
      bs, tiny, c, band_shared, smem, stream);
}

// cudaOccupancyMaxActiveClusters of the served instance of a plan.
int qr_solve_tiled_clusters(int c, int band_shared, int smem) {
  return repro_torch::qc_max_clusters<kMinBlocks>(c, band_shared, smem);
}

}  // extern "C"
