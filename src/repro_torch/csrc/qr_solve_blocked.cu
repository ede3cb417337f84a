// K11: blocked (compact-WY) fused least squares, a lane on a cluster.
//
// Replaces: src/repro/pipelines/qr_solve.py, qr_solve_blocked
// (_qr_solve_blocked_kernel, _qr_panel_reflect_step, _wy_t_step): per
// bs-column panel, bs Householder reflectors built from and applied to the
// panel only, the compact-WY factor T built column by column (LAPACK larft,
// forward) from V^T V, and the block reflector I - V T^T V^T applied to the
// trailing columns and to the whole right-hand side; then the guarded back
// substitution on R[:n, :n] with the threshold max(1e-6 max |diag R|, tiny)
// taken over the finished R.  Q is never formed.
//
// What bounds it on an H100: per lane about 2 (m n^2 - n^3/3) + 4 m n k
// FLOPs and m n + m k + n k floats in and out, microseconds at a carrier's
// width; what holds it back is the order of the reflectors, and at the
// mid-range mix's 32 served lanes, one CTA a lane leaves most SMs idle.
// So a lane runs on a thread-block cluster (csrc/qr_cluster.cuh): the
// panel in row bands across the cluster's shared memory, its sums by
// fixed row groups (no warp takes a norm alone), one cluster barrier a
// reflector; the columns dealt to the CTAs in 64-column blocks of the
// lane's device work buffer.  The plan is pipelines/qr_solve.py's
// qr_cluster_plan.  The rhs takes the block
// reflector, not one reflector at a time as in K4: a different float
// grouping, held at the reference's tolerance.
#include "qr_cluster.cuh"

// K11's instances: qr_cluster_kernel<*, *, 2>, two CTAs an SM asked of ptxas.
constexpr int kMinBlocks = 2;

extern "C" {

// a (batch, m, n) with m >= n, b (batch, m, k) -> x (batch, n, k), float32;
// work: batch * qc_work_floats floats; the plan (c, band_shared, smem)
// must be qr_cluster_plan's formula.
int qr_solve_blocked_f32(const void* a, const void* b, void* x, void* work,
    int batch, int m, int n, int k, int bs, float tiny, int c,
    int band_shared, int smem, void* stream) {
  return repro_torch::qc_launch<false, kMinBlocks>(
      a, b, x, work, nullptr, batch, m, n, k, bs, tiny, c, band_shared, smem,
      stream);
}

// The same solve with the phase stamps (phase_clock.cuh): stamps holds
// batch * kQrStampWords words.  Only scripts/qr_phases.py launches it.
int qr_solve_blocked_phases_f32(const void* a, const void* b, void* x,
    void* work, void* stamps, int batch, int m, int n, int k, int bs,
    float tiny, int c, int band_shared, int smem, void* stream) {
  return repro_torch::qc_launch<true, kMinBlocks>(
      a, b, x, work, static_cast<unsigned long long*>(stamps), batch, m, n, k,
      bs, tiny, c, band_shared, smem, stream);
}

// cudaOccupancyMaxActiveClusters of the served instance of a plan.
int qr_solve_blocked_clusters(int c, int band_shared, int smem) {
  return repro_torch::qc_max_clusters<kMinBlocks>(c, band_shared, smem);
}

}  // extern "C"
