"""Fused solver pipelines — composed FGOP workloads as single kernels.

The paper's wireless motivation (§1, Fig. 4) is a *chain*: in a 5G MMSE
receiver every subcarrier runs channel-Gram product -> Cholesky ->
forward solve -> back solve -> combine, thousands of times per slot.
Each chain here is one kernel launch over all lanes, one CUDA block per
lane, written by hand for Hopper (``src/repro_torch/csrc/``):

  cholesky_solve       K1 — factor + both substitutions fused
  mmse_equalize        K2 — H^T H + sigma^2 I, matched filter, K1's chain
  mmse_equalize_split  K3 — the same from split re/im planes
  qr_solve             K4 — Householder least squares, Q never formed
  channel_estimate     K5 — pilot Gram + K1's chain, H = Z^T
  pusch_chain          K6 — K5 then K2 in one lane, H never leaves it
  pusch_fft            K7 — per-antenna FFT into stacked re/im planes
  svd_factor           K8 — one-sided Jacobi SVD, packed [U; V; s]
  svd_apply            K9 — V diag(s / (s^2 + lam)) U^T b
  cholesky_solve_blocked  K10 — K1 by panels + rank-bs SYRK (n >= 128)
  qr_solve_blocked     K11 — compact-WY least squares (n >= 128)
  cholesky_solve_tiled    K12 — K10 with slabs streamed past shared
                          memory (n >= 512)
  qr_solve_tiled       K13 — K11 the same way, global-threshold back-sub
  mmse_equalize_tiled  K14 — tiled Gram + matched filter, K12's phases

Beside them the unfused baselines the fused kernels are measured
against, each a chain of primitive kernels (``repro_torch.kernels``)
with its intermediates in device memory:

  cholesky_solve_unfused  K15, K16 forward, K16 backward on L^T
  qr_solve_unfused        K17, a library Q^T b, K16 backward
  mmse_equalize_composed  library Gram and H^T y, then the Cholesky chain

Each module holds the kernel's wrapper (``*_fused``: the kernel on a
CUDA tensor, the plain version on a CPU tensor), its plain PyTorch
version (``*_plain``), and a device-taking public wrapper.  The kernel
registry (``repro_torch.kernels``) binds them to the serving stack.
"""
from repro_torch.pipelines.cholesky_solve import (  # noqa: F401
    TILED_VMEM_BUDGET_BYTES, CholTiledPlan, blocked_rhs_groups,
    chol_panel_plan, chol_tiled_forms, chol_tiled_plan, cholesky_solve,
    cholesky_solve_blocked,
    cholesky_solve_blocked_fits, cholesky_solve_blocked_fused,
    cholesky_solve_blocked_plain, cholesky_solve_fused, cholesky_solve_plain, cholesky_solve_tiled,
    cholesky_solve_tiled_fused, cholesky_solve_tiled_plain,
    cholesky_solve_unfused,
    tiled_block_size, tiled_vmem_floats)
from repro_torch.pipelines.mmse import (  # noqa: F401
    expand_complex_channel, mmse_equalize, mmse_equalize_blocked,
    mmse_equalize_composed,
    mmse_equalize_fused, mmse_equalize_plain, mmse_equalize_split,
    mmse_equalize_split_fused, mmse_equalize_split_plain,
    mmse_form, mmse_split_plan, mmse_wide_plan,
    mmse_equalize_tiled, mmse_equalize_tiled_fused,
    mmse_equalize_tiled_plain, mmse_tiled_vmem_floats)
from repro_torch.pipelines.pusch import (  # noqa: F401
    channel_estimate, channel_estimate_fused, channel_estimate_plain,
    channel_estimate_plan, pusch_chain, pusch_chain_fused, pusch_chain_plain, pusch_chain_plan,
    pusch_fft,
    pusch_fft_fused, pusch_fft_plain, svd_apply, svd_apply_fused,
    svd_apply_plain, svd_factor, svd_factor_fused, svd_factor_plain,
    unpack_factors)
from repro_torch.pipelines.qr_solve import (  # noqa: F401
    QrClusterPlan, qr_cluster_forms, qr_cluster_plan, qr_panel_plan,
    qr_solve, qr_solve_blocked, qr_solve_blocked_fits,
    qr_solve_blocked_fused, qr_solve_blocked_plain, qr_solve_fused, qr_solve_plain, qr_solve_tiled,
    qr_solve_tiled_fused, qr_solve_tiled_plain, qr_solve_unfused,
    qr_tiled_vmem_floats)

__all__ = [
    "cholesky_solve", "cholesky_solve_fused", "cholesky_solve_plain",
    "chol_panel_plan",
    "mmse_equalize", "mmse_equalize_fused", "mmse_equalize_plain",
    "mmse_equalize_split", "mmse_equalize_split_fused",
    "mmse_equalize_split_plain", "mmse_split_plan", "mmse_form",
    "mmse_wide_plan",
    "expand_complex_channel",
    "qr_solve", "qr_solve_fused", "qr_solve_plain", "qr_panel_plan",
    "QrClusterPlan", "qr_cluster_plan", "qr_cluster_forms",
    "cholesky_solve_blocked", "cholesky_solve_blocked_fused",
    "cholesky_solve_blocked_plain", "cholesky_solve_blocked_fits",
    "blocked_rhs_groups",
    "qr_solve_blocked", "qr_solve_blocked_fused", "qr_solve_blocked_plain",
    "qr_solve_blocked_fits",
    "TILED_VMEM_BUDGET_BYTES", "tiled_block_size", "tiled_vmem_floats",
    "cholesky_solve_tiled", "cholesky_solve_tiled_fused",
    "cholesky_solve_tiled_plain",
    "qr_solve_tiled", "qr_solve_tiled_fused", "qr_solve_tiled_plain",
    "qr_tiled_vmem_floats",
    "mmse_equalize_tiled", "mmse_equalize_tiled_fused",
    "mmse_equalize_tiled_plain", "mmse_tiled_vmem_floats",
    "mmse_equalize_blocked",
    "cholesky_solve_unfused", "qr_solve_unfused", "mmse_equalize_composed",
    "channel_estimate", "channel_estimate_fused", "channel_estimate_plain",
    "channel_estimate_plan",
    "pusch_chain", "pusch_chain_fused", "pusch_chain_plain",
    "pusch_fft", "pusch_fft_fused", "pusch_fft_plain",
    "svd_factor", "svd_factor_fused", "svd_factor_plain",
    "svd_apply", "svd_apply_fused", "svd_apply_plain", "unpack_factors",
]
