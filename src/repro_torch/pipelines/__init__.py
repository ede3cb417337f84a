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

Each module holds the kernel's wrapper (``*_fused``: the kernel on a
CUDA tensor, the plain version on a CPU tensor), its plain PyTorch
version (``*_plain``), and a device-taking public wrapper.  The kernel
registry (``repro_torch.kernels``) binds them to the serving stack.
"""
from repro_torch.pipelines.cholesky_solve import (  # noqa: F401
    cholesky_solve, cholesky_solve_fused, cholesky_solve_plain)
from repro_torch.pipelines.mmse import (  # noqa: F401
    expand_complex_channel, mmse_equalize, mmse_equalize_fused,
    mmse_equalize_plain, mmse_equalize_split, mmse_equalize_split_fused,
    mmse_equalize_split_plain)
from repro_torch.pipelines.qr_solve import (  # noqa: F401
    qr_solve, qr_solve_fused, qr_solve_plain)

__all__ = [
    "cholesky_solve", "cholesky_solve_fused", "cholesky_solve_plain",
    "mmse_equalize", "mmse_equalize_fused", "mmse_equalize_plain",
    "mmse_equalize_split", "mmse_equalize_split_fused",
    "mmse_equalize_split_plain", "expand_complex_channel",
    "qr_solve", "qr_solve_fused", "qr_solve_plain",
]
