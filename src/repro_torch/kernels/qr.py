"""Batched Householder QR with an explicit Q (paper Fig. 6 left), the
primitive the unfused least-squares baseline factors with (K17).

Per outer column k the householder region (norm + sqrt — the
non-critical point/vector flow producing tau and v) feeds two critical
updates, R -= v (tau v^T R) and Q -= (tau Q v) v^T.  v is masked to
rows >= k (inductive domain), tau is consumed across the whole trailing
submatrix — an ordered dependence with inductive consumption rate (the
paper's ``tau`` edge).  min(n, m - 1) reflectors run (none when m = 1);
R is returned masked to rows <= cols.

The kernel (``csrc/qr.cu``) runs one CUDA block per lane with Q and R in
shared memory, or, for a lane too large for it, in its outputs Q and R in
device memory.  :func:`qr_plain` follows the reference's ``_qr_kernel``
step by step; a CPU tensor takes it, a CUDA tensor the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import CudaKernel, check_f32


def qr_plain(a: torch.Tensor):
    """Plain PyTorch version of K17: a (B, M, N) -> Q (B, M, M), R
    (B, M, N) with a = Q @ R and R zero below its diagonal (an upper
    trapezoid when M < N)."""
    bsz, m, n = a.shape
    rows = torch.arange(m, device=a.device)
    r = a
    q = torch.eye(m, dtype=a.dtype, device=a.device).expand(bsz, m, m)
    for k in range(min(n, m - 1) if m > 1 else 0):
        # ---- householder region (non-critical: norm, sqrt, div) ----
        x = torch.where(rows >= k, r[:, :, k], 0.0)     # masked column
        xk = r[:, k, k]
        norm = torch.sqrt(torch.sum(x * x, dim=-1))
        alpha = torch.where(xk >= 0, -norm, norm)
        v = x - alpha[:, None] * (rows == k).to(a.dtype)
        vnorm2 = torch.clamp_min(torch.sum(v * v, dim=-1), 1e-30)
        tau = 2.0 / vnorm2
        tau = torch.where(norm < 1e-30, 0.0, tau)       # degenerate column
        # ---- critical region 1: R update (v^T R, then the outer) ----
        w = tau[:, None] * (v[:, None, :] @ r)[:, 0]
        r = r - v[:, :, None] * w[:, None, :]
        # ---- critical region 2: Q accumulation ----
        u = tau[:, None] * (q @ v[:, :, None])[:, :, 0]
        q = q - u[:, :, None] * v[:, None, :]
    cols = torch.arange(n, device=a.device)
    return q.contiguous(), torch.where(rows[:, None] <= cols[None, :], r,
                                       0.0)


_KERNEL = CudaKernel(
    "qr", "qr_f32",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4,
    "qr_smem", 2,
    source="src/repro_torch/csrc/qr.cu",
    replaces="src/repro/kernels/qr.py:54 qr_pallas")


def qr_fused(a: torch.Tensor):
    """a: (B, M, N) float32, contiguous, any M and N -> (Q (B, M, M), R
    (B, M, N)) with a = Q @ R and R zero below its diagonal (for M < N,
    min(N, M - 1) reflectors leave R an upper trapezoid).  K17 on a CUDA
    tensor (one launch; a lane past shared memory works in Q and R in
    device memory), its plain version on a CPU one."""
    dev = check_f32("qr", a)
    if a.dim() != 3:
        raise ValueError(f"qr: expected (B, M, N), got {tuple(a.shape)}")
    if dev.type == "cpu":
        return qr_plain(a)
    bsz, m, n = a.shape
    q = torch.empty((bsz, m, m), dtype=a.dtype, device=dev)
    r = torch.empty_like(a)
    if bsz:
        glob = not _KERNEL.fits_shared(m, n)
        _KERNEL.launch(dev, (m, n), a.data_ptr(), q.data_ptr(),
                       r.data_ptr(), bsz, m, n, int(glob),
                       work=q if glob else None)
    return q, r
