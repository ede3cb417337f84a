"""Fused least squares: Householder QR + implicit Q^T b + back
substitution in one kernel launch (paper Fig. 6 chained with Fig. 9).

The fusion is structural, not just spatial: Q is never formed.  Each
reflector (v, tau) — the non-critical point/vector region — is applied to
the trailing columns of R *and* to the right-hand sides in the same outer
iteration (two critical regions sharing one produced value: the paper's
inductive-consumption ``tau`` edge).  After min(m-1, n) reflections the
rhs holds Q^T b, and the back substitution on the n x n upper triangle
of R runs in the same lane, everything in shared memory
(``csrc/qr_solve.cu``, K4).

Pivot guard: a degenerate (zero-norm) column takes tau = 0 (identity
reflector) and the back substitution zeroes a component whose pivot is
below a relative threshold, so rank-deficient systems stay finite.

The plain PyTorch version (:func:`qr_solve_plain`, built from
:func:`reflect_step` and :func:`back_substitute_r`) follows the
reference's per-lane op order; a CPU tensor takes it, a CUDA tensor the
kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (CudaKernel, check_f32,
                                        resolve_device)

DEFAULT_TINY = 1e-20


def _sum_rows(t: torch.Tensor) -> torch.Tensor:
    """Sum a (B, m, ...) tensor over its row axis in ascending row order
    (the last entry of a running sum, which the CPU accumulates row by
    row), so zero rows appended below a lane — a coalesced embedding —
    leave the sum bit-identical.  ``sum`` and matmul regroup their terms
    with the length and the batch."""
    return t.cumsum(dim=1)[:, -1]


def reflect_step(k: int, r: torch.Tensor, y: torch.Tensor,
                 rows: torch.Tensor, *, tiny: float = DEFAULT_TINY):
    """One fused outer iteration over every lane: build reflector k,
    apply it to R (B, m, n) and the rhs (B, m, k)."""
    # ---- householder region (non-critical: norm, sqrt, div) ----
    x = torch.where(rows >= k, r[:, :, k], 0.0)       # masked column (F4)
    xk = r[:, k, k]
    norm = torch.sqrt(_sum_rows(x * x))
    alpha = torch.where(xk >= 0, -norm, norm)
    v = x - alpha[:, None] * (rows == k).to(r.dtype)
    vnorm2 = torch.clamp_min(_sum_rows(v * v), tiny)
    tau = torch.where(norm < tiny, 0.0, 2.0 / vnorm2)  # degenerate: skip
    # ---- critical region 1: R update (v^T R then rank-1) ----
    w = tau[:, None] * _sum_rows(v[:, :, None] * r)
    r = r - v[:, :, None] * w[:, None, :]
    # ---- critical region 2 (fused solve): rhs <- (I - tau v v^T) rhs ----
    wy = tau[:, None] * _sum_rows(v[:, :, None] * y)
    y = y - v[:, :, None] * wy[:, None, :]
    return r, y


def back_substitute_r(r: torch.Tensor, y: torch.Tensor, *, n: int,
                      tiny: float) -> torch.Tensor:
    """Back substitution on R[:n,:n] x = (Q^T b)[:n] for every lane.

    Uses a relative deficiency threshold from R's diagonal: a pivot
    below it marks a numerically dependent column, whose solution
    component is ZEROED (clamping the divisor instead would overflow
    float32: with R = [[0,1],[0,0]] a clamped 1/tiny cascades to inf
    through the remaining rows).
    """
    rows_n = torch.arange(n, device=r.device)
    z = y[:, :n]
    eye = rows_n[:, None] == rows_n[None, :]
    diag = torch.abs(torch.where(eye, r[:, :n], 0.0).sum(dim=-1))
    thresh = torch.clamp_min(1e-6 * diag.amax(dim=-1), tiny)
    for i in range(n):
        k = n - 1 - i
        rkk = r[:, k, k]
        ok = torch.abs(rkk) > thresh
        xk = torch.where(ok[:, None],
                         z[:, k] / torch.where(ok, rkk, 1.0)[:, None], 0.0)
        z = z.clone()
        z[:, k] = xk
        col = torch.where(rows_n < k, r[:, :n, k], 0.0)
        z = z - col[:, :, None] * xk[:, None, :]
    return z


def qr_solve_plain(a: torch.Tensor, b: torch.Tensor, *,
                   tiny: float = DEFAULT_TINY) -> torch.Tensor:
    """Plain PyTorch version of K4: a (B,M,N), b (B,M,K) -> x (B,N,K)."""
    m, n = a.shape[-2:]
    rows = torch.arange(m, device=a.device)
    nref = min(n, m - 1) if m > 1 else 0
    r, y = a, b
    for k in range(nref):
        r, y = reflect_step(k, r, y, rows, tiny=tiny)
    return back_substitute_r(r, y, n=n, tiny=tiny)


_KERNEL = CudaKernel(
    "qr_solve", "qr_solve_f32",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float],
    "qr_solve_smem", 3,
    source="src/repro_torch/csrc/qr_solve.cu",
    replaces="src/repro/pipelines/qr_solve.py:100 qr_solve_pallas")


def qr_solve_fused(a: torch.Tensor, b: torch.Tensor, *,
                   tiny: float = DEFAULT_TINY) -> torch.Tensor:
    """Least squares min ||a @ x - b||. a: (B,M,N) with M >= N,
    b: (B,M,K) -> x: (B,N,K); float32, contiguous.  K4 on a CUDA tensor
    (one launch, Q never formed), its plain version on a CPU one."""
    dev = check_f32("qr_solve", a, b)
    bsz, m, n = a.shape
    b2, m2, k = b.shape
    if not (m == m2 and bsz == b2 and m >= n):
        raise ValueError(f"qr_solve: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if dev.type == "cpu":
        return qr_solve_plain(a, b, tiny=tiny)
    x = torch.empty((bsz, n, k), dtype=torch.float32, device=dev)
    if bsz:
        _KERNEL.launch(dev, (m, n, k), a.data_ptr(), b.data_ptr(),
                       x.data_ptr(), bsz, m, n, k, tiny)
    return x


def qr_solve(a, b, *, device=None) -> torch.Tensor:
    """Public wrapper: a (B,M,N), b (B,M,K) float32 arrays or tensors,
    solved on ``device`` (default ``cuda``; ``"cpu"`` runs the plain
    version)."""
    dev = resolve_device(device)
    return qr_solve_fused(torch.as_tensor(a, device=dev).contiguous(),
                          torch.as_tensor(b, device=dev).contiguous())
