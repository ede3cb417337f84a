"""Fused SPD solve: Cholesky factor + forward + back substitution in one
kernel launch, one lane per problem (paper Figs. 5/9/13 chained as a
single ordered region).

The win the paper measures is the *chain* factor -> forward-solve ->
back-solve executed without the matrix round-tripping through memory.
Here one CUDA block is one lane (``csrc/cholesky_solve.cu``): the matrix
and right-hand sides stay in shared memory across all three stages, and
the forward substitution is interleaved inside the factor loop — as soon
as column k of L is finished (the ordered dependence), the divide + AXPY
of the forward solve for row k consume it.

Numerics: only the lower triangle of A is read (the inductive-domain
mask, paper Feature 4), and the pivot is guarded by ``eps`` so singular
or ill-conditioned systems give finite output instead of NaN lanes.

The plain PyTorch version (:func:`cholesky_solve_plain`, built from
:func:`pivot_threshold`, :func:`factor_forward_step` and
:func:`back_substitution_step`) follows the reference's per-lane op order
with the batch written out; a CPU tensor takes it, a CUDA tensor the
kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (CudaKernel, check_f32,
                                        resolve_device)

# Relative pivot threshold (LAPACK pstrf-style): a pivot below
# eps * max(diag(A)) marks a numerically deficient direction.  Residual
# pivots of an exactly singular float32 matrix land around
# n * ulp * ||A|| ~ 1e-6 * scale, so 1e-5 cleanly separates "deficient"
# from merely ill-conditioned.
DEFAULT_EPS = 1e-5


def pivot_threshold(a: torch.Tensor, rows: torch.Tensor, *,
                    eps: float) -> torch.Tensor:
    """Scale-relative deficiency threshold from the initial diagonal,
    one per lane: a (B, n, n) -> (B,)."""
    diag = torch.where(rows[:, None] == rows[None, :], a, -torch.inf)
    return torch.clamp_min(eps * diag.amax(dim=(-2, -1)), 1e-30)


def factor_forward_step(k: int, a: torch.Tensor, y: torch.Tensor,
                        rows: torch.Tensor, thresh: torch.Tensor):
    """One fused outer iteration over every lane: finish column k of L,
    then immediately run the forward-substitution step that consumes it.

    a: (B, n, n) working matrix (lower triangle -> L in place)
    y: (B, n, m) right-hand sides being forward-solved in place
    thresh: (B,) deficiency threshold (see pivot_threshold)

    A pivot below ``thresh`` takes the rank-deficient path: unit diagonal,
    zeroed column, zeroed solution component — the solve proceeds on the
    numerically non-deficient subspace and every lane stays finite.
    """
    # ---- point region (non-critical): guarded rsqrt of the pivot ----
    akk = a[:, k, k]
    ok = akk > thresh
    inv = torch.where(ok, torch.rsqrt(torch.maximum(akk, thresh)), 0.0)
    # ---- vector region: scale column k; diagonal set to the pivot ----
    col = a[:, :, k] * inv[:, None]
    col = torch.where(rows == k, torch.where(ok, akk * inv, 1.0)[:, None],
                      col)
    col = torch.where(rows >= k, col, 0.0)            # implicit mask (F4)
    # ---- matrix region (critical): masked rank-1 trailing update ----
    live = rows > k
    upd = col[:, :, None] * col[:, None, :]
    mask = live[:, None] & live[None, :]
    a = a - torch.where(mask, upd, 0.0)
    a[:, :, k] = torch.where(rows >= k, col, a[:, :, k])
    # ---- fused forward substitution consuming the finished column ----
    # y[k] /= l[k,k];  y[j>k] -= l[j,k] * y[k]   (divide + masked AXPY)
    yk = y[:, k] * inv[:, None]                       # deficient: x_k = 0
    y = y.clone()
    y[:, k] = yk
    y = y - torch.where(live[:, None], col[:, :, None] * yk[:, None, :], 0.0)
    return a, y


def back_substitution_step(i: int, l: torch.Tensor, y: torch.Tensor,
                           rows: torch.Tensor, *, n: int) -> torch.Tensor:
    """Back-substitution outer iteration on U = L^T, k = n-1-i:
    x[k] = y[k] / l[k,k];  y[j<k] -= l[k,j] * x[k]."""
    k = n - 1 - i
    xk = y[:, k] / l[:, k, k][:, None]    # diagonal already >= sqrt(eps)
    y = y.clone()
    y[:, k] = xk
    row = l[:, k, :]                      # l[k, j] valid for j <= k
    return y - torch.where((rows < k)[:, None],
                           row[:, :, None] * xk[:, None, :], 0.0)


def cholesky_chain_plain(a: torch.Tensor, y: torch.Tensor, *,
                         eps: float) -> torch.Tensor:
    """The fused factor -> forward -> back chain on symmetric (B, n, n)
    systems, shared by the plain versions of K1, K2 and K3 as the kernels
    share ``chol_chain`` in ``csrc/lane_common.cuh``."""
    n = a.shape[-1]
    rows = torch.arange(n, device=a.device)
    thresh = pivot_threshold(a, rows, eps=eps)
    for k in range(n):
        a, y = factor_forward_step(k, a, y, rows, thresh)
    for i in range(n):
        y = back_substitution_step(i, a, y, rows, n=n)
    return y


def cholesky_solve_plain(a: torch.Tensor, b: torch.Tensor, *,
                         eps: float = DEFAULT_EPS) -> torch.Tensor:
    """Plain PyTorch version of K1: a (B,N,N), b (B,N,M) -> x (B,N,M)."""
    n = a.shape[-1]
    rows = torch.arange(n, device=a.device)
    # symmetrize from the lower triangle: the upper half is never read
    # (garbage/NaN lanes there cannot leak into the solve)
    tril = rows[:, None] >= rows[None, :]
    a = torch.where(tril, a, a.transpose(-1, -2))
    return cholesky_chain_plain(a, b, eps=eps)


_KERNEL = CudaKernel(
    "cholesky_solve", "cholesky_solve_f32",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float],
    "cholesky_solve_smem", 2,
    source="src/repro_torch/csrc/cholesky_solve.cu",
    replaces="src/repro/pipelines/cholesky_solve.py:113 "
             "cholesky_solve_pallas")


def cholesky_solve_fused(a: torch.Tensor, b: torch.Tensor, *,
                         eps: float = DEFAULT_EPS) -> torch.Tensor:
    """Solve a @ x = b for SPD a. a: (B,N,N), b: (B,N,M) -> x (B,N,M),
    float32 and contiguous.  K1 on a CUDA tensor (one launch, factor and
    both substitutions fused per lane), its plain version on a CPU one."""
    dev = check_f32("cholesky_solve", a, b)
    bsz, n, n2 = a.shape
    b2, n3, m = b.shape
    if not (n == n2 == n3 and bsz == b2):
        raise ValueError(f"cholesky_solve: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if dev.type == "cpu":
        return cholesky_solve_plain(a, b, eps=eps)
    x = torch.empty_like(b)
    if bsz:
        _KERNEL.launch(dev, (n, m), a.data_ptr(), b.data_ptr(),
                       x.data_ptr(), bsz, n, m, eps)
    return x


def cholesky_solve(a, b, *, device=None) -> torch.Tensor:
    """Public wrapper: a (B,N,N), b (B,N,M) float32 arrays or tensors,
    solved on ``device`` (default ``cuda``; ``"cpu"`` runs the plain
    version)."""
    dev = resolve_device(device)
    return cholesky_solve_fused(torch.as_tensor(a, device=dev).contiguous(),
                                torch.as_tensor(b, device=dev).contiguous())
