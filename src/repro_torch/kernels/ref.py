"""Plain-library oracles for the served solver pipelines — the ground
truth for allclose tests and the serving stack's per-job spot check.

These are deliberately unfused library calls (``torch.linalg``), the
counterparts of the reference's ``repro/kernels/ref.py`` oracles.  This
module is the only place in the package that calls ``torch.linalg``; no
served path calls it.
"""
from __future__ import annotations

import torch


def cholesky_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SPD solve a @ x = b, the unfused library path.
    a: (B,N,N), b: (B,N,M)."""
    return torch.linalg.solve(a, b)


def qr_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Least squares min ||a x - b||, full-rank tall a.
    a: (B,M,N), b: (B,M,K) -> (B,N,K)."""
    q, r = torch.linalg.qr(a)            # reduced
    qtb = torch.einsum("bmn,bmk->bnk", q, b)
    return torch.linalg.solve_triangular(r, qtb, upper=True)


def mmse_equalize(h: torch.Tensor, y: torch.Tensor, *,
                  sigma2: float = 0.1) -> torch.Tensor:
    """LMMSE x = (H^T H + s I)^{-1} H^T y.  h: (B,M,N), y: (B,M,K)."""
    n = h.shape[-1]
    g = torch.einsum("bmi,bmj->bij", h, h) \
        + sigma2 * torch.eye(n, dtype=h.dtype, device=h.device)
    rhs = torch.einsum("bmn,bmk->bnk", h, y)
    return torch.linalg.solve(g, rhs)


def mmse_equalize_split(hr: torch.Tensor, hi: torch.Tensor,
                        yr: torch.Tensor, yi: torch.Tensor, *,
                        sigma2: float = 0.1) -> torch.Tensor:
    """Complex-valued LMMSE oracle for the split re/im kernel.

    hr/hi: (B,M,N) channel planes, yr/yi: (B,M,K) observation planes.
    Solves x = (H^H H + s I)^{-1} H^H y in complex64 and returns the
    REAL-STACKED result (B, 2N, K) = [Re x; Im x] — the layout the real
    expansion produces, so split- and expansion-path answers to the same
    complex problem compare element-for-element.
    """
    h = torch.complex(hr, hi)
    y = torch.complex(yr, yi)
    n = h.shape[-1]
    g = torch.einsum("bmi,bmj->bij", h.conj(), h) \
        + sigma2 * torch.eye(n, dtype=h.dtype, device=h.device)
    rhs = torch.einsum("bmn,bmk->bnk", h.conj(), y)
    x = torch.linalg.solve(g, rhs)
    return torch.cat([x.real, x.imag], dim=-2).to(hr.dtype)
