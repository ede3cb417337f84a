"""The public primitive API: one hand-written kernel per call.

Each function takes float32 arrays or tensors and ``device`` (default
``cuda``; ``"cpu"`` runs the kernel's plain PyTorch version) and goes
through the kernel's wrapper (``*_fused``), which launches the kernel on
a CUDA tensor and takes the plain version on a CPU one:

  cholesky  K15 — unguarded factor L      (``kernels/cholesky.py``)
  trisolve  K16 — forward/back substitution (``kernels/trisolve.py``)
  qr        K17 — Householder Q and R      (``kernels/qr.py``)
  fir       K19 — centro-symmetric FIR     (``kernels/fir.py``)
  fft       K7  — radix-2 DFT              (``kernels/fft.py``)
  svd       K8  — one-sided Jacobi, sorted (``kernels/svd.py``)

The reference's ``backend="xla"`` paths are the library oracles of
``repro_torch.kernels.ref``, which a caller that wants one calls by name;
no switch here sends a CUDA tensor to a plain version.  ``gemm``,
``flash_attention`` and ``ssm_scan`` come with their kernels' slices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cholesky import cholesky_fused
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.fft import fft_fused
from repro_torch.kernels.fir import fir_fused
from repro_torch.kernels.qr import qr_fused
from repro_torch.kernels.svd import svd_fused
from repro_torch.kernels.trisolve import trisolve_fused

__all__ = ["cholesky", "trisolve", "qr", "svd", "fir", "fft"]


def _on(device, *arrays) -> list[torch.Tensor]:
    dev = resolve_device(device)
    return [torch.as_tensor(x, device=dev).contiguous() for x in arrays]


# ---------------- factorizations ----------------

def cholesky(a, *, device=None) -> torch.Tensor:
    """a: (B, N, N) SPD -> L lower triangular with a = L @ L^T."""
    return cholesky_fused(*_on(device, a))


def trisolve(l, b, *, lower: bool = True, device=None) -> torch.Tensor:
    """l: (B, N, N) lower (or upper) triangular, b: (B, N, M) -> y with
    l @ y = b."""
    return trisolve_fused(*_on(device, l, b), lower=lower)


def qr(a, *, device=None):
    """a: (B, M, N), M >= N -> (Q (B, M, M), R (B, M, N)), a = Q @ R."""
    return qr_fused(*_on(device, a))


def svd(a, *, sweeps: int = 12, sort: bool = True, device=None):
    """One-sided Jacobi SVD: (B, M, N), M >= N -> (U, S, V) with
    A ~= U * S @ V^T; with ``sort`` the singular values descend and U's
    and V's columns follow them."""
    u, s, v = svd_fused(*_on(device, a), sweeps=sweeps)
    if sort:
        order = torch.argsort(-s, dim=-1, stable=True)
        u = torch.take_along_dim(u, order[:, None, :], dim=2)
        s = torch.take_along_dim(s, order, dim=1)
        v = torch.take_along_dim(v, order[:, None, :], dim=2)
    return u, s, v


# ---------------- DSP ----------------

def fir(x, h, *, device=None) -> torch.Tensor:
    """Centro-symmetric FIR, valid mode: y[i] = sum_j h[j] x[i+j]."""
    return fir_fused(*_on(device, x, h))


def fft(x_re, x_im, *, device=None):
    """(B, N) re/im planes, N a power of two -> (re, im) of the DFT."""
    return fft_fused(*_on(device, x_re, x_im))
