"""The public primitive API: one hand-written kernel per call.

Each function takes float32 arrays or tensors (``gemm``,
``flash_attention`` and ``ssm_scan`` bfloat16 too) and ``device`` (default
``cuda``; ``"cpu"`` runs the kernel's plain PyTorch version) and goes
through the kernel's wrapper (``*_fused``), which launches the kernel on
a CUDA tensor and takes the plain version on a CPU one:

  cholesky  K15 — unguarded factor L      (``kernels/cholesky.py``)
  trisolve  K16 — forward/back substitution (``kernels/trisolve.py``)
  qr        K17 — Householder Q and R      (``kernels/qr.py``)
  gemm      K18 — (M, K) @ (K, N), f32 acc  (``kernels/gemm.py``)
  fir       K19 — centro-symmetric FIR     (``kernels/fir.py``)
  fft       K7  — radix-2 DFT              (``kernels/fft.py``)
  svd       K8  — one-sided Jacobi, sorted (``kernels/svd.py``)
  flash_attention  K20 — causal GQA attention (``kernels/attention.py``)
  ssm_scan  K21 — chunked SSD/Mamba2 scan  (``kernels/ssm_scan.py``)

The reference's ``backend="xla"`` paths are the library oracles of
``repro_torch.kernels.ref``, which a caller that wants one calls by name;
no switch here sends a CUDA tensor to a plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention import flash_attention_fused
from repro_torch.kernels.cholesky import cholesky_fused
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.fft import fft_fused
from repro_torch.kernels.fir import fir_fused
from repro_torch.kernels.gemm import gemm_fused
from repro_torch.kernels.qr import qr_fused
from repro_torch.kernels.ssm_scan import ssm_scan_fused
from repro_torch.kernels.svd import svd_fused
from repro_torch.kernels.trisolve import trisolve_fused

__all__ = ["cholesky", "trisolve", "qr", "svd", "gemm", "fir", "fft",
           "flash_attention", "ssm_scan"]


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
    """a: (B, M, N) -> (Q (B, M, M), R (B, M, N)), a = Q @ R, R zero
    below its diagonal (an upper trapezoid when M < N)."""
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


# ---------------- dense / DSP ----------------

def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def gemm(x, y, *, bm: int = 128, bn: int = 128, bk: int = 128,
         device=None) -> torch.Tensor:
    """x (M, K) @ y (K, N) -> (M, N) in x's dtype, accumulated in float32.
    Each dimension is zero-padded up to a multiple of its block,
    min(b, max(dim, 8)), as the reference's ``ops.gemm`` pads for its
    kernel, and the product sliced back."""
    x, y = _on(device, x, y)
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"gemm: expected (M, K) @ (K, N), got "
                         f"{tuple(x.shape)} @ {tuple(y.shape)}")
    m, k = x.shape
    n = y.shape[1]
    mp = _round_up(m, min(bm, max(m, 8)))
    np_ = _round_up(n, min(bn, max(n, 8)))
    kp = _round_up(k, min(bk, max(k, 8)))
    xp = torch.nn.functional.pad(x, (0, kp - k, 0, mp - m))
    yp = torch.nn.functional.pad(y, (0, np_ - n, 0, kp - k))
    return gemm_fused(xp, yp)[:m, :n]


def fir(x, h, *, device=None) -> torch.Tensor:
    """Centro-symmetric FIR, valid mode: y[i] = sum_j h[j] x[i+j]."""
    return fir_fused(*_on(device, x, h))


def fft(x_re, x_im, *, device=None):
    """(B, N) re/im planes, N a power of two -> (re, im) of the DFT."""
    return fft_fused(*_on(device, x_re, x_im))


# ---------------- LM-side ----------------

def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, bq: int = 128,
                    bkv: int = 128, device=None) -> torch.Tensor:
    """q (B, H, S, D), k/v (B, Hkv, S, D), H % Hkv == 0 -> (B, H, S, D);
    causal needs square attention, and S must divide by min(128, S).
    The kernel reads views through their strides (the models hand over
    transposed (B, S, H, D) tensors) and answers in q's layout, so no
    copy is made on either side."""
    dev = resolve_device(device)
    return flash_attention_fused(
        *(torch.as_tensor(t, device=dev) for t in (q, k, v)),
        causal=causal, scale=scale, bq=bq, bkv=bkv)


def ssm_scan(x, a, b, c, *, chunk: int = 128, device=None):
    """x: (B, S, H, P), a: (B, S, H), b/c: (B, S, N) shared across heads or
    (B, S, H, N) per head -> y (B, S, H, P), h (B, H, N, P), both in x's
    dtype; S must divide by min(chunk, S).  The kernel reads this layout
    through strides: the reference's moves of the sequence axis are views
    here, not copies."""
    dev = resolve_device(device)
    x, a, b, c = (torch.as_tensor(t, device=dev) for t in (x, a, b, c))
    if x.dim() != 4 or a.dim() != 3 or b.dim() not in (3, 4):
        raise ValueError(f"ssm_scan: expected x (B, S, H, P), a (B, S, H) "
                         f"and b/c (B, S, N) or (B, S, H, N), got "
                         f"{tuple(x.shape)}, {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if b.dim() == 4:
        b, c = b.transpose(1, 2), c.transpose(1, 2)
    y, hf = ssm_scan_fused(x.transpose(1, 2), a.transpose(1, 2), b, c,
                           chunk=chunk)
    return y.transpose(1, 2), hf
