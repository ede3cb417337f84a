"""Batched Cholesky — the paper's running FGOP example (Fig. 5/13), the
primitive the unfused baseline factors with (K15).

One lane is one small SPD matrix.  Per outer iteration k the three
regions run in order:

  point  region (non-critical): rsqrt(a[k,k])
  vector region               : scale column k, masked to rows >= k
  matrix region (critical)    : rank-1 trailing update, masked to
                                 rows > k and cols > k (an RI stream)

The kernel (``csrc/cholesky.cu``) runs one CUDA block per lane with the
matrix in shared memory, or, for a lane too large for it, in its output
L in device memory.  The pivot is NOT guarded: a non-SPD lane gives NaN,
as the reference's does — the guarded factor is K1's
(``pipelines/cholesky_solve.py``), another function.

:func:`cholesky_plain` follows the reference's ``_cholesky_kernel`` step
by step with the batch written out; a CPU tensor takes it, a CUDA tensor
the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import CudaKernel, check_f32


def cholesky_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K15: (B, N, N) SPD -> L (B, N, N) lower
    triangular with a = L L^T."""
    n = a.shape[-1]
    rows = torch.arange(n, device=a.device)
    for k in range(n):
        # ---- point region: unguarded rsqrt of the pivot ----
        inv = torch.rsqrt(a[:, k, k])
        # ---- vector region: scale column k below the diagonal ----
        col = torch.where(rows >= k, a[:, :, k] * inv[:, None], 0.0)
        # ---- matrix region: masked rank-1 trailing update ----
        live = rows > k
        upd = col[:, :, None] * col[:, None, :]
        a = a - torch.where(live[:, None] & live[None, :], upd, 0.0)
        # write the finished L column back (ordered dep to next k)
        a[:, :, k] = torch.where(rows >= k, col, a[:, :, k])
    return torch.where(rows[:, None] >= rows[None, :], a, 0.0)


_KERNEL = CudaKernel(
    "cholesky", "cholesky_f32",
    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3,
    "cholesky_smem", 1,
    source="src/repro_torch/csrc/cholesky.cu",
    replaces="src/repro/kernels/cholesky.py:54 cholesky_pallas")


def cholesky_fused(a: torch.Tensor) -> torch.Tensor:
    """(B, N, N) SPD float32, contiguous -> L (B, N, N) lower triangular.
    Only the lower triangle of ``a`` is read.  K15 on a CUDA tensor (one
    launch; a lane past shared memory works in L in device memory), its
    plain version on a CPU one."""
    dev = check_f32("cholesky", a)
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"cholesky: expected (B, N, N), got "
                         f"{tuple(a.shape)}")
    if dev.type == "cpu":
        return cholesky_plain(a)
    bsz, n, _ = a.shape
    l = torch.empty_like(a)
    if bsz:
        glob = not _KERNEL.fits_shared(n)
        _KERNEL.launch(dev, (n,), a.data_ptr(), l.data_ptr(), bsz, n,
                       int(glob), work=l if glob else None)
    return l
