"""Batched triangular solve (paper Fig. 2 / Fig. 9 — the Solver kernel),
the primitive the unfused baselines substitute with (K16).

Forward (``lower=True``) or backward substitution with many right-hand
sides.  The divide dataflow (non-critical, one reciprocal per row) feeds
the vectorized AXPY update (critical) — production:consumption rate
n-1-k:1, an inductive ordered dependence (paper Fig. 9's a/b edge).  The
update is masked to rows > k (forward) or rows < k (backward): the RI
stream realized as predication.  Both directions read column k of the
triangle, so only the triangle named by ``lower`` and the diagonal are
ever read.

The kernel (``csrc/trisolve.cu``) has three forms, which agree bit for
bit: a lane on one warp, a row a thread, for n <= 32 and m <= 8 (every
path's shapes); a lane on one CUDA block with the triangle and the
right-hand sides in shared memory otherwise; and, for a lane too large for
shared memory, a block solving in its output y in device memory.
:func:`trisolve_form` picks between the first two.  :func:`trisolve_plain`
follows the reference's ``_trisolve_kernel`` step by step; a CPU tensor
takes it, a CUDA tensor the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import CudaKernel, check_f32


# The warp form's limits (a row a thread of one warp, the right-hand sides
# in its registers); the C entry takes no more.  Set WARP_MAX_N to 0 to run
# the CTA form at every size.
WARP_MAX_N = 32
WARP_MAX_M = 8
# the C entry's ``form`` argument
FORM_CTA, FORM_GLOBAL, FORM_WARP = 0, 1, 2


def trisolve_form(n: int, m: int) -> str:
    """The form of a lane of n rows and m right-hand sides that fits in
    shared memory: ``"warp"`` up to :data:`WARP_MAX_N` rows and
    :data:`WARP_MAX_M` right-hand sides, ``"cta"`` past them.  (A lane
    past shared memory takes the global form whatever this says.)"""
    return "warp" if n <= WARP_MAX_N and m <= WARP_MAX_M else "cta"


def trisolve_plain(l: torch.Tensor, b: torch.Tensor, *,
                   lower: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K16: l (B, N, N) triangular, b (B, N, M)
    -> y (B, N, M) with l @ y = b."""
    n = l.shape[-1]
    rows = torch.arange(n, device=l.device)
    y = b
    for i in range(n):
        k = i if lower else n - 1 - i
        # point region: reciprocal of the pivot, then a multiply
        inv = 1.0 / l[:, k, k]
        yk = y[:, k] * inv[:, None]
        y = y.clone()
        y[:, k] = yk
        # critical region: masked AXPY over the remaining rows
        live = (rows > k) if lower else (rows < k)
        upd = l[:, :, k][:, :, None] * yk[:, None, :]
        y = y - torch.where(live[:, None], upd, 0.0)
    return y


_KERNEL = CudaKernel(
    "trisolve", "trisolve_f32",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5,
    "trisolve_smem", 2,
    source="src/repro_torch/csrc/trisolve.cu",
    replaces="src/repro/kernels/trisolve.py:41 trisolve_pallas")


def trisolve_fused(l: torch.Tensor, b: torch.Tensor, *,
                   lower: bool = True) -> torch.Tensor:
    """l: (B, N, N) lower (``lower=True``) or upper triangular, b:
    (B, N, M) -> y (B, N, M) with l @ y = b; float32, contiguous.  Only
    the named triangle and the diagonal of ``l`` are read.  K16 on a CUDA
    tensor (one launch: a warp a lane as :func:`trisolve_form` says, else a
    block a lane; a lane past shared memory solves in y in device memory),
    its plain version on a CPU one."""
    dev = check_f32("trisolve", l, b)
    if l.dim() != 3 or b.dim() != 3 or l.shape[1] != l.shape[2] \
            or b.shape[:2] != l.shape[:2]:
        raise ValueError(f"trisolve: shapes {tuple(l.shape)}, "
                         f"{tuple(b.shape)}")
    if dev.type == "cpu":
        return trisolve_plain(l, b, lower=lower)
    bsz, n, m = b.shape
    y = torch.empty_like(b)
    if bsz:
        glob = not _KERNEL.fits_shared(n, m)
        form = (FORM_GLOBAL if glob else FORM_WARP
                if trisolve_form(n, m) == "warp" else FORM_CTA)
        _KERNEL.launch(dev, (n, m), l.data_ptr(), b.data_ptr(),
                       y.data_ptr(), bsz, n, m, int(lower), form,
                       work=y if glob else None)
        if form == FORM_WARP:
            _KERNEL.launches_warp += 1
    return y
