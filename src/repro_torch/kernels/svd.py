"""Batched one-sided Jacobi SVD (paper Fig. 6 right).

The pair loop (p, q) with q in [p+1, n) is itself an inductive (RI)
iteration domain — the inner loop's lower bound depends on the outer
iterator, exactly the stream shape REVEL encodes with a stretch
parameter.  The rotation-parameter region (div/sqrt chains) is the
non-critical dataflow; the two-column rotations are the critical vector
region.  The kernel (``csrc/svd.cu``, K8) runs a lane on one warp with A
and V in shared memory, in the reference's cyclic pair order.

Works on (B, M, N) with M >= N; returns U (B,M,N), S (B,N), V (B,N,N)
with A ~= U * S @ V^T (singular values unsorted).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import CudaKernel, check_f32


def _sum_rows(t: torch.Tensor) -> torch.Tensor:
    """Sum a (B, m) tensor over its rows in ascending order (the last
    entry of a running sum), so a lane's answer does not depend on the
    batch it rides in: ``sum`` regroups its terms with the shape."""
    return t.cumsum(dim=-1)[:, -1]


def rotation(alpha: torch.Tensor, beta: torch.Tensor, gamma: torch.Tensor):
    """Jacobi rotation (cs, sn) making two columns with squared norms
    ``alpha``, ``beta`` and inner product ``gamma`` orthogonal; the
    reference's selects in order (``torch.sign`` is 0 at 0, as
    ``jnp.sign``)."""
    small = gamma.abs() <= 1e-12 * torch.sqrt(alpha * beta) + 1e-30
    zeta = (beta - alpha) / (2.0 * torch.where(small, 1.0, gamma))
    t = torch.sign(zeta) / (zeta.abs() + torch.sqrt(1.0 + zeta * zeta))
    t = torch.where(zeta == 0.0, 1.0, t)
    cs = torch.rsqrt(1.0 + t * t)
    sn = cs * t
    return torch.where(small, 1.0, cs), torch.where(small, 0.0, sn)


def svd_plain(a: torch.Tensor, sweeps: int = 12):
    """Plain PyTorch version of K8: (B, M, N) -> U (B,M,N), S (B,N),
    V (B,N,N), the same cyclic pair order, one pair at a time over every
    lane."""
    bsz, m, n = a.shape
    a = a.clone()
    v = torch.eye(n, dtype=a.dtype, device=a.device).repeat(bsz, 1, 1)
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                colp, colq = a[:, :, p], a[:, :, q]
                # ---- non-critical point region: rotation parameters ----
                cs, sn = rotation(_sum_rows(colp * colp),
                                  _sum_rows(colq * colq),
                                  _sum_rows(colp * colq))
                cs, sn = cs[:, None], sn[:, None]
                # ---- critical region: rotate columns of A and V ----
                for mat in (a, v):
                    xp, xq = mat[:, :, p], mat[:, :, q]
                    mat[:, :, p], mat[:, :, q] = (cs * xp - sn * xq,
                                                  sn * xp + cs * xq)
    s = torch.sqrt((a * a).cumsum(dim=1)[:, -1])
    u = a / torch.clamp_min(s, 1e-30)[:, None, :]
    return u, s, v


def spectrum_recon(u: torch.Tensor, s: torch.Tensor, v: torch.Tensor):
    """The view an SVD is held by, its factors being sign/order
    ambiguous: (sorted spectrum (B,N) descending, U diag(S) V^T (B,M,N))."""
    return (torch.sort(s, dim=-1, descending=True).values,
            torch.einsum("bmn,bn,bkn->bmk", u, s, v))


_KERNEL = CudaKernel(
    "svd", "svd_f32",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7,
    "svd_smem", 2,
    source="src/repro_torch/csrc/svd.cu",
    replaces="src/repro/kernels/svd.py:73 svd_pallas")


def launch_svd(a: torch.Tensor, u: int, s: int, v: int, sweeps: int,
               strides: tuple[int, int, int]) -> None:
    """Launch K8 on CUDA lanes a (B, M, N), writing each lane's U, S and
    V at the given addresses and (u, s, v) lane strides in floats (see
    ``csrc/svd.cu``)."""
    bsz, m, n = a.shape
    if bsz:
        _KERNEL.launch(a.device, (m, n), a.data_ptr(), u, s, v, bsz, m, n,
                       sweeps, *strides)


def check_svd_shape(name: str, a: torch.Tensor) -> None:
    if a.dim() != 3 or a.shape[1] < a.shape[2]:
        raise ValueError(f"{name}: expected (B, M, N) with M >= N, got "
                         f"{tuple(a.shape)}")


def svd_fused(a: torch.Tensor, sweeps: int = 12):
    """(B, M, N) float32, M >= N -> U (B,M,N), S (B,N), V (B,N,N), A ~=
    U diag(S) V^T, singular values unsorted.  K8 on a CUDA tensor (one
    launch, a warp per lane), its plain version on a CPU one."""
    dev = check_f32("svd", a)
    check_svd_shape("svd", a)
    if dev.type == "cpu":
        return svd_plain(a, sweeps)
    bsz, m, n = a.shape
    u = torch.empty_like(a)
    s = torch.empty((bsz, n), dtype=a.dtype, device=dev)
    v = torch.empty((bsz, n, n), dtype=a.dtype, device=dev)
    launch_svd(a, u.data_ptr(), s.data_ptr(), v.data_ptr(), sweeps,
               (m * n, n, n * n))
    return u, s, v
