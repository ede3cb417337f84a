"""Chunked SSD/Mamba2 scan, K21 — ordered inter-chunk dependence (FGOP
F1/F2).

The recurrence h_t = a_t h_{t-1} + b_t x_t^T is strictly ordered in t.
The chunked decomposition makes everything inside a chunk parallel work
over a triangular (inductive) decay matrix L_ij = exp(la_i - la_j), j <=
i, and leaves across chunks one small state h (N, P), the ordered
dependence, carried from chunk to chunk.  The cumulative log-decay chain
is the non-critical region; the products C B^T, M x, C h and B^T x are the
critical one.

Layouts (the reference kernel's): x (B, H, S, P), a (B, H, S), b/c
(B, S, N) shared across heads or (B, H, S, N) per head; returns y
(B, H, S, P) and the final state h (B, H, N, P), both in x's dtype, with
every input upcast to float32 inside and the state never rounded between
chunks.  S must divide by the chunk min(chunk, S), as the reference
asserts.

The kernel (``csrc/ssm_scan.cu``) runs one CUDA block per (batch, head,
32 columns of P); the reference's sequential chunk axis is a loop inside
it, with the block's columns of h in registers across chunks.  What
bounds it on the card: the products, in IEEE float32 (the least work sits
on the operations side of the float32 roofline at the model shapes).  The
design keeps the products' shared-memory reads to one every four FMAs (4
columns a thread, register tiles of C B^T), skips M's upper triangle and
compiles the models' chunk sizes (128, 64) in; it still rebuilds M for
each column tile (5 times over at zamba2's P = 160, 13 at xLSTM's 385)
and fits one block on an SM.  The block reads its inputs through
strides, so the (B, S, H, P) layout of ``ops.ssm_scan`` and shared B/C
(head stride 0) need no copy.

:func:`ssm_scan_plain` follows ``_ssm_kernel`` chunk by chunk with the
batch and heads written out; a CPU tensor takes it, a CUDA tensor the
kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import CudaKernel

DTYPES = (torch.float32, torch.bfloat16)
MAX_KERNEL_CHUNK = 128
MAX_KERNEL_STATE = 256


def _chunk(x, a, b, c, chunk: int) -> int:
    """Validate the shapes, dtypes and device as the reference's kernel
    takes them; return the chunk min(chunk, S)."""
    ts = (x, a, b, c)
    for t in ts:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"ssm_scan: expected tensors, got {type(t)}")
        if t.dtype not in DTYPES or t.dtype != x.dtype:
            raise TypeError(f"ssm_scan: expected float32 or bfloat16 "
                            f"tensors of one dtype, got "
                            f"{[t_.dtype for t_ in ts]}")
        if t.device != x.device:
            raise ValueError(f"ssm_scan: tensors on {t.device} and "
                             f"{x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssm_scan: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"ssm_scan: expected x (B, H, S, P), got "
                         f"{tuple(x.shape)}")
    bs, h, s, _ = x.shape
    per_head = (bs, h, s, b.shape[-1])
    shared = (bs, s, b.shape[-1])
    if tuple(a.shape) != (bs, h, s) \
            or tuple(b.shape) not in (per_head, shared) \
            or c.shape != b.shape:
        raise ValueError(f"ssm_scan: x {tuple(x.shape)} wants a (B, H, S) "
                         f"and b/c (B, S, N) or (B, H, S, N), got a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}")
    cs = min(chunk, s)
    if cs < 1 or s % cs:
        raise ValueError(f"ssm_scan: S = {s} must divide by its chunk "
                         f"min({chunk}, S) = {cs}")
    return cs


def ssm_scan_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, *, chunk: int = 128):
    """Plain PyTorch version of K21: x (B, H, S, P), a (B, H, S), b/c
    (B, S, N) or (B, H, S, N) -> (y (B, H, S, P), h (B, H, N, P)) in x's
    dtype, chunk by chunk as ``_ssm_kernel``, in float32 inside."""
    cs = _chunk(x, a, b, c, chunk)
    bs, h, s, p = x.shape
    n = b.shape[-1]
    xf, af = x.float(), a.float()
    bf, cf = b.float(), c.float()
    if b.dim() == 3:                       # shared: one "head" broadcast
        bf, cf = bf[:, None], cf[:, None]
    tri = torch.ones((cs, cs), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((bs, h, n, p), device=x.device)
    y = torch.empty((bs, h, s, p), device=x.device)
    floor = torch.tensor(1e-20, device=x.device)
    for c0 in range(0, s, cs):
        xc = xf[:, :, c0:c0 + cs]                            # (B,H,cs,P)
        bc = bf[:, :, c0:c0 + cs]                            # (B,1|H,cs,N)
        cc = cf[:, :, c0:c0 + cs]
        la = torch.cumsum(torch.log(torch.maximum(af[:, :, c0:c0 + cs],
                                                  floor)), dim=-1)
        g = cc @ bc.transpose(-1, -2)                        # (B,1|H,cs,cs)
        ldec = torch.exp(la[..., :, None] - la[..., None, :])
        m = torch.where(tri, g * ldec, 0.0)
        yc = m @ xc + torch.exp(la)[..., None] * (cc @ state)
        total = la[..., -1:]                                 # (B,H,1)
        bw = bc * torch.exp(total - la)[..., None]           # (B,H,cs,N)
        state = torch.exp(total)[..., None] * state \
            + bw.transpose(-1, -2) @ xc
        y[:, :, c0:c0 + cs] = yc
    return y.to(x.dtype), state.to(x.dtype)


_KERNEL = CudaKernel(
    "ssm_scan", "ssm_scan_run",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 15
    + [ctypes.c_int],
    "ssm_scan_smem", 2,
    source="src/repro_torch/csrc/ssm_scan.cu",
    replaces="src/repro/kernels/ssm_scan.py:75 ssm_scan_pallas")


def kernel_fits(cs: int, n: int) -> bool:
    """Whether the kernel launches at chunk ``cs`` and state width ``n``:
    cs <= 128, 1 <= n <= 256 and its block's shared memory (x tile, h,
    C^T, B^T and M, about (20736 + 290 n) floats at cs = 128) within
    :data:`~repro_torch.kernels.common.MAX_SMEM_BYTES`, so N <= 128 at
    cs = 128 and N <= 256 at cs <= 64.  Asks the built kernel."""
    return (1 <= cs <= MAX_KERNEL_CHUNK and 1 <= n <= MAX_KERNEL_STATE
            and _KERNEL.fits_shared(cs, n))


def ssm_scan_fused(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, *, chunk: int = 128):
    """x (B, H, S, P), a (B, H, S), b/c (B, S, N) shared or (B, H, S, N)
    per head, all float32 or all bfloat16 on one device -> (y (B, H, S,
    P), h (B, H, N, P)) in x's dtype; S must divide by min(chunk, S).
    K21 on a CUDA tensor (one launch; chunk <= 128, 1 <= N <= 256, and
    the block's shared memory within 227 KB: N <= 128 at chunk 128, <= 256
    at chunk 64; see :func:`kernel_fits`), its plain version on a CPU
    one.  Views are taken as they are (their last axis
    is made contiguous where it is not); y has x's layout."""
    cs = _chunk(x, a, b, c, chunk)
    if x.device.type == "cpu":
        return ssm_scan_plain(x, a, b, c, chunk=chunk)
    bs, h, s, p = x.shape
    n = b.shape[-1]
    if not kernel_fits(cs, n):
        raise ValueError(f"ssm_scan: the kernel takes chunk <= "
                         f"{MAX_KERNEL_CHUNK} and 1 <= N <= "
                         f"{MAX_KERNEL_STATE} with its block within "
                         f"227 KB of shared memory (N <= 128 at chunk "
                         f"128), got chunk {cs}, N {n}")
    x, b, c = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, b, c))
    y = torch.empty_like(x)
    hf = torch.empty((bs, h, n, p), dtype=x.dtype, device=x.device)
    if not x.numel():
        return y, hf.zero_()

    def bc_strides(t):
        if t.dim() == 3:                       # shared across heads
            return t.stride(0), 0, t.stride(1)
        return t.stride(0), t.stride(1), t.stride(2)

    _KERNEL.launch(x.device, (cs, n), x.data_ptr(), a.data_ptr(),
                   b.data_ptr(), c.data_ptr(), y.data_ptr(), hf.data_ptr(),
                   bs, h, s, p, n, cs, *x.stride()[:3], *a.stride(),
                   *bc_strides(b), *bc_strides(c), *y.stride()[:3],
                   int(x.dtype == torch.bfloat16))
    return y, hf
