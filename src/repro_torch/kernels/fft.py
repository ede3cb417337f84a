"""Batched radix-2 FFT (paper's FFT workload; RR streams per Table 5).

Iterative Cooley-Tukey on separate re/im planes.  The bit-reversal
permutation and the twiddle factors are host-precomputed *stream tables*
(the REVEL analog: the control core issues one stream command per stage;
the pattern state machines do the rest).  The stage loop is an ordered
dependence chain — stage s+1 consumes everything stage s produced — so
it stays inside one kernel (``csrc/fft.cu``, K7) with the row in shared
memory throughout.

Twiddle storage is CHUNKED: stage ``s`` only has ``2**s`` distinct
twiddles (w_span^off for off < span/2), so the table packs stage ``s``
at offset ``2**s - 1`` for a total of ``n - 1`` complex entries.
Butterfly partners and per-stage twiddle offsets are recomputed from the
butterfly index with shift/mask arithmetic.  The kernel, the plain
version and the reference read the same float32 table, built in float64
on the host (:func:`fft_tables`), so all three multiply by identical
twiddles.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels.common import CudaKernel, check_f32


def fft_tables(n: int):
    """Host-side stream tables: bit-reversal permutation and the CHUNKED
    twiddle table (re, im) — stage ``s`` occupies slots
    ``[2**s - 1, 2**(s+1) - 1)``, ``n - 1`` entries total."""
    stages = int(np.log2(n))
    assert 2 ** stages == n, "n must be a power of two"
    rev = np.zeros(n, np.int32)
    bits = stages
    for i in range(n):
        rev[i] = int(format(i, f"0{bits}b")[::-1], 2) if bits else 0
    w_re = np.zeros(max(n - 1, 1), np.float32)
    w_im = np.zeros(max(n - 1, 1), np.float32)
    for s in range(stages):
        half = 1 << s
        span = half << 1
        base = half - 1                  # sum_{t<s} 2**t
        for off in range(half):
            ang = -2.0 * np.pi * off / span
            w_re[base + off] = np.cos(ang)
            w_im[base + off] = np.sin(ang)
    return rev, w_re, w_im


@functools.lru_cache(maxsize=32)
def _device_tables(n: int, device: torch.device):
    """:func:`fft_tables` as tensors on ``device`` (built once per size
    and device)."""
    return tuple(torch.from_numpy(t).to(device) for t in fft_tables(n))


def _check_size(name: str, n: int) -> None:
    if n < 2 or n & (n - 1):
        raise ValueError(f"{name}: n = {n} is not a power of two >= 2")


def fft_plain(x_re: torch.Tensor, x_im: torch.Tensor):
    """Plain PyTorch version of K7: (B, N) re/im -> (re, im), the
    kernel's stages as batched gathers and scatters."""
    n = x_re.shape[-1]
    _check_size("fft", n)
    rev, wr, wi = _device_tables(n, x_re.device)
    rev = rev.long()
    xr, xi = x_re[:, rev], x_im[:, rev]
    b_idx = torch.arange(n // 2, device=x_re.device)
    for s in range(int(np.log2(n))):
        half = 1 << s
        off = b_idx & (half - 1)
        # butterfly partners: i = (b >> s) << (s+1) | off, j = i + half
        ii = ((b_idx >> s) << (s + 1)) + off
        jj = ii + half
        # chunked twiddle gather: stage s lives at offset 2**s - 1
        w_r, w_i = wr[(half - 1) + off], wi[(half - 1) + off]
        ur, ui = xr[:, ii], xi[:, ii]
        vr, vi = xr[:, jj], xi[:, jj]
        # twiddle multiply (critical vector region)
        tr = w_r * vr - w_i * vi
        ti = w_r * vi + w_i * vr
        nr, ni = torch.empty_like(xr), torch.empty_like(xi)
        nr[:, ii], nr[:, jj] = ur + tr, ur - tr
        ni[:, ii], ni[:, jj] = ui + ti, ui - ti
        xr, xi = nr, ni
    return xr, xi


_KERNEL = CudaKernel(
    "fft", "fft_f32",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4,
    "fft_smem", 1,
    source="src/repro_torch/csrc/fft.cu",
    replaces="src/repro/kernels/fft.py:90 fft_pallas")


def launch_fft(x_re: torch.Tensor, x_im: torch.Tensor, out_re: int,
               out_im: int, group: int, group_stride: int) -> None:
    """Launch K7 on CUDA rows (R, N), writing output row r at
    ``(r // group) * group_stride + (r % group) * N`` floats from the
    ``out_re`` / ``out_im`` addresses (see ``csrc/fft.cu``)."""
    rows, n = x_re.shape
    _check_size("fft", n)
    rev, wr, wi = _device_tables(n, x_re.device)
    if rows:
        _KERNEL.launch(x_re.device, (n,), x_re.data_ptr(), x_im.data_ptr(),
                       rev.data_ptr(), wr.data_ptr(), wi.data_ptr(), out_re,
                       out_im, rows, n, group, group_stride)


def fft_fused(x_re: torch.Tensor, x_im: torch.Tensor):
    """(B, N) re/im float32 planes -> (re, im) of the DFT, N a power of
    two >= 2.  K7 on a CUDA tensor (one launch, every row's stages in
    shared memory), its plain version on a CPU one."""
    dev = check_f32("fft", x_re, x_im)
    if x_re.dim() != 2 or x_im.shape != x_re.shape:
        raise ValueError(f"fft: shapes {tuple(x_re.shape)}, "
                         f"{tuple(x_im.shape)}")
    if dev.type == "cpu":
        return fft_plain(x_re, x_im)
    rows, n = x_re.shape
    out_re, out_im = torch.empty_like(x_re), torch.empty_like(x_im)
    launch_fft(x_re, x_im, out_re.data_ptr(), out_im.data_ptr(),
               max(rows, 1), 0)
    return out_re, out_im
