"""Batched radix-2 FFT (paper's FFT workload; RR streams per Table 5).

Iterative Cooley-Tukey on separate re/im planes.  The bit-reversal
permutation and the twiddle factors are host-precomputed *stream tables*
(the REVEL analog: the control core issues one stream command per stage;
the pattern state machines do the rest).  The stage loop is an ordered
dependence chain — stage s+1 consumes everything stage s produced — so
it stays inside one kernel (``csrc/fft.cu``, K7).  The kernel holds a row
in the registers of the threads of one warp (:func:`fft_plan`): the
first stages run inside each thread, one exchange through shared memory
regroups the row, and the last stages run inside each thread again.
Past 1024 points a row spans a CTA, and its stages run four at a time
in registers between trips through shared memory.

Twiddle storage is CHUNKED: stage ``s`` only has ``2**s`` distinct
twiddles (w_span^off for off < span/2), so the table packs stage ``s``
at offset ``2**s - 1`` for a total of ``n - 1`` complex entries.
Butterfly partners and per-stage twiddle offsets are recomputed from the
butterfly index with shift/mask arithmetic.  The kernel, the plain
version and the reference read the same float32 table, built in float64
on the host (:func:`fft_tables`), so all three multiply by identical
twiddles, and the kernel rounds each product and sum as the plain
version does: the two agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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
def _host_tables(n: int):
    """:func:`fft_tables`, built once per size."""
    return fft_tables(n)


@functools.lru_cache(maxsize=32)
def _device_tables(n: int, device: torch.device):
    """:func:`fft_tables` as tensors on ``device`` (built once per size
    and device)."""
    return tuple(torch.from_numpy(t).to(device) for t in _host_tables(n))


def _check_size(name: str, n: int) -> None:
    if n < 2 or n & (n - 1):
        raise ValueError(f"{name}: n = {n} is not a power of two >= 2")


# The kernel's plans, its one owner (csrc/fft.cu compiles a template
# instance a size and depth and takes the rest from here).  Up to WARP *
# WARP points a row lies within one warp (the warp route): CTAs of at most
# CTA_THREADS threads (fft.cu's launch bounds); from STAGED_POINTS a warp
# keeps STAGED_DEPTH batches of rows in flight, staged in shared memory by
# cp.async, and below that a thread loads its points straight into
# registers (depth 0: 1.3 % faster at the PUSCH DAG's 64 points, PERF.md).
# Past WARP * WARP points a row spans a CTA of n / WIDE_POINTS threads (the
# wide route), at most 1024 of them, so rows of up to MAX_POINTS.
WARP = 32
CTA_THREADS = 128
STAGED_POINTS = 256
STAGED_DEPTH = 2
WIDE_POINTS = 16
MAX_POINTS = WIDE_POINTS * 1024


class FftPlan(NamedTuple):
    """How K7 lays an ``n``-point row on the card (``csrc/fft.cu``):
    ``threads`` T a row, ``points`` P = n / T a thread, the ``stages``
    each pass runs in registers (between two passes the row goes through
    shared memory), ``rows`` a CTA, the ``depth`` of staged batches a
    warp (0: loaded straight into registers), and ``smem_bytes`` a CTA.
    The warp route (T <= 32): two passes (log2 P, log2 T) and one
    exchange, in row slots of ``n + T`` floats each plane (the staged
    row, then its exchange, padded by a float a P block): ``depth``
    slots a row where staged, one where not, none where a thread holds
    the row.  The wide route: passes of up to four stages, both planes
    of the row in shared memory, ``depth`` 0."""
    n: int
    threads: int
    points: int
    stages: tuple[int, ...]
    rows: int
    depth: int
    smem_bytes: int

    @property
    def wide(self) -> bool:
        return self.threads > WARP


@functools.lru_cache(maxsize=None)
def fft_plan(n: int) -> FftPlan:
    """The plan of an ``n``-point row: T = 2**floor(log2(n) / 2) threads
    of P = n / T points up to WARP * WARP points, n / WIDE_POINTS threads
    of WIDE_POINTS past that.  Refuses rows past :data:`MAX_POINTS`."""
    _check_size("fft", n)
    if n > MAX_POINTS:
        raise ValueError(f"fft: K7 runs rows of at most {MAX_POINTS} "
                         f"points on the card, not {n}")
    log_n = n.bit_length() - 1
    if n <= WARP * WARP:
        t = 1 << (log_n // 2)
        rows = CTA_THREADS // t
        depth = STAGED_DEPTH if n >= STAGED_POINTS else 0
        slots = depth * rows if depth else rows if t > 1 else 0
        return FftPlan(n, t, n // t, (log_n - log_n // 2, log_n // 2),
                       rows, depth, 4 * 2 * slots * (n + t))
    lp = WIDE_POINTS.bit_length() - 1
    stages = tuple(min(lp, log_n - lp * k) for k in range(-(-log_n // lp)))
    return FftPlan(n, n // WIDE_POINTS, WIDE_POINTS, stages, 1, 0, 4 * 2 * n)


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
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8,
    None, 1,
    source="src/repro_torch/csrc/fft.cu",
    replaces="src/repro/kernels/fft.py:90 fft_pallas")


def launch_fft(x_re: torch.Tensor, x_im: torch.Tensor, out_re: int,
               out_im: int, group: int, group_stride: int) -> None:
    """Launch K7 on CUDA rows (R, N), writing output row r at
    ``(r // group) * group_stride + (r % group) * N`` floats from the
    ``out_re`` / ``out_im`` addresses (see ``csrc/fft.cu``)."""
    rows, n = x_re.shape
    plan = fft_plan(n)
    if plan.depth and (x_re.data_ptr() % 16 or x_im.data_ptr() % 16):
        x_re, x_im = x_re.clone(), x_im.clone()   # 16-byte cp.async copies
    _, wr, wi = _device_tables(n, x_re.device)
    _, host_wr, host_wi = _host_tables(n)
    if rows:
        _KERNEL.launch(x_re.device, (plan.smem_bytes,),
                       x_re.data_ptr(), x_im.data_ptr(), wr.data_ptr(),
                       wi.data_ptr(), host_wr.ctypes.data,
                       host_wi.ctypes.data, out_re, out_im, rows, n,
                       plan.threads, plan.rows, plan.depth, plan.smem_bytes,
                       group, group_stride)


def fft_fused(x_re: torch.Tensor, x_im: torch.Tensor):
    """(B, N) re/im float32 planes -> (re, im) of the DFT, N a power of
    two >= 2 (at most :data:`MAX_POINTS` on the card).  K7 on a CUDA
    tensor (one launch, every row's stages in registers, :func:`fft_plan`),
    its plain version on a CPU one."""
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
