"""Fused least squares: Householder QR + implicit Q^T b + back
substitution in one kernel launch (paper Fig. 6 chained with Fig. 9).

The fusion is structural, not just spatial: Q is never formed.  Each
reflector (v, tau) — the non-critical point/vector region — is applied to
the trailing columns of R *and* to the right-hand sides in the same outer
iteration (two critical regions sharing one produced value: the paper's
inductive-consumption ``tau`` edge).  After min(m-1, n) reflections the
rhs holds Q^T b, and the back substitution on the n x n upper triangle
of R runs in the same lane, everything in shared memory
(``csrc/qr_solve.cu``, K4), or in a device work buffer for a lane too
large for it, by panels as :func:`qr_panel_plan` says
(``csrc/qr_panels.cuh``).

Pivot guard: a degenerate (zero-norm) column takes tau = 0 (identity
reflector) and the back substitution zeroes a component whose pivot is
below a relative threshold, so rank-deficient systems stay finite.

The plain PyTorch version (:func:`qr_solve_plain`, built from
:func:`reflect_step` and :func:`back_substitute_r`) follows the
reference's per-lane op order; a CPU tensor takes it, a CUDA tensor the
kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import common
from repro_torch.kernels.common import (CudaKernel, check_f32, data_ptr,
                                        resolve_device)
from repro_torch.kernels.qr import qr_fused
from repro_torch.kernels.trisolve import trisolve_fused
from repro_torch.pipelines.cholesky_solve import (PANEL_SMEM_BYTES, _align4,
                                                  block_size, tiled_admit)

DEFAULT_TINY = 1e-20


def _sum_rows(t: torch.Tensor) -> torch.Tensor:
    """Sum a (B, m, ...) tensor over its row axis in ascending row order
    (the last entry of a running sum, which the CPU accumulates row by
    row), so zero rows appended below a lane — a coalesced embedding —
    leave the sum bit-identical.  ``sum`` and matmul regroup their terms
    with the length and the batch."""
    return t.cumsum(dim=1)[:, -1]


def reflect_step(k: int, r: torch.Tensor, y: torch.Tensor,
                 rows: torch.Tensor, *, tiny: float = DEFAULT_TINY):
    """One fused outer iteration over every lane: build reflector k,
    apply it to R (B, m, n) and the rhs (B, m, k)."""
    # ---- householder region (non-critical: norm, sqrt, div) ----
    x = torch.where(rows >= k, r[:, :, k], 0.0)       # masked column (F4)
    xk = r[:, k, k]
    norm = torch.sqrt(_sum_rows(x * x))
    alpha = torch.where(xk >= 0, -norm, norm)
    v = x - alpha[:, None] * (rows == k).to(r.dtype)
    vnorm2 = torch.clamp_min(_sum_rows(v * v), tiny)
    tau = torch.where(norm < tiny, 0.0, 2.0 / vnorm2)  # degenerate: skip
    # ---- critical region 1: R update (v^T R then rank-1) ----
    w = tau[:, None] * _sum_rows(v[:, :, None] * r)
    r = r - v[:, :, None] * w[:, None, :]
    # ---- critical region 2 (fused solve): rhs <- (I - tau v v^T) rhs ----
    wy = tau[:, None] * _sum_rows(v[:, :, None] * y)
    y = y - v[:, :, None] * wy[:, None, :]
    return r, y


def back_substitute_r(r: torch.Tensor, y: torch.Tensor, *, n: int,
                      tiny: float,
                      thresh: torch.Tensor | None = None) -> torch.Tensor:
    """Back substitution on R[:n,:n] x = (Q^T b)[:n] for every lane.

    Uses a relative deficiency threshold from R's diagonal: a pivot
    below it marks a numerically dependent column, whose solution
    component is ZEROED (clamping the divisor instead would overflow
    float32: with R = [[0,1],[0,0]] a clamped 1/tiny cascades to inf
    through the remaining rows).  ``thresh`` (B,) overrides the local
    threshold — the tiled solve takes one (bs, bs) diagonal block at a
    time against the GLOBAL threshold of the whole R.
    """
    rows_n = torch.arange(n, device=r.device)
    z = y[:, :n]
    if thresh is None:
        eye = rows_n[:, None] == rows_n[None, :]
        diag = torch.abs(torch.where(eye, r[:, :n], 0.0).sum(dim=-1))
        thresh = torch.clamp_min(1e-6 * diag.amax(dim=-1), tiny)
    for i in range(n):
        k = n - 1 - i
        rkk = r[:, k, k]
        ok = torch.abs(rkk) > thresh
        xk = torch.where(ok[:, None],
                         z[:, k] / torch.where(ok, rkk, 1.0)[:, None], 0.0)
        z = z.clone()
        z[:, k] = xk
        col = torch.where(rows_n < k, r[:, :n, k], 0.0)
        z = z - col[:, :, None] * xk[:, None, :]
    return z


def qr_solve_plain(a: torch.Tensor, b: torch.Tensor, *,
                   tiny: float = DEFAULT_TINY) -> torch.Tensor:
    """Plain PyTorch version of K4: a (B,M,N), b (B,M,K) -> x (B,N,K)."""
    m, n = a.shape[-2:]
    rows = torch.arange(m, device=a.device)
    nref = min(n, m - 1) if m > 1 else 0
    r, y = a, b
    for k in range(nref):
        r, y = reflect_step(k, r, y, rows, tiny=tiny)
    return back_substitute_r(r, y, n=n, tiny=tiny)


# ---------------------------------------------------------------------------
# K4's global form: the Householder chain by panels (csrc/qr_panels.cuh)
# ---------------------------------------------------------------------------

QR_PANEL_WIDTH = 32          # the widest panel a plan picks (the C entry
                             # takes 1 to 32)
QR_TILE_WIDTH = 64           # the widest tile of columns right of a panel,
                             # a thread a column (the C entry takes 1 to 128)


class QrPanelPlan(NamedTuple):
    """How the global form of K4 runs the chain on an m x n lane with k
    right-hand sides: ``threads`` a CTA (one a tile column, a warp at
    least), panels of ``bs`` columns, tiles of ``tile`` columns, and
    ``smem_bytes`` of dynamic shared memory a CTA."""
    threads: int
    bs: int
    tile: int
    smem_bytes: int


def qr_panel_smem(m: int, k: int, bs: int, tile: int) -> int:
    """Shared memory of the panel chain: one region for the panel (m x
    (bs + 1) floats), a tile (m x tile) or back substitution's block of
    R, V (m x (bs + 1)), y's block rows (bs x k), tau and the panel's w
    (bs each) and the threshold (``qr_panel_smem_bytes`` in
    ``csrc/qr_panels.cuh``)."""
    return 4 * (m * (bs + 1) + m * max(bs + 1, tile) + bs * k + 2 * bs + 1)


def qr_panel_plan(m: int, n: int, k: int) -> QrPanelPlan:
    """The one plan of K4's global form at (m, n, k): panels of
    :data:`QR_PANEL_WIDTH` columns and tiles of :data:`QR_TILE_WIDTH`,
    both halved together until a lane fits the card's
    :data:`PANEL_SMEM_BYTES` (the budget is the card's own, never
    ``common.MAX_SMEM_BYTES``, which picks the form), down to one column
    each: the per-column chain.  Neither width
    changes a result.  At 254 x 250 a lane takes 32 and 64 (two lanes
    share an SM), at 1028 x 1024 16 and 32.  Raises where even that does
    not fit: past m = 14,500 or so, beyond every lane whose global form
    took 48 KB or less before the chain ran by panels."""
    if not (1 <= n <= m and k >= 1):
        raise ValueError(f"qr_panel_plan: m = {m}, n = {n}, k = {k}")
    bs, tile = QR_PANEL_WIDTH, QR_TILE_WIDTH
    while (qr_panel_smem(m, k, bs, tile) > PANEL_SMEM_BYTES
           and (bs, tile) != (1, 1)):
        bs, tile = max(bs // 2, 1), max(tile // 2, 1)
    smem = qr_panel_smem(m, k, bs, tile)
    if smem > PANEL_SMEM_BYTES:
        raise ValueError(f"qr_panel_plan: m = {m}, k = {k} at one-column "
                         f"panels and tiles needs {smem} bytes of shared "
                         f"memory, past the card's {PANEL_SMEM_BYTES}")
    return QrPanelPlan(max(32, tile), bs, tile, smem)


def qr_plan_args(work: torch.Tensor | None, m: int, n: int,
                 k: int) -> tuple:
    """The plan arguments of a K4 launch: the chain's plan at (m, n, k)
    for the global form (``work`` given), zeros for the shared form,
    which ignores them."""
    return tuple(qr_panel_plan(m, n, k)) if work is not None else (0,) * 4


_KERNEL = CudaKernel(
    "qr_solve", "qr_solve_f32",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float]
    + [ctypes.c_int] * 4,
    "qr_solve_smem", 3,
    source="src/repro_torch/csrc/qr_solve.cu",
    replaces="src/repro/pipelines/qr_solve.py:100 qr_solve_pallas",
    work_symbol="qr_solve_work")


def qr_solve_fused(a: torch.Tensor, b: torch.Tensor, *,
                   tiny: float = DEFAULT_TINY) -> torch.Tensor:
    """Least squares min ||a @ x - b||. a: (B,M,N) with M >= N,
    b: (B,M,K) -> x: (B,N,K); float32, contiguous.  K4 on a CUDA tensor
    (one launch, Q never formed; a lane past shared memory in a device
    work buffer, by panels as :func:`qr_panel_plan` says), its plain
    version on a CPU one."""
    dev = check_f32("qr_solve", a, b)
    bsz, m, n = a.shape
    b2, m2, k = b.shape
    if not (m == m2 and bsz == b2 and m >= n):
        raise ValueError(f"qr_solve: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if dev.type == "cpu":
        return qr_solve_plain(a, b, tiny=tiny)
    x = torch.empty((bsz, n, k), dtype=torch.float32, device=dev)
    if bsz:
        work = _KERNEL.work_buffer(dev, bsz, m, n, k)
        _KERNEL.launch(dev, (m, n, k), a.data_ptr(), b.data_ptr(),
                       x.data_ptr(), data_ptr(work), bsz, m, n, k, tiny,
                       *qr_plan_args(work, m, n, k), work=work)
    return x


def qr_solve(a, b, *, device=None) -> torch.Tensor:
    """Public wrapper: a (B,M,N), b (B,M,K) float32 arrays or tensors,
    solved on ``device`` (default ``cuda``; ``"cpu"`` runs the plain
    version)."""
    dev = resolve_device(device)
    return qr_solve_fused(torch.as_tensor(a, device=dev).contiguous(),
                          torch.as_tensor(b, device=dev).contiguous())


def qr_solve_unfused(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """No-fusion baseline: the explicit Q and R of K17, a library product
    for Q^T b (outside any kernel, as in the reference), and K16's back
    substitution on the materialised R[:n, :n] — Q, R and Q^T b
    round-trip through device memory.  a (B,M,N), b (B,M,K) float32
    tensors (the plain versions on CPU tensors)."""
    q, r = qr_fused(a)
    n = a.shape[-1]
    qtb = torch.einsum("bmk,bmj->bkj", q, b)[:, :n]
    return trisolve_fused(r[:, :n, :n].contiguous(), qtb.contiguous(),
                          lower=False)


# ---------------------------------------------------------------------------
# K11: blocked (compact-WY) least squares (the mid-range large-n variant)
# ---------------------------------------------------------------------------

def qr_panel_reflect_step(j: int, pan: torch.Tensor, v_acc: torch.Tensor,
                          tau_acc: torch.Tensor, *, o: int,
                          rows: torch.Tensor, tiny: float):
    """Reflector ``g = o + j`` over every lane, built from and applied to
    the panel (B, m, bs) only; (v, tau) accumulated into v_acc (B, m, bs)
    and tau_acc (B, bs) for the compact-WY block apply."""
    g = o + j
    x = torch.where(rows >= g, pan[:, :, j], 0.0)     # masked column (F4)
    xk = x[:, g]
    norm = torch.sqrt(_sum_rows(x * x))
    alpha = torch.where(xk >= 0, -norm, norm)
    v = x - alpha[:, None] * (rows == g).to(pan.dtype)
    vnorm2 = torch.clamp_min(_sum_rows(v * v), tiny)
    tau = torch.where(norm < tiny, 0.0, 2.0 / vnorm2)  # degenerate: skip
    w = tau[:, None] * _sum_rows(v[:, :, None] * pan)
    pan = pan - v[:, :, None] * w[:, None, :]
    v_acc = v_acc.clone()
    v_acc[:, :, j] = v
    tau_acc = tau_acc.clone()
    tau_acc[:, j] = tau
    return pan, v_acc, tau_acc


def wy_t(vt_v: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """The compact-WY ``T`` (B, bs, bs) of one panel (LAPACK larft,
    forward columnwise): T[:j, j] = -tau_j T[:j, :j] (V^T v_j)[:j],
    T[j, j] = tau_j."""
    bsz, bs = taus.shape
    cols = torch.arange(bs, device=taus.device)
    t = torch.zeros((bsz, bs, bs), dtype=taus.dtype, device=taus.device)
    for j in range(bs):
        z = torch.where(cols < j, vt_v[:, :, j], 0.0)
        tau_j = taus[:, j]
        tcol = -tau_j[:, None] * (t @ z[:, :, None])[:, :, 0]
        tcol = torch.where(cols < j, tcol, 0.0)
        tcol = tcol + tau_j[:, None] * (cols == j).to(t.dtype)
        t = t.clone()
        t[:, :, j] = tcol
    return t


def qr_solve_blocked_plain(a: torch.Tensor, b: torch.Tensor, *,
                           bs: int | None = None,
                           tiny: float = DEFAULT_TINY) -> torch.Tensor:
    """Plain PyTorch version of K11: a (B,M,N), b (B,M,K) -> x (B,N,K) by
    the reference's compact-WY algorithm — per panel, ``bs`` reflectors
    on the panel only, T from V^T V, and the block reflector
    I - V T^T V^T on the trailing columns and the whole rhs."""
    m, n = a.shape[-2:]
    bs = block_size(n, bs)
    rows = torch.arange(m, device=a.device)
    cols_n = torch.arange(n, device=a.device)
    bsz = a.shape[0]
    r, y = a, b
    for o in range(0, n, bs):
        # ---- panel factor: bs reflectors applied panel-locally ----
        pan = r[:, :, o:o + bs]
        v = torch.zeros((bsz, m, bs), dtype=a.dtype, device=a.device)
        taus = torch.zeros((bsz, bs), dtype=a.dtype, device=a.device)
        for j in range(bs):
            pan, v, taus = qr_panel_reflect_step(j, pan, v, taus, o=o,
                                                 rows=rows, tiny=tiny)
        r = torch.cat([r[:, :, :o], pan, r[:, :, o + bs:]], dim=-1)
        # ---- T build: one V^T V gram + bs short column steps ----
        vt = v.transpose(-1, -2)
        t = wy_t(vt @ v, taus)
        tt = t.transpose(-1, -2)
        # ---- block apply Q_p^T = I - V T^T V^T ----
        upd = v @ (tt @ (vt @ r))
        r = r - torch.where(cols_n >= o + bs, upd, 0.0)
        y = y - v @ (tt @ (vt @ y))
    return back_substitute_r(r, y, n=n, tiny=tiny)


_BLOCKED = CudaKernel(
    "qr_solve_blocked", "qr_solve_blocked_f32",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float]
    + [ctypes.c_int] * 3,
    None, 1,
    source="src/repro_torch/csrc/qr_solve_blocked.cu",
    replaces="src/repro/pipelines/qr_solve.py:203 qr_solve_blocked",
)


def qr_solve_blocked_fused(a: torch.Tensor, b: torch.Tensor, *,
                           bs: int | None = None,
                           tiny: float = DEFAULT_TINY,
                           plan: QrClusterPlan | None = None) -> torch.Tensor:
    """Blocked (compact-WY) least squares — the mid-range large-n path
    (the registry's ``blocked`` variant, n >= 128 with n % 32 == 0).
    Same contract as :func:`qr_solve_fused`; panels of ``bs`` columns
    (default: 64 when it divides N, else 32).  K11 on a CUDA tensor (one
    cluster launch as :func:`qr_cluster_plan` says, or as ``plan``, one
    of :func:`qr_cluster_forms`, says), its plain version on a CPU
    one."""
    dev = check_f32("qr_solve_blocked", a, b)
    bsz, m, n = a.shape
    b2, m2, k = b.shape
    if not (m == m2 and bsz == b2 and m >= n):
        raise ValueError(f"qr_solve_blocked: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    bs = block_size(n, bs)
    if dev.type == "cpu":
        return qr_solve_blocked_plain(a, b, bs=bs, tiny=tiny)
    if not qr_solve_blocked_fits(m, n, k, bs):
        raise ValueError(f"qr_solve_blocked: {m} x {n}, k = {k}, bs = {bs} "
                         f"is past the blocked rung's shared memory "
                         f"(qr_solve_blocked_fits); the tiled K13 serves it")
    x = torch.empty((bsz, n, k), dtype=torch.float32, device=dev)
    if bsz:
        _cluster_launch(_BLOCKED, a, b, x, bs, tiny, plan)
    return x


def qr_solve_blocked_fits(m: int, n: int, k: int,
                          bs: int | None = None) -> bool:
    """Whether the blocked rung takes per-lane shapes (m, n), (m, k): the
    rule of the one-CTA K11 the cluster form replaced, whose panel of m
    (bs + 1) floats, T, V^T V and the rhs had to fit one CTA's shared
    memory — up to m = 752 at bs = 64, k = 1 (the tiled K13 serves larger
    n).  The dispatcher's choices follow it; the cluster form takes every
    shape it admits (:func:`qr_cluster_plan`)."""
    bs = block_size(n, bs)
    pc = bs + 1
    floats = m * pc + 3 * bs + bs * pc + 64 * bs + m * k + k + 1
    return 4 * floats <= common.MAX_SMEM_BYTES


def qr_solve_blocked(a, b, *, bs: int | None = None,
                     device=None) -> torch.Tensor:
    """Public wrapper of the blocked least squares (see
    :func:`qr_solve`)."""
    dev = resolve_device(device)
    return qr_solve_blocked_fused(
        torch.as_tensor(a, device=dev).contiguous(),
        torch.as_tensor(b, device=dev).contiguous(), bs=bs)


# ---------------------------------------------------------------------------
# K13: slab-streamed compact-WY least squares (the HBM-scale variant)
# ---------------------------------------------------------------------------

def qr_tiled_vmem_floats(m: int, n: int, bs: int, k: int) -> int:
    """The reference's per-cell working set of the tiled least squares,
    in float32 elements: slab (m, bs) + panel carry (2, m, bs) + V
    (m, bs) + T (bs, bs) + rhs carry and b block (m, k) each + x block
    (n, k)."""
    return 4 * m * bs + bs * bs + 2 * m * k + n * k


def qr_solve_tiled_plain(a: torch.Tensor, b: torch.Tensor, *,
                         bs: int | None = None,
                         tiny: float = DEFAULT_TINY) -> torch.Tensor:
    """Plain PyTorch version of K13: a (B,M,N), b (B,M,K) -> x (B,N,K) by
    the reference's tiled algorithm — per panel, ``bs`` reflectors on the
    panel slab, T from V^T V, the block reflector on the rhs and on every
    slab to the right, max |diag R| folded into a running maximum; then
    each slab in reverse solves its (bs, bs) diagonal block against the
    GLOBAL threshold max(1e-6 max |diag R|, tiny) and pushes its
    components to the rows above."""
    bsz, m, n = a.shape
    k = b.shape[-1]
    bs = tiled_admit("qr_solve_tiled", n, bs,
                     lambda w: qr_tiled_vmem_floats(m, n, w, k))
    rows = torch.arange(m, device=a.device)
    cols_bs = torch.arange(bs, device=a.device)
    eye = cols_bs[:, None] == cols_bs[None, :]
    steps = n // bs
    slabs = [a[:, :, o:o + bs] for o in range(0, n, bs)]
    y = b
    dmax = torch.zeros(bsz, dtype=a.dtype, device=a.device)
    for s in range(steps):
        o = s * bs
        pan = slabs[s]
        v = torch.zeros((bsz, m, bs), dtype=a.dtype, device=a.device)
        taus = torch.zeros((bsz, bs), dtype=a.dtype, device=a.device)
        for j in range(bs):
            pan, v, taus = qr_panel_reflect_step(j, pan, v, taus, o=o,
                                                 rows=rows, tiny=tiny)
        vt = v.transpose(-1, -2)
        tt = wy_t(vt @ v, taus).transpose(-1, -2)
        y = y - v @ (tt @ (vt @ y))
        d = torch.abs(torch.where(eye, pan[:, o:o + bs], 0.0))
        dmax = torch.maximum(dmax, d.amax(dim=(-2, -1)))
        slabs[s] = pan
        for t in range(s + 1, steps):
            slabs[t] = slabs[t] - v @ (tt @ (vt @ slabs[t]))
    thresh = torch.clamp_min(1e-6 * dmax, tiny)
    z = y
    for t in range(steps):
        rt = steps - 1 - t
        o = rt * bs
        slab = slabs[rt]
        xt = back_substitute_r(slab[:, o:o + bs], z[:, o:o + bs], n=bs,
                               tiny=tiny, thresh=thresh)
        z = torch.cat([z[:, :o], xt, z[:, o + bs:]], dim=1)
        above = torch.where(rows[:, None] < o, slab, 0.0)
        z = z - above @ xt
    return z[:, :n]


_TILED = CudaKernel(
    "qr_solve_tiled", "qr_solve_tiled_f32",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float]
    + [ctypes.c_int] * 3,
    None, 1,
    source="src/repro_torch/csrc/qr_solve_tiled.cu",
    replaces="src/repro/pipelines/qr_solve.py:376 qr_solve_tiled",
)


def qr_solve_tiled_fused(a: torch.Tensor, b: torch.Tensor, *,
                         bs: int | None = None,
                         tiny: float = DEFAULT_TINY,
                         plan: QrClusterPlan | None = None) -> torch.Tensor:
    """Slab-streamed compact-WY least squares — the HBM-scale path (the
    registry's ``tiled`` variant, n >= 512 with n % 32 == 0).  Same
    contract as :func:`qr_solve_fused`; slabs of ``bs`` columns (default
    ``tiled_block_size``), refused with ValueError where the reference
    asserts.  K13 on a CUDA tensor (one cluster launch as
    :func:`qr_cluster_plan` says, or as ``plan``, one of
    :func:`qr_cluster_forms`, says), its plain version on a CPU one."""
    bsz, m, n = a.shape
    b2, m2, k = b.shape
    if not (m == m2 and bsz == b2 and m >= n):
        raise ValueError(f"qr_solve_tiled: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    bs = tiled_admit("qr_solve_tiled", n, bs,
                     lambda w: qr_tiled_vmem_floats(m, n, w, k))
    dev = check_f32("qr_solve_tiled", a, b)
    if dev.type == "cpu":
        return qr_solve_tiled_plain(a, b, bs=bs, tiny=tiny)
    x = torch.empty((bsz, n, k), dtype=torch.float32, device=dev)
    if bsz:
        _cluster_launch(_TILED, a, b, x, bs, tiny, plan)
    return x


def qr_solve_tiled(a, b, *, bs: int | None = None,
                   device=None) -> torch.Tensor:
    """Public wrapper of the tiled least squares (see :func:`qr_solve`)."""
    dev = resolve_device(device)
    return qr_solve_tiled_fused(
        torch.as_tensor(a, device=dev).contiguous(),
        torch.as_tensor(b, device=dev).contiguous(), bs=bs)


# ---------------------------------------------------------------------------
# K11 and K13 on a thread-block cluster (csrc/qr_cluster.cuh)
# ---------------------------------------------------------------------------

QR_CLUSTER_SIZES = (1, 2, 4, 8)   # CTAs a lane (portable cluster sizes)
QR_CLUSTER_THREADS = 256          # a CTA (the staged product tile's block)
QR_CLUSTER_COLS = 64              # columns of a block dealt to a CTA
QR_GROUP_MAX = 64                 # row groups of a panel, at most
QR_CLUSTER_MAX_PANEL = QR_CLUSTER_THREADS   # a thread a panel column
# Dynamic shared memory a CTA may take: the card's 227 KB less 2 KB for
# the kernel's static pointer tables (1,224 bytes).
QR_CLUSTER_SMEM_BYTES = PANEL_SMEM_BYTES - 2048
_TILE_SMEM_FLOATS = 2 * 32 * 68   # tile_loops.cuh kTileSmemFloats


class QrClusterPlan(NamedTuple):
    """How K11 and K13 run a lane: on a cluster of ``clusters`` CTAs of
    ``threads`` threads and ``smem_bytes`` of dynamic shared memory each,
    R and y in the lane's device work buffer, the panel's row bands in
    the CTAs' shared memory (``panel_shared``) or in the work buffer."""
    clusters: int
    threads: int
    smem_bytes: int
    panel_shared: bool


def qr_group_rows(m: int) -> int:
    """Rows of a panel's row group: 32, or the multiple of 32 that keeps a
    panel's groups at most :data:`QR_GROUP_MAX` (``qc_group_rows``).  A
    function of m alone: the groups fix every sum's order."""
    return 32 * -(-(-(-m // 32)) // QR_GROUP_MAX)


def _band_rows(m: int, c: int) -> int:
    """Words of a band column (``qc_band_rows``): a rank's rows of the
    tallest panel, plus one."""
    return _rank_groups(m, c) * qr_group_rows(m) + 1


def _rank_groups(m: int, c: int) -> int:
    return -(-(-(-m // qr_group_rows(m))) // c)


def qr_cluster_smem(m: int, bs: int, c: int, panel_shared: bool) -> int:
    """Dynamic shared memory of a CTA (``qc_layout`` in
    ``csrc/qr_cluster.cuh``): the product tiles' staging, T (bs (bs + 1)),
    W (bs x 64), v's heads, tau, a reflector's sums and head row (bs
    each), two exchange buffers of (groups + 1) x bs, and the panel's band
    (groups x G rows of bs + 2 columns) where ``panel_shared``."""
    floats = (_TILE_SMEM_FLOATS + bs * (bs + 1) + bs * QR_CLUSTER_COLS
              + 4 * bs + 2 * (_rank_groups(m, c) + 1) * bs)
    if panel_shared:
        floats += (bs + 2) * _band_rows(m, c)
    return 4 * floats


def qr_cluster_work(m: int, n: int, k: int, bs: int,
                    plan: QrClusterPlan) -> int:
    """Floats of a lane's device work buffer (``qc_work_floats``): [R | y],
    then the row bands unless they are in shared memory."""
    floats = _align4(m * (n + k))
    if not plan.panel_shared:
        floats += plan.clusters * (bs + 2) * _band_rows(m, plan.clusters)
    return _align4(floats)


def _check_shape(m: int, n: int, k: int, bs: int) -> None:
    if not (1 <= bs <= QR_CLUSTER_MAX_PANEL and n % bs == 0 and 1 <= n <= m
            and k >= 1):
        raise ValueError(f"qr_cluster_plan: m = {m}, n = {n}, k = {k}, "
                         f"bs = {bs}")


def qr_cluster_forms(m: int, n: int, k: int, bs: int) -> list:
    """Every plan K11 and K13 can run at (m, n, k, bs): each cluster size,
    the panel's bands in shared memory where they fit and in the work
    buffer at every size.  They all give the same bits."""
    _check_shape(m, n, k, bs)
    out = []
    for c in QR_CLUSTER_SIZES:
        for panel_shared in (True, False):
            smem = qr_cluster_smem(m, bs, c, panel_shared)
            if smem <= QR_CLUSTER_SMEM_BYTES:
                out.append(QrClusterPlan(c, QR_CLUSTER_THREADS, smem,
                                         panel_shared))
    if not out:
        raise ValueError(f"qr_cluster_plan: m = {m}, n = {n}, k = {k}, bs = "
                         f"{bs} fits no cluster's shared memory")
    return out


# CTAs an SM each kernel's instance asks ptxas for (__launch_bounds__)
QR_MIN_BLOCKS = {"qr_solve_blocked": 2, "qr_solve_tiled": 1}


@functools.lru_cache(maxsize=None)
def qr_clusters_at_once(kernel: str, plan: QrClusterPlan) -> int:
    """Clusters of ``plan`` the card holds at once for K11 (``kernel``
    "qr_solve_blocked") or K13 ("qr_solve_tiled"): on a machine with a
    card its ``cudaOccupancyMaxActiveClusters`` (asked once a plan), on
    the CPU an H100's (``common.clusters_at_once``; the kernel's static
    pointer tables take 2 KB)."""
    return common.clusters_at_once(
        lambda: qr_cluster_occupancy(kernel, plan), plan.clusters,
        plan.smem_bytes, QR_MIN_BLOCKS[kernel], 2048)


# A lane's SM cycles on a form (qr_lane_cycles), fitted to the sweep of
# every form of K11 and K13 at their main shapes by `scripts/qr_phases.py
# --forms` on an H100 (PERF.md): each reflector's chain (a barrier
# and a gather, longer on more CTAs), cycles a reflector = A + B log2 C;
# the products, C_FLOP cycles a flop a CTA; and with the bands in the work
# buffer their pass, D cycles a panel element a CTA times the share of
# L2's 50 MB that the bands of the lanes in flight take.
QR_LANE_CYCLES = {"A": 5904.0, "B": 616.4, "C_FLOP": 0.04202, "D": 0.7287}
L2_BYTES = 50 * 2**20


def qr_lane_cycles(m: int, n: int, bs: int, plan: QrClusterPlan,
                   lanes_in_flight: int) -> float:
    """The modelled SM cycles of one lane of K11 / K13 at (m, n), panels
    of ``bs``, on ``plan``, with ``lanes_in_flight`` lanes running at
    once (:data:`QR_LANE_CYCLES`)."""
    c = plan.clusters
    k = QR_LANE_CYCLES
    flops = 2 * (m * n * n - n ** 3 / 3)
    cycles = n * (k["A"] + k["B"] * math.log2(c)) + k["C_FLOP"] * flops / c
    if not plan.panel_shared:
        # (pr - j)(bs - j) summed over a panel's reflectors, over panels
        elems = sum((m - o - bs) * bs * (bs + 1) / 2
                    + bs * (bs + 1) * (2 * bs + 1) / 6
                    for o in range(0, n, bs))
        in_flight = lanes_in_flight * m * (bs + 2) * 4 / L2_BYTES
        cycles += k["D"] * elems / c * in_flight
    return cycles


def qr_cluster_plan(batch: int, m: int, n: int, k: int, bs: int,
                    kernel: str = "qr_solve_tiled") -> QrClusterPlan:
    """The one plan of K11 (``kernel`` "qr_solve_blocked") or K13
    ("qr_solve_tiled") for ``batch`` lanes at (m, n, k) with panels of
    ``bs``: of the shape's forms (:func:`qr_cluster_forms`), the one whose
    waves of the clusters the card holds at once
    (:func:`qr_clusters_at_once`) times its modelled lane
    (:func:`qr_lane_cycles`) is least, the smaller cluster on a tie.
    A larger cluster shortens a lane's products but lengthens each
    reflector's barrier and leaves SMs idle where it does not divide a
    GPC; bands in the work buffer cost shared memory nothing, so a CTA
    holds less and more lanes run at once, until their bands outgrow
    L2.  So 516 x 512 at bs = 128 takes C = 1 at a carrier's 3276 lanes
    and C = 2 at the 32 served lanes, both with the bands in the work
    buffer; 260 x 256 at bs = 64 C = 1 with work-buffer bands (two CTAs
    an SM) at 3276 and C = 4 with shared bands at 32; 132 x 128 C = 1
    with shared bands at both.  Shapes, batch and the card alone decide
    it."""
    def cost(plan):
        at_once = qr_clusters_at_once(kernel, plan)
        waves = -(-batch // at_once)
        return waves * qr_lane_cycles(m, n, bs, plan, min(batch, at_once))
    return min(qr_cluster_forms(m, n, k, bs),
               key=lambda p: (cost(p), p.clusters))


def _cluster_plan_args(kernel: CudaKernel, a: torch.Tensor, b: torch.Tensor,
                       bs: int, plan: QrClusterPlan | None):
    """The plan of a K11 / K13 launch (``plan`` checked against the
    shape's forms) and its device work buffer."""
    bsz, m, n = a.shape
    k = b.shape[-1]
    if plan is None:
        plan = qr_cluster_plan(bsz, m, n, k, bs, kernel.name)
    elif plan not in qr_cluster_forms(m, n, k, bs):
        raise ValueError(f"{kernel.name}: {plan} is not a form of "
                         f"{m} x {n}, k = {k}, bs = {bs}")
    work = torch.empty(bsz * qr_cluster_work(m, n, k, bs, plan),
                       dtype=torch.float32, device=a.device)
    return plan, work


def _cluster_launch(kernel: CudaKernel, a: torch.Tensor, b: torch.Tensor,
                    x: torch.Tensor, bs: int, tiny: float,
                    plan: QrClusterPlan | None) -> None:
    """One cluster launch of K11 or K13 on CUDA tensors; raises where the
    card refuses it."""
    bsz, m, n = a.shape
    k = b.shape[-1]
    plan, work = _cluster_plan_args(kernel, a, b, bs, plan)
    kernel.launch(a.device, (plan.smem_bytes,), a.data_ptr(), b.data_ptr(),
                  x.data_ptr(), work.data_ptr(), bsz, m, n, k, bs, tiny,
                  plan.clusters, int(plan.panel_shared), plan.smem_bytes)


def qr_cluster_occupancy(name: str, plan: QrClusterPlan) -> int:
    """``cudaOccupancyMaxActiveClusters`` of K11 (``name``
    "qr_solve_blocked") or K13 ("qr_solve_tiled") at ``plan``: the
    clusters the card holds at once (-1 where the query fails)."""
    return common.cluster_occupancy(name + "_clusters", plan.clusters,
                                    int(plan.panel_shared), plan.smem_bytes)


# ---------------------------------------------------------------------------
# The phase stamps of K11 and K13 (csrc/phase_clock.cuh)
# ---------------------------------------------------------------------------

QR_PHASES = ("load", "panel", "vt", "apply", "backsub", "gather", "dots")
"""The phases a stamped K11 / K13 lane is split into: copying A and B in,
the panels' reflectors, V^T V and T, the block reflector on the trailing
columns and the rhs, the back substitution (each ending at its last
barrier, waits included); the cluster form splits its panels further
(``csrc/phase_clock.cuh``): "gather" up to each reflector's sums
gathered (the cluster barrier's wait; a panel's bands loaded and first
sums at its first reflector), "dots" the pass applying it and summing
the next one's, "panel" the panel's end."""


def qr_solve_phases(name: str, a: torch.Tensor, b: torch.Tensor, *,
                    bs: int | None = None, tiny: float = DEFAULT_TINY,
                    plan: QrClusterPlan | None = None):
    """K11 (``name`` "qr_solve_blocked") or K13 ("qr_solve_tiled") through
    its phase-stamped instance, on CUDA tensors: returns (x, stamps), the
    stamps a (batch, 2 + len(QR_PHASES)) int64 tensor of each lane's
    first and last SM clock on its cluster's first CTA and the cycles of
    each phase, which add up to last - first.  Not a launch of the
    kernel's counted entry (the served instance compiles the stamps
    out)."""
    kernel = {"qr_solve_blocked": _BLOCKED, "qr_solve_tiled": _TILED}[name]
    dev = check_f32(name, a, b)
    if dev.type != "cuda":
        raise ValueError(f"{name}: the phase stamps run on the card")
    bsz, m, n = a.shape
    k = b.shape[-1]
    if name == "qr_solve_tiled":
        bs = tiled_admit(name, n, bs,
                         lambda w: qr_tiled_vmem_floats(m, n, w, k))
    else:
        bs = block_size(n, bs)
    plan, work = _cluster_plan_args(kernel, a, b, bs, plan)
    x = torch.empty((bsz, n, k), dtype=torch.float32, device=dev)
    stamps = torch.zeros((bsz, 2 + len(QR_PHASES)), dtype=torch.int64,
                         device=dev)
    fn = getattr(common.load_library(), name + "_phases_f32")
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(a.data_ptr(), b.data_ptr(), x.data_ptr(), work.data_ptr(),
                 stamps.data_ptr(), bsz, m, n, k, bs, tiny, plan.clusters,
                 int(plan.panel_shared), plan.smem_bytes,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = common.load_library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: phase-stamped launch failed: {msg}")
    return x, stamps
