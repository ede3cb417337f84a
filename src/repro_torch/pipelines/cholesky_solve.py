"""Fused SPD solve: Cholesky factor + forward + back substitution in one
kernel launch, one lane per problem (paper Figs. 5/9/13 chained as a
single ordered region).

The win the paper measures is the *chain* factor -> forward-solve ->
back-solve executed without the matrix round-tripping through memory.
Here one CUDA block is one lane (``csrc/cholesky_solve.cu``): the matrix
and right-hand sides stay in shared memory across all three stages (in a
device work buffer for a lane too large for shared memory), and
the forward substitution is interleaved inside the factor loop — as soon
as column k of L is finished (the ordered dependence), the divide + AXPY
of the forward solve for row k consume it.

Numerics: only the lower triangle of A is read (the inductive-domain
mask, paper Feature 4), and the pivot is guarded by ``eps`` so singular
or ill-conditioned systems give finite output instead of NaN lanes.

The plain PyTorch version (:func:`cholesky_solve_plain`, built from
:func:`pivot_threshold`, :func:`factor_forward_step` and
:func:`back_substitution_step`) follows the reference's per-lane op order
with the batch written out; a CPU tensor takes it, a CUDA tensor the
kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import common
from repro_torch.kernels.cholesky import cholesky_fused
from repro_torch.kernels.common import (CudaKernel, check_f32, data_ptr,
                                        resolve_device)
from repro_torch.kernels.trisolve import trisolve_fused

# Relative pivot threshold (LAPACK pstrf-style): a pivot below
# eps * max(diag(A)) marks a numerically deficient direction.  Residual
# pivots of an exactly singular float32 matrix land around
# n * ulp * ||A|| ~ 1e-6 * scale, so 1e-5 cleanly separates "deficient"
# from merely ill-conditioned.
DEFAULT_EPS = 1e-5


def pivot_threshold(a: torch.Tensor, rows: torch.Tensor, *,
                    eps: float) -> torch.Tensor:
    """Scale-relative deficiency threshold from the initial diagonal,
    one per lane: a (B, n, n) -> (B,)."""
    diag = torch.where(rows[:, None] == rows[None, :], a, -torch.inf)
    return torch.clamp_min(eps * diag.amax(dim=(-2, -1)), 1e-30)


def factor_forward_step(k: int, a: torch.Tensor, y: torch.Tensor,
                        rows: torch.Tensor, thresh: torch.Tensor):
    """One fused outer iteration over every lane: finish column k of L,
    then immediately run the forward-substitution step that consumes it.

    a: (B, n, n) working matrix (lower triangle -> L in place)
    y: (B, n, m) right-hand sides being forward-solved in place
    thresh: (B,) deficiency threshold (see pivot_threshold)

    A pivot below ``thresh`` takes the rank-deficient path: unit diagonal,
    zeroed column, zeroed solution component — the solve proceeds on the
    numerically non-deficient subspace and every lane stays finite.
    """
    # ---- point region (non-critical): guarded rsqrt of the pivot ----
    akk = a[:, k, k]
    ok = akk > thresh
    inv = torch.where(ok, torch.rsqrt(torch.maximum(akk, thresh)), 0.0)
    # ---- vector region: scale column k; diagonal set to the pivot ----
    col = a[:, :, k] * inv[:, None]
    col = torch.where(rows == k, torch.where(ok, akk * inv, 1.0)[:, None],
                      col)
    col = torch.where(rows >= k, col, 0.0)            # implicit mask (F4)
    # ---- matrix region (critical): masked rank-1 trailing update ----
    live = rows > k
    upd = col[:, :, None] * col[:, None, :]
    mask = live[:, None] & live[None, :]
    a = a - torch.where(mask, upd, 0.0)
    a[:, :, k] = torch.where(rows >= k, col, a[:, :, k])
    # ---- fused forward substitution consuming the finished column ----
    # y[k] /= l[k,k];  y[j>k] -= l[j,k] * y[k]   (divide + masked AXPY)
    yk = y[:, k] * inv[:, None]                       # deficient: x_k = 0
    y = y.clone()
    y[:, k] = yk
    y = y - torch.where(live[:, None], col[:, :, None] * yk[:, None, :], 0.0)
    return a, y


def back_substitution_step(i: int, l: torch.Tensor, y: torch.Tensor,
                           rows: torch.Tensor, *, n: int) -> torch.Tensor:
    """Back-substitution outer iteration on U = L^T, k = n-1-i:
    x[k] = y[k] / l[k,k];  y[j<k] -= l[k,j] * x[k]."""
    k = n - 1 - i
    xk = y[:, k] / l[:, k, k][:, None]    # diagonal already >= sqrt(eps)
    y = y.clone()
    y[:, k] = xk
    row = l[:, k, :]                      # l[k, j] valid for j <= k
    return y - torch.where((rows < k)[:, None],
                           row[:, :, None] * xk[:, None, :], 0.0)


def cholesky_chain_plain(a: torch.Tensor, y: torch.Tensor, *,
                         eps: float) -> torch.Tensor:
    """The fused factor -> forward -> back chain on symmetric (B, n, n)
    systems, shared by the plain versions of K1, K2 and K3 as the kernels
    share ``chol_chain`` in ``csrc/lane_common.cuh``."""
    n = a.shape[-1]
    rows = torch.arange(n, device=a.device)
    thresh = pivot_threshold(a, rows, eps=eps)
    for k in range(n):
        a, y = factor_forward_step(k, a, y, rows, thresh)
    for i in range(n):
        y = back_substitution_step(i, a, y, rows, n=n)
    return y


def cholesky_solve_plain(a: torch.Tensor, b: torch.Tensor, *,
                         eps: float = DEFAULT_EPS) -> torch.Tensor:
    """Plain PyTorch version of K1: a (B,N,N), b (B,N,M) -> x (B,N,M)."""
    n = a.shape[-1]
    rows = torch.arange(n, device=a.device)
    # symmetrize from the lower triangle: the upper half is never read
    # (garbage/NaN lanes there cannot leak into the solve)
    tril = rows[:, None] >= rows[None, :]
    a = torch.where(tril, a, a.transpose(-1, -2))
    return cholesky_chain_plain(a, b, eps=eps)


# ---------------------------------------------------------------------------
# The global forms' panel chain (csrc/chol_panels.cuh), shared by K1-K3
# ---------------------------------------------------------------------------

PANEL_THREADS = 256
PANEL_WIDTH = 32             # the widest panel a plan picks (the C entries
                             # take 1 to 64)
# Dynamic shared memory one block may use on sm_90 (227 KB).  The panel's
# budget is the card's own limit, never common.MAX_SMEM_BYTES, which
# decides the form and which tests lower to 0 to force the global form.
PANEL_SMEM_BYTES = 232448
# A plan narrows its panel until three lanes share an SM
# (common.SM_SMEM_BYTES): at n = 1024 a 32-wide panel (135 KB) leaves one
# lane an SM waiting at the panel's barriers, and a 16-wide one reads
# faster (PERF.md, PR 22).
SM_SMEM_BYTES = common.SM_SMEM_BYTES
PANEL_SMEM_TARGET = SM_SMEM_BYTES // 3 - 1024


class CholPanelPlan(NamedTuple):
    """How the global form of K1-K3 runs the chain on an n x n system with
    m right-hand sides: ``threads`` a CTA, panels of ``bs`` columns, and
    ``smem_bytes`` of dynamic shared memory a CTA."""
    threads: int
    bs: int
    smem_bytes: int


def chol_panel_smem(n: int, m: int, bs: int) -> int:
    """Shared memory of the panel chain: the panel (n x (bs + 1) floats),
    y's panel rows (bs x m), the threshold's per-warp partials and the
    threshold (``chol_panel_smem_bytes`` in ``csrc/chol_panels.cuh``)."""
    return 4 * (n * (bs + 1) + bs * m + 2 * (PANEL_THREADS // 32) + 1)


def chol_panel_plan(n: int, m: int) -> CholPanelPlan:
    """The one plan of the global forms' panel chain at (n, m): panels of
    :data:`PANEL_WIDTH` columns, halved until a lane takes at most
    :data:`PANEL_SMEM_TARGET` of shared memory (down to 1 column, the
    per-column chain).  The width never changes a result.  Raises where
    the plan does not fit the card's :data:`PANEL_SMEM_BYTES`."""
    if n < 1 or m < 1:
        raise ValueError(f"chol_panel_plan: n = {n}, m = {m}")
    bs = PANEL_WIDTH
    while bs > 1 and chol_panel_smem(n, m, bs) > PANEL_SMEM_TARGET:
        bs //= 2
    smem = chol_panel_smem(n, m, bs)
    if smem > PANEL_SMEM_BYTES:
        raise ValueError(f"chol_panel_plan: n = {n}, m = {m} at panel "
                         f"width {bs} needs {smem} bytes of shared memory, "
                         f"past the card's {PANEL_SMEM_BYTES}")
    return CholPanelPlan(PANEL_THREADS, bs, smem)


def global_plan_args(work: torch.Tensor | None, n: int, m: int) -> tuple:
    """The plan arguments of a K1-K3 launch: the chain's plan at (n, m)
    for the global form (``work`` given), zeros for the shared form,
    which ignores them."""
    return tuple(chol_panel_plan(n, m)) if work is not None else (0, 0, 0)


_KERNEL = CudaKernel(
    "cholesky_solve", "cholesky_solve_f32",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float]
    + [ctypes.c_int] * 3,
    "cholesky_solve_smem", 2,
    source="src/repro_torch/csrc/cholesky_solve.cu",
    replaces="src/repro/pipelines/cholesky_solve.py:113 "
             "cholesky_solve_pallas",
    work_symbol="cholesky_solve_work")


def cholesky_solve_fused(a: torch.Tensor, b: torch.Tensor, *,
                         eps: float = DEFAULT_EPS) -> torch.Tensor:
    """Solve a @ x = b for SPD a. a: (B,N,N), b: (B,N,M) -> x (B,N,M),
    float32 and contiguous.  K1 on a CUDA tensor (one launch, factor and
    both substitutions fused per lane; a lane past shared memory in a
    device work buffer, factored by panels as :func:`chol_panel_plan`
    says), its plain version on a CPU one.

    bfloat16 a and b are widened to float32, solved as above and the
    answer rounded back to bfloat16: bf16 in, bf16 out, as the
    reference's K1 takes it, with the arithmetic in float32."""
    if a.dtype == b.dtype == torch.bfloat16:
        return cholesky_solve_fused(a.float().contiguous(),
                                    b.float().contiguous(),
                                    eps=eps).to(torch.bfloat16)
    dev = check_f32("cholesky_solve", a, b)
    bsz, n, n2 = a.shape
    b2, n3, m = b.shape
    if not (n == n2 == n3 and bsz == b2):
        raise ValueError(f"cholesky_solve: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if dev.type == "cpu":
        return cholesky_solve_plain(a, b, eps=eps)
    x = torch.empty_like(b)
    if bsz:
        work = _KERNEL.work_buffer(dev, bsz, n, m)
        _KERNEL.launch(dev, (n, m), a.data_ptr(), b.data_ptr(),
                       x.data_ptr(), data_ptr(work), bsz, n, m, eps,
                       *global_plan_args(work, n, m), work=work)
    return x


def cholesky_solve(a, b, *, device=None) -> torch.Tensor:
    """Public wrapper: a (B,N,N), b (B,N,M) float32 arrays or tensors,
    solved on ``device`` (default ``cuda``; ``"cpu"`` runs the plain
    version)."""
    dev = resolve_device(device)
    return cholesky_solve_fused(torch.as_tensor(a, device=dev).contiguous(),
                                torch.as_tensor(b, device=dev).contiguous())


def cholesky_solve_unfused(a: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """The no-fusion baseline: factor, then solve, as THREE kernel
    launches — K15, K16 forward, K16 backward on the materialised L^T —
    with L, the forward solution and L^T round-tripping through device
    memory between them.  Same math as K1 without its pivot guard; this
    is what the fused kernel is measured against.  a (B,N,N), b (B,N,M)
    float32 tensors (the plain versions on CPU tensors)."""
    l = cholesky_fused(a)
    z = trisolve_fused(l, b, lower=True)
    return trisolve_fused(l.mT.contiguous(), z, lower=False)


# ---------------------------------------------------------------------------
# K10: the right-looking blocked solve (the mid-range large-n variant)
# ---------------------------------------------------------------------------

def block_size(n: int, bs: int | None = None) -> int:
    """The panel width of the blocked kernels: 64 when it divides n, else
    32 (the reference's default); an explicit ``bs`` must divide n."""
    if bs is None:
        bs = 64 if n % 64 == 0 else 32
    if n % bs or n < bs:
        raise ValueError(f"panel width {bs} does not tile n = {n}")
    return bs


def panel_factor_forward_step(j: int, c: torch.Tensor, y: torch.Tensor, *,
                              o: int, rows: torch.Tensor,
                              cols_bs: torch.Tensor, thresh: torch.Tensor):
    """One column of the blocked panel factor over every lane, fused with
    the forward-substitution row it finishes (the blocked analog of
    :func:`factor_forward_step`).

    c: (B, n, bs) full-height column slab [cols o..o+bs) of the working
    matrix; y: (B, n, m).  ``g = o + j`` is the global pivot; the rank-1
    update is confined to the REMAINING slab columns (cols_bs > j) —
    trailing columns outside the slab get their whole panel's
    contribution later in one SYRK."""
    g = o + j
    bs = c.shape[-1]
    col = c[:, :, j]
    pivot = col[:, g]
    ok = pivot > thresh
    inv = torch.where(ok, torch.rsqrt(torch.maximum(pivot, thresh)), 0.0)
    newcol = col * inv[:, None]
    newcol = torch.where(rows == g,
                         torch.where(ok, pivot * inv, 1.0)[:, None], newcol)
    newcol = torch.where(rows >= g, newcol, 0.0)      # implicit mask (F4)
    live = rows > g
    # rank-1 update of the remaining panel columns only
    w = torch.where(cols_bs > j, newcol[:, o:o + bs], 0.0)
    c = c - torch.where(live[:, None], newcol[:, :, None] * w[:, None, :],
                        0.0)
    c[:, :, j] = newcol
    # fused forward substitution consuming the finished column
    yg = y[:, g] * inv[:, None]
    y = y.clone()
    y[:, g] = yg
    y = y - torch.where(live[:, None], newcol[:, :, None] * yg[:, None, :],
                        0.0)
    return c, y


def cholesky_solve_blocked_plain(a: torch.Tensor, b: torch.Tensor, *,
                                 bs: int | None = None,
                                 eps: float = DEFAULT_EPS) -> torch.Tensor:
    """Plain PyTorch version of K10: a (B,N,N), b (B,N,M) -> x (B,N,M) by
    the blocked algorithm of the reference — per panel, ``bs`` fused
    factor + forward steps with rank-1 updates inside the panel, then one
    rank-``bs`` SYRK on the trailing submatrix — so its float grouping is
    the reference's, not K1's chain."""
    n = a.shape[-1]
    bs = block_size(n, bs)
    rows = torch.arange(n, device=a.device)
    cols_bs = torch.arange(bs, device=a.device)
    # symmetrize from the lower triangle: the upper half is never read
    tril = rows[:, None] >= rows[None, :]
    a = torch.where(tril, a, a.transpose(-1, -2))
    thresh = pivot_threshold(a, rows, eps=eps)
    y = b
    for o in range(0, n, bs):
        # ---- panel factor + fused forward substitution (bs columns) ----
        c = a[:, :, o:o + bs].clone()
        for j in range(bs):
            c, y = panel_factor_forward_step(j, c, y, o=o, rows=rows,
                                             cols_bs=cols_bs, thresh=thresh)
        a = torch.cat([a[:, :, :o], c, a[:, :, o + bs:]], dim=-1)
        # ---- trailing SYRK: one rank-bs product for the whole panel ----
        cm = torch.where(rows[:, None] >= o + bs, c, 0.0)
        a = a - cm @ cm.transpose(-1, -2)
    for i in range(n):
        y = back_substitution_step(i, a, y, rows, n=n)
    return y


_BLOCKED = CudaKernel(
    "cholesky_solve_blocked", "cholesky_solve_blocked_f32",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float]
    + [ctypes.c_int] * 3,
    None, 1,
    source="src/repro_torch/csrc/cholesky_solve_blocked.cu",
    replaces="src/repro/pipelines/cholesky_solve.py:244 "
             "cholesky_solve_blocked",
)


def blocked_rhs_groups(n: int, k: int, bs: int) -> tuple:
    """How K10 takes ``k`` right-hand sides at (n, bs): ``(width,
    groups)``, the column groups [q0, q1) a launch each, of ``width``
    columns (the last one's missing columns zero and dropped), as few as
    :func:`chol_tiled_max_k` allows.  A column's operations do not depend
    on the others', so a group's answer is the whole k's bit for bit."""
    if k < 1:
        return 0, []
    groups = -(-k // chol_tiled_max_k(n, bs))
    width = -(-k // groups)
    return width, [(q, min(k, q + width)) for q in range(0, k, width)]


def cholesky_solve_blocked_fused(a: torch.Tensor, b: torch.Tensor, *,
                                 bs: int | None = None,
                                 eps: float = DEFAULT_EPS,
                                 plan: CholTiledPlan | None = None
                                 ) -> torch.Tensor:
    """Blocked SPD solve — the mid-range large-n path (the registry's
    ``blocked`` variant, n >= 128 with n % 32 == 0).  Same contract as
    :func:`cholesky_solve_fused`; panels of ``bs`` columns (default: 64
    when it divides N, else 32).  K10 on a CUDA tensor (a cluster launch
    on ``plan``, default :func:`chol_tiled_plan`'s, a column group of the
    right-hand sides at a time, :func:`blocked_rhs_groups`; L in a device
    work buffer), refused with ValueError past
    :func:`cholesky_solve_blocked_fits`; its plain version on a CPU one.
    Every plan gives the same bits; a plan off the forms raises
    ValueError on every device."""
    dev = check_f32("cholesky_solve_blocked", a, b)
    bsz, n, n2 = a.shape
    b2, n3, m = b.shape
    if not (n == n2 == n3 and bsz == b2):
        raise ValueError(f"cholesky_solve_blocked: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    bs = block_size(n, bs)
    width, groups = blocked_rhs_groups(n, m, bs)
    if plan is not None and m:
        plan = chol_tiled_check("cholesky_solve_blocked", plan, bsz, n,
                                width, bs)
    if dev.type == "cpu":
        return cholesky_solve_blocked_plain(a, b, bs=bs, eps=eps)
    if not cholesky_solve_blocked_fits(n, m, bs):
        raise ValueError(f"cholesky_solve_blocked: n = {n}, k = {m}, bs = "
                         f"{bs} is past the blocked rung's shared memory "
                         f"(cholesky_solve_blocked_fits); the tiled K12 "
                         f"serves it")
    x = torch.empty_like(b)
    if not (bsz and m):
        return x
    plan = plan or chol_tiled_plan(bsz, n, width, bs, "cholesky_solve_blocked")
    work = torch.empty((bsz, n, n), dtype=torch.float32, device=dev)
    for q0, q1 in groups:
        bg, xg = b, x
        if len(groups) > 1:
            bg = b.new_zeros((bsz, n, width))
            bg[:, :, :q1 - q0] = b[:, :, q0:q1]
            xg = torch.empty_like(bg)
        _BLOCKED.launch(dev, (plan.smem_bytes,), a.data_ptr(), bg.data_ptr(),
                        xg.data_ptr(), work.data_ptr(), bsz, n, width, bs,
                        eps, plan.clusters, plan.tile, plan.smem_bytes)
        if len(groups) > 1:
            x[:, :, q0:q1] = xg[:, :, :q1 - q0]
    return x


def cholesky_solve_blocked_fits(n: int, m: int,
                                bs: int | None = None) -> bool:
    """Whether the blocked rung takes per-lane shapes (n, n), (n, m): the
    rule of the one-CTA K10 the cluster form replaced, whose panel of
    n (bs + 1) floats, y (n m), a column of L and a row of x had to fit
    one CTA's shared memory — up to n = 832 at bs = 64 (the tiled K12
    serves larger n).  The dispatcher's choices follow it; the cluster
    form takes every shape it admits (:func:`chol_tiled_plan`, a column
    group at a time)."""
    bs = block_size(n, bs)
    floats = n * (bs + 1) + n * m + n + m + 1
    return 4 * floats <= common.MAX_SMEM_BYTES


def cholesky_solve_blocked(a, b, *, bs: int | None = None,
                           device=None) -> torch.Tensor:
    """Public wrapper of the blocked solve (see :func:`cholesky_solve`)."""
    dev = resolve_device(device)
    return cholesky_solve_blocked_fused(
        torch.as_tensor(a, device=dev).contiguous(),
        torch.as_tensor(b, device=dev).contiguous(), bs=bs)


# ---------------------------------------------------------------------------
# K12: the slab-streamed tiled solve (the HBM-scale variant, n >= 512)
# ---------------------------------------------------------------------------

# The reference's admission rule for its tiled kernels: one grid cell's
# working set must stay inside a TPU core's ~16 MiB vector memory.  The
# port's kernels stream slabs past shared memory and have no such limit,
# but keep the rule so that they refuse exactly the shapes the reference
# refuses.
TILED_VMEM_BUDGET_BYTES = 14 * 2 ** 20


def tiled_block_size(n: int) -> int:
    """Default slab width: the largest of {128, 64, 32} dividing n, so
    every n % 32 == 0 shape the dispatcher routes here tiles."""
    for bs in (128, 64, 32):
        if n % bs == 0:
            return bs
    raise ValueError(f"n={n} does not tile into 32-wide slabs")


def tiled_vmem_floats(n: int, bs: int, m: int) -> int:
    """The reference's per-cell working set of the tiled solve, in
    float32 elements: slab (n, bs) + panel carry (2, n, bs) + rhs carry,
    b and x blocks (n, m) each."""
    return 3 * n * bs + 3 * n * m


def tiled_admit(name: str, n: int, bs: int | None, floats) -> int:
    """The slab width of a tiled call at ``n`` (default
    :func:`tiled_block_size`), or ValueError where the reference asserts:
    a width that does not tile n, fewer than two slabs, or a working set
    ``floats(bs)`` past :data:`TILED_VMEM_BUDGET_BYTES`.  Reads shapes
    only, so a refused call allocates nothing."""
    if bs is None:
        bs = tiled_block_size(n)
    if bs < 1 or n % bs or n < 2 * bs:
        raise ValueError(f"{name}: slab width {bs} must tile n = {n} in "
                         f"at least two slabs")
    if 4 * floats(bs) > TILED_VMEM_BUDGET_BYTES:
        raise ValueError(f"{name}: n = {n}, bs = {bs} needs "
                         f"{4 * floats(bs)} bytes a cell, past the "
                         f"reference's {TILED_VMEM_BUDGET_BYTES}-byte "
                         f"budget")
    return bs


def tiled_trailing_update(slab: torch.Tensor, pan: torch.Tensor, t: int, *,
                          o: int, bs: int,
                          rows: torch.Tensor) -> torch.Tensor:
    """Rank-``bs`` SYRK of the factored panel ``pan`` (B, n, bs) onto
    column slab ``t``: slab[r, j] -= sum_p pan[r, p] pan[t bs + j, p] for
    the rows below the panel (r >= o + bs)."""
    pt = pan[:, t * bs:(t + 1) * bs]
    pm = torch.where(rows[:, None] >= o + bs, pan, 0.0)
    return slab - pm @ pt.transpose(-1, -2)


def tiled_backsub_step(slab: torch.Tensor, z: torch.Tensor, rt: int, *,
                       bs: int, rows: torch.Tensor) -> torch.Tensor:
    """Left-looking block step of the L^T back substitution on column
    slab ``rt`` (slabs taken in reverse): subtract the already-solved
    components below, then solve the (bs, bs) diagonal block."""
    o = rt * bs
    below = torch.where(rows[:, None] >= o + bs, slab, 0.0)
    zt = z[:, o:o + bs] - below.transpose(-1, -2) @ z
    lb = slab[:, o:o + bs]
    rows_bs = torch.arange(bs, device=slab.device)
    for i in range(bs):
        zt = back_substitution_step(i, lb, zt, rows_bs, n=bs)
    return torch.cat([z[:, :o], zt, z[:, o + bs:]], dim=1)


def tiled_chain_plain(slabs: list, y: torch.Tensor, *, bs: int,
                      thresh: torch.Tensor) -> torch.Tensor:
    """The tiled factor -> forward -> back chain over the column slabs
    (B, n, bs) of a symmetric working matrix whose lower triangle holds
    the system, shared by the plain versions of K12 and K14 as the
    kernels share ``csrc/tiled_chol.cuh``: per panel step, ``bs`` fused
    factor + forward steps on the panel slab, then the rank-bs update of
    every slab to its right; then the block back substitution over the
    slabs in reverse."""
    n = y.shape[1]
    rows = torch.arange(n, device=y.device)
    cols_bs = torch.arange(bs, device=y.device)
    steps = n // bs
    slabs = list(slabs)
    for s in range(steps):
        o = s * bs
        c = slabs[s]
        for j in range(bs):
            c, y = panel_factor_forward_step(j, c, y, o=o, rows=rows,
                                             cols_bs=cols_bs, thresh=thresh)
        slabs[s] = c
        for t in range(s + 1, steps):
            slabs[t] = tiled_trailing_update(slabs[t], c, t, o=o, bs=bs,
                                             rows=rows)
    for t in range(steps):
        rt = steps - 1 - t
        y = tiled_backsub_step(slabs[rt], y, rt, bs=bs, rows=rows)
    return y


def cholesky_solve_tiled_plain(a: torch.Tensor, b: torch.Tensor, *,
                               bs: int | None = None,
                               eps: float = DEFAULT_EPS) -> torch.Tensor:
    """Plain PyTorch version of K12: a (B,N,N), b (B,N,M) -> x (B,N,M) by
    the reference's tiled algorithm, its float grouping included (the
    left-looking block back substitution, not K10's n-step chain).  Only
    the lower triangle of ``a`` is read; the threshold comes from its raw
    diagonal."""
    n, m = a.shape[-1], b.shape[-1]
    bs = tiled_admit("cholesky_solve_tiled", n, bs,
                     lambda w: tiled_vmem_floats(n, w, m))
    rows = torch.arange(n, device=a.device)
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    thresh = torch.clamp_min(eps * diag.amax(dim=-1), 1e-30)
    low = torch.where(rows[:, None] >= rows[None, :], a, 0.0)
    slabs = [low[:, :, o:o + bs] for o in range(0, n, bs)]
    return tiled_chain_plain(slabs, b, bs=bs, thresh=thresh)


# ---------------------------------------------------------------------------
# K12 and K14 on a thread-block cluster (csrc/tiled_chol.cuh)
# ---------------------------------------------------------------------------

TILED_CLUSTER_SIZES = (1, 2, 4, 8)   # CTAs a lane (portable cluster sizes)
TILED_TILES = (64, 128)              # the wide product tile's edge
TILED_THREADS = 256                  # a CTA (the wide tile's block)
TILED_ROW_CHUNK = 64                 # rows of L21 a pass (kRowChunk)
TILED_MAX_PANEL = 256                # bs, at most (kTcMaxPanel)
TILED_MIN_BLOCKS = 2                 # CTAs an SM the instances ask ptxas for
TILED_KERNELS = ("cholesky_solve_tiled", "mmse_equalize_tiled",
                 "cholesky_solve_blocked")


class CholTiledPlan(NamedTuple):
    """How K10, K12 and K14 run a lane: on a cluster of ``clusters`` CTAs
    of ``threads`` threads and ``smem_bytes`` of dynamic shared memory each,
    the products in ``tile`` x ``tile`` wide tiles; the matrix in the
    lane's device work buffer, the right-hand sides in the output."""
    clusters: int
    threads: int
    smem_bytes: int
    tile: int


def _align4(floats: int) -> int:
    return -(-floats // 4) * 4


def chol_tiled_smem(k: int, bs: int, tile: int, below: bool = True) -> int:
    """Dynamic shared memory of a CTA (``tiled_layout`` in
    ``csrc/tiled_chol.cuh``): the diagonal block (bs rows of pitch
    align4(bs) + 4), the pivots' rsqrt, its rows of y in work and
    finished (bs x k each), the rows of L21 (64 rows of the block's pitch)
    or the wide tile's two stages (2 x 2 x 2048 floats), whichever is
    larger, their rows of y (64 x k) and 32 floats of reduction scratch.
    ``below`` False (a lane of one panel, n = bs: no rows of L21, no
    trailing update) drops the rows of L21, the stages and their rows of
    y, and the block's pitch is align4(bs).  Independent of n and m
    otherwise."""
    pb = _align4(bs) + (4 if below else 0)
    yb = bs * pb + _align4(bs)
    chunk = _align4(_align4(yb + bs * k) + bs * k)
    if not below:
        return 4 * (chunk + 32)
    wide = 2 * 2 * (2048 // tile) * tile
    return 4 * (chunk + max(TILED_ROW_CHUNK * pb, wide)
                + TILED_ROW_CHUNK * k + 32)


def _check_tiled_shape(n: int, k: int, bs: int, kernel: str,
                       m: int | None) -> None:
    if kernel not in TILED_KERNELS:
        raise ValueError(f"chol_tiled_plan: kernel {kernel!r}")
    if not (1 <= bs <= TILED_MAX_PANEL and n % bs == 0 and k >= 1
            and (kernel != "mmse_equalize_tiled" or (m or 0) >= n)):
        raise ValueError(f"chol_tiled_plan: {kernel} n = {n}, k = {k}, "
                         f"bs = {bs}, m = {m}")


def chol_tiled_forms(n: int, k: int, bs: int,
                     kernel: str = "cholesky_solve_tiled",
                     m: int | None = None) -> list:
    """Every plan K12 (``kernel`` "cholesky_solve_tiled"), K14
    ("mmse_equalize_tiled", ``m`` channel rows) or K10
    ("cholesky_solve_blocked") can run at (n, k, bs): each cluster size
    and each tile whose CTA fits the card's shared memory.  They all give
    the same bits."""
    _check_tiled_shape(n, k, bs, kernel, m)
    smem = {t: chol_tiled_smem(k, bs, t, n > bs) for t in TILED_TILES}
    out = [CholTiledPlan(c, TILED_THREADS, smem[t], t)
           for c in TILED_CLUSTER_SIZES for t in TILED_TILES
           if smem[t] <= PANEL_SMEM_BYTES]
    if not out:
        raise ValueError(f"chol_tiled_plan: {kernel} k = {k}, bs = {bs} "
                         f"fits no CTA's shared memory")
    return out


@functools.lru_cache(maxsize=None)
def chol_tiled_max_k(n: int, bs: int) -> int:
    """The most right-hand sides a CTA of the tiled core holds at (n, bs)
    at every product tile (:func:`chol_tiled_smem` within the card's
    shared memory); ValueError where not one fits."""
    def fits(k):
        return all(chol_tiled_smem(k, bs, t, n > bs) <= PANEL_SMEM_BYTES
                   for t in TILED_TILES)
    if not fits(1):
        raise ValueError(f"chol_tiled_plan: bs = {bs} fits no CTA's shared "
                         f"memory at n = {n}")
    k = 1
    while fits(k + 1):
        k += 1
    return k


@functools.lru_cache(maxsize=None)
def chol_tiled_clusters_at_once(kernel: str, plan: CholTiledPlan) -> int:
    """Clusters of ``plan`` the card holds at once for K10, K12 or K14: the
    card's ``cudaOccupancyMaxActiveClusters`` (asked once a plan), an
    H100's on the CPU (``common.clusters_at_once``)."""
    return common.clusters_at_once(
        lambda: chol_tiled_occupancy(kernel, plan), plan.clusters,
        plan.smem_bytes, TILED_MIN_BLOCKS)


def chol_tiled_occupancy(kernel: str, plan: CholTiledPlan) -> int:
    """``cudaOccupancyMaxActiveClusters`` of K12 (``kernel``
    "cholesky_solve_tiled"), K14 ("mmse_equalize_tiled") or K10
    ("cholesky_solve_blocked") at ``plan`` (-1 where the query fails)."""
    return common.cluster_occupancy(kernel + "_clusters", plan.clusters,
                                    plan.tile, plan.smem_bytes)


def chol_tiled_deal(units: int, c: int) -> list:
    """The units (tiles, chunks of rows, elements) each of ``c`` ranks
    takes when ``units`` are dealt round robin, unit u to rank u % c, as
    the kernels deal the Gram's and the trailing update's tiles and the
    chunks of L21."""
    return [list(range(r, units, c)) for r in range(c)]


def chol_tiled_rows_of(bs: int, c: int) -> list:
    """The rows [j0, j1) of a slab whose back-substitution sums each of
    ``c`` ranks takes: contiguous blocks of ceil(bs / c)."""
    per = -(-bs // c)
    return [(min(bs, r * per), min(bs, r * per + per)) for r in range(c)]


# A lane's SM cycles on a plan (chol_lane_cycles): each phase's cycles a
# unit of its work on the longest rank (chol_lane_units), at each product
# tile (the 128 tile's instance spills registers, so every phase of it
# prices apart; "sync" fits to 0 there, its barriers hidden in the other
# prices), fitted to the sweep of every form of K12 and K14 at
# their main shapes by `scripts/chol_tiled_phases.py --forms --fit` on an
# H100 (PERF.md): "diag" a column of the diagonal blocks (every rank),
# "rows" an element of bs x bs a chunk of L21's rows, "trail" / "gram" a
# tile element a depth step, "filter" a matched-filter depth step, "sums"
# a row of the back substitution's sums, "solve" a column of its diagonal
# blocks, "load" an element of A's lower triangle, "sync" a cluster
# barrier a log2 C; "chain" (K10's alone, fitted to K10's sweep, the rest
# kept) a step of a thread's pass over the rows above a slab.
CHOL_LANE_CYCLES = {
    "diag": {64: 860.9, 128: 1099.0}, "rows": {64: 3.288, 128: 4.356},
    "trail": {64: 0.04567, 128: 0.03232},
    "gram": {64: 0.03019, 128: 0.02405},
    "filter": {64: 127.8, 128: 134.4}, "sums": {64: 78.56, 128: 86.72},
    "solve": {64: 332.5, 128: 354.3}, "load": {64: 0.05154, 128: 0.05272},
    "sync": {64: 1188.0, 128: 0.0}, "chain": {64: 86.84, 128: 94.54}}


def chol_lane_units(n: int, k: int, bs: int, plan: CholTiledPlan,
                    kernel: str = "cholesky_solve_tiled",
                    m: int | None = None) -> dict:
    """The work of one lane of K12 / K14 / K10 at (n, k), panels of
    ``bs``, on ``plan``, phase by phase, on the rank that takes the most
    of it by the kernels' deal (:func:`chol_tiled_deal`,
    :func:`chol_tiled_rows_of`; K10's chain takes the next slab's rows on
    every rank and deals the rows above them round robin over the
    cluster's threads): the units :data:`CHOL_LANE_CYCLES` prices."""
    c, t = plan.clusters, plan.tile

    def most(units):            # the longest rank's share, dealt round robin
        return len(chol_tiled_deal(units, c)[0])

    j0, j1 = chol_tiled_rows_of(bs, c)[0]
    passes = -(-(j1 - j0) * k // TILED_THREADS)
    units = {"diag": n, "solve": n, "rows": 0, "trail": 0, "sums": 0,
             "gram": 0, "filter": 0, "load": 0, "chain": 0,
             "sync": (4 * n // bs + 1) * math.log2(c)}
    chain = kernel == "cholesky_solve_blocked"
    for o in range(0, n, bs):
        rest = n - o - bs
        units["rows"] += most(-(-rest // TILED_ROW_CHUNK)) * bs * bs
        tiles = -(-rest // t)
        units["trail"] += most(tiles * (tiles + 1) // 2) * t * t * bs
        if chain and o:         # the rows above the slab at o by passes:
            own = -(-bs * k // TILED_THREADS)     # the next slab's, a rank's
            dealt = -(-(o - bs) * k // (TILED_THREADS * c))    # the rest
            units["chain"] += (own + dealt) * bs
        elif not chain:
            units["sums"] += passes * rest
    if chain:                   # one barrier a slab, not two
        units["sync"] = 3 * n // bs * math.log2(c)
    if kernel == "mmse_equalize_tiled":
        tiles = -(-n // t)
        units["gram"] = most(tiles * (tiles + 1) // 2) * t * t * m
        units["filter"] = -(-n * k // (TILED_THREADS * c)) * m
    else:
        units["load"] = n * (n + 1) / 2 / c
    return units


def chol_lane_cycles(n: int, k: int, bs: int, plan: CholTiledPlan,
                     kernel: str = "cholesky_solve_tiled",
                     m: int | None = None) -> float:
    """The modelled SM cycles of one lane of K12 / K14 / K10 at (n, k),
    panels of ``bs``, on ``plan``: :func:`chol_lane_units` priced by
    :data:`CHOL_LANE_CYCLES`."""
    return sum(units * CHOL_LANE_CYCLES[phase][plan.tile]
               for phase, units in chol_lane_units(n, k, bs, plan, kernel,
                                                   m).items())


def chol_tiled_plan(batch: int, n: int, k: int, bs: int,
                    kernel: str = "cholesky_solve_tiled",
                    m: int | None = None) -> CholTiledPlan:
    """The one plan of K12 (``kernel`` "cholesky_solve_tiled"), K14
    ("mmse_equalize_tiled", ``m`` channel rows) or K10
    ("cholesky_solve_blocked") for ``batch`` lanes at
    (n, k) with panels of ``bs``: of the shape's forms
    (:func:`chol_tiled_forms`), the one whose waves of the clusters the
    card holds at once (:func:`chol_tiled_clusters_at_once`) times its
    modelled lane (:func:`chol_lane_cycles`) is least, the smaller
    cluster and then the wider tile on a tie.  A larger cluster deals a
    lane's rows, tiles and sums over more SMs but not its diagonal
    blocks, adds its barriers, and leaves SMs idle where it does not
    divide a GPC; so a carrier's width runs one CTA a lane and the 32
    lanes the slot mixes serve a cluster of several.  Shapes, batch and
    the card alone decide it."""
    def cost(plan):
        at_once = chol_tiled_clusters_at_once(kernel, plan)
        waves = -(-batch // at_once)
        return (waves * chol_lane_cycles(n, k, bs, plan, kernel, m),
                plan.clusters, -plan.tile)
    return min(chol_tiled_forms(n, k, bs, kernel, m), key=cost)


def chol_tiled_check(kernel: str, plan: CholTiledPlan | None, batch: int,
                     n: int, k: int, bs: int,
                     m: int | None = None) -> CholTiledPlan:
    """The plan of a K12 / K14 / K10 call: ``plan`` if it is one of the
    shape's forms (ValueError where it is not, on every device), else
    :func:`chol_tiled_plan`'s."""
    if plan is None:
        return chol_tiled_plan(batch, n, k, bs, kernel, m)
    if plan not in chol_tiled_forms(n, k, bs, kernel, m):
        raise ValueError(f"{kernel}: {plan} is not a form of n = {n}, "
                         f"k = {k}, bs = {bs}, m = {m}")
    return plan


_TILED = CudaKernel(
    "cholesky_solve_tiled", "cholesky_solve_tiled_f32",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float]
    + [ctypes.c_int] * 3,
    None, 1,
    source="src/repro_torch/csrc/cholesky_solve_tiled.cu",
    replaces="src/repro/pipelines/cholesky_solve.py:503 "
             "cholesky_solve_tiled",
)


def cholesky_solve_tiled_fused(a: torch.Tensor, b: torch.Tensor, *,
                               bs: int | None = None,
                               eps: float = DEFAULT_EPS,
                               plan: CholTiledPlan | None = None
                               ) -> torch.Tensor:
    """Slab-streamed SPD solve — the HBM-scale path (the registry's
    ``tiled`` variant, n >= 512 with n % 32 == 0).  Same contract as
    :func:`cholesky_solve_fused`; slabs of ``bs`` columns (default
    :func:`tiled_block_size`), refused with ValueError where the
    reference asserts.  K12 on a CUDA tensor (one cluster launch on
    ``plan``, default :func:`chol_tiled_plan`; L in a device work
    buffer, shared memory independent of n), its plain version on a CPU
    one.  Every plan gives the same bits."""
    bsz, n, n2 = a.shape
    b2, n3, m = b.shape
    if not (n == n2 == n3 and bsz == b2):
        raise ValueError(f"cholesky_solve_tiled: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    bs = tiled_admit("cholesky_solve_tiled", n, bs,
                     lambda w: tiled_vmem_floats(n, w, m))
    dev = check_f32("cholesky_solve_tiled", a, b)
    plan = chol_tiled_check("cholesky_solve_tiled", plan, bsz, n, m, bs)
    if dev.type == "cpu":
        return cholesky_solve_tiled_plain(a, b, bs=bs, eps=eps)
    x = torch.empty_like(b)
    if bsz:
        work = torch.empty((bsz, n, n), dtype=torch.float32, device=dev)
        _TILED.launch(dev, (plan.smem_bytes,), a.data_ptr(), b.data_ptr(),
                      x.data_ptr(), work.data_ptr(), bsz, n, m, bs, eps,
                      plan.clusters, plan.tile, plan.smem_bytes)
    return x


def cholesky_solve_tiled(a, b, *, bs: int | None = None,
                         device=None) -> torch.Tensor:
    """Public wrapper of the tiled solve (see :func:`cholesky_solve`)."""
    dev = resolve_device(device)
    return cholesky_solve_tiled_fused(
        torch.as_tensor(a, device=dev).contiguous(),
        torch.as_tensor(b, device=dev).contiguous(), bs=bs)


# ---------------------------------------------------------------------------
# The phase stamps of K12 and K14 (csrc/phase_clock.cuh)
# ---------------------------------------------------------------------------

TILED_PHASES = ("load", "gram", "filter", "diag", "update", "walk", "rows",
                "trail", "sums", "backsub", "chain")
"""The phases a stamped K12 / K14 / K10 lane is split into
(``csrc/phase_clock.cuh``): the load (K10, K12: B copied into the output
and the threshold; K14: the threshold from G's diagonal), K14's Gram and
matched filter; summed over the panels the diagonal block (its copy in,
corners and rows: "diag"; its rank-4 updates: "update"), the rows of L21
(the column walk: "walk"; their copy in, scale, stores and rows of y:
"rows") and the trailing update; summed over the back substitution's
slabs its sums over the rows below ("sums", K12 and K14), its diagonal
block's solve ("backsub") and K10's rows above taking the slab's x
("chain").  Each ends at a barrier, waits included, so they add up to
the lane."""


def chol_tiled_phases(name: str, a: torch.Tensor, b: torch.Tensor, *,
                      bs: int | None = None, sigma2: float = 0.1,
                      eps: float = DEFAULT_EPS,
                      plan: CholTiledPlan | None = None):
    """K12 (``name`` "cholesky_solve_tiled", ``a`` A and ``b`` B), K10
    ("cholesky_solve_blocked", A and B) or K14 ("mmse_equalize_tiled",
    ``a`` H and ``b`` y) through its
    phase-stamped instance on ``plan`` (default :func:`chol_tiled_plan`),
    on CUDA tensors: returns (x, stamps), the stamps a (batch, 2 +
    len(TILED_PHASES)) int64 tensor of each lane's first and last SM
    clock on its cluster's first CTA and the cycles of each phase, which
    add up to last - first.  Not a launch of the kernel's counted entry
    (the served instance compiles the stamps out)."""
    dev = check_f32(name, a, b)
    if dev.type != "cuda":
        raise ValueError(f"{name}: the phase stamps run on the card")
    bsz, m, n = a.shape
    k = b.shape[-1]
    if name in ("cholesky_solve_tiled", "cholesky_solve_blocked"):
        bs = (tiled_admit(name, n, bs, lambda w: tiled_vmem_floats(n, w, k))
              if name == "cholesky_solve_tiled" else block_size(n, bs))
        plan = chol_tiled_check(name, plan, bsz, n, k, bs)
        dims = [bsz, n, k, bs]
        scalars = [eps]
    else:
        from repro_torch.pipelines.mmse import mmse_tiled_vmem_floats
        bs = tiled_admit(name, n, bs,
                         lambda w: mmse_tiled_vmem_floats(m, n, w, k))
        plan = chol_tiled_check(name, plan, bsz, n, k, bs, m)
        dims = [bsz, m, n, k, bs]
        scalars = [sigma2, eps]
    work = torch.empty((bsz, n, n), dtype=torch.float32, device=dev)
    x = torch.empty((bsz, n, k), dtype=torch.float32, device=dev)
    stamps = torch.zeros((bsz, 2 + len(TILED_PHASES)), dtype=torch.int64,
                         device=dev)
    fn = getattr(common.load_library(), name + "_phases_f32")
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * len(dims)
                   + [ctypes.c_float] * len(scalars) + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(a.data_ptr(), b.data_ptr(), x.data_ptr(), work.data_ptr(),
                 stamps.data_ptr(), *dims, *scalars, plan.clusters,
                 plan.tile, plan.smem_bytes,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = common.load_library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: phase-stamped launch failed: {msg}")
    return x, stamps
