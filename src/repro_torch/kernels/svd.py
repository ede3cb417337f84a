"""Batched one-sided Jacobi SVD (paper Fig. 6 right).

The pair loop (p, q) with q in [p+1, n) is itself an inductive (RI)
iteration domain — the inner loop's lower bound depends on the outer
iterator, exactly the stream shape REVEL encodes with a stretch
parameter.  The rotation-parameter region (div/sqrt chains) is the
non-critical dataflow; the two-column rotations are the critical vector
region.

The reference walks the pairs cyclic by rows, one at a time.  Here a
sweep is the rounds of a round-robin ordering (:func:`jacobi_rounds`),
each round n/2 disjoint pairs that rotate at once: the kernel
(``csrc/svd.cu``, K8) runs a lane on one CTA, a group of g threads a
pair (:func:`svd_plan`), with A and V in shared memory, and the plain
version runs a round's pairs as one vectorised step.  The rotations
differ from the reference's, and so do U and V; the spectrum and
U diag(S) V^T agree within the spec's rtol.

Works on (B, M, N) with M >= N; returns U (B,M,N), S (B,N), V (B,N,N)
with A ~= U * S @ V^T (singular values unsorted).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.kernels.common import CudaKernel, check_f32


# ---------------- the pair schedule ----------------

def round_pair(cols: int, r: int, i: int) -> tuple[int, int]:
    """Pair ``i`` of round ``r`` of the circle ordering of ``cols`` (even)
    columns: column cols - 1 stays, the others turn by one a round; pair 0
    joins r and cols - 1, pair i > 0 joins (r + i) and (r - i) mod
    (cols - 1).  The lower index plays p.  ``csrc/svd.cu`` round_pair is
    the same formula."""
    c1 = cols - 1
    x = r if i == 0 else (r + i) % c1
    y = c1 if i == 0 else (r - i) % c1
    return min(x, y), max(x, y)


@functools.lru_cache(maxsize=None)
def jacobi_rounds(n: int) -> tuple[tuple[tuple[int, int], ...], ...]:
    """The rounds of one sweep over ``n`` columns, each a tuple of
    disjoint pairs (p, q), p < q: for even n, n - 1 rounds of n / 2
    pairs; for odd n, a phantom column n makes n rounds, and its pair
    (always pair 0) is skipped, leaving (n - 1) / 2 pairs a round.  Every
    pair appears once a sweep.  The one source of K8's pair order, for
    the plain version and (by :func:`round_pair`) the kernel."""
    cols = n + n % 2
    return tuple(
        tuple(round_pair(cols, r, i) for i in range(n % 2, cols // 2))
        for r in range(cols - 1))


@functools.lru_cache(maxsize=None)
def _round_index(n: int, device: torch.device):
    """Each round's p and q columns as index tensors on ``device``."""
    return [tuple(torch.tensor(c, dtype=torch.long, device=device)
                  for c in zip(*pairs))
            for pairs in jacobi_rounds(n) if pairs]


# ---------------- the plain version ----------------

def _sum_rows(t: torch.Tensor) -> torch.Tensor:
    """Sum a (B, m, ...) tensor over its rows in ascending order (the
    last entry of a running sum), so a lane's answer does not depend on
    the batch it rides in: ``sum`` regroups its terms with the shape."""
    return t.cumsum(dim=1)[:, -1]


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
    V (B,N,N), the same rounds (:func:`jacobi_rounds`), each round's
    disjoint pairs rotated at once over every lane."""
    bsz, m, n = a.shape
    a = a.clone()
    v = torch.eye(n, dtype=a.dtype, device=a.device).repeat(bsz, 1, 1)
    rounds = _round_index(n, a.device)
    for _ in range(sweeps):
        for p, q in rounds:
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
    s = torch.sqrt(_sum_rows(a * a))
    u = a / torch.clamp_min(s, 1e-30)[:, None, :]
    return u, s, v


def spectrum_recon(u: torch.Tensor, s: torch.Tensor, v: torch.Tensor):
    """The view an SVD is held by, its factors being sign/order
    ambiguous: (sorted spectrum (B,N) descending, U diag(S) V^T (B,M,N))."""
    return (torch.sort(s, dim=-1, descending=True).values,
            torch.einsum("bmn,bn,bkn->bmk", u, s, v))


# ---------------- the plan ----------------

class SvdPlan(NamedTuple):
    """How K8 runs a lane: ``group`` threads a pair (n // 2 groups),
    ``threads`` a CTA (:func:`svd_threads`) and ``cache``, the 32-row
    blocks of a pair's columns a thread keeps in registers from their
    loads to the rotation (ceil(m / 32), at m <= 64), or 0 to read them
    again."""
    group: int
    threads: int
    cache: int


SVD_GROUPS = (4, 8, 16, 32)
# each group size's launch bound (``csrc/svd.cu`` max_threads): the n / 2
# pairs of the n <= 170 that shared memory admits at 4 and 8
SVD_MAX_THREADS = {4: 352, 8: 704, 16: 1024, 32: 1024}
SVD_CACHE_ROWS = 64


def svd_threads(n: int, group: int) -> int:
    """The CTA's threads: n // 2 groups of ``group``, at least a warp,
    rounded up to whole warps (``csrc/svd.cu`` svd_threads)."""
    return max(32, -(-(n // 2) * group // 32) * 32)


def svd_forms(m: int, n: int) -> list[SvdPlan]:
    """Every plan K8 can run at (m, n): each group size whose CTA stays
    within its launch bound, its rows read again and, at m <= 64, held
    in registers.  They all give the same bits."""
    caches = (0, -(-m // 32)) if 0 < m <= SVD_CACHE_ROWS else (0,)
    return [SvdPlan(g, svd_threads(n, g), c) for g in SVD_GROUPS
            for c in caches if svd_threads(n, g) <= SVD_MAX_THREADS[g]]


# The plan's model of one round (ns), a price a form (group, rows held or
# not) linear in m + n, fitted to the served kernel's time of every form
# at the cases of `scripts/svd_phases.py --forms --fit` on an H100 at
# 700 W (PERF.md, K8's run 4): a lane alone on its SM takes the round's
# chain, a + b (m + n); lanes sharing an SM share its issue, c + d (m + n)
# a warp a round.
SVD_ROUND_NS = {
    (4, False): {"chain": (663.21, 5.03), "issue": (44.03, 0.91)},
    (4, True): {"chain": (494.62, -0.99), "issue": (47.57, 0.94)},
    (8, False): {"chain": (611.70, 3.86), "issue": (44.43, 0.14)},
    (8, True): {"chain": (735.78, 4.96), "issue": (65.54, -0.13)},
    (16, False): {"chain": (658.73, 1.40), "issue": (37.90, -0.14)},
    (16, True): {"chain": (542.88, 3.45), "issue": (32.53, 0.10)},
    (32, False): {"chain": (642.38, 1.12), "issue": (22.71, 0.10)},
    (32, True): {"chain": (535.33, 1.17), "issue": (18.55, 0.19)}}
SM_COUNT = 132


def svd_lanes_an_sm(m: int, n: int, plan: SvdPlan) -> int:
    """Lanes of ``plan`` an SM holds at once, by threads, blocks and
    shared memory (each CTA also holds 1 KB; registers not counted)."""
    smem = 4 * (m * n + n * n + n)
    return max(1, min(32, 2048 // plan.threads,
                      common.SM_SMEM_BYTES // (smem + 1024)))


def _sharing(batch: int, m: int, n: int, plan: SvdPlan) -> int:
    """The lanes that share an SM at once."""
    return min(svd_lanes_an_sm(m, n, plan), -(-batch // SM_COUNT))


def _waves(batch: int, m: int, n: int, plan: SvdPlan) -> int:
    return -(-batch // (SM_COUNT * svd_lanes_an_sm(m, n, plan)))


def svd_round_ns(batch: int, m: int, n: int, plan: SvdPlan) -> float:
    """The modelled time of one round of ``batch`` lanes on ``plan``
    (:data:`SVD_ROUND_NS`): its waves times a lane's chain or the issue
    of the lanes sharing its SM, whichever is longer."""
    price = SVD_ROUND_NS[plan.group, bool(plan.cache)]
    a, b = price["chain"]
    c, d = price["issue"]
    lane = max(a + b * (m + n), _sharing(batch, m, n, plan)
               * plan.threads / 32 * (c + d * (m + n)))
    return _waves(batch, m, n, plan) * lane


def svd_plan(batch: int, m: int, n: int) -> SvdPlan:
    """The one plan of K8 for ``batch`` lanes at (m, n): of the shape's
    forms (:func:`svd_forms`), the one whose modelled round
    (:func:`svd_round_ns`) is least, the larger group and then the held
    rows on a tie.  A few lanes are bound by a round's chain, which rows
    held in registers shorten; a card full of lanes by issue, which a
    smaller group saves until its threads' rows grow long."""
    return min(svd_forms(m, n), key=lambda p: (
        svd_round_ns(batch, m, n, p), -p.group, -p.cache))


def fit_round_ns(rows) -> dict:
    """:data:`SVD_ROUND_NS` fitted by least squares to ``rows`` of (n, m,
    batch, plan, measured ns of one round of the batch: the served
    kernel's time over its sweeps' rounds), a form at a time: the rows
    whose lanes each had an SM to themselves price its chain, the others,
    each divided by its waves and by the lanes and warps sharing an SM,
    its issue.  A price with rows at fewer than two m + n keeps its
    value."""
    points = {}
    for n, m, batch, plan, ns in rows:
        k = _sharing(batch, m, n, plan)
        y = ns / _waves(batch, m, n, plan)
        if k > 1:
            y /= k * plan.threads / 32
        points.setdefault((plan.group, bool(plan.cache),
                           "chain" if k == 1 else "issue"), []).append(
            ([1.0, m + n], y))
    out = {form: dict(price) for form, price in SVD_ROUND_NS.items()}
    for (g, cached, part), pts in points.items():
        if len({x[1] for x, _ in pts}) >= 2:
            x, y = (np.array(c, dtype=float) for c in zip(*pts))
            out[g, cached][part] = tuple(
                map(float, np.linalg.lstsq(x, y, rcond=None)[0]))
    return out


# ---------------- the kernel ----------------

_KERNEL = CudaKernel(
    "svd", "svd_f32",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10,
    "svd_smem", 2,
    source="src/repro_torch/csrc/svd.cu",
    replaces="src/repro/kernels/svd.py:73 svd_pallas")


def plan_of(a: torch.Tensor, plan: SvdPlan | None) -> SvdPlan:
    """``plan`` checked against the shape's forms (ValueError off them,
    on every device), or the shape's plan."""
    bsz, m, n = a.shape
    if plan is None:
        return svd_plan(bsz, m, n)
    if plan not in svd_forms(m, n):
        raise ValueError(f"svd: {plan} is not a form of {m} x {n}")
    return plan


def launch_svd(a: torch.Tensor, u: int, s: int, v: int, sweeps: int,
               strides: tuple[int, int, int],
               plan: SvdPlan | None = None) -> None:
    """Launch K8 on CUDA lanes a (B, M, N), writing each lane's U, S and
    V at the given addresses and (u, s, v) lane strides in floats (see
    ``csrc/svd.cu``), on ``plan`` (default :func:`svd_plan`)."""
    bsz, m, n = a.shape
    plan = plan_of(a, plan)
    if bsz:
        _KERNEL.launch(a.device, (m, n), a.data_ptr(), u, s, v, bsz, m, n,
                       sweeps, *strides, *plan)


def check_svd_shape(name: str, a: torch.Tensor) -> None:
    if a.dim() != 3 or a.shape[1] < a.shape[2]:
        raise ValueError(f"{name}: expected (B, M, N) with M >= N, got "
                         f"{tuple(a.shape)}")


def svd_fused(a: torch.Tensor, sweeps: int = 12, *,
              plan: SvdPlan | None = None):
    """(B, M, N) float32, M >= N -> U (B,M,N), S (B,N), V (B,N,N), A ~=
    U diag(S) V^T, singular values unsorted.  K8 on a CUDA tensor (one
    launch, a CTA per lane, on ``plan``, default :func:`svd_plan`; every
    plan gives the same bits), its plain version on a CPU one."""
    dev = check_f32("svd", a)
    check_svd_shape("svd", a)
    plan = plan_of(a, plan)
    if dev.type == "cpu":
        return svd_plain(a, sweeps)
    bsz, m, n = a.shape
    u = torch.empty_like(a)
    s = torch.empty((bsz, n), dtype=a.dtype, device=dev)
    v = torch.empty((bsz, n, n), dtype=a.dtype, device=dev)
    launch_svd(a, u.data_ptr(), s.data_ptr(), v.data_ptr(), sweeps,
               (m * n, n, n * n), plan)
    return u, s, v


# ---------------- the phase stamps (csrc/phase_clock.cuh) ----------------

SVD_PHASES = ("load", "sums", "params", "rotate", "barrier", "epilogue")
"""The phases a stamped K8 lane is split into: A copied in and V set to
I; per round the three sums (the columns' loads, the partial products
and their reduction), the rotation's parameters, the rotation of A's and
V's columns, the round's barrier; the epilogue (norms, U, stores)."""


def svd_phases(a: torch.Tensor, sweeps: int = 12, *,
               plan: SvdPlan | None = None):
    """K8 through its phase-stamped instance on a CUDA tensor: returns
    ((u, s, v), stamps), the stamps a (batch, 2 + len(SVD_PHASES)) int64
    tensor of each lane's first and last SM clock (thread 0) and the
    cycles of each phase, which add up to last - first.  Not a launch of
    the kernel's counted entry (the served instance compiles the stamps
    out)."""
    dev = check_f32("svd", a)
    check_svd_shape("svd", a)
    if dev.type != "cuda":
        raise ValueError("svd: the phase stamps run on the card")
    bsz, m, n = a.shape
    plan = plan_of(a, plan)
    u = torch.empty_like(a)
    s = torch.empty((bsz, n), dtype=a.dtype, device=dev)
    v = torch.empty((bsz, n, n), dtype=a.dtype, device=dev)
    stamps = torch.zeros((bsz, 2 + len(SVD_PHASES)), dtype=torch.int64,
                         device=dev)
    fn = common.load_library().svd_phases_f32
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(a.data_ptr(), u.data_ptr(), s.data_ptr(), v.data_ptr(),
                 stamps.data_ptr(), bsz, m, n, sweeps, *plan,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = common.load_library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"svd: phase-stamped launch failed: {msg}")
    return (u, s, v), stamps
