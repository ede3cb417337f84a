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

The kernel (``csrc/ssm_scan.cu``) runs the chunks of a lane (one batch,
head and a run of column tiles of P) at once on a thread-block cluster,
rank r taking chunks r, r + C, ... in order, and passes only the state
down the cluster, tile by tile; a first pass builds the gram C B^T once
per (batch, chunk) where B/C are shared (once per head where they are
not), beside C^T and B in float32 for the scan CTAs to copy in, and
each chunk's CTA builds its M once for all its columns.
:func:`ssm_plan` owns the plan (:class:`SsmPlan`: the cluster size, the
tiles a CTA and the slots it holds for the incoming state); every plan of
:func:`ssm_forms` gives the same bits (each output is one fmaf chain in
a fixed order).  What bounds it
on the card: the products, in IEEE float32 (the least work sits on the
operations side of the float32 roofline at the model shapes).  The
kernel reads its inputs through strides, so the (B, S, H, P) layout of
``ops.ssm_scan`` and shared B/C (head stride 0) need no copy.

:func:`ssm_scan_plain` follows ``_ssm_kernel`` chunk by chunk with the
batch and heads written out; a CPU tensor takes it, a CUDA tensor the
kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import common
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


# ---------------- the plan ----------------

GRAM_ROWS = 32
"""Rows of G a CTA of the gram pass (``ssm_gram_kernel``)."""


def _round16(cs: int) -> int:
    return (cs + 15) // 16 * 16


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def ssm_tile_cols(cs: int) -> int:
    """Columns of P a tile at chunk ``cs``: 64 where the chunk rounds up
    to 64 rows (a 64 x 64 tile of y on 256 threads), else 32."""
    return 64 if _round16(cs) == 64 else 32


def _b_pitch(n: int) -> int:
    """The pitch of B's rows in shared memory: N up to 4, and 4 more where
    that is a multiple of 32 floats (so the gram's float4 reads of eight
    rows at once hit every bank)."""
    n4 = _round4(n)
    return n4 + 4 if n4 % 32 == 0 else n4


def ssm_smem(cs: int, n: int, slots: int) -> int:
    """Shared memory of a scan CTA (``scan_smem`` in the kernel's source,
    which refuses a plan off it): an mbarrier pair
    a slot, then la (cs16), M^T (cs16^2), C^T (n cs16), B w (cs16 rows of
    :func:`_b_pitch`), the x tile (cs16 qt) and ``slots`` tiles of the
    incoming state (n qt), cs16 the chunk rounded up to 16, qt
    :func:`ssm_tile_cols`."""
    cs16, qt = _round16(cs), ssm_tile_cols(cs)
    return 16 * slots + 4 * (cs16 + cs16 * cs16 + n * cs16
                             + cs16 * _b_pitch(n) + cs16 * qt
                             + slots * n * qt)


def ssm_gram_smem(cs: int, n: int) -> int:
    """Shared memory of a gram CTA (``gram_smem``): C^T's 32 columns
    of its rows and B's rows up to its last, cs16 at most."""
    return 4 * (n * GRAM_ROWS + _round16(cs) * _b_pitch(n))


def ssm_lane_floats(cs: int, n: int) -> int:
    """Floats of one lane of the work buffer, laid out as a scan CTA's
    shared memory from M^T on: G (cs16 x cs16, j-major), C^T (n x cs16)
    and B (cs16 rows of :func:`_b_pitch`), all float32."""
    cs16 = _round16(cs)
    return cs16 * cs16 + n * cs16 + cs16 * _b_pitch(n)


def ssm_work_floats(batch: int, gram_heads: int, s: int, cs: int,
                    n: int) -> int:
    """Floats of the work buffer the gram pass fills: a lane
    (:func:`ssm_lane_floats`) for each (batch, gram head, chunk);
    ``gram_heads`` is 1 where B and C are shared across heads."""
    return batch * gram_heads * (s // cs) * ssm_lane_floats(cs, n)


class SsmPlan(NamedTuple):
    """A K21 plan: a lane of ``tiles`` tiles of :func:`ssm_tile_cols`
    columns on a cluster of ``clusters`` CTAs (rank r takes chunks r, r +
    clusters, ...), each holding ``slots`` slots for the incoming state's
    tiles, ``smem_bytes`` of shared memory a CTA (:func:`ssm_smem`)."""
    clusters: int
    tiles: int
    slots: int
    smem_bytes: int


def ssm_cluster_sizes(chunks: int) -> tuple:
    """The cluster sizes a lane of ``chunks`` chunks may run on: one CTA
    for one chunk, else 2, 4 and 8 up to the chunks (the card's cluster
    limit is 8)."""
    if chunks == 1:
        return (1,)
    return tuple(c for c in (2, 4, 8) if c <= chunks)


def rank_chunks(chunks: int, clusters: int, rank: int) -> range:
    """The chunks rank ``rank`` of a cluster of ``clusters`` takes, in
    order: rank, rank + clusters, ..."""
    return range(rank, chunks, clusters)


def ssm_widths(p: int, cs: int) -> tuple:
    """The tiles a CTA may own: ceil(T / g) for g = 1 .. T lanes a
    (batch, head), T the tiles of P; widest first."""
    total = -(-p // ssm_tile_cols(cs))
    return tuple(sorted({-(-total // g) for g in range(1, total + 1)},
                        reverse=True))


def ssm_groups(p: int, cs: int, tiles: int) -> int:
    """Lanes a (batch, head) at ``tiles`` tiles a CTA."""
    return -(-(-(-p // ssm_tile_cols(cs))) // tiles)


def ssm_slots(chunks: int, clusters: int, tiles: int, cs: int,
              n: int) -> int | None:
    """The slots of a form: one a tile where a rank takes more than one
    chunk (its producer, the rank before it, fills the next chunk's tiles
    before it is done with its own, and the ring back to rank 0 would
    close on fewer), else 2 (1 where 2 do not fit, or for one tile); None
    where they do not fit in shared memory."""
    cands = ((tiles,) if chunks > clusters
             else (2, 1) if tiles >= 2 else (1,))
    for slots in cands:
        if ssm_smem(cs, n, slots) <= common.MAX_SMEM_BYTES:
            return slots
    return None


def kernel_fits(cs: int, n: int) -> bool:
    """Whether the kernel launches at chunk ``cs`` and state width ``n``:
    cs <= 128, 1 <= n <= 256, its narrowest form (one tile, one slot) and
    the gram pass within :data:`~repro_torch.kernels.common.
    MAX_SMEM_BYTES` (read at each call): N <= 128 at cs = 128 and N <= 256
    at cs <= 64."""
    return (1 <= cs <= MAX_KERNEL_CHUNK and 1 <= n <= MAX_KERNEL_STATE
            and ssm_smem(cs, n, 1) <= common.MAX_SMEM_BYTES
            and ssm_gram_smem(cs, n) <= common.MAX_SMEM_BYTES)


def ssm_forms(s: int, p: int, n: int, cs: int) -> list:
    """Every plan of a lane at sequence ``s``, width ``p``, state ``n``
    and chunk ``cs`` (:func:`ssm_cluster_sizes` x :func:`ssm_widths`,
    the slots of :func:`ssm_slots`); empty where the kernel does not fit.
    Every form gives the same bits."""
    if not kernel_fits(cs, n):
        return []
    chunks = s // cs
    out = []
    for clusters in ssm_cluster_sizes(chunks):
        for tiles in ssm_widths(p, cs):
            slots = ssm_slots(chunks, clusters, tiles, cs, n)
            if slots is not None:
                out.append(SsmPlan(clusters, tiles, slots,
                                   ssm_smem(cs, n, slots)))
    return out


# The lane model the plan weighs its forms by: cycles of one SM a unit of
# :func:`ssm_lane_units`, fitted to the phase split of every form at the
# main path's shapes by ``scripts/ssm_phases.py --forms --fit``.
SSM_LANE_CYCLES = {"stage": 7869.0, "exp": 0.5223, "fma": 0.02216,
                   "hop": 4093.0}


def ssm_lane_units(s: int, p: int, n: int, cs: int, plan: SsmPlan) -> dict:
    """The work of a lane's CTA on ``plan``, in the units
    :data:`SSM_LANE_CYCLES` prices: its chunks' staging ("stage", a chunk),
    M and B w ("exp", an expf and its product an entry), its tiles' M x
    (to the end of each row's 32-row block), C h and state ("fma"), and the
    hops down the cluster ("hop")."""
    cs16, qt, n4 = _round16(cs), ssm_tile_cols(cs), _round4(n)
    terms = sum(min(cs16, 32 * (i // 32 + 1)) for i in range(cs16))
    per_rank = -(-(s // cs) // plan.clusters)
    return {"stage": per_rank, "exp": per_rank * (cs16 * cs16 + cs16 * n4),
            "fma": per_rank * plan.tiles * qt * (terms + 2 * cs16 * n4),
            "hop": plan.clusters - 1}


def ssm_lane_cycles(s: int, p: int, n: int, cs: int, plan: SsmPlan) -> float:
    """The modelled cycles of a lane's CTA on ``plan``: its units priced by
    :data:`SSM_LANE_CYCLES`."""
    return sum(units * SSM_LANE_CYCLES[key] for key, units
               in ssm_lane_units(s, p, n, cs, plan).items())


@functools.lru_cache(maxsize=None)
def _occupancy(cs16: int, clusters: int, smem: int) -> int:
    return common.cluster_occupancy("ssm_scan_clusters", cs16, clusters,
                                    smem)


def ssm_clusters_at_once(cs: int, plan: SsmPlan) -> int:
    """Clusters of ``plan`` the card holds at once: its
    ``cudaOccupancyMaxActiveClusters`` (asked once a plan), an H100's on
    the CPU (``common.clusters_at_once``)."""
    return common.clusters_at_once(
        lambda: _occupancy(_round16(cs), plan.clusters, plan.smem_bytes),
        plan.clusters, plan.smem_bytes, 1)


def _cost(batch: int, heads: int, s: int, p: int, n: int, cs: int,
          plan: SsmPlan) -> tuple:
    lanes = batch * heads * ssm_groups(p, cs, plan.tiles)
    waves = -(-lanes // ssm_clusters_at_once(cs, plan))
    return (waves * ssm_lane_cycles(s, p, n, cs, plan), plan.clusters,
            -plan.tiles, -plan.slots)


@functools.lru_cache(maxsize=4096)
def _plan(batch, heads, s, p, n, cs, limit) -> SsmPlan:
    forms = ssm_forms(s, p, n, cs)
    if not forms:
        raise ValueError(f"ssm_scan: no plan fits chunk {cs}, N {n}")
    return min(forms, key=lambda f: _cost(batch, heads, s, p, n, cs, f))


def ssm_plan(batch: int, heads: int, s: int, p: int, n: int,
             cs: int) -> SsmPlan:
    """The one plan of ``batch`` x ``heads`` lanes at (s, p, n, cs): the
    form of :func:`ssm_forms` whose waves of the clusters the card holds
    at once (:func:`ssm_clusters_at_once`) times its modelled lane
    (:func:`ssm_lane_cycles`) is least, the smaller cluster, the wider
    lane and then more slots on a tie."""
    return _plan(batch, heads, s, p, n, cs, common.MAX_SMEM_BYTES)


def ssm_check_forms(batch: int, heads: int, s: int, p: int, n: int,
                    cs: int) -> list:
    """The forms the card holds bit for bit against each other: the plan,
    then for every cluster size the form the plan's cost picks among that
    size's and its narrowest (one tile a CTA)."""
    plan = ssm_plan(batch, heads, s, p, n, cs)
    forms = ssm_forms(s, p, n, cs)
    out = [plan]
    for clusters in ssm_cluster_sizes(s // cs):
        own = [f for f in forms if f.clusters == clusters]
        for f in (min(own, key=lambda f: _cost(batch, heads, s, p, n, cs,
                                               f)),
                  min(own, key=lambda f: (f.tiles, -f.slots))):
            if f not in out:
                out.append(f)
    return out


# ---------------- the kernel ----------------

_KERNEL = CudaKernel(
    "ssm_scan", "ssm_scan_run",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 15
    + [ctypes.c_int] * 5,
    None, 1,
    source="src/repro_torch/csrc/ssm_scan.cu",
    replaces="src/repro/kernels/ssm_scan.py:75 ssm_scan_pallas")


def _gram_heads(b: torch.Tensor, c: torch.Tensor) -> int:
    """1 where B and C are shared across heads (a (B, S, N) tensor, or a
    head stride of 0 in both), else the heads."""
    if b.dim() == 3 or (b.stride(1) == 0 and c.stride(1) == 0):
        return 1
    return b.shape[1]


def _bc_strides(t: torch.Tensor) -> tuple:
    if t.dim() == 3:                       # shared across heads
        return t.stride(0), 0, t.stride(1)
    return t.stride(0), t.stride(1), t.stride(2)


def _plan_of(x, b, cs: int, plan: SsmPlan | None) -> SsmPlan:
    """``plan`` checked against the shape's forms (ValueError off them,
    on every device), or the shape's plan."""
    bs, h, s, p = x.shape
    n = b.shape[-1]
    if plan is None:
        return ssm_plan(bs, h, s, p, n, cs)
    if plan not in ssm_forms(s, p, n, cs):
        raise ValueError(f"ssm_scan: {plan} is not a form of S {s}, P {p}, "
                         f"N {n} at chunk {cs}")
    return plan


def _check_fits(cs: int, n: int) -> None:
    if not kernel_fits(cs, n):
        raise ValueError(f"ssm_scan: the kernel takes chunk <= "
                         f"{MAX_KERNEL_CHUNK} and 1 <= N <= "
                         f"{MAX_KERNEL_STATE} with a CTA within "
                         f"227 KB of shared memory (N <= 128 at chunk "
                         f"128), got chunk {cs}, N {n}")


def ssm_scan_fused(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, *, chunk: int = 128,
                   plan: SsmPlan | None = None):
    """x (B, H, S, P), a (B, H, S), b/c (B, S, N) shared or (B, H, S, N)
    per head, all float32 or all bfloat16 on one device -> (y (B, H, S,
    P), h (B, H, N, P)) in x's dtype; S must divide by min(chunk, S).
    K21 on a CUDA tensor (one launch: the gram pass and the scan, on
    ``plan``, default :func:`ssm_plan`; every plan gives the same bits;
    chunk <= 128, 1 <= N <= 256 within shared memory: N <= 128 at chunk
    128, <= 256 at chunk 64, see :func:`kernel_fits`), its plain version on
    a CPU one.  Views are taken as they are (their last axis is made
    contiguous where it is not); y has x's layout."""
    cs = _chunk(x, a, b, c, chunk)
    bs, h, s, p = x.shape
    n = b.shape[-1]
    if plan is not None:
        _plan_of(x, b, cs, plan)
    if x.device.type == "cpu":
        return ssm_scan_plain(x, a, b, c, chunk=chunk)
    _check_fits(cs, n)
    x, b, c = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, b, c))
    y = torch.empty_like(x)
    hf = torch.empty((bs, h, n, p), dtype=x.dtype, device=x.device)
    if not x.numel():
        return y, hf.zero_()
    plan = _plan_of(x, b, cs, plan)
    hg = _gram_heads(b, c)
    work = torch.empty(ssm_work_floats(bs, hg, s, cs, n),
                       dtype=torch.float32, device=x.device)
    _KERNEL.launch(x.device, (plan.smem_bytes,), x.data_ptr(),
                   a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
                   hf.data_ptr(), work.data_ptr(), bs, h, hg, s, p, n, cs,
                   *x.stride()[:3], *a.stride(), *_bc_strides(b),
                   *_bc_strides(c), *y.stride()[:3], *plan,
                   int(x.dtype == torch.bfloat16))
    return y, hf


# ---------------- the phase stamps (csrc/phase_clock.cuh) ----------------

SSM_PHASES = ("load", "scan", "M", "Mx", "state", "wait", "chain", "Ch",
              "x")
"""The phases a stamped K21 scan CTA is split into (the gram pass's CTAs
are stamped apart): the chunk's staging, the log-decay scan, M^T from G
and B scaled; per tile M x, the chunk's own state, the wait for
h_{c-1}'s tile (and the next rank's slot), the chain (h formed and sent),
C h with y stored, and the next x tile's stores."""


def ssm_phases(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, *, chunk: int = 128,
               plan: SsmPlan | None = None):
    """K21 through its phase-stamped instance on contiguous float32 CUDA
    tensors: returns ((y, h), stamps, gram_stamps, plan), stamps a (scan
    CTAs, 2 + len(SSM_PHASES)) int64 tensor of each CTA's first and last
    SM clock (thread 0) and the cycles of each phase, which add up to last
    - first, gram_stamps a (gram CTAs, 2) one of each gram pass CTA's first
    and last clock.  Not a launch of the kernel's counted entry (the served
    instances compile the stamps out)."""
    cs = _chunk(x, a, b, c, chunk)
    common.check_f32("ssm_scan", x, a, b, c)
    if x.device.type != "cuda":
        raise ValueError("ssm_scan: the phase stamps run on the card")
    bs, h, s, p = x.shape
    n = b.shape[-1]
    _check_fits(cs, n)
    plan = _plan_of(x, b, cs, plan)
    hg = 1 if b.dim() == 3 else h
    y = torch.empty_like(x)
    hf = torch.empty((bs, h, n, p), dtype=x.dtype, device=x.device)
    work = torch.empty(ssm_work_floats(bs, hg, s, cs, n),
                       dtype=torch.float32, device=x.device)
    ctas = bs * h * ssm_groups(p, cs, plan.tiles) * plan.clusters
    stamps = torch.zeros((ctas, 2 + len(SSM_PHASES)), dtype=torch.int64,
                         device=x.device)
    gram = torch.zeros((bs * hg * (s // cs) * -(-_round16(cs) // GRAM_ROWS),
                        2), dtype=torch.int64, device=x.device)
    fn = common.load_library().ssm_scan_phases_f32
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 y.data_ptr(), hf.data_ptr(), work.data_ptr(),
                 stamps.data_ptr(), gram.data_ptr(), bs, h, hg, s, p, n, cs,
                 *plan, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        msg = common.load_library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"ssm_scan: phase-stamped launch failed: {msg}")
    return (y, hf), stamps, gram, plan
