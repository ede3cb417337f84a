"""Fused MMSE equalizer: Gram product + regularize + Cholesky solve +
combine in one kernel launch — the paper's 5G wireless motivation end to
end.

Per subcarrier (one lane, one CUDA block) with channel H (m x n) and
received symbols y (m x k):

    G   = H^T H + sigma2 * I      (Gram region)
    rhs = H^T y                   (matched filter, same residency)
    x   = G^{-1} rhs              (fused factor + fwd + bwd substitution)

which is the real-valued LMMSE estimate x = (H^H H + s I)^{-1} H^H y.
Nothing leaves shared memory between the four stages
(``csrc/mmse_equalize.cu``, K2).  Up to n = 32 a lane runs on one warp,
past it on a CTA of W warps with its triangle in registers (the wide
form, :func:`mmse_form`, :func:`mmse_wide_plan`); a lane too large for
shared memory keeps G in a device work buffer, reads H and y in place
and factors G by panels
(:func:`~repro_torch.pipelines.cholesky_solve.chol_panel_plan`).

Complex channels are handled two ways:

  * the standard real expansion [[Re, -Im], [Im, Re]]
    (:func:`expand_complex_channel`) fed to K2;
  * the split re/im fast path (``csrc/mmse_equalize_split.cu``, K3):
    Gram and matched filter accumulated from the Re/Im planes directly
    (G = Hr^T Hr + Hi^T Hi + i (Hr^T Hi - (Hr^T Hi)^T), the cross term
    ONE product by antisymmetry), then the same fused Cholesky chain on
    the real-embedded 2n x 2n system.  Identical output layout
    [Re x; Im x].  Registered as the ``split_complex`` variant of the
    ``mmse_equalize`` spec; the dispatcher picks it whenever a job
    presents 4 (split) planes instead of one expanded matrix.  Up to
    n = 32 a lane runs on one warp (:func:`mmse_split_plan`), past it
    on a CTA, past shared memory by panels.

Each kernel has a plain PyTorch version in this module with the
reference's per-lane op order; a CPU tensor takes it, a CUDA tensor the
kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.common import (CudaKernel, check_f32, data_ptr,
                                        resolve_device)
from repro_torch.pipelines.cholesky_solve import (DEFAULT_EPS,
                                                  CholTiledPlan,
                                                  chol_tiled_check,
                                                  cholesky_chain_plain,
                                                  cholesky_solve_unfused,
                                                  global_plan_args,
                                                  tiled_admit,
                                                  tiled_chain_plain)
from repro_torch.pipelines.warp_chain import (LANE_PHASES, WARP_MAX_RHS,
                                              WARP_MAX_ROWS, launch_phases,
                                              warp_fits, warp_pitch,
                                              warp_plan, warp_scratch_floats)


def mmse_equalize_plain(h: torch.Tensor, y: torch.Tensor, *,
                        sigma2: float = 0.1,
                        eps: float = DEFAULT_EPS) -> torch.Tensor:
    """Plain PyTorch version of K2: h (B,M,N), y (B,M,K) -> x (B,N,K)."""
    n = h.shape[-1]
    ht = h.transpose(-1, -2)
    # ---- Gram region: G = H^T H + sigma2 I ----
    g = ht @ h
    rows = torch.arange(n, device=h.device)
    g = g + sigma2 * (rows[:, None] == rows[None, :]).to(g.dtype)
    # ---- matched filter: rhs = H^T y ----
    rhs = ht @ y
    return cholesky_chain_plain(g, rhs, eps=eps)


def mmse_equalize_split_plain(hr: torch.Tensor, hi: torch.Tensor,
                              yr: torch.Tensor, yi: torch.Tensor, *,
                              sigma2: float = 0.1,
                              eps: float = DEFAULT_EPS) -> torch.Tensor:
    """Plain PyTorch version of K3: hr/hi (B,M,N), yr/yi (B,M,K) ->
    x (B,2N,K) stacked [Re x; Im x]."""
    n = hr.shape[-1]
    # ---- split Gram region: Gr = Hs^T Hs on the stacked (2m, n) planes;
    # Gi = C - C^T from the single cross product C = Hr^T Hi ----
    hs = torch.cat([hr, hi], dim=-2)                   # (B, 2m, n)
    hst = hs.transpose(-1, -2)
    gr = hst @ hs
    c = hr.transpose(-1, -2) @ hi
    gi = c - c.transpose(-1, -2)
    # ---- split matched filter: rhs_r = Hr^T yr + Hi^T yi and
    # rhs_i = Hr^T yi - Hi^T yr, each one stacked product ----
    ys = torch.cat([yr, yi], dim=-2)                   # (B, 2m, k)
    yt = torch.cat([yi, -yr], dim=-2)
    rr = hst @ ys
    ri = hst @ yt
    # ---- real embedding of the Hermitian system (2n x 2n) ----
    rows_n = torch.arange(n, device=hr.device)
    gr = gr + sigma2 * (rows_n[:, None] == rows_n[None, :]).to(gr.dtype)
    g = torch.cat([torch.cat([gr, -gi], dim=-1),
                   torch.cat([gi, gr], dim=-1)], dim=-2)
    rhs = torch.cat([rr, ri], dim=-2)                  # (B, 2n, k)
    return cholesky_chain_plain(g, rhs, eps=eps)


_KERNEL = CudaKernel(
    "mmse_equalize", "mmse_equalize_f32",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
    + [ctypes.c_int] * 4,
    "mmse_equalize_smem", 3,
    source="src/repro_torch/csrc/mmse_equalize.cu",
    replaces="src/repro/pipelines/mmse.py:78 mmse_equalize_pallas",
    work_symbol="mmse_equalize_work")

_SPLIT_KERNEL = CudaKernel(
    "mmse_equalize_split", "mmse_equalize_split_f32",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
    + [ctypes.c_int] * 4,
    "mmse_equalize_split_smem", 3,
    source="src/repro_torch/csrc/mmse_equalize_split.cu",
    replaces="src/repro/pipelines/mmse.py:148 mmse_equalize_split_pallas",
    work_symbol="mmse_equalize_split_work")


# K2's forms in shared memory (csrc/mmse_equalize.cu): a lane on one warp
# up to n = 32 and k = 8; past it a CTA of W warps holding the Gram's
# lower 4 x 4 tiles and y's in registers, one a thread, its back
# substitution a row a thread up to 6 x 32 rows; a 128-thread CTA past
# those.
MMSE_FORMS = ("warp", "wide", "cta")
WIDE_MAX_N = 192
WIDE_WARPS = (2, 4, 8, 16, 32)


def mmse_cta_smem(m: int, n: int, k: int) -> int:
    """Shared memory of one lane of K2's CTA form (``smem_bytes``): H, y,
    G, the right-hand sides and the chain's scratch."""
    return 4 * (m * n + m * k + n * n + n * k + n + k + 1)


def mmse_warp_smem(m: int, n: int, k: int) -> int:
    """Shared memory of one lane of K2's warp form (``warp_lane_floats``):
    H at row pitch warp_pitch(n), the symbols, the system at the same
    pitch and the chain's scratch, each part rounded to 16 bytes."""
    up = lambda x: -(-x // 4) * 4                                # noqa: E731
    pitch = warp_pitch(n)
    return 4 * (m * pitch + up(m * k) + n * pitch
                + up(warp_scratch_floats(n, k)))


def mmse_warp_fits(m: int, n: int, k: int) -> bool:
    """Whether K2's warp form takes a lane: n <= 32, 1 <= k <= 8 and the
    lane within a CTA's 227 KB."""
    return (1 <= n <= 32 and 1 <= k <= WARP_MAX_RHS and m >= n
            and warp_fits(mmse_warp_smem(m, n, k)))


def mmse_wide_units(n: int, k: int) -> int:
    """The 4 x 4 register tiles of K2's wide form: the Gram's lower
    triangle and y's (``wide_units``)."""
    t = -(-n // 4)
    return t * (t + 1) // 2 + t * -(-k // 4)


def mmse_wide_smem(m: int, n: int, k: int, warps: int) -> int:
    """Shared memory of one lane of the wide form (``WideLane``): H at row
    pitch n4, y at k4, two raw columns, two raw solution rows and each
    warp's diagonal max (n4, k4: n, k rounded up to 4)."""
    n4, k4 = -(-n // 4) * 4, -(-k // 4) * 4
    return 4 * (m * n4 + m * k4 + 2 * n4 + 2 * k4 + 2 * warps)


def mmse_wide_plan(m: int, n: int, k: int) -> int:
    """The warps W of K2's wide form: the fewest of :data:`WIDE_WARPS`
    whose threads hold the lane's tiles one a thread (32 at n = 128, k =
    2, on 32 lanes and at B = 3276 alike), its shared memory within a
    CTA's 227 KB; 0 where none does.  (``scripts/lane_phases.py --forms``
    times the wide form at every W that holds the tiles.)"""
    if not (1 <= n <= WIDE_MAX_N and k >= 1 and m >= n):
        return 0
    return next((w for w in WIDE_WARPS if 32 * w >= mmse_wide_units(n, k)
                 and mmse_wide_smem(m, n, k, w) <= common.MAX_SMEM_BYTES),
                0)


def mmse_wide_fits(m: int, n: int, k: int) -> bool:
    """Whether K2's wide form takes a lane: its tiles fit a CTA one a
    thread (:func:`mmse_wide_plan`), and the lane's CTA form fits shared
    memory (past it the lane takes the global form, as before)."""
    return (bool(mmse_wide_plan(m, n, k))
            and mmse_cta_smem(m, n, k) <= common.MAX_SMEM_BYTES)


def mmse_form(m: int, n: int, k: int, form: str | None = None) -> str:
    """K2's form of a lane in shared memory: ``"warp"`` where it fits
    (:func:`mmse_warp_fits`), else ``"wide"`` where it fits
    (:func:`mmse_wide_fits`), else ``"cta"``.  ``form`` asks for one; a
    form off :data:`MMSE_FORMS`, or one past its limits, raises ValueError
    (on every device).  (A lane past shared memory takes the global form
    whatever the form says.)"""
    if form not in (None,) + MMSE_FORMS:
        raise ValueError(f"mmse_form: form {form!r}, not one of "
                         f"{MMSE_FORMS}")
    warp, wide = mmse_warp_fits(m, n, k), mmse_wide_fits(m, n, k)
    if form == "warp" and not warp:
        raise ValueError(f"mmse_form: no warp form (m = {m}, n = {n}, k = "
                         f"{k}: n <= 32, k <= {WARP_MAX_RHS})")
    if form == "wide" and not wide:
        raise ValueError(f"mmse_form: no wide form (m = {m}, n = {n}, k = "
                         f"{k}: {mmse_wide_units(n, k)} tiles, n <= "
                         f"{WIDE_MAX_N}, the CTA form in shared memory)")
    return form or ("warp" if warp else "wide" if wide else "cta")


def mmse_split_warp_smem(m: int, n: int, k: int) -> int:
    """Shared memory of one lane of K3's warp form (``warp_lane_floats``
    in ``csrc/mmse_equalize_split.cu``): the 2n x warp_pitch(2n)
    embedding written over the staged planes (columns padded to a
    multiple of 4), then the chain's scratch, each part rounded to 16
    bytes."""
    n2, n4 = 2 * n, -(-n // 4) * 4
    region = -(-max(n2 * warp_pitch(n2), 2 * m * n4 + 2 * m * k) // 4) * 4
    return 4 * (-(-(region + warp_scratch_floats(n2, k)) // 4) * 4)


def mmse_split_warp_fits(m: int, n: int, k: int) -> bool:
    """Whether K3's warp form takes a lane: 2n <= 64 rows, 1 <= k <= 8
    right-hand sides, and the lane within a CTA's 227 KB."""
    return (1 <= n and 2 * n <= WARP_MAX_ROWS and 1 <= k <= WARP_MAX_RHS
            and warp_fits(mmse_split_warp_smem(m, n, k)))


def mmse_split_plan(m: int, n: int, k: int, form: str | None = None) -> str:
    """K3's form (:func:`~repro_torch.pipelines.warp_chain.warp_plan`):
    ``"warp"`` where it fits (n <= 32, k <= 8), ``"cta"`` past it;
    ``form`` asks for one.  (A lane past shared memory takes the global
    form whatever the plan says.)"""
    return warp_plan("mmse_split_plan", mmse_split_warp_fits(m, n, k), form,
                     f"m = {m}, n = {n}, k = {k}: 2n <= {WARP_MAX_ROWS}, "
                     f"k <= {WARP_MAX_RHS}")


def _mmse_shapes(h, y):
    bsz, m, n = h.shape
    b2, m2, k = y.shape
    if not (m == m2 and bsz == b2 and m >= n):
        raise ValueError(f"mmse_equalize: shapes {tuple(h.shape)}, "
                         f"{tuple(y.shape)}")
    return bsz, m, n, k


def mmse_equalize_fused(h: torch.Tensor, y: torch.Tensor, *,
                        sigma2: float = 0.1, eps: float = DEFAULT_EPS,
                        form: str | None = None) -> torch.Tensor:
    """h: (B,M,N) per-subcarrier channels, y: (B,M,K) observations
    -> x: (B,N,K) equalized symbols; float32, contiguous.  K2 on a CUDA
    tensor (one launch for the whole chain) in ``form`` (default
    :func:`mmse_form`: a lane on a warp up to n = 32, on a CTA of
    :func:`mmse_wide_plan`'s warps past it; a lane past shared memory in
    a device work buffer), its plain version on a CPU one.  Every form
    gives the same bits; a form the lane cannot take raises ValueError on
    every device."""
    dev = check_f32("mmse_equalize", h, y)
    bsz, m, n, k = _mmse_shapes(h, y)
    form = mmse_form(m, n, k, form)
    if dev.type == "cpu":
        return mmse_equalize_plain(h, y, sigma2=sigma2, eps=eps)
    x = torch.empty((bsz, n, k), dtype=torch.float32, device=dev)
    if bsz:
        work = _KERNEL.work_buffer(dev, bsz, m, n, k)
        if work is not None:
            form = "global"
            plan = global_plan_args(work, n, k)
        else:
            wide = form == "wide"
            plan = (32 * mmse_wide_plan(m, n, k) if wide else 0, 0, 0)
        _KERNEL.launch(dev, (m, n, k), h.data_ptr(), y.data_ptr(),
                       x.data_ptr(), data_ptr(work), bsz, m, n, k, sigma2,
                       eps, *plan, {"warp": 1, "wide": 2}.get(form, 0),
                       work=work)
        if form == "warp":
            _KERNEL.launches_warp += 1
        elif form == "wide":
            _KERNEL.launches_wide += 1
    return x


def mmse_equalize_phases(h: torch.Tensor, y: torch.Tensor, *,
                         sigma2: float = 0.1, eps: float = DEFAULT_EPS):
    """K2's warp or wide form (:func:`mmse_form`'s) through its
    phase-stamped instance on a CUDA tensor: returns (x, stamps), as
    :func:`mmse_equalize_split_phases`.  Not a launch of the kernel's
    counted entry."""
    dev = check_f32("mmse_equalize", h, y)
    bsz, m, n, k = _mmse_shapes(h, y)
    form = mmse_form(m, n, k)
    if form == "cta":
        raise ValueError("mmse_equalize: the CTA form has no phase stamps")
    if dev.type != "cuda":
        raise ValueError("mmse_equalize: the phase stamps run on the card")
    x = torch.empty((bsz, n, k), dtype=torch.float32, device=dev)
    stamps = torch.zeros((bsz, 2 + len(LANE_PHASES)), dtype=torch.int64,
                         device=dev)
    threads = 32 * mmse_wide_plan(m, n, k) if form == "wide" else 32
    launch_phases("mmse_equalize_phases_f32", dev, [h, y, x, stamps],
                  [bsz, m, n, k, {"warp": 1, "wide": 2}[form], threads],
                  [sigma2, eps])
    return x, stamps


def _split_shapes(name, hr, hi, yr, yi):
    bsz, m, n = hr.shape
    b2, m2, k = yr.shape
    if not (hi.shape == hr.shape and yi.shape == yr.shape and m == m2
            and bsz == b2 and m >= n):
        raise ValueError(f"{name}: shapes {tuple(hr.shape)}, "
                         f"{tuple(hi.shape)}, {tuple(yr.shape)}, "
                         f"{tuple(yi.shape)}")
    return bsz, m, n, k


def mmse_equalize_split_fused(hr: torch.Tensor, hi: torch.Tensor,
                              yr: torch.Tensor, yi: torch.Tensor, *,
                              sigma2: float = 0.1,
                              eps: float = DEFAULT_EPS,
                              form: str | None = None) -> torch.Tensor:
    """Split re/im fused MMSE equalizer — the complex-native fast path.

    hr/hi: (B,M,N) channel planes, yr/yi: (B,M,K) observations ->
    x: (B,2N,K) stacked [Re x; Im x] (the real-expansion output layout,
    so both paths answer the same complex problem identically); float32,
    contiguous.  K3 on a CUDA tensor in ``form`` (default
    :func:`mmse_split_plan`: a lane on a warp up to n = 32, on a CTA past
    it; a lane past shared memory in a device work buffer), its plain
    version on a CPU one.  Every form gives the same bits; a form the
    lane cannot take raises ValueError on every device."""
    dev = check_f32("mmse_equalize_split", hr, hi, yr, yi)
    bsz, m, n, k = _split_shapes("mmse_equalize_split", hr, hi, yr, yi)
    form = mmse_split_plan(m, n, k, form)
    if dev.type == "cpu":
        return mmse_equalize_split_plain(hr, hi, yr, yi, sigma2=sigma2,
                                         eps=eps)
    x = torch.empty((bsz, 2 * n, k), dtype=torch.float32, device=dev)
    if bsz:
        work = _SPLIT_KERNEL.work_buffer(dev, bsz, m, n, k)
        warp = work is None and form == "warp"
        _SPLIT_KERNEL.launch(dev, (m, n, k), hr.data_ptr(), hi.data_ptr(),
                             yr.data_ptr(), yi.data_ptr(), x.data_ptr(),
                             data_ptr(work), bsz, m, n, k, sigma2, eps,
                             int(warp), *global_plan_args(work, 2 * n, k),
                             work=work)
        if warp:
            _SPLIT_KERNEL.launches_warp += 1
    return x


def mmse_equalize_split_phases(hr: torch.Tensor, hi: torch.Tensor,
                               yr: torch.Tensor, yi: torch.Tensor, *,
                               sigma2: float = 0.1,
                               eps: float = DEFAULT_EPS):
    """K3's warp form through its phase-stamped instance on a CUDA
    tensor: returns (x, stamps), the stamps a (batch, 2 +
    len(LANE_PHASES)) int64 tensor of each lane's first and last SM clock
    (thread 0 of its warp) and the cycles of each phase, which add up to
    last - first.  Not a launch of the kernel's counted entry."""
    dev = check_f32("mmse_equalize_split", hr, hi, yr, yi)
    bsz, m, n, k = _split_shapes("mmse_equalize_split", hr, hi, yr, yi)
    mmse_split_plan(m, n, k, "warp")
    if dev.type != "cuda":
        raise ValueError("mmse_equalize_split: the phase stamps run on the "
                         "card")
    x = torch.empty((bsz, 2 * n, k), dtype=torch.float32, device=dev)
    stamps = torch.zeros((bsz, 2 + len(LANE_PHASES)), dtype=torch.int64,
                         device=dev)
    launch_phases("mmse_equalize_split_phases_f32", dev,
                  [hr, hi, yr, yi, x, stamps], [bsz, m, n, k],
                  [sigma2, eps])
    return x, stamps


def mmse_equalize(h, y, *, sigma2: float = 0.1,
                  device=None) -> torch.Tensor:
    """Public wrapper: h (B,M,N), y (B,M,K) float32 arrays or tensors,
    equalized on ``device`` (default ``cuda``; ``"cpu"`` runs the plain
    version)."""
    dev = resolve_device(device)
    return mmse_equalize_fused(torch.as_tensor(h, device=dev).contiguous(),
                               torch.as_tensor(y, device=dev).contiguous(),
                               sigma2=sigma2)


def mmse_equalize_split(hr, hi, yr, yi, *, sigma2: float = 0.1,
                        device=None) -> torch.Tensor:
    """Public split-complex wrapper (see :func:`mmse_equalize`)."""
    dev = resolve_device(device)
    return mmse_equalize_split_fused(
        *(torch.as_tensor(p, device=dev).contiguous()
          for p in (hr, hi, yr, yi)), sigma2=sigma2)


def mmse_equalize_composed(h: torch.Tensor, y: torch.Tensor, *,
                           sigma2: float = 0.1) -> torch.Tensor:
    """Kernel-at-a-time baseline: library products for G = H^T H + s I
    and H^T y (outside any kernel, as in the reference), then the three
    launches of :func:`cholesky_solve_unfused` — every intermediate hits
    device memory.  h (B,M,N), y (B,M,K) float32 tensors."""
    n = h.shape[-1]
    g = torch.einsum("bmi,bmj->bij", h, h) \
        + sigma2 * torch.eye(n, dtype=h.dtype, device=h.device)
    rhs = torch.einsum("bmn,bmk->bnk", h, y)
    return cholesky_solve_unfused(g.contiguous(), rhs.contiguous())


def expand_complex_channel(hr: torch.Tensor, hi: torch.Tensor,
                           yr: torch.Tensor, yi: torch.Tensor):
    """Real expansion of a complex MIMO system: H -> [[Hr,-Hi],[Hi,Hr]]
    (2m x 2n), y -> [yr; yi] (2m x k).  The equalized output x (2n x k)
    splits back as x[:n] + 1j x[n:]."""
    top = torch.cat([hr, -hi], dim=-1)
    bot = torch.cat([hi, hr], dim=-1)
    h = torch.cat([top, bot], dim=-2)
    y = torch.cat([yr, yi], dim=-2)
    return h, y


# ---------------------------------------------------------------------------
# K14: the slab-streamed tiled MMSE equalizer (the HBM-scale variant)
# ---------------------------------------------------------------------------

def mmse_tiled_vmem_floats(m: int, n: int, bs: int, k: int) -> int:
    """The reference's per-cell working set of the tiled MMSE equalizer,
    in float32 elements: two (m, bs) channel slabs + Gram staging
    (bs, bs) + Cholesky slab (n, bs) + panel carry (2, n, bs) + rhs carry
    (n, k) + y block (m, k) + x block (n, k)."""
    return 2 * m * bs + bs * bs + 3 * n * bs + m * k + 2 * n * k


def mmse_equalize_tiled_plain(h: torch.Tensor, y: torch.Tensor, *,
                              bs: int | None = None, sigma2: float = 0.1,
                              eps: float = DEFAULT_EPS) -> torch.Tensor:
    """Plain PyTorch version of K14: h (B,M,N), y (B,M,K) -> x (B,N,K) by
    the reference's tiled algorithm: the lower (bs, bs) Gram blocks
    G(r, t) = H_r^T H_t, t <= r, with sigma2 I on the diagonal blocks,
    the matched filter H_r^T y beside each diagonal block, the threshold
    max(eps max diag G, 1e-30), then K12's tiled chain over G.  The upper
    blocks are never built (they hold zeros here) and never read."""
    bsz, m, n = h.shape
    k = y.shape[-1]
    bs = tiled_admit("mmse_equalize_tiled", n, bs,
                     lambda w: mmse_tiled_vmem_floats(m, n, w, k))
    cols_bs = torch.arange(bs, device=h.device)
    eye = (cols_bs[:, None] == cols_bs[None, :]).to(h.dtype)
    steps = n // bs
    slabs = [torch.zeros((bsz, n, bs), dtype=h.dtype, device=h.device)
             for _ in range(steps)]
    rhs = []
    dmax = torch.zeros(bsz, dtype=h.dtype, device=h.device)
    for r in range(steps):
        hrt = h[:, :, r * bs:(r + 1) * bs].transpose(-1, -2)
        for t in range(r + 1):
            gb = hrt @ h[:, :, t * bs:(t + 1) * bs]
            if t == r:
                gb = gb + sigma2 * eye
                diag = torch.diagonal(gb, dim1=-2, dim2=-1)
                dmax = torch.maximum(dmax, diag.amax(dim=-1))
            slabs[t][:, r * bs:(r + 1) * bs] = gb
        rhs.append(hrt @ y)
    thresh = torch.clamp_min(eps * dmax, 1e-30)
    return tiled_chain_plain(slabs, torch.cat(rhs, dim=1), bs=bs,
                             thresh=thresh)


_TILED_KERNEL = CudaKernel(
    "mmse_equalize_tiled", "mmse_equalize_tiled_f32",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
    + [ctypes.c_int] * 3,
    None, 1,
    source="src/repro_torch/csrc/mmse_equalize_tiled.cu",
    replaces="src/repro/pipelines/mmse.py:333 mmse_equalize_tiled")


def mmse_equalize_tiled_fused(h: torch.Tensor, y: torch.Tensor, *,
                              bs: int | None = None, sigma2: float = 0.1,
                              eps: float = DEFAULT_EPS,
                              plan: CholTiledPlan | None = None
                              ) -> torch.Tensor:
    """Slab-streamed MMSE equalizer — the HBM-scale path (the registry's
    ``tiled`` variant, n >= 512 with n % 32 == 0).  Same contract as
    :func:`mmse_equalize_fused`; slabs of ``bs`` columns (default
    ``tiled_block_size``), refused with ValueError where the reference
    asserts.  K14 on a CUDA tensor (one cluster launch on ``plan``,
    default ``chol_tiled_plan``: the lower Gram tiles into a device work
    buffer, then K12's phases over it), its plain version on a CPU one.
    Every plan gives the same bits."""
    bsz, m, n = h.shape
    b2, m2, k = y.shape
    if not (m == m2 and bsz == b2 and m >= n):
        raise ValueError(f"mmse_equalize_tiled: shapes {tuple(h.shape)}, "
                         f"{tuple(y.shape)}")
    bs = tiled_admit("mmse_equalize_tiled", n, bs,
                     lambda w: mmse_tiled_vmem_floats(m, n, w, k))
    dev = check_f32("mmse_equalize_tiled", h, y)
    plan = chol_tiled_check("mmse_equalize_tiled", plan, bsz, n, k, bs, m)
    if dev.type == "cpu":
        return mmse_equalize_tiled_plain(h, y, bs=bs, sigma2=sigma2,
                                         eps=eps)
    x = torch.empty((bsz, n, k), dtype=torch.float32, device=dev)
    if bsz:
        work = torch.empty((bsz, n, n), dtype=torch.float32, device=dev)
        _TILED_KERNEL.launch(dev, (plan.smem_bytes,), h.data_ptr(),
                             y.data_ptr(), x.data_ptr(), work.data_ptr(),
                             bsz, m, n, k, bs, sigma2, eps, plan.clusters,
                             plan.tile, plan.smem_bytes)
    return x


def mmse_equalize_tiled(h, y, *, bs: int | None = None, sigma2: float = 0.1,
                        device=None) -> torch.Tensor:
    """Public wrapper of the tiled equalizer (see :func:`mmse_equalize`)."""
    dev = resolve_device(device)
    return mmse_equalize_tiled_fused(
        torch.as_tensor(h, device=dev).contiguous(),
        torch.as_tensor(y, device=dev).contiguous(), bs=bs, sigma2=sigma2)


# The reference's "blocked MMSE Gram" ships as its tiled kernel; the
# blocked-family name resolves to it, as in the reference.
mmse_equalize_blocked = mmse_equalize_tiled
