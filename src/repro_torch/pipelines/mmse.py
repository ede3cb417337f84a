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
(``csrc/mmse_equalize.cu``, K2); a lane too large for shared memory
keeps G in a device work buffer, reads H and y in place and factors G
by panels (:func:`~repro_torch.pipelines.cholesky_solve.chol_panel_plan`).

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
    + [ctypes.c_int] * 3,
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


def mmse_equalize_fused(h: torch.Tensor, y: torch.Tensor, *,
                        sigma2: float = 0.1,
                        eps: float = DEFAULT_EPS) -> torch.Tensor:
    """h: (B,M,N) per-subcarrier channels, y: (B,M,K) observations
    -> x: (B,N,K) equalized symbols; float32, contiguous.  K2 on a CUDA
    tensor (one launch for the whole chain; a lane past shared memory in
    a device work buffer), its plain version on a CPU one."""
    dev = check_f32("mmse_equalize", h, y)
    bsz, m, n = h.shape
    b2, m2, k = y.shape
    if not (m == m2 and bsz == b2 and m >= n):
        raise ValueError(f"mmse_equalize: shapes {tuple(h.shape)}, "
                         f"{tuple(y.shape)}")
    if dev.type == "cpu":
        return mmse_equalize_plain(h, y, sigma2=sigma2, eps=eps)
    x = torch.empty((bsz, n, k), dtype=torch.float32, device=dev)
    if bsz:
        work = _KERNEL.work_buffer(dev, bsz, m, n, k)
        _KERNEL.launch(dev, (m, n, k), h.data_ptr(), y.data_ptr(),
                       x.data_ptr(), data_ptr(work), bsz, m, n, k, sigma2,
                       eps, *global_plan_args(work, n, k), work=work)
    return x


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
