"""PUSCH receiver stage kernels: the DAG-served pipeline's new stages.

The end-to-end 5G PUSCH uplink receive chain (arXiv:2210.09196) is a
producer/consumer pipeline — OFDM demod (FFT) feeds pilot-based channel
estimation feeds MMSE equalization — whose stages the serving stack
schedules as a DAG (``repro_torch.kernels.DagSpec`` /
``SolverMux.submit_dag``).  This module holds the stage entry points
that are not already registered pipelines:

``channel_estimate``  (``csrc/pusch_chain.cu``, K5)
    Regularized least-squares channel estimation from pilots: given the
    known pilot block Xp (N, P) and its received observation Yp (M, P),
    solve (Xp Xp^T + ridge I) Z = Xp Yp^T and return H = Z^T (M, N) — a
    Gram product and K1's fused Cholesky chain per lane.  Up to n = 32 a
    lane runs on one warp (:func:`channel_estimate_plan`, K6's first
    stage), past it on a CTA.

``pusch_chain``  (``csrc/pusch_chain.cu``, K6)
    Channel estimate -> MMSE equalize in one launch: the lane estimates
    H from pilots and immediately consumes it for the data-symbol
    equalization, H never leaving shared memory.  Serving this entry
    instead of the two separate stages is the DAG's "stage-chained"
    mode.  Up to n = 32 a lane runs on one warp
    (:func:`pusch_chain_plan`), past it on a CTA.

``pusch_fft``  (``csrc/fft.cu``, K7)
    Stage adapter over the FFT kernel: per lane, A antenna rows of NF
    time samples -> one stacked (2, A, NF) re/im frequency buffer (the
    serving stack moves ONE array per stage output).

``svd_factor`` / ``svd_apply``  (``csrc/svd.cu``, K8 and K9)
    The non-wireless generality DAG: one-sided-Jacobi SVD packed into a
    single (M+N+1, N) factor buffer [U; V; s], then the ridge-regularized
    pseudo-inverse apply x = V diag(s / (s^2 + lam)) U^T b.

Each has a kernel wrapper (``*_fused``: the kernel on a CUDA tensor, the
plain version on a CPU tensor), a plain PyTorch version (``*_plain``)
and a device-taking public wrapper.  The plain versions accumulate every
product in a fixed order, so a lane's answer does not depend on the
batch it is served in (the DAG's stage outputs are bit-identical to a
standalone run).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (CudaKernel, check_f32,
                                        resolve_device)
from repro_torch.kernels.fft import fft_plain, launch_fft
from repro_torch.kernels.svd import (SvdPlan, check_svd_shape, launch_svd,
                                     plan_of, svd_plain)
from repro_torch.pipelines.cholesky_solve import (DEFAULT_EPS,
                                                  cholesky_chain_plain)
from repro_torch.pipelines.mmse import mmse_equalize_plain
from repro_torch.pipelines.warp_chain import (LANE_PHASES, WARP_MAX_RHS,
                                              launch_phases, warp_fits,
                                              warp_pitch, warp_plan,
                                              warp_scratch_floats)

DEFAULT_RIDGE = 1e-3
DEFAULT_LAM = 1e-3
DAG_SWEEPS = 14          # Jacobi sweeps of the served svd_factor stage


def row_products(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (B, R, T), y (B, C, T) -> (B, R, C), sum over t of
    x[:, i, t] * y[:, j, t], accumulated t = 0, 1, ... in order (the
    kernels' order) with no batch-dependent regrouping."""
    acc = torch.zeros((x.shape[0], x.shape[1], y.shape[1]), dtype=x.dtype,
                      device=x.device)
    for t in range(x.shape[-1]):
        acc = acc + x[:, :, None, t] * y[:, None, :, t]
    return acc


# ---------------- plain versions ----------------

def channel_estimate_plain(xp: torch.Tensor, yp: torch.Tensor, *,
                           ridge: float = DEFAULT_RIDGE,
                           eps: float = DEFAULT_EPS) -> torch.Tensor:
    """Plain PyTorch version of K5: xp (B,N,P), yp (B,M,P) -> H (B,M,N)."""
    n = xp.shape[1]
    g = row_products(xp, xp) + ridge * torch.eye(n, dtype=xp.dtype,
                                                  device=xp.device)
    z = cholesky_chain_plain(g, row_products(xp, yp), eps=eps)   # (B,N,M)
    return z.transpose(-1, -2).contiguous()


def pusch_chain_plain(xp: torch.Tensor, yp: torch.Tensor, y: torch.Tensor,
                      *, ridge: float = DEFAULT_RIDGE, sigma2: float = 0.1,
                      eps: float = DEFAULT_EPS) -> torch.Tensor:
    """Plain PyTorch version of K6: K5 then K2 on the H it produced.
    xp (B,N,P), yp (B,M,P), y (B,M,K) -> x (B,N,K)."""
    h = channel_estimate_plain(xp, yp, ridge=ridge, eps=eps)
    return mmse_equalize_plain(h, y, sigma2=sigma2, eps=eps)


def pusch_fft_plain(xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the K7 stage adapter: (B, A, NF) re/im ->
    (B, 2, A, NF) stacked frequency planes."""
    bsz, a, nf = xr.shape
    fr, fi = fft_plain(xr.reshape(bsz * a, nf), xi.reshape(bsz * a, nf))
    return torch.stack([fr.reshape(bsz, a, nf), fi.reshape(bsz, a, nf)],
                       dim=1)


def svd_factor_plain(a: torch.Tensor, *,
                     sweeps: int = DAG_SWEEPS) -> torch.Tensor:
    """Plain PyTorch version of the K8 stage adapter: (B, M, N) ->
    packed factors (B, M+N+1, N) = rows [U; V; s]."""
    u, s, v = svd_plain(a, sweeps)
    return torch.cat([u, v, s[:, None, :]], dim=1)


def unpack_factors(f: torch.Tensor):
    """Packed factors (B, M+N+1, N) = rows [U; V; s] -> (U, s, V)."""
    n = f.shape[-1]
    m = f.shape[1] - n - 1
    return f[:, :m], f[:, m + n], f[:, m:m + n]


def svd_apply_plain(f: torch.Tensor, b: torch.Tensor, *,
                    lam: float = DEFAULT_LAM) -> torch.Tensor:
    """Plain PyTorch version of K9: f (B, M+N+1, N), b (B, M, K) ->
    x (B, N, K) = V diag(s / (s^2 + lam)) U^T b."""
    u, s, v = unpack_factors(f)
    w = row_products(u.transpose(1, 2), b.transpose(1, 2))       # (B,N,K)
    w = (s / (s * s + lam))[:, :, None] * w
    return row_products(v, w.transpose(1, 2))


# ---------------- kernels ----------------

_CHANEST = CudaKernel(
    "channel_estimate", "channel_estimate_f32",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
    + [ctypes.c_int],
    "channel_estimate_smem", 3,
    source="src/repro_torch/csrc/pusch_chain.cu",
    replaces="src/repro/pipelines/pusch.py:92 channel_estimate_pallas")

_CHAIN = CudaKernel(
    "pusch_chain", "pusch_chain_f32",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
    + [ctypes.c_int],
    "pusch_chain_smem", 4,
    source="src/repro_torch/csrc/pusch_chain.cu",
    replaces="src/repro/pipelines/pusch.py:135 pusch_chain_pallas")

# K6's warp form: n <= 32 rows, a row a thread; the stage-1 products'
# 4 x 4 tiles at most four a thread (kWarpSlots in csrc/pusch_chain.cu)
PUSCH_WARP_MAX_N = 32
PUSCH_WARP_SLOTS = 4
PUSCH_PILOT_CHUNK = 32       # pilots staged at a time (kPilotChunk)


def pusch_warp_units(n: int, m: int) -> int:
    """The 4 x 4 tiles of K6's stage-1 products in its warp form: the
    pilot Gram's lower tiles and Xp Yp^T's."""
    t = -(-n // 4)
    return t * (t + 1) // 2 + t * -(-m // 4)


def pusch_warp_smem(n: int, p: int, m: int, k: int) -> int:
    """Shared memory of one lane of K6's warp form (``WarpLane`` in
    ``csrc/pusch_chain.cu``): the pilots and observations, 32 pilots at a
    time at row pitch min(p, 32) | 1, overwritten by L (pitch
    warp_pitch(n)) and Z (pitch warp_pitch(m)), then the symbols, the
    chains' scratch and the first chain's rsqrts, each part rounded to 16
    bytes."""
    px, ldz = min(p, PUSCH_PILOT_CHUNK) | 1, warp_pitch(m)
    region = -(-max((n + m) * px, n * warp_pitch(n) + n * ldz) // 4) * 4
    return 4 * (-(-(region + -(-m * k // 4) * 4 + warp_scratch_floats(n, k)
                    + n) // 4) * 4)


def pusch_warp_fits(n: int, p: int, m: int, k: int) -> bool:
    """Whether K6's warp form takes a lane: n <= 32, 1 <= k <= 8, its
    stage-1 tiles within four a thread and the lane within a CTA's
    227 KB."""
    return (1 <= n <= PUSCH_WARP_MAX_N and 1 <= k <= WARP_MAX_RHS
            and p >= 1 and m >= 1
            and pusch_warp_units(n, m) <= 32 * PUSCH_WARP_SLOTS
            and warp_fits(pusch_warp_smem(n, p, m, k)))


def pusch_chain_plan(n: int, p: int, m: int, k: int,
                     form: str | None = None) -> str:
    """K6's form (:func:`~repro_torch.pipelines.warp_chain.warp_plan`):
    ``"warp"`` where it fits (:func:`pusch_warp_fits`), ``"cta"`` past
    it; ``form`` asks for one."""
    return warp_plan("pusch_chain_plan", pusch_warp_fits(n, p, m, k), form,
                     f"n = {n}, p = {p}, m = {m}, k = {k}: n <= "
                     f"{PUSCH_WARP_MAX_N}, k <= {WARP_MAX_RHS}, "
                     f"{pusch_warp_units(n, m)} tiles of at most "
                     f"{32 * PUSCH_WARP_SLOTS}")


def chanest_warp_fits(n: int, p: int, m: int) -> bool:
    """Whether K5's warp form (K6's first stage) takes a lane: n <= 32,
    its tiles within four a thread and the lane (K6's at k = 0) within a
    CTA's 227 KB."""
    return (1 <= n <= PUSCH_WARP_MAX_N and p >= 1 and m >= 1
            and pusch_warp_units(n, m) <= 32 * PUSCH_WARP_SLOTS
            and warp_fits(pusch_warp_smem(n, p, m, 0)))


def channel_estimate_plan(n: int, p: int, m: int,
                          form: str | None = None) -> str:
    """K5's form (:func:`~repro_torch.pipelines.warp_chain.warp_plan`):
    ``"warp"`` where it fits (:func:`chanest_warp_fits`), ``"cta"`` past
    it; ``form`` asks for one."""
    return warp_plan("channel_estimate_plan", chanest_warp_fits(n, p, m),
                     form, f"n = {n}, p = {p}, m = {m}: n <= "
                     f"{PUSCH_WARP_MAX_N}, {pusch_warp_units(n, m)} tiles "
                     f"of at most {32 * PUSCH_WARP_SLOTS}")


_APPLY = CudaKernel(
    "svd_apply", "svd_apply_f32",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float],
    "svd_apply_smem", 3,
    source="src/repro_torch/csrc/svd.cu",
    replaces="src/repro/pipelines/pusch.py:200 svd_apply_pallas")


def _pilot_shapes(name: str, xp: torch.Tensor, yp: torch.Tensor):
    bsz, n, p = xp.shape
    b2, m, p2 = yp.shape
    if not (bsz == b2 and p == p2):
        raise ValueError(f"{name}: shapes {tuple(xp.shape)}, "
                         f"{tuple(yp.shape)}")
    return bsz, n, p, m


def channel_estimate_fused(xp: torch.Tensor, yp: torch.Tensor, *,
                           ridge: float = DEFAULT_RIDGE,
                           eps: float = DEFAULT_EPS,
                           form: str | None = None) -> torch.Tensor:
    """LS channel estimate.  xp: (B,N,P) known pilots, yp: (B,M,P)
    received pilots -> H (B,M,N); float32, contiguous.  K5 on a CUDA
    tensor in ``form`` (default :func:`channel_estimate_plan`: a lane on a
    warp up to n = 32, on a CTA past it), its plain version on a CPU one.
    Every form gives the same bits; a form the lane cannot take raises
    ValueError on every device."""
    dev = check_f32("channel_estimate", xp, yp)
    bsz, n, p, m = _pilot_shapes("channel_estimate", xp, yp)
    form = channel_estimate_plan(n, p, m, form)
    if dev.type == "cpu":
        return channel_estimate_plain(xp, yp, ridge=ridge, eps=eps)
    h = torch.empty((bsz, m, n), dtype=torch.float32, device=dev)
    if bsz:
        warp = form == "warp"
        _CHANEST.launch(dev, (n, p, m), xp.data_ptr(), yp.data_ptr(),
                        h.data_ptr(), bsz, n, p, m, ridge, eps, int(warp))
        if warp:
            _CHANEST.launches_warp += 1
    return h


def channel_estimate_phases(xp: torch.Tensor, yp: torch.Tensor, *,
                            ridge: float = DEFAULT_RIDGE,
                            eps: float = DEFAULT_EPS):
    """K5's warp form through its phase-stamped instance on a CUDA
    tensor: returns (h, stamps), as
    :func:`~repro_torch.pipelines.mmse.mmse_equalize_split_phases`.  Not
    a launch of the kernel's counted entry."""
    dev = check_f32("channel_estimate", xp, yp)
    bsz, n, p, m = _pilot_shapes("channel_estimate", xp, yp)
    channel_estimate_plan(n, p, m, "warp")
    if dev.type != "cuda":
        raise ValueError("channel_estimate: the phase stamps run on the "
                         "card")
    h = torch.empty((bsz, m, n), dtype=torch.float32, device=dev)
    stamps = torch.zeros((bsz, 2 + len(LANE_PHASES)), dtype=torch.int64,
                         device=dev)
    launch_phases("channel_estimate_phases_f32", dev, [xp, yp, h, stamps],
                  [bsz, n, p, m], [ridge, eps])
    return h, stamps


def _chain_shapes(xp, yp, y):
    bsz, n, p, m = _pilot_shapes("pusch_chain", xp, yp)
    b3, m2, k = y.shape
    if not (bsz == b3 and m == m2):
        raise ValueError(f"pusch_chain: shapes {tuple(xp.shape)}, "
                         f"{tuple(yp.shape)}, {tuple(y.shape)}")
    return bsz, n, p, m, k


def pusch_chain_fused(xp: torch.Tensor, yp: torch.Tensor, y: torch.Tensor,
                      *, ridge: float = DEFAULT_RIDGE, sigma2: float = 0.1,
                      eps: float = DEFAULT_EPS,
                      form: str | None = None) -> torch.Tensor:
    """Fused channel-estimate -> equalize.  xp: (B,N,P), yp: (B,M,P),
    y: (B,M,K) -> x (B,N,K); float32, contiguous.  K6 on a CUDA tensor
    (one launch, H never leaves the lane) in ``form`` (default
    :func:`pusch_chain_plan`: a lane on a warp up to n = 32, on a CTA
    past it), its plain version on a CPU one.  Every form gives the same
    bits; a form the lane cannot take raises ValueError on every
    device."""
    dev = check_f32("pusch_chain", xp, yp, y)
    bsz, n, p, m, k = _chain_shapes(xp, yp, y)
    form = pusch_chain_plan(n, p, m, k, form)
    if dev.type == "cpu":
        return pusch_chain_plain(xp, yp, y, ridge=ridge, sigma2=sigma2,
                                 eps=eps)
    x = torch.empty((bsz, n, k), dtype=torch.float32, device=dev)
    if bsz:
        warp = form == "warp"
        _CHAIN.launch(dev, (n, p, m, k), xp.data_ptr(), yp.data_ptr(),
                      y.data_ptr(), x.data_ptr(), bsz, n, p, m, k, ridge,
                      sigma2, eps, int(warp))
        if warp:
            _CHAIN.launches_warp += 1
    return x


def pusch_chain_phases(xp: torch.Tensor, yp: torch.Tensor, y: torch.Tensor,
                       *, ridge: float = DEFAULT_RIDGE, sigma2: float = 0.1,
                       eps: float = DEFAULT_EPS):
    """K6's warp form through its phase-stamped instance on a CUDA
    tensor: returns (x, stamps), as
    :func:`~repro_torch.pipelines.mmse.mmse_equalize_split_phases`.  Not a
    launch of the kernel's counted entry."""
    dev = check_f32("pusch_chain", xp, yp, y)
    bsz, n, p, m, k = _chain_shapes(xp, yp, y)
    pusch_chain_plan(n, p, m, k, "warp")
    if dev.type != "cuda":
        raise ValueError("pusch_chain: the phase stamps run on the card")
    x = torch.empty((bsz, n, k), dtype=torch.float32, device=dev)
    stamps = torch.zeros((bsz, 2 + len(LANE_PHASES)), dtype=torch.int64,
                         device=dev)
    launch_phases("pusch_chain_phases_f32", dev, [xp, yp, y, x, stamps],
                  [bsz, n, p, m, k], [ridge, sigma2, eps])
    return x, stamps


def pusch_fft_fused(xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """OFDM demod stage: (B, A, NF) time-domain re/im planes per antenna
    -> (B, 2, A, NF) stacked frequency planes; float32, contiguous.  The
    antenna axis folds into K7's rows, which write the stacked layout
    directly (CUDA); the plain version on a CPU tensor."""
    dev = check_f32("pusch_fft", xr, xi)
    if xr.dim() != 3 or xi.shape != xr.shape:
        raise ValueError(f"pusch_fft: shapes {tuple(xr.shape)}, "
                         f"{tuple(xi.shape)}")
    if dev.type == "cpu":
        return pusch_fft_plain(xr, xi)
    bsz, a, nf = xr.shape
    out = torch.empty((bsz, 2, a, nf), dtype=torch.float32, device=dev)
    if bsz and a:
        base = out.data_ptr()
        launch_fft(xr.view(bsz * a, nf), xi.view(bsz * a, nf), base,
                   base + 4 * a * nf, a, 2 * a * nf)
    return out


def svd_factor_fused(a: torch.Tensor, *, sweeps: int = DAG_SWEEPS,
                     plan: SvdPlan | None = None) -> torch.Tensor:
    """SVD stage: (B, M, N) -> packed factor buffer (B, M+N+1, N) = rows
    [U; V; s]; float32, contiguous.  K8 writes the packed rows directly
    (CUDA; on ``plan``, default ``svd_plan``, every plan the same bits,
    and the same bits as ``svd_fused``); the plain version on a CPU
    tensor."""
    dev = check_f32("svd_factor", a)
    check_svd_shape("svd_factor", a)
    plan = plan_of(a, plan)
    if dev.type == "cpu":
        return svd_factor_plain(a, sweeps=sweeps)
    bsz, m, n = a.shape
    f = torch.empty((bsz, m + n + 1, n), dtype=torch.float32, device=dev)
    base = f.data_ptr()
    lane = (m + n + 1) * n
    launch_svd(a, base, base + 4 * (m + n) * n, base + 4 * m * n, sweeps,
               (lane, lane, lane), plan)
    return f


def svd_apply_fused(f: torch.Tensor, b: torch.Tensor, *,
                    lam: float = DEFAULT_LAM) -> torch.Tensor:
    """Ridge-regularized pseudo-inverse apply from packed SVD factors:
    x = V diag(s / (s^2 + lam)) U^T b.  f: (B, M+N+1, N), b: (B, M, K)
    -> (B, N, K); float32, contiguous.  Equals (A^T A + lam I)^{-1} A^T b,
    so the answer is invariant to the SVD's sign/order ambiguity.  K9 on
    a CUDA tensor, its plain version on a CPU one."""
    dev = check_f32("svd_apply", f, b)
    bsz, mn1, n = f.shape
    b2, m, k = b.shape
    if not (bsz == b2 and mn1 == m + n + 1):
        raise ValueError(f"svd_apply: shapes {tuple(f.shape)}, "
                         f"{tuple(b.shape)}")
    if dev.type == "cpu":
        return svd_apply_plain(f, b, lam=lam)
    x = torch.empty((bsz, n, k), dtype=torch.float32, device=dev)
    if bsz:
        _APPLY.launch(dev, (m, n, k), f.data_ptr(), b.data_ptr(),
                      x.data_ptr(), bsz, m, n, k, lam)
    return x


# ---------------- public wrappers ----------------

def _on(device, *arrays):
    dev = resolve_device(device)
    return [torch.as_tensor(a, device=dev).contiguous() for a in arrays]


def channel_estimate(xp, yp, *, device=None) -> torch.Tensor:
    """Public wrapper of :func:`channel_estimate_fused` on ``device``
    (default ``cuda``; ``"cpu"`` runs the plain version)."""
    return channel_estimate_fused(*_on(device, xp, yp))


def pusch_chain(xp, yp, y, *, sigma2: float = 0.1,
                device=None) -> torch.Tensor:
    """Public wrapper of :func:`pusch_chain_fused` (see
    :func:`channel_estimate`)."""
    return pusch_chain_fused(*_on(device, xp, yp, y), sigma2=sigma2)


def pusch_fft(xr, xi, *, device=None) -> torch.Tensor:
    """Public wrapper of :func:`pusch_fft_fused` (see
    :func:`channel_estimate`)."""
    return pusch_fft_fused(*_on(device, xr, xi))


def svd_factor(a, *, sweeps: int = DAG_SWEEPS, device=None) -> torch.Tensor:
    """Public wrapper of :func:`svd_factor_fused` (see
    :func:`channel_estimate`)."""
    return svd_factor_fused(*_on(device, a), sweeps=sweeps)


def svd_apply(f, b, *, device=None) -> torch.Tensor:
    """Public wrapper of :func:`svd_apply_fused` (see
    :func:`channel_estimate`)."""
    return svd_apply_fused(*_on(device, f, b))
