"""K7's plan and index maps as far as the CPU reaches them.

``kernels/fft.py`` ``fft_plan`` lays an n-point row of up to 1024 points
on T threads of one warp, P = n / T points each (``csrc/fft.cu``'s warp
route): each thread reads its points in bit-reversed order (from 256
points up out of the slots its warp staged them in by cp.async), pass 1
(stages 0 .. log2 P - 1) in registers, one exchange through the row's
slot, pass 2 (the other log2 T stages) in registers, contiguous stores.
Past 1024 points (the wide route) a row spans a CTA of n / 16 threads,
16 points each, its stages four a pass in registers between trips
through shared memory.  ``emulate`` runs those index maps here, driven
by the plan, with
``fft_plain``'s butterfly arithmetic (each product and sum a float32
operation of its own): the result equals ``fft_plain`` bit for bit at
every size, and holds the reference's Pallas kernel (interpret mode) at
the spec's 1e-3 at the registry sizes.  The maps' coalescing, the
shared-memory banks and the staging copies are checked from the same
plan.  The kernel itself equals
``fft_plain`` bit for bit on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fft import fft_pallas  # noqa: E402
from repro_torch import kernels as TK  # noqa: E402
from repro_torch.kernels import common as TK_COMMON  # noqa: E402

from conftest import assert_close  # noqa: E402

tfft = importlib.import_module("repro_torch.kernels.fft")

SIZES = [2 ** k for k in range(1, 11)]
WIDE_SIZES = [2 ** k for k in range(11, 15)]
WARP = 32
BANKS = 32


def _rev(v: int, bits: int) -> int:
    return int(format(v, f"0{bits}b")[::-1], 2) if bits else 0


def _slot_at(plan, a, b):
    """Where point a P + b of a row sits in the row's exchange slot."""
    return a * (plan.points + 1) + b


def _slot(plan):
    """Floats from one row's slot to the next, in each plane."""
    return plan.n + plan.threads


def _maps(plan):
    """The kernel's index maps for one row, as integer arrays.

    ``load[g, j]``: the input index thread g loads into register j (from
    device memory, or from the staged slot, where point e sits at e);
    ``put[g, j]``: where in the row's exchange slot it stores register j
    after pass 1; ``take[g, i]``: where it reads register i = q T + t
    (group c = g + T q, point c + P t) for pass 2; ``store[g, i]``: the
    output index of register i after pass 2."""
    t, p = plan.threads, plan.points
    lt, lp = plan.stages[1], plan.stages[0]
    g = np.arange(t)[:, None]
    j = np.arange(p)[None, :]
    load = t * np.array([_rev(x, lp) for x in range(p)])[None, :] \
        + np.array([_rev(x, lt) for x in range(t)])[:, None]
    put = _slot_at(plan, g, j)
    q, tt = (a[None, :] for a in np.divmod(np.arange(p), t))
    c = g + t * q
    take = _slot_at(plan, tt, c)
    store = c + p * tt
    return load, put, take, store


def _butterfly(ur, ui, vr, vi, w_r, w_i):
    """``fft_plain``'s butterfly, operation for operation."""
    tr = w_r * vr - w_i * vi
    ti = w_r * vi + w_i * vr
    return ur + tr, ui + ti, ur - tr, ui - ti


def _wide_maps(plan):
    """The wide route's index maps for one row: ``at[k][u, j]``, the row
    index register j of thread u holds in pass k (pass 0: point 16 g + j
    of x_perm, g = rev_{L-4}(u); pass k: bits b .. b + 3 are j's, b =
    min(4 k, L - 4), the others u's); ``load[u, j]``, the input index it
    loads into register j in pass 0."""
    t, p = plan.threads, plan.points
    log_n, lp = plan.n.bit_length() - 1, plan.stages[0]
    u = np.arange(t)[:, None]
    j = np.arange(p)[None, :]
    at = [(np.array([_rev(x, log_n - lp) for x in range(t)])[:, None]
           << lp) + j]
    for k in range(1, len(plan.stages)):
        b = min(lp * k, log_n - lp)
        at.append((u & ((1 << b) - 1)) | (u >> b) << (b + lp) | j << b)
    load = t * np.array([_rev(x, lp) for x in range(p)])[None, :] + u
    return at, load


def _wide_slot(plan, i):
    """Where point i of a wide row sits in its shared-memory plane."""
    return i ^ ((i >> (plan.n.bit_length() - 1 - 5)) & 31)


def emulate_wide(x_re: torch.Tensor, x_im: torch.Tensor):
    """The wide route on CPU rows (B, n), every thread at once:
    registers are the last axis of (B, T, 16) tensors, shared memory a
    (B, n) plane written and read through :func:`_wide_slot`."""
    b, n = x_re.shape
    plan = tfft.fft_plan(n)
    lp, p = plan.stages[0], plan.points
    log_n = n.bit_length() - 1
    _, wr, wi = tfft._device_tables(n, x_re.device)
    at, load = _wide_maps(plan)
    load = torch.from_numpy(load)
    re, im = x_re[:, load], x_im[:, load]                 # (B, T, P)
    u = torch.arange(plan.threads)
    for k, count in enumerate(plan.stages):
        bit = 0 if k == 0 else min(lp * k, log_n - lp)
        if k:                                             # through smem
            sr = torch.full((b, n), float("nan"))
            si = torch.full((b, n), float("nan"))
            put = torch.from_numpy(_wide_slot(plan, at[k - 1]))
            take = torch.from_numpy(_wide_slot(plan, at[k]))
            sr[:, put.flatten()] = re.reshape(b, -1)
            si[:, put.flatten()] = im.reshape(b, -1)
            re, im = sr[:, take], si[:, take]
        lo = u & ((1 << bit) - 1) if k else torch.zeros_like(u)
        for s in range(lp * k, lp * k + count):
            half = 1 << (s - bit)
            for j in range(p):
                if j & half:
                    continue
                w = (1 << s) - 1 + lo + ((j & (half - 1)) << bit)
                (re[:, :, j], im[:, :, j], re[:, :, j + half],
                 im[:, :, j + half]) = _butterfly(
                    re[:, :, j], im[:, :, j], re[:, :, j + half],
                    im[:, :, j + half], wr[w], wi[w])
    out_re = torch.full((b, n), float("nan"))
    out_im = torch.full((b, n), float("nan"))
    store = torch.from_numpy(at[-1]).flatten()
    out_re[:, store] = re.reshape(b, -1)
    out_im[:, store] = im.reshape(b, -1)
    return out_re, out_im


def emulate(x_re: torch.Tensor, x_im: torch.Tensor):
    """K7's schedule on CPU rows (B, n), every thread of every row at
    once: registers are the last axis of (B, T, P) tensors."""
    b, n = x_re.shape
    plan = tfft.fft_plan(n)
    if plan.wide:
        return emulate_wide(x_re, x_im)
    t, p = plan.threads, plan.points
    lp, lt = plan.stages
    _, wr, wi = tfft._device_tables(n, x_re.device)
    load, put, take, store = (torch.from_numpy(m) for m in _maps(plan))
    re, im = x_re[:, load], x_im[:, load]                 # (B, T, P)
    for s in range(lp):                                   # pass 1
        half = 1 << s
        for j in range(p):
            if j & half:
                continue
            w = half - 1 + (j & (half - 1))
            (re[:, :, j], im[:, :, j], re[:, :, j + half],
             im[:, :, j + half]) = _butterfly(
                re[:, :, j], im[:, :, j], re[:, :, j + half],
                im[:, :, j + half], wr[w], wi[w])
    if t > 1:                                             # the exchange
        row = _slot(plan)
        sr = torch.full((b, row), float("nan"))
        si = torch.full((b, row), float("nan"))
        sr[:, put.flatten()] = re.reshape(b, -1)
        si[:, put.flatten()] = im.reshape(b, -1)
        re, im = sr[:, take], si[:, take]
    g = torch.arange(t)
    for s2 in range(lt):                                  # pass 2
        half = 1 << s2
        base = (p << s2) - 1
        for q in range(p // t):
            c = g + t * q
            for tt in range(t):
                if tt & half:
                    continue
                w = base + c + p * (tt & (half - 1))
                i = q * t + tt
                (re[:, :, i], im[:, :, i], re[:, :, i + half],
                 im[:, :, i + half]) = _butterfly(
                    re[:, :, i], im[:, :, i], re[:, :, i + half],
                    im[:, :, i + half], wr[w], wi[w])
    out_re = torch.full((b, n), float("nan"))
    out_im = torch.full((b, n), float("nan"))
    out_re[:, store.flatten()] = re.reshape(b, -1)
    out_im[:, store.flatten()] = im.reshape(b, -1)
    return out_re, out_im


def _rows(seed, b, n):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((b, n)).astype(
        np.float32)) for _ in range(2))


@pytest.mark.parametrize("n", SIZES)
def test_plan_covers_the_row_within_a_warp(n):
    plan = tfft.fft_plan(n)
    t, p = plan.threads, plan.points
    assert plan.n == n and t * p == n
    assert 2 ** plan.stages[0] == p and 2 ** plan.stages[1] == t
    assert sum(plan.stages) == int(np.log2(n))
    assert t <= WARP and WARP % t == 0           # a row within one warp
    assert p // t in (1, 2) and p % t == 0       # whole pass-2 groups
    assert plan.rows * t == tfft.CTA_THREADS and not plan.wide
    assert plan.depth == (tfft.STAGED_DEPTH if n >= tfft.STAGED_POINTS
                          else 0)
    # both planes: STAGED_DEPTH slots a row (staged), one padded slot a
    # row (loaded straight into registers), nothing where a thread holds
    # the row
    slots = (plan.depth * plan.rows if plan.depth
             else plan.rows if t > 1 else 0)
    assert plan.smem_bytes == 4 * 2 * slots * _slot(plan)


@pytest.mark.parametrize("n", WIDE_SIZES)
def test_wide_plan_covers_the_row_within_a_cta(n):
    """Past 1024 points: n / 16 threads of 16 points, at most a CTA's
    1024; passes of four stages (the last takes what is left) cover
    log2 n; both planes of one row in shared memory."""
    plan = tfft.fft_plan(n)
    assert plan.wide and plan.threads * plan.points == n
    assert plan.points == tfft.WIDE_POINTS and plan.threads <= 1024
    assert plan.threads % WARP == 0 and plan.rows == 1
    assert plan.stages[:-1] == (4,) * (len(plan.stages) - 1)
    assert 1 <= plan.stages[-1] <= 4
    assert sum(plan.stages) == int(np.log2(n))
    assert plan.depth == 0 and plan.smem_bytes == 4 * 2 * n
    assert plan.smem_bytes <= TK_COMMON.MAX_SMEM_BYTES


@pytest.mark.parametrize("n", [65536, 32768, 48, 1, 0])
def test_plan_refuses_sizes_the_kernel_does_not_compile(n):
    with pytest.raises(ValueError):
        tfft.fft_plan(n)


@pytest.mark.parametrize("n", SIZES)
def test_maps_are_permutations_and_coalesced(n):
    """Every input point loaded once, every output point stored once,
    every exchange slot written once and read once, inside the row's
    slot; for each register the T threads of a row touch T contiguous
    floats of the row, T-aligned."""
    plan = tfft.fft_plan(n)
    t = plan.threads
    load, put, take, store = _maps(plan)
    assert sorted(load.flatten()) == list(range(n))
    assert sorted(store.flatten()) == list(range(n))
    assert sorted(put.flatten()) == sorted(take.flatten())
    assert len(set(put.flatten())) == n and put.max() < _slot(plan)
    for m in (load, store):
        for col in m.T:
            assert sorted(col) == list(range(col.min(), col.min() + t))
            assert col.min() % t == 0


@pytest.mark.parametrize("n", SIZES)
def test_shared_memory_accesses_are_free_of_bank_conflicts(n):
    """The 32 threads of a warp (32 / T rows, row r's slot ``r`` slots
    into its plane) hit 32 distinct banks at every read of a point from a
    staged slot (staging compiles from 16 points up) and, where there is
    an exchange, at every store after pass 1 and every load before pass
    2."""
    plan = tfft.fft_plan(n)
    t = plan.threads
    load, put, take, _ = _maps(plan)
    row = np.arange(WARP // t)[:, None, None] * _slot(plan)
    for m in ((load,) if n >= 16 else ()) + ((put, take) if t > 1 else ()):
        addr = (row + m[None]).reshape(WARP, -1)  # (thread, register)
        for col in addr.T:
            assert len(set(col % BANKS)) == WARP


@pytest.mark.parametrize("n", [n for n in SIZES if n >= 16])
def test_staging_copies_each_row_once_in_16_byte_pieces(n):
    """``stage_batch`` (compiled from 16 points up, where rows and slots
    are whole 16-byte pieces; the plan stages from STAGED_POINTS): lane
    l's i-th cp.async is piece c = l + 32 i of
    the batch, plane c // (R n / 4), row (c % (R n / 4)) // (n / 4),
    floats 4 k .. 4 k + 3 of the row (k = c % (n / 4)), landing at
    (plane R + row) slot + 4 k: every float of the warp's R rows, both
    planes, once, each piece 16-byte aligned at both ends."""
    plan = tfft.fft_plan(n)
    r_warp, slot = WARP // plan.threads, _slot(plan)
    assert n % 4 == 0 and slot % 4 == 0
    chunks = r_warp * n // 4
    seen = set()
    for i in range(2 * chunks // WARP):
        for lane in range(WARP):
            c = lane + WARP * i
            plane, r, k = c // chunks, c % chunks // (n // 4), c % (n // 4)
            dst = (plane * r_warp + r) * slot + 4 * k
            assert dst % 4 == 0 and (r * n + 4 * k) % 4 == 0
            seen.add((plane, r * n + 4 * k, dst - (plane * r_warp + r)
                      * slot))
    assert len(seen) == 2 * chunks
    assert {(p, e, d) for p, e, d in seen} == {
        (p, e, e % n) for p in range(2) for e in range(0, r_warp * n, 4)}


@pytest.mark.parametrize("n", WIDE_SIZES)
def test_wide_maps_are_permutations_coalesced_and_free_of_conflicts(n):
    """The wide route: each pass's map covers the row once; pass 0
    loads, for each register, contiguous floats across the CTA (x[T
    rev_4(j) + u] is point 16 g + j of x_perm) and the last pass stores
    them; each stage of a pass pairs two registers of one thread; the
    shared-memory slots are a permutation of the row, and a warp's 32
    accesses hit 32 banks at every access but the second pass's, where
    they hit 16."""
    plan = tfft.fft_plan(n)
    t, log_n = plan.threads, n.bit_length() - 1
    at, load = _wide_maps(plan)
    rev = np.array([_rev(x, log_n) for x in range(n)])
    assert np.array_equal(rev[at[0]], load)
    assert np.array_equal(at[-1], np.arange(t)[:, None]
                          + t * np.arange(plan.points)[None, :])
    slots = _wide_slot(plan, np.arange(n))
    assert sorted(slots) == list(range(n))
    for k, m in enumerate(at):
        assert sorted(m.flatten()) == list(range(n))
        for s in range(4 * k, 4 * k + plan.stages[k]):   # pairs i, i ^ 2^s
            assert np.array_equal(np.sort(m, axis=1),
                                  np.sort(m ^ (1 << s), axis=1))
        for col in _wide_slot(plan, m).reshape(t // WARP, WARP, -1):
            for warp_col in col.T:
                assert len(set(warp_col % BANKS)) == (
                    WARP // 2 if k == 1 else WARP)


@pytest.mark.parametrize("n", SIZES + WIDE_SIZES)
def test_emulated_kernel_equals_plain_bit_for_bit(n):
    xr, xi = _rows(n, 5 if n <= 1024 else 2, n)
    got = emulate(xr, xi)
    want = tfft.fft_plain(xr, xi)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_emulated_kernel_spreads_non_finite_inputs_as_plain():
    xr, xi = _rows(7, 4, 64)
    xr[0, 3] = float("inf")
    xi[1, 10] = float("nan")
    xr[2, 0] = float("-inf")
    xi[2, 0] = float("inf")
    for g, w in zip(emulate(xr, xi), tfft.fft_plain(xr, xi)):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        keep = ~torch.isnan(w)
        assert torch.equal(g[keep], w[keep])
        assert torch.isnan(w).any()


@pytest.mark.parametrize("n", TK.get("fft").sizes)
def test_emulated_kernel_matches_pallas(n):
    xr, xi = _rows(500 + n, 2, n)
    got = emulate(xr, xi)
    want = fft_pallas(jnp.asarray(xr.numpy()), jnp.asarray(xi.numpy()))
    for g, w, part in zip(got, want, ("re", "im")):
        assert_close(g.numpy(), np.asarray(w), rtol=1e-3,
                     name=f"fft n={n} {part} vs pallas")


def test_plain_version_serves_sizes_past_the_kernel_on_the_cpu():
    """Past :data:`MAX_POINTS` the card refuses (``fft_plan``); the CPU
    route still takes any power of two, as before."""
    xr, xi = _rows(3, 2, 2 * tfft.MAX_POINTS)
    got = tfft.fft_fused(xr, xi)
    want = np.fft.fft(xr.numpy().astype(np.float64)
                      + 1j * xi.numpy().astype(np.float64))
    assert_close(got[0].numpy(), want.real, rtol=1e-3, name="re")
    assert_close(got[1].numpy(), want.imag, rtol=1e-3, name="im")
