"""K2's wide form on the CPU: its plan, and its schedule
(``mmse_wide_kernel`` in ``csrc/mmse_equalize.cu``) emulated in torch.

Past n = 32, while the lane's CTA form fits shared memory, K2 runs a lane
on one CTA of W warps holding the Gram's lower 4 x 4 tiles and y's in
registers, thread t owning tile t (the triangle's dealt column by
column, so that finished tiles idle whole warps).  Here the plan is
checked (W the fewest warps holding the tiles one a thread, refusal past
shared memory on every device), a pure-Python emulation of the tile
ownership (test code, not a version in the package) checks that at every
factor step every live element of the trailing triangle and of y is
updated by exactly one thread, each element's updates coming in k order
and ending where its column (row of y) is set, and that each step's
published column and solution row are written once; a torch emulation of
the chain in the tiles' order agrees with ``cholesky_chain_plain`` and
takes the rank-deficient path on the same columns; and K2's plain
version is held to the reference's Pallas kernel (interpret mode) at a
mid width.  The kernel itself is held to its CTA form bit for bit by the
``gpu`` tests and ``chip_smoke.py``.
"""
import importlib
from collections import defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.pipelines import mmse_equalize_pallas  # noqa: E402

from conftest import assert_close  # noqa: E402

C = importlib.import_module("repro_torch.pipelines.cholesky_solve")
M = importlib.import_module("repro_torch.pipelines.mmse")
common = importlib.import_module("repro_torch.kernels.common")

WIDE_NS = (33, 40, 64, 97, 128, 168)


# ---------------- the plan ----------------

@pytest.mark.parametrize("n", range(33, 200))
def test_wide_form_by_n(n):
    """Past n = 32 the wide form takes a lane up to n = 168 at m = n + 4,
    k = 2 (where the CTA form leaves shared memory); past it the lane is
    the CTA form's (which the global form then serves)."""
    m = n + 4
    want = "wide" if n <= 168 else "cta"
    assert M.mmse_form(m, n, 2) == want
    assert M.mmse_wide_fits(m, n, 2) == (n <= 168)
    assert M.mmse_form(m, n, 2, form="cta") == "cta"
    if n <= 168:
        w = M.mmse_wide_plan(m, n, 2)
        assert 32 * w >= M.mmse_wide_units(n, 2) > 16 * w or w == 2
        assert M.mmse_wide_smem(m, n, 2, w) <= common.MAX_SMEM_BYTES


def test_wide_tiles_a_thread():
    """At n = 128, k = 2 the lane has 528 Gram tiles and 32 of y, one a
    thread on 32 warps; at n = 168, k = 9 it has 1029, more than a CTA's
    1024 threads, so no wide form takes it."""
    assert M.mmse_wide_units(128, 2) == 528 + 32
    assert M.mmse_wide_plan(132, 128, 2) == 32
    assert M.mmse_wide_plan(172, 168, 2) == 32
    assert M.mmse_wide_plan(44, 40, 2) == 4
    assert M.mmse_wide_plan(37, 33, 2) == 2
    assert M.mmse_wide_units(168, 9) == 1029
    assert M.mmse_wide_plan(172, 168, 9) == 0
    assert M.mmse_form(172, 168, 9) == "cta"
    assert M.mmse_wide_smem(132, 128, 2, 32) == 71008
    up = lambda x: -(-x // 4) * 4                                # noqa: E731
    for n in WIDE_NS:
        for m, k, w in ((n, 1, 2), (n + 4, 2, 8), (2 * n, 9, 32)):
            assert M.mmse_wide_smem(m, n, k, w) == 4 * (
                m * up(n) + m * up(k) + 2 * up(n) + 2 * up(k) + 2 * w)


# the fastest W of the ``scripts/lane_phases.py --forms`` sweep (PERF.md
# §6): (n, W on 32 lanes, W at B = 3276)
SWEEP_BEST = ((40, 16, 4), (64, 16, 8), (97, 16, 16), (128, 32, 32),
              (168, 32, 32))


@pytest.mark.parametrize("n,few,many", SWEEP_BEST)
def test_wide_plan_by_lanes(n, few, many):
    """W does not hang on lanes: the fewest warps holding the tiles one a
    thread, the sweep's fastest W at B = 3276 at every width it read and
    on 32 lanes at the served n = 128 (and 168); on 32 lanes at n = 40-97,
    which no path serves, the sweep's fastest W (16) also holds the
    tiles."""
    m = n + 4
    w = M.mmse_wide_plan(m, n, 2)
    assert w == many
    assert few >= w and (w == few or n < 128)
    assert 32 * few >= M.mmse_wide_units(n, 2)


def test_wide_form_refused_past_shared_memory(monkeypatch):
    """At n = 169 (m = 173, k = 2) the CTA form leaves shared memory, so
    the wide form is refused (the lane takes the global form, as before);
    with no shared memory at all no form in it is taken.  The refusals
    come on the CPU too."""
    assert not M.mmse_wide_fits(173, 169, 2)
    with pytest.raises(ValueError, match="no wide form"):
        M.mmse_form(173, 169, 2, form="wide")
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((2, 173, 169)).astype(
        np.float32))
    y = torch.from_numpy(rng.standard_normal((2, 173, 2)).astype(np.float32))
    with pytest.raises(ValueError, match="no wide form"):
        M.mmse_equalize_fused(h, y, form="wide")
    with pytest.raises(ValueError, match="form"):
        M.mmse_equalize_fused(h, y, form="global")
    monkeypatch.setattr(common, "MAX_SMEM_BYTES", 0)
    assert M.mmse_form(132, 128, 2) == "cta"
    assert M.mmse_form(36, 32, 2) == "cta"
    with pytest.raises(ValueError, match="no wide form"):
        M.mmse_form(132, 128, 2, form="wide")


def test_every_form_runs_the_plain_version_on_the_cpu():
    """On a CPU tensor each form the lane takes answers with the plain
    version (the forms are the card's)."""
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.standard_normal((2, 44, 40)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((2, 44, 2)).astype(np.float32))
    want = M.mmse_equalize_plain(h, y)
    for form in (None, "wide", "cta"):
        assert torch.equal(M.mmse_equalize_fused(h, y, form=form), want)


# ---------------- the schedule ----------------

def _units(n, k):
    """The wide form's tiles in the kernel's order (``col_tri_tile``'s
    lower triangle column by column, then y's row by row): (I, J, is a
    tile of y)."""
    tiles, ktiles = -(-n // 4), -(-k // 4)
    tri = [(i, j, False) for j in range(tiles) for i in range(j, tiles)]
    return tri + [(i, j, True) for i in range(tiles) for j in range(ktiles)]


def _owned(n, k, warps):
    """The tiles each thread of ``warps`` warps holds: unit t, or none
    past the units."""
    units, threads = _units(n, k), 32 * warps
    assert len(units) <= threads
    return [units[t:t + 1] for t in range(threads)]


def _step_ops(unit, kk, n, k):
    """What one tile does at step kk, as the kernel's loop: (element,
    "update" or "set"), the elements in the lane (rows and columns < n,
    the lower triangle; y's columns < k), and the tile's publishes of
    column kk + 1 and row kk + 1 of y."""
    i0, j0, is_y = unit
    kt, dk = divmod(kk, 4)
    ops, pub = [], []
    if (i0 if is_y else j0) >= kt:
        for q in range(4):
            for v in range(4):
                i, j = 4 * i0 + q, 4 * j0 + v
                if is_y:
                    op = ("update" if i0 > kt or q > dk else
                          "set" if q == dk else None)
                    if op and i < n and j < k:
                        ops.append((("y", i, j), op))
                else:
                    op = ("update" if j0 > kt or v > dk else
                          "set" if v == dk else None)
                    if op and j <= i < n and (op == "update" or i >= kk):
                        ops.append((("a", i, j), op))
    k1 = kk + 1
    if k1 < n:
        if not is_y and j0 == k1 // 4:
            pub += [("col", 4 * i0 + q) for q in range(4)
                    if k1 <= 4 * i0 + q < n]
        if is_y and i0 == k1 // 4:
            pub += [("row", 4 * j0 + v) for v in range(4) if 4 * j0 + v < k]
    return ops, pub


@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("n", WIDE_NS)
def test_every_live_element_updated_once_a_step_in_k_order(n, k):
    """At the plan's W and every W past it (the C entry takes them) and
    every step kk: the elements updated are
    exactly the trailing triangle (kk < j <= i) and the rows of y below
    kk, each by one thread; column kk of L (rows kk..n-1) and row kk of y
    are set by one thread; column kk + 1 and row kk + 1 of y are
    published by one thread each.  So each element sees its updates at
    steps 0, 1, ..., then its set, in order."""
    plan = M.mmse_wide_plan(n + 4, n, k)
    for warps in (w for w in M.WIDE_WARPS if w >= plan):
        owned = _owned(n, k, warps)
        history = defaultdict(list)
        for kk in range(n):
            seen, pubs = [], []
            for mine in owned:
                for unit in mine:
                    ops, pub = _step_ops(unit, kk, n, k)
                    seen += ops
                    pubs += pub
            assert len(set(e for e, _ in seen)) == len(seen)
            updates = sorted(e for e, op in seen if op == "update")
            sets = sorted(e for e, op in seen if op == "set")
            assert updates == sorted(
                [("a", i, j) for i in range(kk + 1, n)
                 for j in range(kk + 1, i + 1)]
                + [("y", i, c) for i in range(kk + 1, n) for c in range(k)])
            assert sets == sorted([("a", i, kk) for i in range(kk, n)]
                                  + [("y", kk, c) for c in range(k)])
            if kk + 1 < n:
                assert sorted(pubs) == sorted(
                    [("col", i) for i in range(kk + 1, n)]
                    + [("row", c) for c in range(k)])
            for e, op in seen:
                history[e].append((kk, op))
        for (kind, i, j), ops in history.items():
            last = j if kind == "a" else i
            assert ops == [(s, "update") for s in range(last)] + \
                [(last, "set")]


@pytest.mark.parametrize("n", [64, 128, 168])
def test_finished_tiles_idle_whole_warps(n):
    """Dealt column by column, the tiles a step has finished are the
    first units: at step kk the warps holding a live tile on W = 32 are a
    run at the end, and over the last tile column at most two warps
    (the last Gram tile's and the last rows of y's) are live."""
    owned = _owned(n, 2, 32)
    warps = [sum(owned[32 * w:32 * w + 32], []) for w in range(32)]
    holding = [w for w in range(32) if warps[w]]
    live_count = []
    for kk in range(n):
        live = [w for w in holding if any(
            (i0 if is_y else j0) >= kk // 4 for i0, j0, is_y in warps[w])]
        assert live == holding[len(holding) - len(live):]
        live_count.append(len(live))
    assert max(live_count[-4:]) <= 2


def _wide_chain(a, y, thresh):
    """The chain in the wide form's order: each step every tile takes the
    published column kk (and row kk of y) and the guarded rsqrt, scales
    and subtracts as the kernel's loop; then L and y's rows solve back in
    chol_chain's order.  Returns x and whether each step passed."""
    b, n, _ = a.shape
    k = y.shape[-1]
    tiles, ktiles = -(-n // 4), -(-k // 4)
    g = torch.zeros((b, 4 * tiles, 4 * tiles))
    g[:, :n, :n] = a
    z = torch.zeros((b, 4 * tiles, 4 * ktiles))
    z[:, :n, :k] = y
    raw, rawy = g[:, :, 0].clone(), z[:, 0, :].clone()
    ok_steps = []
    for kk in range(n):
        kt, dk = divmod(kk, 4)
        akk = raw[:, kk]
        ok = akk > thresh
        inv = torch.where(ok, torch.rsqrt(torch.maximum(akk, thresh)), 0.0)
        ok_steps.append(ok)
        ng, nz = g.clone(), z.clone()
        for i0, j0, is_y in _units(n, k):
            if (i0 if is_y else j0) < kt:
                continue
            rows = slice(4 * i0, 4 * i0 + 4)
            cols = slice(4 * j0, 4 * j0 + 4)
            ci = raw[:, rows] * inv[:, None]
            if is_y:
                yk = rawy[:, cols] * inv[:, None]
                nv = z[:, rows, cols] - ci[:, :, None] * yk[:, None, :]
                for q in range(4):
                    if i0 > kt or q > dk:
                        nz[:, 4 * i0 + q, cols] = nv[:, q]
                    elif q == dk:
                        nz[:, 4 * i0 + q, cols] = yk
            else:
                cj = raw[:, cols] * inv[:, None]
                nv = g[:, rows, cols] - ci[:, :, None] * cj[:, None, :]
                for v in range(4):
                    if j0 > kt or v > dk:
                        ng[:, rows, 4 * j0 + v] = nv[:, :, v]
                    elif v == dk:
                        cq = ci.clone()
                        if i0 == kt:
                            cq[:, dk] = torch.where(ok, ci[:, dk], 1.0)
                        ng[:, rows, 4 * j0 + v] = cq
        g, z = ng, nz
        if kk + 1 < n:
            raw, rawy = g[:, :, kk + 1].clone(), z[:, kk + 1, :].clone()
    x = z[:, :n, :k].clone()
    for kk in range(n - 1, -1, -1):
        xk = x[:, kk] / g[:, kk, kk][:, None]
        x[:, :kk] = x[:, :kk] - g[:, kk, :kk, None] * xk[:, None, :]
        x[:, kk] = xk
    return x, torch.stack(ok_steps, dim=1)


def _grams(rng, b, n, deficient):
    """MMSE Grams H^T H + 0.1 I at m = n + 4; or, ``deficient``, lane 1
    of rank n - 2 (two columns of H repeated, no sigma2) and lane 2 all
    zero but its last diagonal entry."""
    h = rng.standard_normal((b, n + 4, n)).astype(np.float32)
    g = h.swapaxes(-1, -2) @ h + 0.1 * np.eye(n, dtype=np.float32)
    if deficient:
        h[1, :, n // 2] = h[1, :, 0]
        h[1, :, n - 1] = h[1, :, 1]
        g[1] = h[1].T @ h[1]
        g[2] = 0.0
        g[2, -1, -1] = 1.0
    return torch.from_numpy(g.astype(np.float32))


@pytest.mark.parametrize("n", [33, 40, 64])
def test_emulated_wide_chain_agrees_with_the_plain_chain(n):
    """The chain in the wide form's tile order agrees with
    cholesky_chain_plain to 1e-6 relative on seeded MMSE Grams (k = 2 and
    5), and takes the rank-deficient path on the same columns of
    deficient lanes."""
    rng = np.random.default_rng(n)
    for deficient in (False, True):
        for k in (2, 5):
            a = _grams(rng, 3, n, deficient)
            y = torch.from_numpy(
                rng.standard_normal((3, n, k)).astype(np.float32))
            want = C.cholesky_chain_plain(a, y, eps=C.DEFAULT_EPS)
            thresh = C.pivot_threshold(a, torch.arange(n),
                                       eps=C.DEFAULT_EPS)
            got, ok = _wide_chain(a, y, thresh)
            scale = want.abs().amax(dim=(1, 2), keepdim=True).clamp_min(
                1e-30)
            assert bool(((got - want).abs() / scale <= 1e-6).all())
            rows = torch.arange(n)
            z = torch.zeros((3, n, 1))
            plain_ok, g = [], a
            for kk in range(n):
                plain_ok.append(g[:, kk, kk] > thresh)
                g, z = C.factor_forward_step(kk, g, z, rows, thresh)
            assert torch.equal(ok, torch.stack(plain_ok, dim=1))
    assert not bool(ok.all())          # the deficient lanes took the path


# ---------------- the plain version against the reference ----------------

@pytest.mark.parametrize("n,b", [(40, 2), (33, 3)])
def test_plain_version_matches_reference_pallas_at_a_mid_width(n, b):
    """K2's plain version (what a CPU tensor runs in every form) against
    the reference's Pallas kernel in interpret mode at a width the wide
    form serves, rtol 1e-4."""
    rng = np.random.default_rng(n + b)
    h = rng.standard_normal((b, n + 4, n)).astype(np.float32)
    y = rng.standard_normal((b, n + 4, 2)).astype(np.float32)
    want = np.asarray(mmse_equalize_pallas(jnp.asarray(h), jnp.asarray(y)))
    got = M.mmse_equalize_fused(torch.from_numpy(h), torch.from_numpy(y),
                                form="wide")
    assert_close(got.numpy(), want, rtol=1e-4, name=f"K2 n={n}")
