"""K10 on the tiled core's thread-block clusters (``csrc/tiled_chol.cuh``,
``csrc/cholesky_solve_blocked.cu``) on the CPU: its admission, its plan,
the column groups of its right-hand sides and the deal of its chain back
substitution.

Admission is the one-CTA kernel's rule, written as a formula, so the
dispatcher's buckets do not move.  Every shape it admits has a plan on
the core (a column group of the right-hand sides at a time where k is
past the core's room), and a plan off the forms raises.  The chain back
substitution, emulated slab by slab in the kernel's order, equals the
plain chain (``back_substitution_step``) bit for bit, and its deal hands
every (row, right-hand side) element above a slab to exactly one rank
and thread at every cluster size.  (The card holds the kernel to the
same bits at every plan: ``tests/test_torch_gpu.py``.)
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

CH = importlib.import_module("repro_torch.pipelines.cholesky_solve")

CARD_SMEM = 232448                 # one block's shared memory on sm_90
SIZES = (1, 2, 4, 8)
THREADS = 256
K10 = "cholesky_solve_blocked"


def _parent_fits(n, m, bs):
    """The one-CTA K10's launch rule: its panel (n x (bs + 1)), y (n x m),
    a column of L (n) and a row of x (m) and the threshold (1 float) in
    one CTA's shared memory."""
    return 4 * (n * (bs + 1) + n * m + n + m + 1) <= CARD_SMEM


def _widths(n):
    """The panel widths block_size takes at n: every divisor of n (its
    default, 64 or 32, among them where n % 32 == 0)."""
    return [d for d in range(1, n + 1) if n % d == 0]


def _admitted(n):
    """(bs, m_max) of every width the rule admits at n, m_max the most
    right-hand sides it admits there."""
    for bs in _widths(n):
        if not _parent_fits(n, 1, bs):
            continue
        m = 1
        while _parent_fits(n, m + 1, bs):
            m += 1
        yield bs, m


@pytest.mark.parametrize("lo,hi", [(128, 320), (320, 576), (576, 833)])
def test_fits_is_the_one_cta_kernels_rule(lo, hi):
    for n in range(lo, hi):
        for bs in _widths(n):
            for m in (1, 2, 4, 33, 236, 237, 384, 385, 1000):
                assert CH.cholesky_solve_blocked_fits(n, m, bs) == \
                    _parent_fits(n, m, bs), (n, m, bs)
        if n % 32 == 0:
            assert CH.cholesky_solve_blocked_fits(n, 2) == \
                _parent_fits(n, 2, CH.block_size(n))


def test_fits_at_the_edges():
    assert CH.cholesky_solve_blocked_fits(832, 1)
    assert not CH.cholesky_solve_blocked_fits(896, 1)
    assert CH.cholesky_solve_blocked_fits(128, 384)
    assert not CH.cholesky_solve_blocked_fits(128, 385)


def test_fits_follows_max_smem(monkeypatch):
    """The rule reads common.MAX_SMEM_BYTES at each call, as the one-CTA
    kernel's launch check did (tests lower it to force global forms)."""
    from repro_torch.kernels import common
    monkeypatch.setattr(common, "MAX_SMEM_BYTES", 0)
    assert not CH.cholesky_solve_blocked_fits(128, 2)


@pytest.mark.parametrize("lo,hi", [(128, 320), (320, 576), (576, 833)])
def test_plan_fits_every_shape_fits_admits(lo, hi):
    """Every (n, bs, k) the rule admits has a form at every cluster size
    for its column groups, each CTA within the card's shared memory."""
    count = 0
    for n in range(lo, hi):
        for bs, m in _admitted(n):
            for k in sorted({1, 2, m}):
                width, groups = CH.blocked_rhs_groups(n, k, bs)
                forms = CH.chol_tiled_forms(n, width, bs, K10)
                assert {p.clusters for p in forms} == set(SIZES), (n, bs, k)
                for p in forms:
                    assert p.smem_bytes == CH.chol_tiled_smem(
                        width, bs, p.tile, n > bs)
                    assert p.smem_bytes <= CARD_SMEM, (n, bs, k)
                count += 1
    assert count > 500


@pytest.mark.parametrize("n,bs,k", [(128, 64, 2), (256, 64, 2),
                                    (128, 16, 2), (192, 48, 2),
                                    (832, 64, 1), (128, 64, 384),
                                    (239, 239, 2), (224, 224, 33)])
def test_plan_is_a_form_at_every_batch(n, bs, k):
    width, _ = CH.blocked_rhs_groups(n, k, bs)
    forms = CH.chol_tiled_forms(n, width, bs, K10)
    for batch in (1, 4, 32, 264, 3276):
        plan = CH.chol_tiled_plan(batch, n, width, bs, K10)
        assert plan in forms
        assert CH.chol_tiled_check(K10, None, batch, n, width, bs) == plan


def test_one_panel_lane_drops_the_rows_below():
    """A lane of one panel (n = bs) has no rows of L21 and no trailing
    update: its CTA holds the block at pitch align4(bs), up to bs = 239
    at one right-hand side, where the layout with rows below does not
    fit past bs = 206."""
    for bs in (64, 128, 200, 239):
        for t in (64, 128):
            assert CH.chol_tiled_smem(2, bs, t, False) < \
                CH.chol_tiled_smem(2, bs, t)
    assert CH.chol_tiled_smem(1, 239, 64, False) <= CARD_SMEM
    assert CH.chol_tiled_smem(1, 207, 64) > CARD_SMEM
    assert CH.chol_tiled_smem(1, 206, 64) <= CARD_SMEM
    assert {p.smem_bytes for p in CH.chol_tiled_forms(239, 1, 239, K10)} \
        == {CH.chol_tiled_smem(1, 239, 64, False)}


@pytest.mark.parametrize("n,bs", [(128, 64), (256, 32), (224, 224),
                                  (192, 192), (128, 128)])
def test_column_groups_cover_every_column_once(n, bs):
    kmax = CH.chol_tiled_max_k(n, bs)
    for k in list(range(0, 40)) + [kmax - 1, kmax, kmax + 1, 2 * kmax + 3,
                                   3 * kmax, 1000]:
        width, groups = CH.blocked_rhs_groups(n, k, bs)
        cols = [q for q0, q1 in groups for q in range(q0, q1)]
        assert cols == list(range(k)), (k, groups)
        assert len(groups) == -(-k // kmax)
        assert all(0 < q1 - q0 <= width for q0, q1 in groups)
        assert width <= kmax
        if groups:
            assert all(q1 - q0 == width for q0, q1 in groups[:-1])


def test_max_k_is_the_largest_that_fits():
    for n, bs in ((128, 64), (256, 64), (192, 48), (128, 16), (239, 239)):
        kmax = CH.chol_tiled_max_k(n, bs)
        for t in (64, 128):
            assert CH.chol_tiled_smem(kmax, bs, t, n > bs) <= CARD_SMEM
        assert any(CH.chol_tiled_smem(kmax + 1, bs, t, n > bs) > CARD_SMEM
                   for t in (64, 128))
    assert CH.chol_tiled_max_k(128, 64) == 236


def test_plan_off_the_forms_raises_on_the_cpu():
    a = torch.eye(128).repeat(2, 1, 1) * 4.0
    b = torch.ones(2, 128, 2)
    plan = CH.chol_tiled_plan(2, 128, 2, 64, K10)
    for bad in (plan._replace(tile=96), plan._replace(clusters=3),
                plan._replace(smem_bytes=plan.smem_bytes + 4),
                plan._replace(threads=128)):
        with pytest.raises(ValueError, match="not a form"):
            CH.cholesky_solve_blocked_fused(a, b, plan=bad)
    got = CH.cholesky_solve_blocked_fused(a, b, plan=plan)
    assert torch.equal(got, CH.cholesky_solve_blocked_plain(a, b))
    with pytest.raises(ValueError):
        CH.chol_tiled_forms(128, 2, 48, K10)        # 48 does not tile 128


@pytest.mark.parametrize("c", SIZES)
@pytest.mark.parametrize("n,bs,k", [(256, 64, 2), (192, 48, 3),
                                    (128, 16, 1), (832, 64, 2), (64, 16, 5)])
def test_chain_deal_covers_every_element_once(c, n, bs, k):
    """The kernel's loops over the elements above a slab at o, emulated
    index by index: the next slab's bs x k elements on every rank, each
    element by one thread (e from tid, stride 256); the rest dealt over
    the cluster (e from rank x 256 + tid, stride C x 256), each by one
    rank and thread.  The busiest thread's passes are what the lane model
    prices."""
    plan = CH.CholTiledPlan(c, THREADS, CH.chol_tiled_smem(k, bs, 64), 64)
    passes = 0
    for o in range(bs, n, bs):
        on = o - bs
        own = [[] for _ in range(THREADS)]
        for tid in range(THREADS):
            for e in range(tid, bs * k, THREADS):
                own[tid].append((on + e // k, e % k))
        assert sorted(x for mine in own for x in mine) == \
            [(i, q) for i in range(on, o) for q in range(k)]
        seen, most = [], 0
        for rank in range(c):
            for tid in range(THREADS):
                mine = []
                e = rank * THREADS + tid
                while e < on * k:
                    mine.append((e // k, e % k))
                    e += c * THREADS
                seen += mine
                most = max(most, len(mine))
        assert sorted(seen) == [(i, q) for i in range(on) for q in range(k)]
        passes += max(len(m) for m in own) + most
    assert CH.chol_lane_units(n, k, bs, plan, K10)["chain"] == passes * bs


def _chain_emulated(l, y, bs):
    """The kernel's chain back substitution on one lane (numpy float32,
    each product and difference rounded as the plain version rounds
    them): by slabs in reverse, the slab's diagonal block by sub-blocks of
    32 rows, the last first (a right-hand side's sub-block a row at a
    time, then the rows above in the block), then the rows above the slab
    taking its x, r descending."""
    n = l.shape[0]
    z = y.copy()
    for o in range(n - bs, -1, -bs):
        for b0 in range((bs - 1) // 32 * 32, -1, -32):
            nb = min(32, bs - b0)
            for r in range(nb - 1, -1, -1):
                g = o + b0 + r
                x = z[g] / l[g, g]
                z[g] = x
                rows = slice(o + b0, g)
                z[rows] = z[rows] - l[g, rows, None] * x[None]
            for r in range(b0 + nb - 1, b0 - 1, -1):
                g = o + r
                rows = slice(o, o + b0)
                z[rows] = z[rows] - l[g, rows, None] * z[g][None]
        for r in range(bs - 1, -1, -1):
            g = o + r
            z[:o] = z[:o] - l[g, :o, None] * z[g][None]
    return z


@pytest.mark.parametrize("n,bs,k", [(128, 64, 2), (96, 48, 3),
                                    (64, 16, 1), (72, 72, 2)])
def test_chain_order_equals_the_plain_chain_bit_for_bit(n, bs, k):
    """Each element of x takes the plain chain's subtractions in its
    order, on a deficient factor too (a zeroed column, unit pivot)."""
    rng = np.random.default_rng(n + bs)
    g = rng.standard_normal((n, n)).astype(np.float32)
    spd = g @ g.T + n * np.eye(n, dtype=np.float32)
    l = np.linalg.cholesky(spd.astype(np.float64)).astype(np.float32)
    l[n // 3 + 1:, n // 3] = 0.0
    l[n // 3, n // 3] = 1.0
    y = rng.standard_normal((n, k)).astype(np.float32)
    rows = torch.arange(n)
    want = torch.from_numpy(y)[None]
    lt = torch.from_numpy(l)[None]
    for i in range(n):
        want = CH.back_substitution_step(i, lt, want, rows, n=n)
    got = _chain_emulated(l, y, bs)
    np.testing.assert_array_equal(got.view(np.int32),
                                  want[0].numpy().view(np.int32))


def test_lane_units_price_the_chain():
    plan = CH.chol_tiled_plan(32, 256, 2, 64, K10)
    units = CH.chol_lane_units(256, 2, 64, plan, K10)
    assert units["sums"] == 0 and units["chain"] > 0
    tiled = CH.chol_lane_units(512, 2, 128, CH.chol_tiled_plan(
        32, 512, 2, 128), "cholesky_solve_tiled")
    assert tiled["chain"] == 0 and tiled["sums"] > 0
    one = CH.CholTiledPlan(1, THREADS, plan.smem_bytes, plan.tile)
    # above slabs 1..3: the next slab's 64 rows of 2 (a pass each), then
    # 0, 64 and 128 rows of 2 on one CTA (0, 1, 1 passes)
    assert CH.chol_lane_units(256, 2, 64, one, K10)["chain"] == \
        (3 + 0 + 1 + 1) * 64
    assert CH.chol_lane_units(64, 2, 64, one, K10)["chain"] == 0
