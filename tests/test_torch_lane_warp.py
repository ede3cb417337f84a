"""The warp forms of K2, K3, K5 and K6 on the CPU: their plans, and the
warp chain's schedule (``csrc/warp_chain.cuh``) emulated in torch.

A warp form runs a lane on one warp, a CTA of 32 threads, a thread owning
whole rows (row t, and past 32 rows row rows - 1 - t), the factor's steps
ordered by one ``__syncwarp`` each.  Here the plan is checked at every
slot-mix and DAG shape (its form by n, the lane's shared memory within
the 227 KB a CTA may opt into, refusal past the warp form's limits), and
a pure-torch emulation of the factor's schedule (test code, not a version
in the package) checks that every trailing element of every step is
updated by exactly one thread, how K3's row pairing deals the work, and
that the chain run in the kernel's element order agrees with
``cholesky_chain_plain`` and takes the rank-deficient path on the same
columns.  The kernels themselves are held to their CTA forms bit for bit
by the ``gpu`` tests and ``chip_smoke.py``.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

C = importlib.import_module("repro_torch.pipelines.cholesky_solve")
M = importlib.import_module("repro_torch.pipelines.mmse")
P = importlib.import_module("repro_torch.pipelines.pusch")
W = importlib.import_module("repro_torch.pipelines.warp_chain")

CARD_SMEM_BYTES = 232448      # dynamic shared memory a block may use, sm_90
SLOT_SIZES = (8, 12, 16, 24, 32)      # the slot mixes' and DAGs' n
EMULATED = (8, 12, 16, 24, 32)


def _split_dims(n):
    return n + 4, n, 2                  # m, n, k of a slot-mix lane


def _chain_dims(n):
    return n, 2 * n, n + 4, 2           # n, p, m, k of a DAG lane


# ---------------- the plans ----------------

@pytest.mark.parametrize("n", range(1, 97))
def test_split_plan_form_by_n(n):
    """K3 (and K2, on the same slot-mix lane: a warp up to n = 32, its
    wide form past it)."""
    m, _, k = _split_dims(n)
    assert M.mmse_split_plan(m, n, k) == ("warp" if n <= 32 else "cta")
    assert M.mmse_split_plan(m, n, k, form="cta") == "cta"
    assert M.mmse_form(m, n, k) == ("warp" if n <= 32 else "wide")
    assert M.mmse_form(m, n, k, form="cta") == "cta"


@pytest.mark.parametrize("n", range(1, 41))
def test_pusch_plan_form_by_n(n):
    """K6 (and K5, its first stage, on the same DAG lane)."""
    dims = _chain_dims(n)
    assert P.pusch_chain_plan(*dims) == ("warp" if n <= 32 else "cta")
    assert P.pusch_chain_plan(*dims, form="cta") == "cta"
    assert P.channel_estimate_plan(*dims[:3]) == ("warp" if n <= 32
                                                   else "cta")
    assert P.channel_estimate_plan(*dims[:3], form="cta") == "cta"


@pytest.mark.parametrize("n", SLOT_SIZES)
def test_every_slot_and_dag_shape_fits_the_opt_in(n):
    """Every slot-mix and DAG lane takes the warp form within the 227 KB a
    CTA may opt into; at n = 32 a lane of K3 takes 17,984 bytes (12 an SM
    by shared memory), one of K6 10,976, of K2 10,400 and of K5
    10,672."""
    assert M.mmse_split_plan(*_split_dims(n), form="warp") == "warp"
    assert P.pusch_chain_plan(*_chain_dims(n), form="warp") == "warp"
    assert M.mmse_form(*_split_dims(n), form="warp") == "warp"
    assert P.channel_estimate_plan(*_chain_dims(n)[:3], form="warp") == \
        "warp"
    assert M.mmse_split_warp_smem(*_split_dims(n)) <= CARD_SMEM_BYTES
    assert P.pusch_warp_smem(*_chain_dims(n)) <= CARD_SMEM_BYTES
    assert M.mmse_warp_smem(*_split_dims(n)) <= CARD_SMEM_BYTES
    assert M.mmse_split_warp_smem(36, 32, 2) == 17984
    assert P.pusch_warp_smem(32, 64, 36, 2) == 10976
    assert M.mmse_warp_smem(36, 32, 2) == 10400
    assert P.pusch_warp_smem(32, 64, 36, 0) == 10672


def test_lane_bytes_follow_their_formulas():
    """4 (max(2n P(2n), 2 m n4 + 2 m k) + S(2n, k)) for K3,
    4 (max((n + m) (min(p, 32) | 1), n P(n) + n P(m)) + m k + S(n, k) +
    n) for K6 (K5: k = 0) and 4 (m P(n) + m k + n P(n) + S(n, k)) for K2,
    each part rounded to 16 bytes; P the pitch, 4 modulo 8 and past rows
    + 3, S the chain's scratch."""
    up = lambda x: -(-x // 4) * 4                                # noqa: E731
    for rows in range(1, 65):
        pitch = W.warp_pitch(rows)
        assert pitch % 8 == 4 and pitch >= rows + 4
        assert W.warp_scratch_floats(rows, 2) == 2 * (up(rows) + 4) + 6
    for n in range(1, 33):
        for m, k in ((n, 1), (n + 4, 2), (2 * n + 3, 8)):
            n4 = up(n)
            assert M.mmse_split_warp_smem(m, n, k) == 4 * up(
                up(max(2 * n * W.warp_pitch(2 * n), 2 * m * n4 + 2 * m * k))
                + W.warp_scratch_floats(2 * n, k))
            p = 2 * n
            for kk in (k, 0):
                assert P.pusch_warp_smem(n, p, m, kk) == 4 * up(
                    up(max((n + m) * (min(p, 32) | 1),
                           n * W.warp_pitch(n) + n * W.warp_pitch(m)))
                    + up(m * kk) + W.warp_scratch_floats(n, kk) + n)
            assert M.mmse_warp_smem(m, n, k) == 4 * (
                m * W.warp_pitch(n) + up(m * k) + n * W.warp_pitch(n)
                + up(W.warp_scratch_floats(n, k)))


def test_warp_form_refused_past_its_limits():
    with pytest.raises(ValueError, match="no warp form"):
        M.mmse_split_plan(37, 33, 2, form="warp")
    with pytest.raises(ValueError, match="no warp form"):
        M.mmse_split_plan(36, 32, 9, form="warp")
    with pytest.raises(ValueError, match="no warp form"):
        P.pusch_chain_plan(33, 66, 37, 2, form="warp")
    with pytest.raises(ValueError, match="no warp form"):
        P.pusch_chain_plan(32, 64, 36, 9, form="warp")
    # K6's stage-1 tiles: 36 Gram tiles + 8 x 12 cross tiles > 128
    assert P.pusch_warp_units(32, 48) > 128
    with pytest.raises(ValueError, match="no warp form"):
        P.pusch_chain_plan(32, 64, 48, 2, form="warp")
    assert P.pusch_chain_plan(32, 64, 48, 2) == "cta"
    # a lane past a CTA's 227 KB: K3 at m = 1000 antennas
    assert M.mmse_split_warp_smem(1000, 32, 2) > CARD_SMEM_BYTES
    assert M.mmse_split_plan(1000, 32, 2) == "cta"
    with pytest.raises(ValueError, match="form"):
        M.mmse_split_plan(36, 32, 2, form="global")
    # K2: past n = 32 or k = 8; K5: past n = 32 or its tiles four a thread
    with pytest.raises(ValueError, match="no warp form"):
        M.mmse_form(37, 33, 2, form="warp")
    with pytest.raises(ValueError, match="no warp form"):
        M.mmse_form(36, 32, 9, form="warp")
    assert M.mmse_form(36, 32, 9) == "wide"
    with pytest.raises(ValueError, match="no warp form"):
        P.channel_estimate_plan(33, 66, 37, form="warp")
    with pytest.raises(ValueError, match="no warp form"):
        P.channel_estimate_plan(32, 64, 48, form="warp")
    assert P.channel_estimate_plan(32, 64, 48) == "cta"
    with pytest.raises(ValueError, match="form"):
        P.channel_estimate_plan(32, 64, 36, form="wide")


def test_form_the_lane_cannot_take_is_refused_on_every_device():
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(                             # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    planes = (t(2, 12, 8), t(2, 12, 8), t(2, 12, 2), t(2, 12, 2))
    want = M.mmse_equalize_split_plain(*planes)
    for form in (None, "warp", "cta"):
        assert torch.equal(M.mmse_equalize_split_fused(*planes, form=form),
                           want)
    for bad in ("global", "lanes"):
        with pytest.raises(ValueError, match="form"):
            M.mmse_equalize_split_fused(*planes, form=bad)
    wide = (t(2, 36, 33), t(2, 36, 33), t(2, 36, 2), t(2, 36, 2))
    with pytest.raises(ValueError, match="no warp form"):
        M.mmse_equalize_split_fused(*wide, form="warp")
    pilots = (t(2, 8, 16), t(2, 12, 16), t(2, 12, 2))
    with pytest.raises(ValueError, match="form"):
        P.pusch_chain_fused(*pilots, form="global")
    assert torch.equal(P.pusch_chain_fused(*pilots, form="cta"),
                       P.pusch_chain_plain(*pilots))
    h, y = t(2, 12, 8), t(2, 12, 2)
    for form in (None, "warp", "wide", "cta"):
        assert torch.equal(M.mmse_equalize_fused(h, y, form=form),
                           M.mmse_equalize_plain(h, y))
    with pytest.raises(ValueError, match="no warp form"):
        M.mmse_equalize_fused(t(2, 40, 36), t(2, 40, 2), form="warp")
    with pytest.raises(ValueError, match="form"):
        M.mmse_equalize_fused(h, y, form="global")
    for form in (None, "warp", "cta"):
        assert torch.equal(P.channel_estimate_fused(*pilots[:2], form=form),
                           P.channel_estimate_plain(*pilots[:2]))
    with pytest.raises(ValueError, match="no warp form"):
        P.channel_estimate_fused(t(2, 33, 8), t(2, 37, 8), form="warp")


# ---------------- the schedule ----------------

def _warp_rows(rows):
    """The rows each of a warp's 32 threads owns in a lane of ``rows``
    rows (``warp_row`` in ``csrc/warp_chain.cuh``): row t, and past 32
    rows also row rows - 1 - t."""
    return tuple((t,) * (t < rows) + (rows - 1 - t,) * (rows - 1 - t >= 32)
                 for t in range(32))


@pytest.mark.parametrize("rows", [1, 7, 16, 31, 32, 33, 48, 63, 64])
def test_warp_rows_cover_every_row_once(rows):
    owned = [r for mine in _warp_rows(rows) for r in mine]
    assert sorted(owned) == list(range(rows))
    assert max(len(mine) for mine in _warp_rows(rows)) == (
        1 if rows <= 32 else 2)


def _updates(rows, k):
    """The trailing elements each thread updates at step k: (i, j) for
    its rows i > k and j = k+1 .. i."""
    return [[(i, j) for i in mine if i > k for j in range(k + 1, i + 1)]
            for mine in _warp_rows(rows)]


@pytest.mark.parametrize("n", EMULATED)
@pytest.mark.parametrize("kernel", ["K3", "K6"])
def test_every_trailing_element_updated_by_exactly_one_thread(n, kernel):
    rows = 2 * n if kernel == "K3" else n
    for k in range(rows):
        done = [e for mine in _updates(rows, k) for e in mine]
        want = [(i, j) for i in range(k + 1, rows)
                for j in range(k + 1, i + 1)]
        assert sorted(done) == want
        assert len(set(done)) == len(done)


def test_k3_row_pairing_deals_the_triangle_evenly():
    """At 2n = 64 rows each thread owns 65 elements of the lower triangle
    (rows t and 63 - t), and at every step no thread updates more than
    the longest row left, 63 - k elements: the least any schedule of
    whole rows can take; threads whose two rows are both live update
    63 - 2k each."""
    rows = 64
    assert all(sum(r + 1 for r in mine) == rows + 1
               for mine in _warp_rows(rows))
    for k in range(rows):
        counts = [len(mine) for mine in _updates(rows, k)]
        assert max(counts) == rows - 1 - k
        both = [c for t, c in enumerate(counts) if t > k]
        assert all(c == rows - 1 - 2 * k for c in both)


def _spd(rng, b, n):
    x = rng.standard_normal((b, n, n)).astype(np.float32)
    return torch.from_numpy(x @ x.swapaxes(-1, -2)
                            + n * np.eye(n, dtype=np.float32))


def _emulated_chain(a, thresh, y):
    """The warp chain in the kernel's element order: at step k every
    thread takes the pivot and col[j] = a[j][k] * inv from the raw
    column, scales its rows' column-k element, updates its rows'
    right-hand sides by the solution row and subtracts col[i] * col[j]
    from its rows, j = k+1 .. i; then back substitution a row a thread
    (the owner of row k divides, the owners of the rows above take row k
    of L).  Returns x and whether each step's pivot passed."""
    a, y = a.clone(), y.clone()
    rows = a.shape[-1]
    owners = _warp_rows(rows)
    ok_steps = []
    for k in range(rows):
        akk = a[:, k, k].clone()
        ok = akk > thresh
        inv = torch.where(ok, torch.rsqrt(torch.maximum(akk, thresh)), 0.0)
        ok_steps.append(ok)
        col = a[:, :, k] * inv[:, None]
        col[:, k] = torch.where(ok, akk * inv, 1.0)
        yk = y[:, k] * inv[:, None]
        for i in (i for mine in owners for i in mine if i >= k):
            a[:, i, k] = col[:, i]
            y[:, i] = yk if i == k else y[:, i] - col[:, i, None] * yk
            a[:, i, k + 1:i + 1] = (a[:, i, k + 1:i + 1]
                                    - col[:, i, None] * col[:, k + 1:i + 1])
    for k in range(rows - 1, -1, -1):
        xk = y[:, k] / a[:, k, k][:, None]
        for i in (i for mine in owners for i in mine if i <= k):
            y[:, i] = xk if i == k else y[:, i] - a[:, k, i][:, None] * xk
    return y, torch.stack(ok_steps, dim=1)


def _plain_ok_steps(a, thresh):
    """Whether each step of the plain chain's factor passes its pivot."""
    rows = torch.arange(a.shape[-1])
    y = torch.zeros((a.shape[0], a.shape[-1], 1))
    ok = []
    for k in range(a.shape[-1]):
        ok.append(a[:, k, k] > thresh)
        a, y = C.factor_forward_step(k, a, y, rows, thresh)
    return torch.stack(ok, dim=1)


def _deficient_lanes(rng, b, rows):
    """SPD lanes with lane 1 of rank rows - 2 (two rows of X repeated) and
    lane 2 all zero but its last diagonal entry."""
    x = rng.standard_normal((b, rows, rows)).astype(np.float32)
    x[1, rows // 2] = x[1, 0]
    x[1, rows - 1] = x[1, 1]
    a = x @ x.swapaxes(-1, -2)
    a[2] = 0.0
    a[2, -1, -1] = 1.0
    return torch.from_numpy(a.astype(np.float32))


@pytest.mark.parametrize("n", EMULATED)
@pytest.mark.parametrize("kernel", ["K3", "K6 chain 1", "K6 chain 2", "K2",
                                    "K5"])
def test_emulated_chain_agrees_with_the_plain_chain(n, kernel):
    """The warp chain in the kernel's element order (K3's 2n rows two a
    thread; K6's first chain with its m = n + 4 antennas as right-hand
    sides, its second with k = 2; K2's chain, K6's second, at k = 3, an
    odd instance of its registers; K5's, K6's first, on lanes of its own)
    agrees with cholesky_chain_plain to 1e-6 relative on seeded SPD
    lanes, and takes the rank-deficient path on the same columns of
    deficient lanes."""
    rows = 2 * n if kernel == "K3" else n
    m = {"K6 chain 1": n + 4, "K5": n + 4, "K2": 3}.get(kernel, 2)
    rng = np.random.default_rng(rows * 7 + m + 1000 * (kernel == "K5"))
    for a in (_spd(rng, 3, rows), _deficient_lanes(rng, 3, rows)):
        y = torch.from_numpy(
            rng.standard_normal((3, rows, m)).astype(np.float32))
        want = C.cholesky_chain_plain(a, y, eps=C.DEFAULT_EPS)
        thresh = C.pivot_threshold(a, torch.arange(rows), eps=C.DEFAULT_EPS)
        got, ok = _emulated_chain(a, thresh, y)
        scale = want.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)
        assert bool(((got - want).abs() / scale <= 1e-6).all()), kernel
        assert torch.equal(ok, _plain_ok_steps(a, thresh))
    assert not bool(ok.all())          # the deficient lanes took the path
