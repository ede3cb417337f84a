"""The plan and the order argument of the panel chain that K1-K3's global
forms run (``csrc/chol_panels.cuh``), on the CPU.

The kernel factors a panel of ``bs`` columns in shared memory and then
updates the trailing lower triangle once, each element taking the panel's
products one at a time in column order; the back substitution runs by
blocks of bs rows the same way.  It claims the per-column chain's
bits at every panel width.  Here a pure-torch emulation of that schedule
(test code, not a version in the package) reproduces the plain chain
``cholesky_chain_plain`` bit for bit in float32 at ragged panel edges and
on a rank-deficient lane; and ``chol_panel_plan`` is checked for every
size the global forms may meet: it fits the card's shared memory, its
bytes are its formula's, and the shared-memory limit that picks the form
does not move it.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import common  # noqa: E402
C = importlib.import_module("repro_torch.pipelines.cholesky_solve")

CARD_SMEM_BYTES = 232448      # dynamic shared memory a block may use, sm_90
NS = range(1, 4097)


def _formula(n, m, bs):
    """The panel (n x (bs + 1)), y's panel rows (bs x m), 8 warps' two
    partials and the threshold, in float32."""
    return 4 * (n * (bs + 1) + bs * m + 2 * 8 + 1)


@pytest.mark.parametrize("m", [1, 2, 260])
def test_plan_fits_the_card_at_every_size(m):
    for n in NS:
        plan = C.chol_panel_plan(n, m)
        assert plan.threads == C.PANEL_THREADS == 256
        assert 1 <= plan.bs <= C.PANEL_WIDTH <= 64   # the C entries' widest
        assert plan.smem_bytes == _formula(n, m, plan.bs), n
        assert plan.smem_bytes <= CARD_SMEM_BYTES, n
        # the widest width of the halving ladder that lets three lanes
        # share an SM's shared memory (1 KB a block reserved), or 1
        assert C.PANEL_SMEM_TARGET == 233472 // 3 - 1024   # 228 KB an SM
        assert (plan.bs == 1 or plan.smem_bytes <= C.PANEL_SMEM_TARGET), n
        assert (plan.bs == C.PANEL_WIDTH
                or _formula(n, m, 2 * plan.bs) > C.PANEL_SMEM_TARGET), n


def test_plan_widths_come_down_as_n_grows():
    widths = [C.chol_panel_plan(n, 2).bs for n in NS]
    assert widths == sorted(widths, reverse=True)
    assert [C.chol_panel_plan(n, 2).bs for n in (97, 250, 512, 1024, 2048,
                                                 4096)] == [32, 32, 32, 16,
                                                            8, 2]


def test_shared_memory_limit_of_the_form_moves_no_plan(monkeypatch):
    """Tests and chip_smoke.py force the global form by lowering
    common.MAX_SMEM_BYTES to 0; the plan's budget is the card's own."""
    sizes = [(n, m) for n in (1, 97, 200, 250, 1024, 2048, 4096)
             for m in (1, 2, 260)]
    before = [C.chol_panel_plan(n, m) for n, m in sizes]
    monkeypatch.setattr(common, "MAX_SMEM_BYTES", 0)
    assert [C.chol_panel_plan(n, m) for n, m in sizes] == before


@pytest.mark.parametrize("bs", [1, 8, 16, 32, 64])
def test_plan_takes_each_width_that_fits(monkeypatch, bs):
    """The gpu tests and chip_smoke.py run K1 at n = 200 under each width
    by setting the plan's widest panel."""
    monkeypatch.setattr(C, "PANEL_WIDTH", bs)
    plan = C.chol_panel_plan(200, 2)
    assert plan.bs == bs and plan.smem_bytes == _formula(200, 2, bs)


@pytest.mark.parametrize("n,m", [(0, 2), (1, 0), (29100, 2)])
def test_plan_refuses_what_the_chain_cannot_run(n, m):
    """No lane, no right-hand side, or a lane whose one-column panel
    passes the card's shared memory."""
    with pytest.raises(ValueError):
        C.chol_panel_plan(n, m)


def test_plan_args_of_the_shared_form_are_zero():
    assert C.global_plan_args(None, 250, 2) == (0, 0, 0)
    assert C.global_plan_args(torch.empty(1), 250, 2) == tuple(
        C.chol_panel_plan(250, 2))


# ---------------- the order argument ----------------

def panel_chain_emulation(a, y, *, eps, bs):
    """The panel chain's schedule in torch: per panel, its bs steps on
    the panel's columns and y's panel rows; then the trailing lower
    triangle and y's rows below, each taking the panel's products one at
    a time in column order; then the back substitution by blocks of bs
    rows of L, last first, y's rows above a block taking its products
    one at a time, k descending.  Each product is rounded and subtracted
    as the plain chain does it."""
    n = a.shape[-1]
    rows = torch.arange(n)
    thresh = C.pivot_threshold(a, rows, eps=eps)
    a, y = a.clone(), y.clone()
    for o in range(0, n, bs):
        pw = min(bs, n - o)
        t0 = o + pw
        for j in range(pw):
            g = o + j
            piv = a[:, g, g].clone()
            ok = piv > thresh
            inv = torch.where(ok, torch.rsqrt(torch.maximum(piv, thresh)),
                              0.0)
            a[:, g + 1:, g] = a[:, g + 1:, g] * inv[:, None]
            a[:, g, g] = torch.where(ok, piv * inv, 1.0)
            y[:, g] = y[:, g] * inv[:, None]
            for cc in range(g + 1, t0):          # the panel's columns
                prod = a[:, cc:, g] * a[:, cc, g][:, None]
                a[:, cc:, cc] = a[:, cc:, cc] - prod
            prod = a[:, g + 1:t0, g][:, :, None] * y[:, g][:, None, :]
            y[:, g + 1:t0] = y[:, g + 1:t0] - prod
        for p in range(o, t0):                   # the trailing update
            prod = a[:, t0:, p][:, :, None] * a[:, t0:, p][:, None, :]
            a[:, t0:, t0:] = a[:, t0:, t0:] - torch.tril(prod)
            prod = a[:, t0:, p][:, :, None] * y[:, p][:, None, :]
            y[:, t0:] = y[:, t0:] - prod
    for k1 in range(n - 1, -1, -bs):             # back substitution
        k0 = max(0, k1 - bs + 1)
        for k in range(k1, k0 - 1, -1):          # the block's rows
            y[:, k] = y[:, k] / a[:, k, k][:, None]
            prod = a[:, k, k0:k][:, :, None] * y[:, k][:, None, :]
            y[:, k0:k] = y[:, k0:k] - prod
        for k in range(k1, k0 - 1, -1):          # the rows above it
            prod = a[:, k, :k0][:, :, None] * y[:, k][:, None, :]
            y[:, :k0] = y[:, :k0] - prod
    return y


def _systems(n, b=3, m=2):
    """Well-posed SPD lanes and, in lane 1, an exactly rank-deficient one
    (row 3n/5 of X copies row 3, so pivot 3n/5 falls in a later panel)."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((b, n, n + 16)).astype(np.float32)
    x[1, 3 * n // 5] = x[1, 3]
    a = x @ x.swapaxes(-1, -2)
    a[0] += n * np.eye(n, dtype=np.float32)
    a = np.tril(a) + np.swapaxes(np.tril(a, -1), -1, -2)
    return (torch.from_numpy(a),
            torch.from_numpy(rng.standard_normal((b, n, m)).astype(
                np.float32)))


@pytest.mark.parametrize("bs", [1, 8, 32])
@pytest.mark.parametrize("n", [97, 200, 250])
def test_panel_schedule_equals_the_plain_chain_bit_for_bit(n, bs):
    a, y = _systems(n)
    want = C.cholesky_chain_plain(a, y, eps=C.DEFAULT_EPS)
    got = panel_chain_emulation(a, y, eps=C.DEFAULT_EPS, bs=bs)
    assert torch.isfinite(want).all()
    # the deficient lane took the rank-deficient path (a zeroed component)
    assert (want[1] == 0).any()
    assert torch.equal(got, want)
