"""The plan and the order argument of the panel chain that K4's global form
runs (``csrc/qr_panels.cuh``), and the rule that picks K16's form, on the
CPU.

The kernel takes a panel's ``bs`` reflections in shared memory and then
sweeps each column right of the panel, y's among them, once per
reflection of the panel in a tile of shared memory, a column a thread;
R's entries below the diagonal are left behind once their column's
reflection is built, and the back substitution runs by blocks of bs
rows.  It claims the per-column
chain's bits at every panel and tile width.  Here a pure-torch emulation
of that schedule (test code, not a version in the package) reproduces the
plain chain ``qr_solve_plain`` bit for bit in float32 at ragged panel and
tile edges and on rank-deficient lanes; ``qr_panel_plan`` is checked for
every lane the global form may meet: it fits the card's shared memory, its
bytes are its formula's, its widths come down a halving ladder, and the
shared-memory limit that picks the form does not move it.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import common  # noqa: E402
Q = importlib.import_module("repro_torch.pipelines.qr_solve")
T = importlib.import_module("repro_torch.kernels.trisolve")

CARD_SMEM_BYTES = 232448      # dynamic shared memory a block may use, sm_90
# the global form took 4 (m + n + k + 1) bytes of shared memory before it
# ran by panels, and a launch past 48 KB is refused without the attribute
# it never set: so it ran every lane with m + n + k + 1 <= 12288
PARENT_FLOATS = 48 * 1024 // 4


def _formula(m, k, bs, tile):
    """The panel / tile region (m x max(bs + 1, tile)), V (m x (bs +
    1)), y's block rows (bs x k), tau and w (bs each) and the threshold,
    in float32."""
    return 4 * (m * (bs + 1) + m * max(bs + 1, tile) + bs * k + 2 * bs + 1)


def _check_plan(m, n, k):
    plan = Q.qr_panel_plan(m, n, k)
    assert plan.threads == max(32, plan.tile)
    assert 1 <= plan.bs <= Q.QR_PANEL_WIDTH <= 32     # the C entry's widest
    assert 1 <= plan.tile <= Q.QR_TILE_WIDTH <= 128
    assert plan.smem_bytes == _formula(m, k, plan.bs, plan.tile), (m, k)
    assert plan.smem_bytes <= CARD_SMEM_BYTES, (m, k)
    # both widths come down one halving ladder together (1 at its foot),
    # and the rung above did not fit
    h = 0
    while (max(Q.QR_PANEL_WIDTH >> h, 1), max(Q.QR_TILE_WIDTH >> h, 1)) \
            != (plan.bs, plan.tile):
        h += 1
        assert h <= 8, (m, k, plan)
    if h:
        above = (max(Q.QR_PANEL_WIDTH >> (h - 1), 1),
                 max(Q.QR_TILE_WIDTH >> (h - 1), 1))
        assert _formula(m, k, *above) > CARD_SMEM_BYTES, (m, k)
    return plan


@pytest.mark.parametrize("k", [1, 2])
def test_plan_fits_the_card_for_every_lane_the_global_form_took(k):
    """Every m x n lane with k right-hand sides that the global form ran
    before it ran by panels (and every one past shared memory that the
    mixes send) has a plan; its shared memory does not depend on n."""
    for m in range(1, PARENT_FLOATS - k - 1):
        _check_plan(m, 1, k)
    for m in (254, 1028, 4100):
        _check_plan(m, m - 4, k)


def test_plan_fits_lanes_with_many_right_hand_sides():
    for m in (1, 7, 64, 254, 1028, 4096):
        for k in (8, 100, PARENT_FLOATS - m - 2):
            _check_plan(m, 1, k)


def test_plan_widths_come_down_as_m_grows():
    plans = [Q.qr_panel_plan(m, 1, 1) for m in range(1, 12000, 7)]
    assert [p.bs for p in plans] == sorted((p.bs for p in plans),
                                           reverse=True)
    assert [p.tile for p in plans] == sorted((p.tile for p in plans),
                                             reverse=True)
    # the mixes' K4 lanes past shared memory: two lanes an SM at 254 x
    # 250, the demoted 1024 bucket's rung on one
    assert Q.qr_panel_plan(254, 250, 1) == (64, 32, 64, 98940)
    assert Q.qr_panel_plan(1028, 1024, 1) == (32, 16, 32, 201684)


def test_shared_memory_limit_of_the_form_moves_no_plan(monkeypatch):
    """Tests and chip_smoke.py force the global form by lowering
    common.MAX_SMEM_BYTES to 0; the plan's budget is the card's own."""
    sizes = [(m, n, k) for m, n in ((1, 1), (36, 32), (132, 128),
                                    (204, 200), (254, 250), (1028, 1024))
             for k in (1, 2, 8)]
    before = [Q.qr_panel_plan(*s) for s in sizes]
    monkeypatch.setattr(common, "MAX_SMEM_BYTES", 0)
    assert [Q.qr_panel_plan(*s) for s in sizes] == before


@pytest.mark.parametrize("bs", [1, 8, 16, 32])
def test_plan_takes_each_panel_width_that_fits(monkeypatch, bs):
    """The gpu tests and chip_smoke.py run K4 at 204 x 200 under each
    panel width by setting the plan's widest panel."""
    monkeypatch.setattr(Q, "QR_PANEL_WIDTH", bs)
    plan = Q.qr_panel_plan(204, 200, 1)
    assert (plan.bs, plan.tile) == (bs, Q.QR_TILE_WIDTH)
    assert plan.smem_bytes == _formula(204, 1, bs, Q.QR_TILE_WIDTH)


@pytest.mark.parametrize("m,n,k", [(4, 0, 1), (4, 5, 1), (4, 4, 0),
                                   (15000, 2, 1)])
def test_plan_refuses_what_the_chain_cannot_run(m, n, k):
    """No column, more columns than rows, no right-hand side, or a lane
    whose one-column panels and tiles pass the card's shared memory."""
    with pytest.raises(ValueError):
        Q.qr_panel_plan(m, n, k)


def test_plan_args_of_the_shared_form_are_zero():
    assert Q.qr_plan_args(None, 254, 250, 1) == (0, 0, 0, 0)
    assert Q.qr_plan_args(torch.empty(1), 254, 250, 1) == tuple(
        Q.qr_panel_plan(254, 250, 1))


# ---------------- the order argument ----------------

def _reflector(col, g, rows, tiny):
    """Reflector g of a full-height column (B, m), as reflect_step builds
    it: v (B, m), zero above g, and tau (B,)."""
    x = torch.where(rows >= g, col, 0.0)
    xk = col[:, g]
    norm = torch.sqrt(Q._sum_rows(x * x))
    alpha = torch.where(xk >= 0, -norm, norm)
    v = x - alpha[:, None] * (rows == g).to(col.dtype)
    vnorm2 = torch.clamp_min(Q._sum_rows(v * v), tiny)
    return v, torch.where(norm < tiny, 0.0, 2.0 / vnorm2)


def _dot(v, c):
    """v^T c over rows for (B, m) v and (B, m, j) columns, in row order."""
    return Q._sum_rows(v[:, :, None] * c)


def panel_chain_emulation(a, b, *, bs, tile, tiny=Q.DEFAULT_TINY):
    """The panel chain's schedule in torch on [R | y]: per panel, its
    reflections on the panel's columns only, each column of the panel
    taking the previous reflection's update in the sweep of this one's
    dot product, column g's own reflection only on its diagonal; then the
    columns right of the panel, ``tile`` at a time, every reflection of
    the panel in order, the update of p with the dot product of p + 1;
    then the back substitution by blocks of bs rows, last first, the rows
    above a block taking its products one at a time, k descending.  Each
    product is rounded and subtracted as the plain chain does it, and no
    entry below R's diagonal is updated once its column's reflection is
    built."""
    m, n = a.shape[-2:]
    k = b.shape[-1]
    rows = torch.arange(m)
    c = torch.cat([a, b], dim=-1).clone()
    nref = min(n, m - 1) if m > 1 else 0
    for o in range(0, nref, bs):
        pw = min(bs, nref - o)
        vs, taus, wp = [], [], {}
        for j in range(pw):
            g = o + j
            if j:                                   # column g, reflection g-1
                c[:, g - 1:, g] -= vs[-1][:, g - 1:] * wp[g][:, None]
            v, tau = _reflector(c[:, :, g], g, rows, tiny)
            vs.append(v)
            taus.append(tau)
            for jj in range(g, o + pw):             # a thread a column
                if jj > g and j:
                    c[:, g - 1:, jj] -= vs[-2][:, g - 1:] * wp[jj][:, None]
                w = tau * _dot(v, c[:, :, jj:jj + 1])[:, 0]
                if jj == g:                         # the diagonal only
                    c[:, g, g] -= v[:, g] * w
                else:
                    wp[jj] = w
        for t0 in range(o + pw, n + k, tile):       # a tile of columns
            cs = slice(t0, min(t0 + tile, n + k))
            w = None
            for p in range(pw):
                g = o + p
                if p:
                    c[:, g - 1:, cs] -= (vs[p - 1][:, g - 1:, None]
                                         * w[:, None, :])
                w = taus[p][:, None] * _dot(vs[p], c[:, :, cs])
            g = o + pw - 1
            c[:, g:, cs] -= vs[-1][:, g:, None] * w[:, None, :]
    r, y = c[:, :, :n], c[:, :n, n:].clone()
    diag = torch.abs(torch.diagonal(r[:, :n], dim1=-2, dim2=-1))
    thresh = torch.clamp_min(1e-6 * diag.amax(dim=-1), tiny)
    for k1 in range(n - 1, -1, -bs):                # back substitution
        k0 = max(0, k1 - bs + 1)
        for kk in range(k1, k0 - 1, -1):            # the block's rows
            rkk = r[:, kk, kk]
            ok = torch.abs(rkk) > thresh
            y[:, kk] = torch.where(ok[:, None], y[:, kk] / torch.where(
                ok, rkk, 1.0)[:, None], 0.0)
            y[:, k0:kk] -= r[:, k0:kk, kk, None] * y[:, kk, None, :]
        for kk in range(k1, k0 - 1, -1):            # the rows above it
            y[:, :k0] -= r[:, :k0, kk, None] * y[:, kk, None, :]
    return y


def _lanes(m, n, k, b=4):
    """Gaussian lanes; lane 1 has column 3n/5 a copy of column 3 (a
    deficient pivot in a later panel), lane 2 an exact zero column, lane
    3 a scaled copy of lane 0."""
    rng = np.random.default_rng(m * 100 + n)
    a = rng.standard_normal((b, m, n)).astype(np.float32)
    a[1, :, 3 * n // 5] = a[1, :, 3]
    a[2, :, n // 2] = 0.0
    a[3] = 1e3 * a[0]
    return (torch.from_numpy(a),
            torch.from_numpy(rng.standard_normal((b, m, k)).astype(
                np.float32)))


@pytest.mark.parametrize("bs,tile", [(1, 1), (8, 3), (16, 64), (32, 7)])
@pytest.mark.parametrize("m,n,k", [(45, 40, 1), (64, 64, 2), (70, 61, 3)])
def test_panel_schedule_equals_the_plain_chain_bit_for_bit(m, n, k, bs,
                                                           tile):
    a, b = _lanes(m, n, k)
    want = Q.qr_solve_plain(a, b)
    got = panel_chain_emulation(a, b, bs=bs, tile=tile)
    assert torch.isfinite(want).all()
    # the zero column took the deficient path (a zeroed component)
    assert torch.equal(want[2, n // 2], torch.zeros_like(want[2, n // 2]))
    assert torch.equal(got, want)


# ---------------- K16's form ----------------

def test_trisolve_form_rule_holds_on_every_shape(monkeypatch):
    """A warp a lane up to 32 rows and 8 right-hand sides, a CTA past
    either; WARP_MAX_N = 0 (what chip_smoke.py sets) forces the CTA form
    everywhere."""
    for n in range(1, 300):
        for m in range(1, 13):
            want = "warp" if n <= 32 and m <= 8 else "cta"
            assert T.trisolve_form(n, m) == want, (n, m)
    monkeypatch.setattr(T, "WARP_MAX_N", 0)
    assert {T.trisolve_form(n, m) for n in range(1, 40)
            for m in range(1, 9)} == {"cta"}
