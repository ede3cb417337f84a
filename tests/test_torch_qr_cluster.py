"""K11 and K13 on thread-block clusters (``csrc/qr_cluster.cuh``) on the
CPU: the plan (``qr_cluster_plan``) and an emulation of the cluster
schedule in torch.

The plan: every CTA fits the card's shared memory at every shape either
variant takes (K11 wherever ``qr_solve_blocked_fits`` admits it, K13
within the reference's ``qr_tiled_vmem_floats`` budget wherever the
one-CTA K13 it replaced launched), it runs the batch in the fewest waves
of the clusters an H100 holds at once, the cluster grows as the batch
shrinks, the column blocks and the panels' row bands cover every column
and row once, and shapes neither variant takes raise.

The emulation runs the kernel's schedule lane by lane in float32: R's
column blocks of one [R | y] work matrix dealt block-cyclic to C ranks,
each panel's rows in groups of G rows
dealt to the ranks in contiguous bands, every reflector's sums taken a
group at a time (one serial chain over the group's rows) and the groups'
partials added in ascending order from the owners' exchange slots, V^T V,
T and the block reflector with each sum in its depth order, and the back
substitution by blocks of 32 rows.  Its answer equals itself bit for bit
at C = 1, 2, 4, 8, and it is within the spec's rtol
(1e-3 K11, 2e-3 K13) of the reference's blocked and tiled kernels in
interpret mode.  (It rounds each product and sum apart where the card
fuses them, so it is not the card's bits: ``tests/test_torch_gpu.py``
holds the kernels' forms to each other bit for bit on the card.)
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import pipelines as rp  # noqa: E402
from repro_torch.pipelines.cholesky_solve import (  # noqa: E402
    TILED_VMEM_BUDGET_BYTES, block_size)

from conftest import assert_close  # noqa: E402

Q = importlib.import_module("repro_torch.pipelines.qr_solve")

CARD_SMEM = 232448                 # one block's shared memory on sm_90
SIZES = (1, 2, 4, 8)


def _tiled_admits(m, n, k, bs):
    """Whether the one-CTA K13 took (m, n, k, bs): the reference's budget
    and its shared memory (bs and k alone)."""
    if n % bs or n < 2 * bs:
        return False
    if 4 * Q.qr_tiled_vmem_floats(m, n, bs, k) > TILED_VMEM_BUDGET_BYTES:
        return False
    # qr_tiled_layout: v's heads, tau, w, T, W1, W2, the staging (16-byte
    # aligned), the per-warp sums, the rhs rows, x row, 32 + 1 scratch
    stage = (3 * bs + bs * (bs + 1) + 2 * bs * 64 + 3) & ~3
    floats = stage + 2 * 32 * 68 + 8 * bs + bs * k + k + 33
    return 4 * floats <= CARD_SMEM


def _k11_shapes():
    for n in (128, 160, 192, 256, 384, 512, 704):
        for bs in (16, 32, 35, 48, 64, 128):
            if n % bs:
                continue
            for k in (1, 2, 4):
                for m in range(n, 760, 36):
                    if Q.qr_solve_blocked_fits(m, n, k, bs):
                        yield m, n, k, bs


def _k13_shapes():
    for n in (512, 1024, 2048):
        for bs in (32, 64, 128, 256):
            for k in (1, 2, 16):
                for m in (n, n + 4, n + 16, 2 * n, 3000, 5000, 7000):
                    if m >= n and _tiled_admits(m, n, k, bs):
                        yield m, n, k, bs


KERNEL = {"blocked": "qr_solve_blocked", "tiled": "qr_solve_tiled"}


@pytest.mark.parametrize("variant", ["blocked", "tiled"])
def test_plan_fits_every_shape_the_variant_takes(variant):
    shapes = list(_k11_shapes() if variant == "blocked" else _k13_shapes())
    assert len(shapes) > 50
    for m, n, k, bs in shapes:
        forms = Q.qr_cluster_forms(m, n, k, bs)
        # the bands in the work buffer fit at every cluster size
        assert {p.clusters for p in forms if not p.panel_shared} == set(SIZES)
        for batch in (1, 32, 264, 3276):
            plan = Q.qr_cluster_plan(batch, m, n, k, bs, KERNEL[variant])
            assert plan.clusters in SIZES
            assert plan.threads == 256
            assert plan.smem_bytes == Q.qr_cluster_smem(
                m, bs, plan.clusters, plan.panel_shared)
            assert plan.smem_bytes <= CARD_SMEM - 2048, (m, n, k, bs)
            assert plan in forms


@pytest.mark.parametrize("m,n,bs,at_carrier,at_served", [
    (516, 512, 128, (1, False), (2, False)),
    (1028, 1024, 128, (2, False), (2, False)),
    (260, 256, 64, (1, False), (4, True)),
    (132, 128, 64, (1, True), (1, True)),
    (2052, 512, 128, (4, False), (8, False))])
def test_cluster_grows_as_the_batch_shrinks(m, n, bs, at_carrier, at_served):
    """(C, bands in shared memory) at a carrier's 3276 lanes and at the 32
    lanes the slot mixes serve are as stated; every plan is the form
    whose waves of the clusters an H100 holds at once times its modelled
    lane is least (the smaller cluster on a tie); at the main shapes C
    never shrinks as the batch does (at 2052 x 512, whose bands live in
    the work buffer at every C, the bands in flight against L2 move it
    both ways)."""
    kernel = "qr_solve_tiled" if n >= 512 else "qr_solve_blocked"
    batches = (3276, 264, 132, 64, 32, 16, 8, 1)
    plans = [Q.qr_cluster_plan(b, m, n, 1, bs, kernel) for b in batches]
    sizes = [p.clusters for p in plans]
    if m < 2052:
        assert sizes == sorted(sizes)
    assert (plans[0].clusters, plans[0].panel_shared) == at_carrier
    assert (plans[4].clusters, plans[4].panel_shared) == at_served
    forms = Q.qr_cluster_forms(m, n, 1, bs)
    for b, p in zip(batches, plans):
        def cost(f):
            at_once = Q.qr_clusters_at_once(kernel, f)
            return -(-b // at_once) * Q.qr_lane_cycles(m, n, bs, f,
                                                       min(b, at_once))
        best = min(cost(f) for f in forms)
        assert cost(p) == best
        assert p.clusters == min(f.clusters for f in forms
                                 if cost(f) == best)


def test_lane_model_follows_the_card():
    """The lane model's picks at the main shapes: with its bands in the
    work buffer a 516 x 512 lane on one CTA costs less than on four CTAs
    with shared bands at a carrier's width (an H100: 176.6 against 296.4
    ms), and a modelled lane shortens as C grows where its products
    dominate (1028 x 1024)."""
    shared4 = Q.QrClusterPlan(4, 256, Q.qr_cluster_smem(516, 128, 4, True),
                              True)
    work1 = Q.QrClusterPlan(1, 256, Q.qr_cluster_smem(516, 128, 1, False),
                            False)
    assert (25 * Q.qr_lane_cycles(516, 512, 128, work1, 132)
            < 110 * Q.qr_lane_cycles(516, 512, 128, shared4, 30))
    lanes = [Q.qr_lane_cycles(1028, 1024, 128, Q.QrClusterPlan(
        c, 256, Q.qr_cluster_smem(1028, 128, c, False), False), 32)
        for c in SIZES]
    assert lanes == sorted(lanes, reverse=True)


@pytest.mark.parametrize("c", SIZES)
def test_column_blocks_and_row_bands_cover_once(c):
    """Block q of 64 columns goes to rank q % C: every column once, the
    ranks' trailing shares within one block of each other at every panel;
    each panel's row groups go to the ranks in contiguous bands that
    cover its rows once, each within its capacity."""
    for n in (128, 140, 256, 512, 1024):
        blocks = -(-n // 64)
        owner = [q % c for q in range(blocks)]
        cols = sorted(col for q in range(blocks)
                      for col in range(64 * q, min(n, 64 * q + 64)))
        assert cols == list(range(n))
        for o in range(0, n, 32):
            share = [sum(1 for q in range(blocks) if owner[q] == r
                         and 64 * q + 64 > o) for r in range(c)]
            assert max(share) - min(share) <= 1
    for m in (132, 260, 516, 1028, 5000):
        g = Q.qr_group_rows(m)
        assert g % 32 == 0 and -(-m // g) <= Q.QR_GROUP_MAX
        rows_max = Q._band_rows(m, c) - 1          # a band's capacity
        for o in range(0, m - 1, 37):
            pr = m - o
            ngp = -(-pr // g)
            rpr = -(-ngp // c) * g
            rows = [p for r in range(c)
                    for p in range(r * rpr, min(pr, (r + 1) * rpr))]
            assert rows == list(range(pr))
            assert rpr <= rows_max


@pytest.mark.parametrize("m,n,k,bs", [(400, 400, 1, 200), (300, 256, 1, 0),
                                      (128, 256, 1, 64), (260, 256, 0, 64),
                                      (260, 256, 1, 48), (260, 256, 1, 512)])
def test_plan_raises_on_what_neither_variant_takes(m, n, k, bs):
    with pytest.raises(ValueError):
        Q.qr_cluster_plan(32, m, n, k, bs)


# ---------------- the emulation of the cluster schedule ----------------

class _Lane:
    """A lane's [R | y] work matrix; R's 64-column block q belongs to rank
    q % C, y to the next rank in the cycle."""

    def __init__(self, a, b, c):
        bsz, m, n = a.shape
        self.m, self.n, self.k, self.c = m, n, b.shape[-1], c
        self.nblk = -(-n // 64)
        self.yowner = self.nblk % c
        self.work = torch.cat([a, b], dim=-1).clone()

    def owners(self, q):
        return q % self.c

    def get(self, rows, c0, c1):
        return self.work[:, rows, c0:c1]

    def set(self, rows, c0, c1, val):
        self.work[:, rows, c0:c1] = val

    def ycols(self):
        return self.work[:, :, self.n:]


def _serial_dot(u, v):
    """sum over the row axis (1) of u * v, one row after another from 0
    (a lane's chain), each product and sum rounded in float32."""
    s = torch.zeros_like(u[:, 0] * v[:, 0])
    for p in range(u.shape[1]):
        s = s + u[:, p] * v[:, p]
    return s


def emulate(a, b, bs, c, tiny=Q.DEFAULT_TINY):
    """K11 / K13's cluster schedule on (B, m, n), (B, m, k) float32 CPU
    tensors on C ranks -> x (B, n, k)."""
    bsz, m, n = a.shape
    k = b.shape[-1]
    lane = _Lane(a, b, c)
    g = Q.qr_group_rows(m)
    dmax = torch.zeros(bsz)
    for o in range(0, n, bs):
        pr = m - o
        ngp = -(-pr // g)
        gprp = -(-ngp // c)
        rpr = gprp * g
        bands = [lane.get(slice(o + r * rpr, o + min(pr, (r + 1) * rpr)),
                          o, o + bs).clone() for r in range(c)]

        def row(p):
            r = p // rpr
            return bands[r][:, p - r * rpr]

        def group_rows(gi):
            return range(gi * g, min(pr, gi * g + g))

        # exchange: per rank, two buffers of per-group partials + row slot
        exch = [[{}, {}] for _ in range(c)]

        def dots(jn, update, vg, tau, dsum, prow):
            first = jn - 1 if update else jn
            for r in range(c):
                for gi in range(r * gprp, min(ngp, r * gprp + gprp)):
                    rows = [p for p in group_rows(gi) if p >= first]
                    if not rows:
                        continue
                    d = torch.zeros(bsz, bs - jn)
                    w = tau[:, None] * (vg[:, None] * prow[:, jn + 1:]
                                        + dsum[:, jn + 1:]) if update else None
                    for p in rows:
                        rp_ = row(p)
                        x = rp_[:, jn:].clone()
                        if update:
                            v = vg if p == jn - 1 else rp_[:, jn - 1]
                            x[:, 1:] = x[:, 1:] - v[:, None] * w
                            rp_[:, jn + 1:] = x[:, 1:]
                        if p == jn:
                            exch[r][jn & 1]["row"] = x.clone()
                        if p > jn:
                            d = d + rp_[:, jn][:, None] * x
                    exch[r][jn & 1][gi] = d

        zero = torch.zeros(bsz)
        dots(0, False, zero, zero, None, None)
        vd = torch.zeros(bsz, bs)
        taus = torch.zeros(bsz, bs)
        for j in range(bs):
            s = torch.zeros(bsz, bs - j)
            for gi in range((j + 1) // g, ngp):
                part = exch[gi // gprp][j & 1][gi]
                s = s + part[:, part.shape[1] - (bs - j):]
            dsum = torch.zeros(bsz, bs)
            dsum[:, j:] = s
            prow = torch.zeros(bsz, bs)
            hrow = exch[j // rpr][j & 1]["row"]
            prow[:, j:] = hrow[:, hrow.shape[1] - (bs - j):]
            tail, xk = dsum[:, j], prow[:, j]
            norm = torch.sqrt(tail + xk * xk)
            alpha = torch.where(xk >= 0, -norm, norm)
            vg = xk - alpha
            vnorm2 = torch.clamp_min(tail + vg * vg, tiny)
            tau = torch.where(norm < tiny, 0.0, 2.0 / vnorm2)
            rdiag = xk - vg * (tau * (vg * xk + tail))
            dmax = torch.where(torch.isnan(dmax) | torch.isnan(rdiag),
                               float("nan"),
                               torch.maximum(dmax, rdiag.abs()))
            vd[:, j], taus[:, j] = vg, tau
            row(j)[:, j] = rdiag
            if j + 1 == bs:
                break
            wn = tau * (vg * prow[:, j + 1] + dsum[:, j + 1])
            for p in range(j, pr):
                rp_ = row(p)
                rp_[:, j + 1] = rp_[:, j + 1] - (vg if p == j
                                                 else rp_[:, j]) * wn
            dots(j + 1, True, vg, tau, dsum, prow)
        # R's upper part of the panel back to its blocks
        for p in range(min(bs, pr)):
            lane.set(slice(o + p, o + p + 1), o + p, o + bs,
                     row(p)[:, p:][:, None])
        # V (pr x bs): v's heads aside, zeros above
        v = torch.stack([row(p) for p in range(pr)], dim=1)
        pidx = torch.arange(pr)[:, None]
        cidx = torch.arange(bs)[None, :]
        v = torch.where(pidx > cidx, v, 0.0)
        v = torch.where(pidx == cidx, vd[:, None, :], v)
        gram = _serial_dot(v[:, :, :, None], v[:, :, None, :])   # (B,bs,bs)
        t = torch.zeros(bsz, bs, bs)
        for j in range(bs):
            for i in range(j):
                s = torch.zeros(bsz)
                for l_ in range(i, j):
                    s = s + t[:, i, l_] * gram[:, l_, j]
                t[:, i, j] = -taus[:, j] * s
            t[:, j, j] = taus[:, j]

        def apply(cmat):
            w1 = _serial_dot(v[:, :, :, None], cmat[:, :, None, :])
            w2 = torch.zeros_like(w1)
            for p in range(bs):
                s = torch.zeros_like(w1[:, 0])
                for l_ in range(p + 1):
                    s = s + t[:, l_, p][:, None] * w1[:, l_]
                w2[:, p] = s
            upd = _serial_dot(v.transpose(1, 2)[:, :, :, None],
                              w2[:, :, None, :])
            return cmat - upd

        for q in range(lane.nblk):
            c0, c1 = max(64 * q, o + bs), min(n, 64 * q + 64)
            if c0 < c1:
                cm = lane.get(slice(o, m), c0, c1)
                lane.set(slice(o, m), c0, c1, apply(cm))
        yc = lane.ycols()
        yc[:, o:] = apply(yc[:, o:].clone())
    thresh = torch.where(torch.isnan(dmax), float("nan"),
                         torch.clamp_min(1e-6 * dmax, tiny))
    y = lane.ycols()
    r = lane.get(slice(0, n), 0, n)
    for k0 in range((-(-n // 32) - 1) * 32, -1, -32):
        nb = min(32, n - k0)
        z = y[:, k0:k0 + nb].clone()
        for cc in range(nb - 1, -1, -1):
            rcc = r[:, k0 + cc, k0 + cc]
            ok = rcc.abs() > thresh
            xc = torch.where(ok[:, None],
                             z[:, cc] / torch.where(ok, rcc, 1.0)[:, None],
                             0.0)
            z[:, cc] = xc
            z[:, :cc] = z[:, :cc] - r[:, k0:k0 + cc, k0 + cc, None] * xc[:, None]
        y[:, k0:k0 + nb] = z
        acc = y[:, :k0].clone()
        for cc in range(nb - 1, -1, -1):
            acc = acc - r[:, :k0, k0 + cc, None] * z[:, cc][:, None]
        y[:, :k0] = acc
    return y[:, :n].clone()


def _lanes(seed, b, m, n, k=2):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, m, n)).astype(np.float32)
    a[1, :, 3 * n // 4] = a[1, :, 3]        # a rank-deficient later panel
    a[2, :, n // 2] = 0.0                   # an exact zero column
    return a, rng.standard_normal((b, m, k)).astype(np.float32)


@pytest.mark.parametrize("m,n,bs", [(68, 64, 32), (40, 32, 8), (33, 32, 16)])
def test_emulation_equal_at_every_cluster_size_and_form(m, n, bs):
    """The schedule gives one answer bit for bit whatever the cluster size
    (the bands' place, shared or device memory, changes no arithmetic);
    the zero column's component is zeroed, the deficient lane finite,
    and a NaN lane leaves the lanes beside it as they were."""
    a, b = _lanes(m + bs, 4, m, n)
    a = torch.from_numpy(a)
    b = torch.from_numpy(b)
    outs = [emulate(a, b, bs, c) for c in SIZES]
    for out in outs[1:]:
        assert torch.equal(out.view(torch.int32), outs[0].view(torch.int32))
    assert bool(torch.isfinite(outs[0]).all())
    assert torch.equal(outs[0][2, n // 2], torch.zeros(b.shape[-1]))
    nan = a.clone()
    nan[3, 5, 7] = float("nan")
    poisoned = emulate(nan, b, bs, 2)
    assert torch.equal(poisoned[:3], outs[0][:3])
    # a NaN on the diagonal makes the threshold NaN: every component of
    # that lane is zeroed, as the plain version zeroes it
    plain = Q.qr_solve_blocked_plain(nan[3:], b[3:], bs=bs)
    assert torch.equal(poisoned[3], torch.zeros_like(poisoned[3]))
    assert torch.equal(plain[0], poisoned[3])


@pytest.mark.parametrize("variant,bs,rtol", [("blocked", 32, 1e-3),
                                             ("tiled", 32, 2e-3)])
def test_emulation_matches_the_reference(variant, bs, rtol):
    """The schedule (at C = 4 and C = 1) within the spec's rtol of the
    reference's Pallas kernel in interpret mode at 68 x 64 (K13 at bs = 32: two slabs), and of the
    port's plain version."""
    rng = np.random.default_rng(64)
    a = rng.standard_normal((2, 68, 64)).astype(np.float32)
    b = rng.standard_normal((2, 68, 2)).astype(np.float32)
    ref = {"blocked": rp.qr_solve_blocked, "tiled": rp.qr_solve_tiled}
    plain = {"blocked": Q.qr_solve_blocked_plain,
             "tiled": Q.qr_solve_tiled_plain}
    want = np.asarray(ref[variant](jnp.asarray(a), jnp.asarray(b), bs=bs))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    for c in (4, 1):
        got = emulate(at, bt, bs, c).numpy()
        assert_close(got, want, rtol=rtol, name=f"{variant} C={c}")
        assert_close(got, plain[variant](at, bt, bs=bs).numpy(), rtol=rtol,
                     name=f"{variant} plain C={c}")
    assert block_size(64, bs) == bs
