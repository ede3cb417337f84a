"""K12 and K14 on thread-block clusters (``csrc/tiled_chol.cuh``) on the
CPU: the plan (``chol_tiled_plan``) and the deal of a lane's work to the
ranks of its cluster.

The plan: every CTA fits the card's shared memory at every shape the
tiled variants take (wherever the one-CTA kernels they replaced
launched), it runs the batch in the least modelled time of the waves of
the clusters an H100 holds at once, a carrier's width takes one CTA a
lane and the 32 lanes the slot mixes serve a cluster, and shapes the
variants do not take raise.  The deal: the kernels' loops, emulated
index by index, hand every Gram and trailing tile, every chunk of L21's
rows, every matched-filter and back-substitution element, every row of
A's copy and every element of a wide product tile to exactly one rank
and thread at every cluster size.  (Each element's arithmetic is the
same on every plan, so the plans give the same bits: the card holds
them to it, ``tests/test_torch_gpu.py``.)
"""
import importlib

import pytest

torch = pytest.importorskip("torch")

CH = importlib.import_module("repro_torch.pipelines.cholesky_solve")
MM = importlib.import_module("repro_torch.pipelines.mmse")
from repro_torch.kernels import common  # noqa: E402

CARD_SMEM = 232448                 # one block's shared memory on sm_90
SIZES = (1, 2, 4, 8)
THREADS = 256
K12, K14 = "cholesky_solve_tiled", "mmse_equalize_tiled"


def _parent_fits(k, bs):
    """Whether the one-CTA kernels K12 and K14 replaced launched at (k,
    bs): their shared memory (the old tiled_layout: the block at pitch
    bs + 1, its pivots and rows of y, 64 rows of L21 at pitch bs + 4 or
    the 64 x 64 tile's staging, their rows of y, 32 floats)."""
    head = (bs * (bs + 1) + bs + bs * k + k + 3) // 4 * 4
    floats = head + max(64 * (bs + 4), 2 * 32 * 68) + 64 * k + 32
    return 4 * floats <= CARD_SMEM


def _shapes(kernel):
    """(n, k, bs, m) the tiled variant takes: n >= 512 in 32-wide slabs
    within the reference's budget, its default slab width and the
    explicit ones that tile n, where the replaced kernel launched."""
    for n in (512, 544, 576, 640, 768, 1024, 1056, 2048):
        for bs in sorted({CH.tiled_block_size(n), 128, 64, 32}):
            for k in (1, 2, 4, 16, 64):
                ms = ((None,) if kernel == K12
                      else (n, n + 4, n + 16, 2 * n, 2052, 4100))
                for m in ms:
                    if m is not None and m < n:
                        continue
                    try:
                        if kernel == K12:
                            CH.tiled_admit(kernel, n, bs,
                                           lambda w: CH.tiled_vmem_floats(
                                               n, w, k))
                        else:
                            CH.tiled_admit(kernel, n, bs,
                                           lambda w: MM.mmse_tiled_vmem_floats(
                                               m, n, w, k))
                    except ValueError:
                        continue
                    if _parent_fits(k, bs):
                        yield n, k, bs, m


@pytest.mark.parametrize("kernel", [K12, K14])
def test_plan_fits_every_shape_the_variant_takes(kernel):
    shapes = list(_shapes(kernel))
    assert len(shapes) > 50
    for n, k, bs, m in shapes:
        forms = CH.chol_tiled_forms(n, k, bs, kernel, m)
        assert {p.clusters for p in forms} == set(SIZES)
        for batch in (1, 32, 264, 3276):
            plan = CH.chol_tiled_plan(batch, n, k, bs, kernel, m)
            assert plan in forms
            assert plan.threads == THREADS
            assert plan.tile in (64, 128)
            assert plan.smem_bytes == CH.chol_tiled_smem(k, bs, plan.tile)
            assert plan.smem_bytes <= CARD_SMEM, (n, k, bs, m)


def test_shared_memory_depends_on_k_bs_and_the_tile_alone():
    """103 KB at the served bs = 128, k = 2: two CTAs an SM, at every n."""
    for kernel, m in ((K12, None), (K14, 1028)):
        smem = {p.smem_bytes for n in (512, 1024)
                for p in CH.chol_tiled_forms(n, 2, 128, kernel,
                                             m and n + 4)}
        assert smem == {CH.chol_tiled_smem(2, 128, 64)} == {104576}
    assert 2 * (104576 + 1024) <= common.SM_SMEM_BYTES


@pytest.mark.parametrize("kernel,n,k,bs,m", [
    (K12, 512, 2, 96, None), (K12, 512, 0, 128, None),
    (K12, 512, 2, 0, None), (K12, 1024, 2, 512, None),
    (K14, 512, 2, 128, 500), (K14, 512, 2, 128, None),
    ("qr_solve_tiled", 512, 2, 128, 516)])
def test_plan_raises_on_what_the_variants_do_not_take(kernel, n, k, bs, m):
    with pytest.raises(ValueError):
        CH.chol_tiled_plan(32, n, k, bs, kernel, m)


def test_a_plan_off_the_forms_raises_on_every_device():
    """A plan that is not one of the shape's forms raises before any work,
    on the CPU too; one of the forms gives the plain version's answer
    there."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 64, 64), generator=gen)
    a = x @ x.mT + 64 * torch.eye(64)
    b = torch.randn((2, 64, 2), generator=gen)
    plan = CH.chol_tiled_plan(2, 64, 2, 32)
    want = CH.cholesky_solve_tiled_plain(a, b, bs=32)
    assert torch.equal(CH.cholesky_solve_tiled_fused(a, b, bs=32, plan=plan),
                       want)
    for bad in (plan._replace(clusters=16), plan._replace(tile=32),
                plan._replace(smem_bytes=plan.smem_bytes + 4)):
        with pytest.raises(ValueError, match="not a form"):
            CH.cholesky_solve_tiled_fused(a, b, bs=32, plan=bad)
    h = torch.randn((2, 70, 64), generator=gen)
    y = torch.randn((2, 70, 2), generator=gen)
    hplan = CH.chol_tiled_plan(2, 64, 2, 32, K14, 70)
    assert torch.equal(MM.mmse_equalize_tiled_fused(h, y, bs=32, plan=hplan),
                       MM.mmse_equalize_tiled_plain(h, y, bs=32))
    with pytest.raises(ValueError, match="not a form"):
        MM.mmse_equalize_tiled_fused(h, y, bs=32,
                                     plan=hplan._replace(clusters=3))


# ---------------- the plan's choices ----------------

def _cost(kernel, plan, batch, n, k, bs, m):
    at_once = CH.chol_tiled_clusters_at_once(kernel, plan)
    return -(-batch // at_once) * CH.chol_lane_cycles(n, k, bs, plan,
                                                      kernel, m)


@pytest.mark.parametrize("kernel,n,m,at_carrier,at_served", [
    (K12, 512, None, (1, 64), (4, 64)),
    (K12, 1024, None, (1, 128), (4, 64)),
    (K14, 512, 516, (1, 128), (4, 64)),
    (K14, 1024, 1028, (1, 128), (4, 128)),
    (K14, 512, 2052, (1, 128), (4, 64))])
def test_plan_at_a_carriers_width_and_at_the_served_lanes(
        kernel, n, m, at_carrier, at_served):
    """(C, tile) at a carrier's width (3276 lanes at n = 512, 264 at n =
    1024) and at the 32 lanes the slot mixes serve are as stated; every
    plan is the form whose waves of the clusters an H100 holds at once
    times its modelled lane is least, the smaller cluster and then the
    wider tile on a tie."""
    carrier = 3276 if n == 512 else 264
    bs = CH.tiled_block_size(n)
    for batch, want in ((carrier, at_carrier), (32, at_served)):
        plan = CH.chol_tiled_plan(batch, n, 2, bs, kernel, m)
        assert (plan.clusters, plan.tile) == want
        forms = CH.chol_tiled_forms(n, 2, bs, kernel, m)
        best = min(_cost(kernel, f, batch, n, 2, bs, m) for f in forms)
        assert _cost(kernel, plan, batch, n, 2, bs, m) == best
        ties = [f for f in forms
                if _cost(kernel, f, batch, n, 2, bs, m) == best]
        assert plan == min(ties, key=lambda f: (f.clusters, -f.tile))


def test_clusters_at_once_follow_the_card_table(monkeypatch):
    """On the CPU the clusters at once are an H100's at the CTAs an SM
    holds by shared memory (two at bs = 128, the instances' bound); a card
    that held more clusters of 4 would move the served plan's waves, and
    a plan follows the table it is given."""
    plan = CH.chol_tiled_plan(32, 512, 2, 128)
    assert CH.chol_tiled_clusters_at_once(K12, plan) == \
        common.H100_CLUSTERS_AT_ONCE[2][plan.clusters]
    assert CH.chol_tiled_clusters_at_once(
        K12, plan._replace(clusters=8)) == 30
    # a card that holds a single cluster of 4 at once: 32 lanes of C = 4
    # would take 32 waves, so the plan leaves C = 4
    table = {per: dict(row) for per, row in
             common.H100_CLUSTERS_AT_ONCE.items()}
    table[2][4] = 1
    monkeypatch.setattr(common, "H100_CLUSTERS_AT_ONCE", table)
    CH.chol_tiled_clusters_at_once.cache_clear()
    try:
        assert CH.chol_tiled_plan(32, 512, 2, 128).clusters != 4
    finally:
        CH.chol_tiled_clusters_at_once.cache_clear()


def test_lane_model_follows_its_constants(monkeypatch):
    """A modelled lane shortens as C grows while the dealt phases dominate
    (a lane's products and rows), and a free cluster barrier never makes
    a larger cluster dearer; with barriers that cost a lane's worth the
    plan stays on one CTA even at 32 lanes."""
    for kernel, n, m in ((K12, 1024, None), (K14, 1024, 1028)):
        lanes = [CH.chol_lane_cycles(n, 2, 128, CH.CholTiledPlan(
            c, THREADS, CH.chol_tiled_smem(2, 128, 128), 128), kernel, m)
            for c in SIZES]
        assert lanes == sorted(lanes, reverse=True)
    costs = dict(CH.CHOL_LANE_CYCLES)
    costs["sync"] = {64: 1e9, 128: 1e9}
    monkeypatch.setattr(CH, "CHOL_LANE_CYCLES", costs)
    assert CH.chol_tiled_plan(32, 512, 2, 128).clusters == 1


# ---------------- the deal, emulated from the kernels' loops ----------------

def _tiles(rest, t):
    """The kernels' enumeration of a region's lower tiles: idx counts (ti,
    tj <= ti) row by row."""
    tiles = -(-rest // t)
    return [(ti, tj) for ti in range(tiles) for tj in range(ti + 1)]


@pytest.mark.parametrize("c", SIZES)
@pytest.mark.parametrize("n,bs,k,t", [(512, 128, 2, 64), (512, 128, 2, 128),
                                      (1024, 128, 2, 128), (544, 32, 3, 64),
                                      (640, 64, 16, 128)])
def test_deal_covers_every_tile_row_and_element_once(c, n, bs, k, t):
    # the Gram's tiles (tile idx to rank idx % c), and each panel's
    # trailing tiles: every tile once, the ranks' shares within one
    for rest in [n] + [n - o - bs for o in range(0, n, bs)]:
        tiles = _tiles(rest, t)
        got = [[x for idx, x in enumerate(tiles) if idx % c == r]
               for r in range(c)]
        assert sorted(x for g in got for x in g) == sorted(tiles)
        assert max(map(len, got)) - min(map(len, got)) <= 1
        assert [len(g) for g in got] == [
            len(d) for d in CH.chol_tiled_deal(len(tiles), c)]
    # each panel's chunks of L21's rows (chunk q to rank q % c): every row
    # below the panel once
    for o in range(0, n, bs):
        nch = -(-(n - o - bs) // CH.TILED_ROW_CHUNK)
        rows = sorted(o + bs + q * CH.TILED_ROW_CHUNK + i
                      for r in range(c) for q in range(r, nch, c)
                      for i in range(min(CH.TILED_ROW_CHUNK,
                                         n - o - bs - q * CH.TILED_ROW_CHUNK)))
        assert rows == list(range(o + bs, n))
    # the back substitution's sums: contiguous blocks of a slab's rows,
    # every (row, rhs) once
    blocks = CH.chol_tiled_rows_of(bs, c)
    assert sorted(j for j0, j1 in blocks for j in range(j0, j1)) == \
        list(range(bs))
    # the matched filter's elements and the rows of A's copy: thread tid
    # of rank r takes e = r 256 + tid + 256 c t, warp w row r 8 + w + 8 c t
    elems = sorted(r * THREADS + tid + THREADS * c * s
                   for r in range(c) for tid in range(THREADS)
                   for s in range(-(-n * k // (THREADS * c)))
                   if r * THREADS + tid + THREADS * c * s < n * k)
    assert elems == list(range(n * k))
    rows = sorted(r * 8 + w + 8 * c * s for r in range(c) for w in range(8)
                  for s in range(-(-n // (8 * c)))
                  if r * 8 + w + 8 * c * s < n)
    assert rows == list(range(n))


@pytest.mark.parametrize("t", [64, 128])
def test_wide_tile_gives_every_element_to_one_thread(t):
    """wide_ry / wide_cx / wide_off (tile_loops.cuh): the 256 threads'
    kR x kR elements cover the t x t tile once, and each warp reads 4
    consecutive float4 of A and 8 of B a depth step."""
    kr = t // 16
    seen = set()
    for tid in range(THREADS):
        w, lane = tid >> 5, tid & 31
        ry = (w >> 1) * 4 + (lane >> 3)
        cx = (w & 1) * 8 + (lane & 7)
        for u in range(kr):
            for v in range(kr):
                off = lambda b, x: 4 * b + (x & 3) + 64 * (x >> 2)  # noqa
                seen.add((off(ry, u), off(cx, v)))
    assert seen == {(i, j) for i in range(t) for j in range(t)}
    for w in range(8):
        rys = {(w >> 1) * 4 + (lane >> 3) for lane in range(32)}
        cxs = {(w & 1) * 8 + (lane & 7) for lane in range(32)}
        assert len(rys) == 4 and max(rys) - min(rys) == 3
        assert len(cxs) == 8 and max(cxs) - min(cxs) == 7
