"""K21's cluster plan on the CPU (``kernels/ssm_scan.py``): the cluster
size, the chunks a rank takes, the column width, the slots and the bytes
of shared memory and of the work buffer at every chunk count 1-40 and
every admitted N; the order in which the cluster passes the state down
(an emulation of the kernel's mbarrier protocol, which finishes at every
form and deadlocks where the ring has too few slots); and the plain
version against the reference's Pallas kernel (interpret mode) at narrow
widths with many chunks, shared and per-head B/C, within the spec's rtol.

The kernel itself runs on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``, ``scripts/ssm_ab.py``), where every form is held to
the others bit for bit.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import kernels as RK  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan_pallas  # noqa: E402
from repro_torch.kernels import common  # noqa: E402

from conftest import assert_close  # noqa: E402

KS = importlib.import_module("repro_torch.kernels.ssm_scan")


def one_cta_fits(cs: int, n: int) -> bool:
    """The shapes K21 must take: those whose lane fits one CTA holding a
    32-column x tile and h, la, C^T, B^T and M at pitch cs16 + 1."""
    cs16 = (cs + 15) // 16 * 16
    ld = cs16 + 1
    return 4 * (cs16 * 32 + n * 32 + cs16 + 2 * n * ld + cs16 * ld) \
        <= common.MAX_SMEM_BYTES


def test_admission_keeps_every_one_cta_shape():
    for cs in range(1, KS.MAX_KERNEL_CHUNK + 1):
        for n in range(1, KS.MAX_KERNEL_STATE + 1):
            if one_cta_fits(cs, n):
                assert KS.kernel_fits(cs, n), (cs, n)
    assert KS.kernel_fits(128, 128) and not KS.kernel_fits(128, 129)
    assert KS.kernel_fits(64, 256) and not KS.kernel_fits(64, 257)
    assert not KS.kernel_fits(129, 8)


# (chunk, P): the two model chunks at their widths, and two chunks the
# general instance takes (32-column tiles)
PLAN_SHAPES = [(128, 160), (64, 385), (16, 4), (48, 33)]


@pytest.mark.parametrize("cs,p", PLAN_SHAPES,
                         ids=[f"cs{cs}-p{p}" for cs, p in PLAN_SHAPES])
def test_plan_covers_every_chunk_and_column_once(cs, p):
    """At every chunk count 1-40 and every admitted N: the plan is one of
    its forms; its cluster is 1 for one chunk, else 2, 4 or 8 up to the
    chunks; its ranks take every chunk exactly once, each rank its own in
    order; its lanes' tiles cover P's tiles once; its slots are a tile
    each where a rank takes more than one chunk, else 1 or 2; its shared
    memory is the formula's and the work buffer one lane (G, C^T and B) a
    (batch, gram head, chunk)."""
    qt = KS.ssm_tile_cols(cs)
    cs16 = (cs + 15) // 16 * 16
    tiles_of_p = -(-p // qt)
    for chunks in range(1, 41):
        s = chunks * cs
        for n in range(1, KS.MAX_KERNEL_STATE + 1):
            if not KS.kernel_fits(cs, n):
                continue
            plan = KS.ssm_plan(4, 2, s, p, n, cs)
            assert plan in KS.ssm_forms(s, p, n, cs)
            c = plan.clusters
            assert c == 1 if chunks == 1 else c in (2, 4, 8) and c <= chunks
            dealt = [list(KS.rank_chunks(chunks, c, r)) for r in range(c)]
            assert all(d == sorted(d) and d for d in dealt)
            assert sorted(sum(dealt, [])) == list(range(chunks))
            groups = KS.ssm_groups(p, cs, plan.tiles)
            assert (groups - 1) * plan.tiles < tiles_of_p \
                <= groups * plan.tiles
            if chunks > c:
                assert plan.slots == plan.tiles
            else:
                assert 1 <= plan.slots <= min(2, plan.tiles)
            assert plan.smem_bytes == KS.ssm_smem(cs, n, plan.slots) \
                <= common.MAX_SMEM_BYTES
            assert KS.ssm_gram_smem(cs, n) <= common.MAX_SMEM_BYTES
            lane = cs16 * cs16 + n * cs16 + cs16 * KS._b_pitch(n)
            assert KS.ssm_lane_floats(cs, n) == lane
            for hg in (1, 2):
                assert KS.ssm_work_floats(4, hg, s, cs, n) \
                    == 4 * hg * chunks * lane


def test_check_forms_cover_every_cluster_size():
    """The forms held bit for bit on the card: the plan first, then every
    cluster size a lane may run on, each at least once, all distinct."""
    for s, p, n, cs in ((512, 160, 64, 128), (512, 385, 192, 64),
                        (128, 160, 64, 128), (128, 385, 192, 64),
                        (2048, 33, 8, 128), (64, 4, 8, 16)):
        forms = KS.ssm_check_forms(4, 32, s, p, n, cs)
        assert forms[0] == KS.ssm_plan(4, 32, s, p, n, cs)
        assert len(set(forms)) == len(forms)
        assert {f.clusters for f in forms} \
            == set(KS.ssm_cluster_sizes(s // cs))
        assert all(f in KS.ssm_forms(s, p, n, cs) for f in forms)


def test_a_plan_off_the_forms_raises_on_the_cpu():
    x, a, b, c = (torch.zeros(s) for s in ((1, 2, 256, 8), (1, 2, 256),
                                            (1, 256, 4), (1, 256, 4)))
    plan = KS.ssm_plan(1, 2, 256, 8, 4, 64)
    KS.ssm_scan_fused(x, a, b, c, chunk=64, plan=plan)
    with pytest.raises(ValueError):
        KS.ssm_scan_fused(x, a, b, c, chunk=64,
                          plan=plan._replace(clusters=3))
    with pytest.raises(ValueError):
        KS.ssm_scan_fused(x, a, b, c, chunk=64,
                          plan=plan._replace(slots=plan.slots + 1))


def run_ring(chunks: int, clusters: int, tiles: int, slots: int) -> bool:
    """Emulate the kernel's passing of the state down a cluster: each
    rank, for each of its chunks and tiles in order, waits for its slot
    to be full (chunk > 0), waits for the next rank's slot to be empty
    (from its slots-th send on), sends (chunk + 1 < chunks), then reads
    and frees its slot.  True when every rank finishes, False on a
    deadlock (no rank can move)."""
    steps = [[(c, t) for c in KS.rank_chunks(chunks, clusters, r)
              for t in range(tiles)] for r in range(clusters)]
    pc = [0] * clusters
    filled = [0] * clusters      # fills of a rank's slots (by its producer)
    freed = [0] * clusters       # of them read and freed (by the rank)
    sent = [0] * clusters        # fills a rank made of the next one's
    while any(pc[r] < len(steps[r]) for r in range(clusters)):
        moved = False
        for r in range(clusters):
            if pc[r] == len(steps[r]):
                continue
            c, _ = steps[r][pc[r]]
            dst = (r + 1) % clusters
            if c > 0 and filled[r] <= freed[r]:
                continue                 # h_{c-1}'s tile not in yet
            send = c + 1 < chunks
            if send and sent[r] >= slots and freed[dst] < sent[r] - slots + 1:
                continue                 # the next rank's slot not free
            if send:
                sent[r] += 1
                filled[dst] += 1
            if c > 0:
                freed[r] += 1
            pc[r] += 1
            moved = True
        if not moved:
            return False
    return True


def test_the_state_goes_down_every_form_without_a_deadlock():
    """Every (chunks, cluster, tiles) a plan may take, with its slots:
    the ring finishes.  Fewer slots than tiles where a rank takes more
    than one chunk would close the ring on itself."""
    for chunks in range(1, 41):
        for clusters in KS.ssm_cluster_sizes(chunks):
            for tiles in range(1, 14):
                wrap = chunks > clusters
                for slots in ((tiles,) if wrap else (1, 2)):
                    assert run_ring(chunks, clusters, tiles, slots), \
                        (chunks, clusters, tiles, slots)
    assert not run_ring(4, 2, 5, 2)
    assert not run_ring(3, 2, 3, 1)


# (b, h, s, p, n, per_head, chunk): 9 and 17 chunks at narrow widths,
# shared and per-head B/C, an odd P and a chunk that is not a multiple of 16
MANY_CHUNKS = [(1, 2, 72, 5, 4, False, 8), (2, 2, 136, 3, 6, True, 8),
               (1, 3, 153, 7, 5, True, 9), (2, 2, 9 * 16, 33, 8, False, 16)]


@pytest.mark.parametrize("b,h,s,p,n,per_head,chunk", MANY_CHUNKS)
def test_plain_scan_matches_pallas_over_many_chunks(b, h, s, p, n,
                                                    per_head, chunk):
    spec = RK.get("ssm_scan")
    rng = np.random.default_rng(s * 7 + p)
    bc = (b, h, s, n) if per_head else (b, s, n)
    x, a, bb, cc = (rng.standard_normal((b, h, s, p)).astype(np.float32),
                    rng.uniform(0.8, 0.999, (b, h, s)).astype(np.float32),
                    rng.standard_normal(bc).astype(np.float32),
                    rng.standard_normal(bc).astype(np.float32))
    plan = KS.ssm_plan(b, h, s, p, n, chunk)
    got_y, got_h = KS.ssm_scan_fused(
        *(torch.from_numpy(t.copy()) for t in (x, a, bb, cc)), chunk=chunk,
        plan=plan)
    py, ph = ssm_scan_pallas(*map(jnp.asarray, (x, a, bb, cc)), chunk=chunk,
                             interpret=True)
    assert_close(got_y.numpy(), np.asarray(py), rtol=spec.rtol,
                 name="y vs pallas")
    assert_close(got_h.numpy(), np.asarray(ph), rtol=spec.rtol,
                 name="h vs pallas")
