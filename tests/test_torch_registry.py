"""The port's kernel registry against the reference's: dispatch, fillers,
flops models, coalescing — and the port's own coalesced-corner exactness.

Float bit-identity is asserted port against port only, never across the
two frameworks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import kernels as RK  # noqa: E402
from repro_torch import kernels as TK  # noqa: E402
from repro_torch import pipelines as tp  # noqa: E402
from repro_torch.serve import ManualClock, SolverMux  # noqa: E402

SPECS = ["cholesky_solve", "qr_solve", "mmse_equalize"]
# the kernel specs (the primitives and the DAGs' kernels) and the DAG
# stages, beside the three pipelines
DAG_SPECS = ["cholesky", "trisolve", "qr", "svd", "gemm", "fir", "fft",
             "flash_attention", "ssm_scan", "pusch_fft",
             "pusch_chanest", "pusch_chain", "svd_factor", "svd_apply"]


def test_registry_holds_the_three_served_pipelines():
    """The three solver pipelines, and the DAG stages, the DAGs' kernels
    and the primitive kernels ported beside them, in the reference's
    registration order and with its sizes, tolerances, kinds, variants
    and stream descriptors."""
    assert TK.names() == [n for n in RK.names() if n in SPECS + DAG_SPECS]
    assert TK.names("pipeline")[:3] == SPECS
    for name in SPECS + DAG_SPECS:
        t, j = TK.get(name), RK.get(name)
        assert (t.sizes, t.rtol, t.kind) == (j.sizes, j.rtol, j.kind)
        assert [v.name for v in t.variants] == [v.name for v in j.variants]
        for tv, jv in zip(t.variants, j.variants):
            assert tv.sizes == jv.sizes
        n = t.sizes[0]
        assert t.stream(n).capability == j.stream(n).capability
        assert t.stream(n).length() == j.stream(n).length()
        if name in SPECS:
            assert t.stream(16).capability == "RI"


def _registry_shapes():
    """Per-lane shapes of every registry case of the reference (base,
    split, blocked and tiled sizes) plus the predicates' boundaries."""
    out = []
    for name in SPECS:
        spec = RK.get(name)
        for variant in (spec.base,) + spec.variants:
            for n in variant.sizes:
                case = (variant.make_case or spec.make_case)(
                    np.random.default_rng(0), n)
                out.append((name, tuple(tuple(np.shape(a)[1:])
                                        for a in case)))
        for n in (96, 127, 128, 129, 160, 480, 511, 512, 513, 544):
            m = n if name == "cholesky_solve" else n + 4
            out.append((name, ((m, n), (m, 2))))
    return out


@pytest.mark.parametrize("name,shapes", _registry_shapes())
def test_dispatch_and_flops_match_reference(name, shapes):
    dtypes = ("float32",) * len(shapes)
    t, j = TK.get(name), RK.get(name)
    tv, jv = t.dispatch_key(shapes, dtypes), j.dispatch_key(shapes, dtypes)
    assert tv.name == jv.name
    assert t.model_flops(shapes, dtypes) == j.model_flops(shapes, dtypes)


@pytest.mark.parametrize("name,variant", [
    ("cholesky_solve", "base"), ("qr_solve", "base"),
    ("mmse_equalize", "base"), ("mmse_equalize", "split_complex")])
def test_fillers_match_reference(name, variant):
    t, j = TK.get(name), RK.get(name)
    pick = lambda s: s.base if variant == "base" else next(
        v for v in s.variants if v.name == variant)
    tv, jv = pick(t), pick(j)
    case = jv.make_case(np.random.default_rng(0), 8)
    shapes = tuple(np.shape(a)[1:] for a in case)
    dtypes = tuple(np.dtype("float32") for _ in case)
    got = tv.filler(shapes, dtypes)
    want = jv.filler(shapes, dtypes)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def _key(*shapes):
    return tuple((s, "float32") for s in shapes)


@pytest.mark.parametrize("small,big", [
    (((8, 8), (8, 2)), ((12, 12), (12, 2))),
    (((12, 8), (12, 2)), ((16, 12), (16, 2))),
    (((12, 8), (12, 1)), ((16, 12), (16, 2))),
    (((12, 8), (12, 2)), ((12, 12), (12, 2))),   # overhang does not fit
    (((12, 8), (12, 8), (12, 2), (12, 2)), ((16, 12), (16, 2))),
])
def test_coalescer_compatibility_matches_reference(small, big):
    for name in SPECS:
        t, j = TK.get(name).coalesce, RK.get(name).coalesce
        assert t.compatible(_key(*small), _key(*big)) == \
            j.compatible(_key(*small), _key(*big))


@pytest.mark.parametrize("name,small_n,big_n", [
    ("cholesky_solve", 8, 12), ("qr_solve", 8, 12),
    ("mmse_equalize", 8, 12)])
def test_coalesced_corner_bit_identical_to_solo(name, small_n, big_n):
    """A small job embedded block-diagonally into a big lane solves to
    exactly its solo answer (port against port)."""
    spec = TK.get(name)
    rng = np.random.default_rng(3)
    small = [a[0].numpy() for a in spec.make_case(rng, small_n)]
    big = [a[0].numpy() for a in spec.make_case(rng, big_n)]
    big_shapes = tuple(a.shape for a in big)
    embedded = spec.coalesce.embed(small, big_shapes)
    solo = spec.kernel(*(torch.from_numpy(a[None]) for a in small))[0]
    lanes = [np.stack([e, b]) for e, b in zip(embedded, big)]
    out = spec.kernel(*(torch.from_numpy(a) for a in lanes))[0]
    got = spec.coalesce.extract(out.numpy(),
                                tuple(a.shape for a in small))
    np.testing.assert_array_equal(got, solo.numpy())


def test_run_oracle_lane_routes_split_jobs():
    rng = np.random.default_rng(5)
    planes = [rng.standard_normal(s).astype(np.float32)
              for s in ((12, 8), (12, 8), (12, 2), (12, 2))]
    got = TK.get("mmse_equalize").run_oracle_lane(*planes)
    want = np.asarray(RK.get("mmse_equalize").run_oracle_lane(*planes))
    assert got.shape == (16, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name,n", [("cholesky_solve", 512),
                                    ("qr_solve", 512),
                                    ("mmse_equalize", 512)])
def test_tiled_variants_are_served_on_port_kernels(name, n):
    """A shape the reference sends to its tiled HBM-scale kernels
    dispatches to the port's ``tiled`` variant, whose entry point is the
    port's K12-K14 wrapper, and the mux enqueues the job."""
    spec = TK.get(name)
    m = n if name == "cholesky_solve" else n + 4
    v = spec.dispatch_key(((m, n), (m, 2)), ("float32", "float32"))
    assert v.name == "tiled"
    assert v.fn is {"cholesky_solve": tp.cholesky_solve_tiled_fused,
                    "qr_solve": tp.qr_solve_tiled_fused,
                    "mmse_equalize": tp.mmse_equalize_tiled_fused}[name]
    mux = SolverMux(lanes=2, clock=ManualClock(), device="cpu")
    job = mux.submit(name, np.eye(m, n, dtype=np.float32),
                     np.zeros((m, 2), np.float32))
    assert job.state == "queued"
    assert mux.pending() == 1
