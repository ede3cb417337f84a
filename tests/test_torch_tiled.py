"""The HBM-scale path (n >= 512, n % 32 == 0): the port's tiled kernels
K12 (``cholesky_solve_tiled``), K13 (``qr_solve_tiled``) and K14
(``mmse_equalize_tiled``) against the reference, their shape admission
and dispatch, and the mux and launcher serving the n = 512 slot mix on
the CPU.

The same numpy inputs, made from a seed (``strategies.spd_system`` /
``tall_system``), go through the reference's tiled Pallas kernels
(interpret mode on the CPU, as its own tests run them) and the port's
wrappers on CPU tensors, which run the kernels' plain PyTorch versions.
Tolerances are the reference's own (``tests/test_tiled.py``): the
Cholesky plain version against the reference kernel at 1e-4 for
n <= 256, QR and MMSE at 1e-3 there, every pipeline at 2e-3 for
n >= 512 (``test_tiled_matches_oracle_large``); against the oracle 1e-3,
2e-3 for n >= 512.  The CUDA kernels are held against these plain
versions on the card (``tests/test_torch_gpu.py``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import kernels as RK  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro import pipelines as rp  # noqa: E402
from repro_torch import kernels as TK  # noqa: E402
from repro_torch import pipelines as tp  # noqa: E402
from repro_torch.launch import serve_solvers as TS  # noqa: E402
from repro_torch.serve import (FaultInjector, ManualClock,  # noqa: E402
                               SolverMux)

from conftest import assert_close  # noqa: E402
from strategies import spd_system, tall_system  # noqa: E402

PIPELINES = ("cholesky_solve", "qr_solve", "mmse_equalize")
PORT = {"cholesky_solve": tp.cholesky_solve_tiled_fused,
        "qr_solve": tp.qr_solve_tiled_fused,
        "mmse_equalize": tp.mmse_equalize_tiled_fused}
REF = {"cholesky_solve": rp.cholesky_solve_tiled,
       "qr_solve": rp.qr_solve_tiled,
       "mmse_equalize": rp.mmse_equalize_tiled}
ORACLE = {"cholesky_solve": jref.cholesky_solve,
          "qr_solve": jref.qr_solve,
          "mmse_equalize": jref.mmse_equalize}


def _t(x):
    return torch.from_numpy(np.array(x))      # a writable copy


def _case(name, seed, n, k=2):
    if name == "cholesky_solve":
        return spd_system(seed, 1, n, k=k)
    return tall_system(seed, 1, n + 16, n, k=k)


def _both(name, a, b, bs):
    got = PORT[name](_t(a), _t(b), bs=bs).numpy()
    want = np.asarray(REF[name](jnp.asarray(a), jnp.asarray(b), bs=bs))
    return got, want


# ---------------- the plain versions against the reference ----------------

@pytest.mark.parametrize("name", PIPELINES)
@pytest.mark.parametrize("n,bs", [(128, 32), (256, 64), (512, 128),
                                  (1024, 128)])
def test_tiled_plain_matches_reference_kernel_and_oracle(name, n, bs):
    a, b = _case(name, n + bs, n)
    got, want = _both(name, a, b, bs)
    if n >= 512:
        rtol = rtol_o = 2e-3
    else:
        rtol = 1e-4 if name == "cholesky_solve" else 1e-3
        rtol_o = 1e-3
    assert_close(got, want, rtol=rtol, name=f"tiled-{name} n={n} bs={bs}")
    assert_close(got, np.asarray(ORACLE[name](a, b)), rtol=rtol_o,
                 name=f"tiled-{name}-oracle n={n} bs={bs}")


def test_tiled_cholesky_never_reads_the_upper_triangle():
    """NaN poured into the strict upper triangle changes nothing: the
    answer equals the clean lane's bit for bit, and the reference's."""
    n = 256
    a, b = spd_system(5, 1, n, k=2)
    poisoned = a.copy()
    poisoned[0][np.triu_indices(n, 1)] = np.nan
    got, want = _both("cholesky_solve", poisoned, b, 64)
    clean = tp.cholesky_solve_tiled_fused(_t(a), _t(b), bs=64).numpy()
    np.testing.assert_array_equal(got, clean)
    assert np.isfinite(want).all()
    assert_close(got, want, rtol=1e-4, name="tiled poisoned upper")


@pytest.mark.parametrize("rank", [40, 100, 129])
def test_tiled_cholesky_deficiency_across_tile_boundaries(rank):
    """Rank-deficient SPD input whose rank ends inside the first, second
    and third tile (bs = 64, n = 256): the port and the reference stay
    finite and, for a consistent right-hand side, both keep the residual
    |A x - b| below 1e-3 of |b| (the solution on the deficient subspace
    is not unique, so the residual is the property)."""
    n = 256
    a, _ = spd_system(rank, 1, n, k=2, rank=rank)
    rng = np.random.default_rng(rank + 1)
    b = (a @ rng.standard_normal((1, n, 2))).astype(np.float32)
    got, want = _both("cholesky_solve", a, b, 64)
    for x in (got, want):
        assert np.isfinite(x).all()
        resid = np.abs(a @ x - b).max() / np.abs(b).max()
        assert resid < 1e-3, (rank, resid)


@pytest.mark.parametrize("col", [10, 70, 130])
def test_tiled_qr_deficient_column_in_any_panel(col):
    """A zeroed column inside panel 0, 1 and 2 (bs = 64, n = 192): its
    solution component is zeroed, and the answer is within 2e-3 of the
    reference's tiled kernel."""
    n = 192
    a, b = tall_system(col, 1, n + 8, n, k=2, deficient_col=col)
    got, want = _both("qr_solve", a, b, 64)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[0, col], np.zeros(2, np.float32))
    assert abs(want[0, col]).max() < 1e-5
    assert_close(got, want, rtol=2e-3, name=f"tiled-qr deficient {col}")


# ---------------- shape admission ----------------

def _meta_args(name, n, m_extra=16):
    """Operands on the meta device: shapes only, nothing allocated."""
    m = n if name == "cholesky_solve" else n + m_extra
    return (torch.empty((1, m, n), device="meta"),
            torch.empty((1, m, 2), device="meta"))


@pytest.mark.parametrize("name", PIPELINES)
def test_tiled_wrapper_refuses_what_the_reference_asserts(name):
    """n % bs != 0, fewer than two slabs, and the reference's over-budget
    shape (n = 16384, bs = 128: 3 n bs floats alone pass 14 MiB) raise
    ValueError before anything is allocated (the operands live on the
    meta device), and the reference refuses each of them too."""
    cases = [(512, 96, "must tile"), (128, 128, "at least two slabs"),
             (16384, 128, "budget")]
    for n, bs, msg in cases:
        with pytest.raises(ValueError, match=msg):
            PORT[name](*_meta_args(name, n), bs=bs)
        a, b = (jax.ShapeDtypeStruct(t.shape, jnp.float32)
                for t in _meta_args(name, n))
        with pytest.raises(AssertionError):
            jax.eval_shape(functools.partial(REF[name], bs=bs), a, b)


def test_tiled_shape_contract_equals_the_reference():
    from repro.pipelines.cholesky_solve import (
        TILED_VMEM_BUDGET_BYTES, tiled_block_size)
    assert tp.TILED_VMEM_BUDGET_BYTES == TILED_VMEM_BUDGET_BYTES
    for n in (64, 96, 512, 544, 1024, 1888, 2048):
        assert tp.tiled_block_size(n) == tiled_block_size(n)
    with pytest.raises(ValueError):
        tp.tiled_block_size(528)
    for n, bs, m, k in ((512, 128, 528, 2), (1024, 64, 1040, 3)):
        assert tp.tiled_vmem_floats(n, bs, k) == rp.tiled_vmem_floats(
            n, bs, k)
        assert tp.qr_tiled_vmem_floats(m, n, bs, k) == \
            rp.qr_tiled_vmem_floats(m, n, bs, k)
        assert tp.mmse_tiled_vmem_floats(m, n, bs, k) == \
            rp.mmse_tiled_vmem_floats(m, n, bs, k)


# ---------------- dispatch ----------------

@pytest.mark.parametrize("name", PIPELINES)
@pytest.mark.parametrize("n", [512, 1024, 1888, 2048])
def test_dispatch_names_tiled_like_reference(name, n):
    mat = (n, n) if name == "cholesky_solve" else (n + 16, n)
    key = (mat, (mat[0], 2))
    dts = (np.float32, np.float32)
    port = TK.get(name).dispatch_key(key, dts)
    assert port.name == "tiled"
    assert port.name == RK.get(name).dispatch_key(key, dts).name
    assert n % tp.tiled_block_size(n) == 0


def test_tiled_variants_run_the_port_kernels():
    for name in PIPELINES:
        v = next(v for v in TK.get(name).variants if v.name == "tiled")
        assert v.fn is PORT[name]
        assert v.sizes == (512, 1024)
    assert tp.mmse_equalize_blocked is tp.mmse_equalize_tiled


# ---------------- serving the n = 512 mix on the CPU ----------------

def test_mux_serves_hbm_bucket_from_tiled_variant():
    """The reference's slow mux test on the port: one n = 512 job of each
    pipeline lands on the tiled variant and is within 2e-3 of the
    reference oracle."""
    mux = SolverMux(lanes=2, clock=ManualClock(), device="cpu")
    a, b = spd_system(0, 1, 512, k=2)
    jobs = [mux.submit("cholesky_solve", a[0], b[0])]
    a, b = tall_system(1, 1, 528, 512, k=2)
    jobs.append(mux.submit("qr_solve", a[0], b[0]))
    h, y = tall_system(2, 1, 528, 512, k=2)
    jobs.append(mux.submit("mmse_equalize", h[0], y[0]))
    assert len(mux.run()) == len(jobs)
    snap = mux.metrics()
    for name in PIPELINES:
        assert snap[name].dispatch_counts == {"tiled": 1}
    for job in jobs:
        assert job.state == "done"
        want = RK.get(job.pipeline).run_oracle_lane(*job.args)
        assert_close(job.out, np.asarray(want), rtol=2e-3,
                     name=f"mux-tiled-{job.pipeline}")


def test_launcher_serves_hbm_mix_with_reference_dispatch(capsys):
    """``serve_solvers --sizes 512`` on the CPU serves every job, drops
    no hard job, and dispatches each bucket where the reference registry
    does."""
    summary = TS.main(["--device", "cpu", "--slots", "2", "--lanes", "2",
                       "--sizes", "512"])
    capsys.readouterr()
    assert summary["done"] == summary["jobs"]
    assert summary["hard_dropped"] == 0
    assert summary["oracle_rel_err"] < 2e-3
    want: dict = {}
    for slot in range(2):
        for pipeline, arrays, _ in TS.build_slot_jobs(
                np.random.default_rng(0), slot, [512]):
            key = tuple(a.shape for a in arrays)
            v = RK.get(pipeline).dispatch_key(
                key, tuple(a.dtype for a in arrays))
            want.setdefault(pipeline, set()).add(v.name)
    for pipeline, counts in summary["dispatch"].items():
        assert set(counts) == want[pipeline], pipeline
    assert summary["dispatch"]["cholesky_solve"] == {"tiled": 1}
    assert summary["dispatch"]["qr_solve"] == {"tiled": 1}
    assert "tiled" in summary["dispatch"]["mmse_equalize"]


@pytest.mark.parametrize("name,fallback", [("cholesky_solve", "blocked"),
                                           ("qr_solve", "blocked"),
                                           ("mmse_equalize", "base")])
def test_repeated_tiled_failure_demotes_like_reference(name, fallback):
    """Two injected failures of a tiled bucket (demote_after = 2, the
    REPRO_SERVE_DEMOTE_AFTER default) demote it down the reference's
    ladder: tiled -> blocked for Cholesky and QR, tiled -> base for real
    MMSE, which has no blocked variant; the jobs are then served."""
    trace = {"target": [{"pipeline": name, "variant": "tiled",
                         "kind": "raise", "count": 2}]}
    mux = SolverMux(lanes=2, clock=ManualClock(),
                    injector=FaultInjector(trace, seed=0), device="cpu")
    jobs = [mux.submit(name, *TS.job_args(name, 512, 2, seed))
            for seed in range(2)]
    mux.poll()
    assert all(j.state == "done" for j in jobs)
    demotes = [e for e in mux.events if e["event"] == "demote"]
    assert [(e["from_variant"], e["to_variant"]) for e in demotes] == \
        [("tiled", fallback)]
    assert [e["variant"] for e in mux.events if e["event"] == "flush"] \
        == [fallback]
    for job in jobs:
        want = RK.get(name).run_oracle_lane(*job.args)
        assert_close(job.out, np.asarray(want), rtol=2e-3,
                     name=f"demoted-{name}")


@pytest.mark.parametrize("name,key", [
    ("cholesky_solve", (((1024, 1024), "float32"), ((1024, 2), "float32"))),
    ("qr_solve", (((1028, 1024), "float32"), ((1028, 1), "float32")))])
def test_card_demotion_passes_over_blocked_rung_that_cannot_launch(
        monkeypatch, name, key):
    """On the card K10/K11 keep a whole panel in shared memory and cannot
    launch at n = 1024, so a dispatcher on a CUDA device demotes a failing
    1024 tiled bucket straight to the base; on the CPU, where the plain
    versions take every shape, the ladder is the reference's and the
    launch check is never asked.  The check itself reads the kernel's
    shared-memory query, which needs the card (``tests/test_torch_gpu.py``
    holds it there); here it is stubbed."""
    from repro_torch.serve.solver import VariantDispatcher
    asked = []
    fits = f"{name}_blocked_fits"
    monkeypatch.setattr(tp, fits, lambda *a: asked.append(a) or False)
    spec = TK.get(name)
    card = VariantDispatcher(spec, device=torch.device("cuda"))
    assert card.resolve(key)[0].name == "tiled"
    tiled = card.resolve(key)[0]
    assert card.note_failure(key, tiled, 2) is None
    assert card.note_failure(key, tiled, 2).name == "base"
    assert card.resolve(key)[0].name == "base" and asked

    monkeypatch.setattr(tp, fits, lambda *a: pytest.fail("asked on CPU"))
    cpu = VariantDispatcher(spec, device=torch.device("cpu"))
    tiled = cpu.resolve(key)[0]
    cpu.note_failure(key, tiled, 1)
    assert cpu.resolve(key)[0].name == "blocked"
