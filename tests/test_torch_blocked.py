"""The mid-range large-n path (n = 128-511, n % 32 == 0): the port's
blocked kernels K10 (``cholesky_solve_blocked``) and K11
(``qr_solve_blocked``) against the reference, and the mux and launcher
serving the mid-range slot mix on the CPU.

The same numpy inputs, made from a seed, go through the reference's
blocked Pallas kernels (interpret mode on the CPU, as its own tests run
them) and the port's wrappers on CPU tensors, which run the kernels'
plain PyTorch versions: the blocked algorithm with the reference's op
order, held at the reference's own tolerances (``tests/test_variants.py``:
1e-4 Cholesky against the reference kernel, 1e-3 against the oracle and
for QR, 2e-3 for served answers).  The CUDA kernels are held against
these plain versions on the card (``tests/test_torch_gpu.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import kernels as RK  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import serve_solvers as RS  # noqa: E402
from repro.pipelines import cholesky_solve_blocked as ref_chol  # noqa: E402
from repro.pipelines import qr_solve_blocked as ref_qr  # noqa: E402
from repro.serve import ManualClock as RefClock  # noqa: E402
from repro.serve import SolverMux as RefMux  # noqa: E402
from repro_torch import kernels as TK  # noqa: E402
from repro_torch import pipelines as tp  # noqa: E402
from repro_torch.kernels.common import sample_spd  # noqa: E402
from repro_torch.launch import serve_solvers as TS  # noqa: E402
from repro_torch.pipelines.cholesky_solve import block_size  # noqa: E402
from repro_torch.serve import (FaultInjector, ManualClock,  # noqa: E402
                               SolverMux)

from conftest import assert_close  # noqa: E402
from strategies import spd_system  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))      # a writable copy


def _chol(a, b, bs=None):
    got = tp.cholesky_solve_blocked_fused(_t(a), _t(b), bs=bs).numpy()
    want = np.asarray(ref_chol(jnp.asarray(a), jnp.asarray(b), bs=bs))
    return got, want


def _qr(a, b, bs=None):
    got = tp.qr_solve_blocked_fused(_t(a), _t(b), bs=bs).numpy()
    want = np.asarray(ref_qr(jnp.asarray(a), jnp.asarray(b), bs=bs))
    return got, want


# ---------------- K10: blocked Cholesky ----------------

@pytest.mark.parametrize("n,bs", [(128, 32), (128, 64), (256, 64)])
def test_blocked_cholesky_matches_reference_and_oracle(n, bs):
    a, b = spd_system(n + bs, 2 if n < 256 else 1, n, k=3)
    got, want = _chol(a, b, bs)
    assert_close(got, want, rtol=1e-4, name=f"chol-blocked n={n} bs={bs}")
    assert_close(got, np.asarray(jref.cholesky_solve(a, b)), rtol=1e-3,
                 name=f"chol-blocked-oracle n={n} bs={bs}")


@pytest.mark.parametrize("rhs", [1, 5])
def test_blocked_cholesky_rhs_widths(rhs):
    a, b = spd_system(rhs, 2, 128, k=rhs)
    got, want = _chol(a, b, 32)
    assert got.shape == (2, 128, rhs)
    assert_close(got, want, rtol=1e-4, name=f"chol-blocked rhs={rhs}")


def test_blocked_cholesky_never_reads_the_upper_triangle():
    """NaN poured into the strict upper triangle changes nothing: the
    answer equals the clean lane's bit for bit, and the reference's."""
    a, b = spd_system(7, 1, 128, k=2)
    poisoned = a.copy()
    iu = np.triu_indices(128, 1)
    poisoned[:, iu[0], iu[1]] = np.nan
    got, want = _chol(poisoned, b, 32)
    clean = tp.cholesky_solve_blocked_fused(_t(a), _t(b), bs=32).numpy()
    np.testing.assert_array_equal(got, clean)
    assert_close(got, want, rtol=1e-4, name="chol-blocked poisoned")


def _deficient_spd(rng, n, dup):
    """SPD a = M M^T whose row/column ``dup`` repeats row 3: the pivot at
    ``dup`` is rank-deficient, in whichever panel holds it."""
    mm = rng.standard_normal((n, n)).astype(np.float32)
    mm[dup] = mm[3]
    return (mm @ mm.T)[None]


@pytest.mark.parametrize("case", ["singular", "deficient_pivot_panel_2"])
def test_blocked_cholesky_deficient_lanes_zero_like_reference(case):
    """A singular lane (rank 5 of 128) and a deficient pivot in the
    second panel (column 40 at bs = 32) stay finite and zero the same
    solution components as the reference."""
    rng = np.random.default_rng(11)
    if case == "singular":
        a, b = spd_system(11, 1, 128, k=2, rank=5)
    else:
        a = _deficient_spd(rng, 128, 40)
        b = rng.standard_normal((1, 128, 2)).astype(np.float32)
    got, want = _chol(a, b, 32)
    assert np.isfinite(got).all()
    zeros = np.all(want == 0, axis=-1)
    assert zeros.any()
    np.testing.assert_array_equal(np.all(got == 0, axis=-1), zeros)
    if case != "singular":
        assert zeros[0, 40]
    assert_close(got, want, rtol=1e-3, name=f"chol-blocked {case}")


# ---------------- K11: blocked (compact-WY) QR ----------------

@pytest.mark.parametrize("bs", [32, 64])
@pytest.mark.parametrize("m,n", [(132, 128), (160, 128)])
def test_blocked_qr_matches_reference(m, n, bs):
    rng = np.random.default_rng(m + bs)
    a = rng.standard_normal((2, m, n)).astype(np.float32)
    b = rng.standard_normal((2, m, 2)).astype(np.float32)
    got, want = _qr(a, b, bs)
    assert_close(got, want, rtol=1e-3, name=f"qr-blocked m={m} n={n}")
    assert_close(got, np.asarray(jref.qr_solve(a, b)), rtol=1e-3,
                 name=f"qr-blocked-oracle m={m} n={n}")


@pytest.mark.parametrize("rhs", [1, 5])
def test_blocked_qr_rhs_widths(rhs):
    rng = np.random.default_rng(rhs)
    a = rng.standard_normal((1, 132, 128)).astype(np.float32)
    b = rng.standard_normal((1, 132, rhs)).astype(np.float32)
    got, want = _qr(a, b, 32)
    assert got.shape == (1, 128, rhs)
    assert_close(got, want, rtol=1e-3, name=f"qr-blocked rhs={rhs}")


def test_blocked_qr_rank_deficient_column_in_second_panel():
    """A zero column in the second panel (column 40 at bs = 32) gives an
    exactly zero pivot: its component is zeroed as in the reference, and
    a duplicated column beside it leaves every lane finite."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, 132, 128)).astype(np.float32)
    a[:, :, 40] = 0.0
    a[1, :, 50] = a[1, :, 3]
    b = rng.standard_normal((2, 132, 2)).astype(np.float32)
    got, want = _qr(a, b, 32)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[:, 40], np.zeros((2, 2), np.float32))
    np.testing.assert_array_equal(np.all(got == 0, axis=-1),
                                  np.all(want == 0, axis=-1))
    assert_close(got[0], want[0], rtol=1e-3, name="qr-blocked zero column")


def test_blocked_variants_registered_on_the_port_kernels():
    for name, fn in (("cholesky_solve", tp.cholesky_solve_blocked_fused),
                     ("qr_solve", tp.qr_solve_blocked_fused)):
        v = next(v for v in TK.get(name).variants if v.name == "blocked")
        assert v.fn is fn
        assert v.sizes == (128, 256)
    with pytest.raises(ValueError, match="does not tile"):
        tp.cholesky_solve_blocked_fused(torch.eye(96)[None].contiguous(),
                                        torch.ones((1, 96, 1)), bs=64)


@pytest.mark.parametrize("kernel", ["cholesky", "qr"])
def test_blocked_plain_takes_any_panel_width(kernel):
    """Any panel width that tiles n is taken, as by the reference: at
    bs = 16 the plain version matches the reference's blocked kernel (on
    the card K10's SYRK tiles and K11's reflector pairs now cover the
    remainder, held against this plain version in test_torch_gpu.py)."""
    assert block_size(128) == 64
    assert block_size(160) == 32
    assert block_size(128, 16) == 16
    rng = np.random.default_rng(16)
    if kernel == "cholesky":
        a, b = spd_system(16, 1, 128, k=2)
        got, want = _chol(a, b, 16)
        rtol = 1e-4
    else:
        a = rng.standard_normal((1, 132, 128)).astype(np.float32)
        b = rng.standard_normal((1, 132, 2)).astype(np.float32)
        got, want = _qr(a, b, 16)
        rtol = 1e-3
    assert_close(got, want, rtol=rtol, name=f"{kernel}-blocked plain bs=16")


# ---------------- serving the mid-range mix ----------------

def _mixed_trace(submit, rng):
    """The reference's mixed-size, mixed-arity trace
    (``tests/test_variants.py``): n = 8 and n = 128 Cholesky, 4-plane
    MMSE and 132 x 128 QR, twice."""
    jobs = []
    for _ in range(2):
        jobs.append(submit("cholesky_solve", sample_spd(rng, 1, 8)[0],
                           rng.standard_normal((8, 2)).astype(np.float32)))
        jobs.append(submit("cholesky_solve", sample_spd(rng, 1, 128)[0],
                           rng.standard_normal((128, 2))
                           .astype(np.float32)))
        m, n = 16, 12
        jobs.append(submit("mmse_equalize",
                           *[rng.standard_normal(s).astype(np.float32)
                             for s in ((m, n), (m, n), (m, 1), (m, 1))]))
        jobs.append(submit("qr_solve",
                           rng.standard_normal((132, 128))
                           .astype(np.float32),
                           rng.standard_normal((132, 1))
                           .astype(np.float32)))
    return jobs


def test_mux_serves_mixed_trace_like_reference():
    """Both muxes serve the same mixed trace: every bucket's variant
    record and dispatch counts are the reference's, and every answer is
    within 2e-3 of the reference mux's."""
    tmux = SolverMux(lanes=2, clock=ManualClock(), device="cpu")
    rmux = RefMux(lanes=2, clock=RefClock())
    tjobs = _mixed_trace(tmux.submit, np.random.default_rng(11))
    rjobs = _mixed_trace(rmux.submit, np.random.default_rng(11))
    assert len(tmux.run()) == len(rmux.run()) == len(tjobs)
    for tj, rj in zip(tjobs, rjobs):
        assert tj.state == rj.state == "done"
        assert_close(tj.out, np.asarray(rj.out), rtol=2e-3,
                     name=f"mux-{tj.pipeline}-{tj.args[0].shape}")

    def records(mux):
        return sorted((l.pipeline, str(l.shape), l.variant)
                      for l in mux.metrics().launches)

    assert records(tmux) == records(rmux)
    by_shape = {(l.pipeline, l.shape[0][0]): l.variant
                for l in tmux.metrics().launches}
    assert by_shape[("cholesky_solve", (128, 128))] == "blocked"
    assert by_shape[("qr_solve", (132, 128))] == "blocked"
    tsnap, rsnap = tmux.metrics(), rmux.metrics()
    for name in ("cholesky_solve", "mmse_equalize", "qr_solve"):
        assert tsnap[name].dispatch_counts == rsnap[name].dispatch_counts


def _dispatch_table(out: str) -> dict:
    """pipeline -> the dispatch column of a launcher's printed table."""
    lines = out.splitlines()
    head = next(i for i, l in enumerate(lines) if l.startswith("pipeline"))
    rows = {}
    for line in lines[head + 2:]:
        if line.startswith("deadline misses"):
            break
        words = line.split()
        rows[words[0]] = words[-1]
    return rows


def test_launcher_serves_mid_range_mix_like_reference(capsys):
    argv = ["--slots", "2", "--lanes", "4", "--sizes", "128,256"]
    summary = TS.main(argv + ["--device", "cpu"])
    port = _dispatch_table(capsys.readouterr().out)
    assert summary["done"] == summary["jobs"] == 14
    assert summary["hard_dropped"] == 0
    assert summary["oracle_rel_err"] < 1e-3
    RS.main(argv)
    ref = _dispatch_table(capsys.readouterr().out)
    assert port == ref
    assert port == {"cholesky_solve": "blocked:2",
                    "mmse_equalize": "base:2,split_complex:2",
                    "qr_solve": "blocked:2"}
    assert summary["dispatch"]["cholesky_solve"] == {"blocked": 2}


def test_repeated_blocked_failure_demotes_to_base():
    """The reference's demotion test (``tests/test_faults.py``) on the
    port: n = 128 resolves the blocked Cholesky; failing it twice
    (demote_after = 2) demotes the bucket to base, whose kernel takes the
    lane, and the demotion sticks."""
    trace = {"target": [{"pipeline": "cholesky_solve",
                         "variant": "blocked", "kind": "raise",
                         "count": 2}]}
    mux = SolverMux(lanes=2, clock=ManualClock(),
                    injector=FaultInjector(trace, seed=0), device="cpu")

    def args(seed):
        return TS.job_args("cholesky_solve", 128, 3, seed)

    def events(*kinds):
        return [e for e in mux.events if e["event"] in kinds]

    jobs = [mux.submit("cholesky_solve", *args(i)) for i in range(2)]
    mux.poll()
    assert all(j.state == "done" for j in jobs)
    demotes = events("demote")
    assert len(demotes) == 1
    assert demotes[0]["from_variant"] == "blocked"
    assert demotes[0]["to_variant"] == "base"
    assert [e["variant"] for e in events("flush")] == ["base"]
    snap = mux.metrics()
    assert snap.faults.demotions == 1
    assert snap.faults.alerts == ("demote:cholesky_solve:blocked->base",)
    for job in jobs:
        want = RK.get("cholesky_solve").run_oracle_lane(*job.args)
        assert_close(job.out, np.asarray(want), rtol=1e-3, name="demoted")
    more = [mux.submit("cholesky_solve", *args(9 + i)) for i in range(2)]
    mux.poll()
    assert all(j.state == "done" for j in more)
    assert [e["variant"] for e in events("flush")] == ["base", "base"]
