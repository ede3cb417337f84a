"""The port's serving stack against the reference's: the golden trace
replay, the overload scenario's counts, a slot-mix run job by job, the
cost model's calibration, import hygiene and the device default."""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import kernels as RK  # noqa: E402
from repro.launch import serve_solvers as RS  # noqa: E402
from repro.serve import CostModel as RefCostModel  # noqa: E402
from repro.serve import ManualClock as RefClock  # noqa: E402
from repro.serve import SolverMux as RefMux  # noqa: E402
from repro_torch.launch import serve_solvers as TS  # noqa: E402
from repro_torch.serve import (CostModel, ManualClock,  # noqa: E402
                               OverloadPolicy, PipelineEngine, SolveJob,
                               SolverMux)

from conftest import assert_close  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"
ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_golden_trace_replay_event_sequence():
    """The committed overload trace, replayed through the port's mux on
    the CPU with the reference test's settings, gives exactly the
    reference's golden event stream."""
    trace = TS.load_trace(DATA / "overload_trace.json")
    mux = TS.replay_trace(trace, lanes=2, policy=OverloadPolicy(
        budget=6.5e-5, cost_model=CostModel()), pressure=4, device="cpu")
    got = json.loads(json.dumps(mux.events))
    want = json.loads((DATA / "overload_golden.json").read_text())
    assert got == want


@pytest.mark.parametrize("policy", [True, False])
def test_run_overload_summary_matches_reference(policy):
    got = TS.run_overload(policy, device="cpu")
    want = RS.run_overload(policy)
    assert got == want
    assert got["hard_dropped"] == 0


def test_slot_mix_jobs_match_reference_mux():
    """A short slot mix (3 slots, n = 8) served by both muxes on the same
    virtual schedule: the same jobs, the same launches, and every job's
    output within the spec's rtol of the reference's."""
    sizes = [8]

    def serve(mod, mux):
        rng = np.random.default_rng(0)
        jobs = []
        for slot in range(3):
            for pipeline, arrays, priority in mod.build_slot_jobs(
                    rng, slot, sizes):
                jobs.append(mux.submit(pipeline, *arrays,
                                       deadline=mux.clock() + 2e-3,
                                       priority=priority))
            mux.poll()
            mux.clock.advance(0.5e-3)
        mux.run()
        return jobs

    tjobs = serve(TS, SolverMux(lanes=4, max_wait=1e-3,
                                clock=ManualClock(), device="cpu"))
    rjobs = serve(RS, RefMux(lanes=4, max_wait=1e-3, clock=RefClock()))
    assert len(tjobs) == len(rjobs) > 0
    for t, r in zip(tjobs, rjobs):
        assert (t.pipeline, t.seq, t.state) == (r.pipeline, r.seq, r.state)
        for a, b in zip(t.args, r.args):
            np.testing.assert_array_equal(a, b)
        assert_close(t.out, np.asarray(r.out),
                     rtol=RK.get(t.pipeline).rtol,
                     name=f"{t.pipeline} job {t.seq}")


def test_cost_model_calibration_matches_reference():
    """``CostModel.from_bench_json`` on the committed CPU interpret-mode
    baseline gives exactly the reference's rates and overhead — the
    numbers golden pricing needs, not the card's."""
    path = ROOT / "BENCH_pipelines.json"
    t, r = CostModel.from_bench_json(path), RefCostModel.from_bench_json(
        path)
    assert t.table == r.table and len(t.table) > 0
    assert t.overhead() == r.overhead()
    for pipeline, variant in t.table:
        assert t.source(pipeline, variant) == r.source(pipeline, variant)


def test_pipeline_engine_serves_on_cpu():
    eng = PipelineEngine("cholesky_solve", lanes=4, device="cpu")
    case = [np.asarray(a) for a in RK.get("cholesky_solve").make_case(
        np.random.default_rng(0), 8)]
    jobs = [eng.submit(SolveJob(args=(case[0][i], case[1][i])))
            for i in range(2)]
    eng.run()
    for job in jobs:
        want = RK.get("cholesky_solve").run_oracle_lane(*job.args)
        assert_close(job.out, np.asarray(want), rtol=1e-4)


def test_main_cpu_run_reports_summary():
    summary = TS.main(["--slots", "3", "--sizes", "8", "--policy",
                       "--device", "cpu"])
    assert summary["done"] == summary["jobs"] > 0
    assert summary["hard_dropped"] == 0
    assert summary["oracle_rel_err"] < 1e-3


@pytest.mark.parametrize("flag", [["--pusch", "--mesh", "2"],
                                  ["--decode", "--mesh", "2"],
                                  ["--chaos"], ["--mesh", "2"]])
def test_main_refuses_later_slices(flag, capsys):
    with pytest.raises(SystemExit):
        TS.main(flag + ["--device", "cpu"])
    assert "later slice" in capsys.readouterr().err


def test_mux_refuses_what_is_not_ported():
    """Mesh-sharded lane pools, and models of the families a later slice
    brings (token decode itself is served since the LM slice)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tT
    with pytest.raises(NotImplementedError, match="later slice"):
        SolverMux(lanes=2, mesh_size=2, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        tT.init_params(torch.Generator(), get_smoke("dbrx-132b"))


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    """With no GPU, the entry points raise unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch import pipelines as tp
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SolverMux()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PipelineEngine("qr_solve")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.main(["--pusch"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.pusch_fft(np.zeros((1, 2, 64), np.float32),
                     np.zeros((1, 2, 64), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.cholesky_solve(np.eye(2, dtype=np.float32)[None],
                          np.ones((1, 2, 1), np.float32))
    assert SolverMux(device="cpu").device.type == "cpu"


def test_importing_the_port_pulls_in_neither_jax_nor_repro():
    """Every module of repro_torch imports in a fresh interpreter without
    bringing ``jax`` or the reference package into ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' "
        "or n.startswith('jax.') or n == 'repro' "
        "or n.startswith('repro.'))\n"
        "print(len([n for n in sys.modules "
        "if n.startswith('repro_torch')]), bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 20


def test_chip_smoke_imports_neither_jax_nor_repro():
    src = (ROOT / "chip_smoke.py").read_text()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in ("jax", "repro"), line
