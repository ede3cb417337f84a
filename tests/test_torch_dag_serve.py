"""The port's served pipeline DAGs (``SolverMux.submit_dag``) against the
reference's, on ``device="cpu"``: the golden staged-scheduling replay,
criticality-first admission, staged vs chained, mid-DAG fault
containment, stage-output bit-identity, and the registry's DAG
declarations (criticality, dispatch) shape for shape.

Float bit-identity is asserted port against port only; across the two
frameworks DAG outputs are held at the DAG's rtol (2e-3).
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import kernels as RK  # noqa: E402
from repro.launch import serve_solvers as RS  # noqa: E402
from repro_torch import kernels as TK  # noqa: E402
from repro_torch.launch import serve_solvers as TS  # noqa: E402
from repro_torch.serve import FaultInjector  # noqa: E402

from conftest import assert_close  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"

# (dag, n, priority, deadline_ticks, gap, chained), as the reference's
# deterministic grid
GRID_TRACES = [
    [("pusch_receive", 8, "hard", 8, 1, False),
     ("pusch_receive", 8, "hard", 7, 1, False),
     ("svd_solve", 8, "best_effort", 0, 0, False)],
    [("pusch_receive", 8, "hard", 4, 0, True),
     ("pusch_receive", 12, "best_effort", 0, 1, True),
     ("svd_solve", 12, "hard", 6, 0, False)],
]


def _trace_dicts(entries) -> list[dict]:
    trace, tick = [], 0
    for i, (dag, n, priority, deadline, gap, chained) in enumerate(entries):
        trace.append(dict(tick=tick, dag=dag, n=n, priority=priority,
                          deadline_ticks=deadline or None,
                          chained=chained and bool(
                              TK.get_dag(dag).chained),
                          seed=1000 + i))
        tick += gap
    return trace


def _golden_replay():
    trace = json.loads((DATA / "pusch_trace.json").read_text())
    return TS.replay_pusch(trace, device="cpu")


def test_golden_pusch_replay_event_sequence():
    """Byte for byte: the committed DAG trace replayed through the
    port's mux gives the committed golden event stream."""
    mux, dags = _golden_replay()
    got = json.dumps(mux.drain_events(), indent=1) + "\n"
    assert got == (DATA / "pusch_golden.json").read_text()
    assert all(d.state == "done" for d in dags)


def test_golden_trace_matches_generator():
    committed = json.loads((DATA / "pusch_trace.json").read_text())
    assert committed == TS.pusch_trace(4, seed=0) == RS.pusch_trace(4,
                                                                    seed=0)


def test_dag_outputs_match_reference_on_golden_trace():
    """The whole slice: every DAG of the golden trace, served by the
    port's mux and by the reference's, agrees at the DAG's rtol, and
    both agree with the port's ``DagSpec.oracle``."""
    trace = json.loads((DATA / "pusch_trace.json").read_text())
    _, tdags = TS.replay_pusch(trace, device="cpu")
    _, rdags = RS.replay_pusch(trace)
    assert len(tdags) == len(rdags) == 6
    for t, r in zip(tdags, rdags):
        spec = TK.get_dag(t.dag)
        assert spec.rtol == RK.get_dag(r.dag).rtol == 2e-3
        assert (t.dag, t.seq, t.state) == (r.dag, r.seq, r.state)
        label = f"{t.dag} seq {t.seq}"
        assert_close(t.out, np.asarray(r.out), rtol=spec.rtol,
                     name=f"{label} vs reference")
        assert_close(t.out, spec.oracle(*t.args), rtol=spec.rtol,
                     name=f"{label} vs oracle")


def test_criticality_rank_admits_critical_stage_first():
    """At t=2.0 the earlier DAG's slack equalize stage (lower job seq)
    and the later DAG's critical channel-estimate stage (higher seq)
    hold EQUAL deadlines; the criticality rank flushes chanest first."""
    mux, _ = _golden_replay()
    events = mux.drain_events()
    stage_of = {e["job"]: (e["stage"], e["critical"])
                for e in events if e["event"] == "dag_stage"}
    flushed = [(seq, *stage_of[seq]) for e in events
               if e["event"] == "flush" and e["t"] == 2.0
               for seq in e["jobs"] if seq in stage_of]
    names = [name for _, name, _ in flushed]
    i_crit, i_slack = names.index("chanest"), names.index("equalize")
    assert i_crit < i_slack, flushed
    assert flushed[i_crit][0] > flushed[i_slack][0], flushed
    assert flushed[i_crit][2] is True and flushed[i_slack][2] is False


def test_chained_e2e_latency_beats_staged():
    staged = TS.run_pusch(False, ticks=4, device="cpu")
    chained = TS.run_pusch(True, ticks=4, device="cpu")
    for s in (staged, chained):
        assert s["done"] == s["dags"] and s["hard_lost"] == 0
        assert s["max_rel_err"] < 2e-3
    assert chained["e2e_p50"] < staged["e2e_p50"]
    assert chained["launches"] < staged["launches"]
    want = RS.run_pusch(True, ticks=4)
    assert (chained["e2e_p50"], chained["launches"]) == \
        (want["e2e_p50"], want["launches"])


def test_mid_dag_stage_fault_contained():
    """The committed fault trace (channel estimate raises twice) is
    absorbed by launch supervision: retries, every DAG done, no hard
    DAG lost — with the reference's counts."""
    path = str(DATA / "pusch_fault_trace.json")
    s = TS.run_pusch(False, ticks=4, fault_trace=path, device="cpu")
    assert s["retries"] >= 1
    assert s["hard_lost"] == 0
    assert s["done"] == s["dags"]
    assert s["failed_jobs"] == 0
    want = RS.run_pusch(False, ticks=4, fault_trace=path)
    assert (s["retries"], s["launches"], s["e2e_p50"]) == \
        (want["retries"], want["launches"], want["e2e_p50"])


def test_mid_dag_fault_beyond_retries_cascades_cleanly():
    injector = FaultInjector({"target": [
        {"pipeline": "pusch_chanest", "variant": "base",
         "kind": "raise", "count": 50}]}, seed=0)
    mux, dags = TS.replay_pusch(_trace_dicts(GRID_TRACES[0]),
                                injector=injector, device="cpu")
    assert mux.pending() == 0
    pusch = [d for d in dags if d.dag == "pusch_receive"]
    assert pusch and all(d.state == "failed" for d in pusch)
    for d in pusch:
        assert d.reason.startswith("stage:chanest:")
        assert d.stages["equalize"] == "cancelled"
        assert d.stages["fft"].state == "done"
    assert all(d.state == "done" for d in dags if d.dag == "svd_solve")
    assert TS.dag_hard_lost(dags) == 0


@pytest.mark.parametrize("idx", range(len(GRID_TRACES)))
def test_stage_outputs_bit_identical_to_standalone(idx):
    """Every done stage job's served output (a padded, batched lane
    group) equals a standalone run of the dispatched variant on the same
    singleton-batch arguments, bit for bit; every stage is accounted."""
    mux, dags = TS.replay_pusch(_trace_dicts(GRID_TRACES[idx]),
                                device="cpu")
    assert mux.pending() == 0
    checked = 0
    for dj in dags:
        assert dj.state == "done"
        for name, sj in dj.stages.items():
            assert sj.state == "done", (dj.dag, name)
            variant = TK.get(sj.pipeline).dispatch_key(
                tuple(np.shape(a) for a in sj.args),
                tuple(np.asarray(a).dtype for a in sj.args))
            alone = variant.fn(*(torch.from_numpy(np.array(a)[None])
                                 for a in sj.args))[0].numpy()
            assert np.array_equal(sj.out, alone), (dj.dag, name)
            checked += 1
    assert checked >= 5


@pytest.mark.parametrize("dag", ["pusch_receive", "svd_solve"])
@pytest.mark.parametrize("n", [8, 12, 16, 24])
def test_dag_criticality_and_dispatch_match_reference(dag, n):
    """``DagSpec.criticality`` (staged and chained), the stage lists,
    and each stage's ``dispatch_key`` and model FLOPs at the stage
    shapes equal the reference's."""
    t, r = TK.get_dag(dag), RK.get_dag(dag)
    args = r.make_case(np.random.default_rng(n), n)
    for a, b in zip(args, t.make_case(np.random.default_rng(n), n)):
        np.testing.assert_array_equal(a, b)
    shapes = tuple(np.shape(a) for a in args)
    assert (t.crit_threshold, t.rtol) == (r.crit_threshold, r.rtol)
    for chained in ((False, True) if r.chained else (False,)):
        assert t.criticality(shapes, chained) == \
            r.criticality(shapes, chained)
        assert [s.name for s in t.stage_list(chained)] == \
            [s.name for s in r.stage_list(chained)]
        assert t.region_graph(shapes, chained).critical.name == \
            r.region_graph(shapes, chained).critical.name
    for ts, rs in zip(t.stages + t.chained, r.stages + r.chained):
        assert (ts.name, ts.pipeline, ts.consumes, ts.transcendental) == \
            (rs.name, rs.pipeline, rs.consumes, rs.transcendental)
        assert ts.model_flops(shapes) == rs.model_flops(shapes)
    # producer outputs at their served shapes, bound through each stage
    m = n + 4
    outs = {"fft": np.zeros((2, m, 64), np.float32),
            "chanest": np.zeros((m, n), np.float32),
            "factor": np.zeros((m + n + 1, n), np.float32)}
    for ts in t.stages + t.chained:
        bound = ts.bind(args, outs)
        st = tuple(np.shape(a) for a in bound)
        dt = tuple(np.asarray(a).dtype for a in bound)
        tp_, rp = TK.get(ts.pipeline), RK.get(ts.pipeline)
        assert tp_.dispatch_key(st, dt).name == rp.dispatch_key(st, dt).name
        assert tp_.model_flops(st, dt) == rp.model_flops(st, dt)


def test_pusch_cli_runs_on_cpu(capsys):
    out = TS.main(["--pusch", "--device", "cpu", "--ticks", "2"])
    assert out["staged"]["hard_lost"] == out["chained"]["hard_lost"] == 0
    assert out["staged"]["done"] == out["staged"]["dags"] == 3
    assert "stage-chained speedup" in capsys.readouterr().out
