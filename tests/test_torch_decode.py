"""The port's continuous-batching decode serving (``repro_torch.serve.
decode``, the mux's decode front-end, ``serve_solvers --decode`` and the
LM launcher) — the characterizations of the reference's
``tests/test_decode_serve.py``, run on the port on the CPU, plus the
committed golden trace replayed event for event and the port's step and
token counts held equal to the reference's on the same trace.

Greedy decoding is held for equality; sampling only for per-request
independence (JAX's ``fold_in`` streams cannot be matched bit for bit).
The replay engine's ``eos_id=-1`` makes the golden event stream depend
on the trace's lengths only, never on either model's floating point.
"""
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve_solvers as RS  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import serve as TLS  # noqa: E402
from repro_torch.launch import serve_solvers as TS  # noqa: E402
from repro_torch.launch.serve_solvers import (decode_model,  # noqa: E402
                                              decode_prompt, decode_trace,
                                              replay_decode,
                                              run_decode_serve)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import (CostModel, ManualClock,  # noqa: E402
                               OverloadPolicy, SolverMux)
from repro_torch.serve.decode import DecodeEngine, Request  # noqa: E402
from strategies import decode_traffic, fuzzed, integers  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"


def _engine(batch=4):
    cfg, params = decode_model("cpu")
    return DecodeEngine(cfg, params, batch=batch, max_len=64, eos_id=-1)


@pytest.fixture(scope="module")
def engine():
    """Shared standalone engine: ``eos_id=-1`` makes every request run
    exactly ``max_new`` steps — tests that need EOS semantics override
    ``engine.eos`` in place."""
    return _engine()


def _solo(engine, prompt, max_new=5, temperature=0.0):
    r = engine.submit(Request(prompt=list(prompt), max_new=max_new,
                              temperature=temperature))
    engine.run()
    return r.out


# ---------------- engine characterization ----------------

def test_greedy_deterministic_across_pool_compositions(engine):
    alone = _solo(engine, [9, 8, 7, 6])
    r1 = engine.submit(Request(prompt=[9, 8, 7, 6], max_new=5))
    engine.submit(Request(prompt=[30, 31, 32], max_new=4))
    engine.submit(Request(prompt=[40], max_new=6))
    engine.run()
    r2 = engine.submit(Request(prompt=[9, 8, 7, 6], max_new=5))
    engine.submit(Request(prompt=[3, 4], max_new=6, temperature=1.0))
    engine.submit(Request(prompt=[5], max_new=6, temperature=0.7))
    engine.run()
    assert alone == r1.out == r2.out


def test_eos_stops_generation_per_request(engine):
    """A token the model generates, declared EOS, stops the request at
    its first occurrence; pool mates stop on their own terms."""
    base = _solo(engine, [11, 12, 13], max_new=6)
    assert len(base) == 6
    engine.eos = base[3]
    try:
        r = engine.submit(Request(prompt=[11, 12, 13], max_new=6))
        mate = engine.submit(Request(prompt=[40], max_new=4))
        engine.run()
        assert r.out == base[:base.index(engine.eos) + 1]
        assert r.done and mate.done
        assert len(mate.out) == 4 or mate.out[-1] == engine.eos
    finally:
        engine.eos = -1


def test_max_new_honored_and_clamped(engine):
    reqs = [engine.submit(Request(prompt=[2 + i], max_new=1 + i))
            for i in range(6)]
    engine.run()
    assert [len(r.out) for r in reqs] == [1, 2, 3, 4, 5, 6]
    r = engine.submit(Request(prompt=[7, 8], max_new=10_000))
    assert r.max_new == engine.max_len - 2
    engine._queue.remove(r)
    with pytest.raises(ValueError):
        engine.submit(Request(prompt=[], max_new=1))
    with pytest.raises(ValueError):
        engine.submit(Request(prompt=[1] * 64, max_new=1))


def test_paged_slot_reuse_does_not_contaminate(engine):
    before = _solo(engine, [21, 22], max_new=4)
    for i in range(5):
        engine.submit(Request(prompt=[3 + i] * 8, max_new=12))
    engine.run()
    assert _solo(engine, [21, 22], max_new=4) == before


def test_single_request_lockstep_bit_identity(engine):
    cont = _solo(engine, [9, 4, 2], max_new=5)
    r = engine.submit(Request(prompt=[9, 4, 2], max_new=5))
    engine.run_lockstep()
    assert r.out == cont


def test_continuous_retires_heterogeneous_batch_in_fewer_steps(engine):
    mk = lambda: [Request(prompt=[2 + i] * (1 + i % 4),
                          max_new=1 + 2 * (i % 4)) for i in range(8)]
    engine.steps = 0
    for r in mk():
        engine.submit(r)
    engine.run()
    cont_steps = engine.steps
    engine.steps = 0
    for r in mk():
        engine.submit(r)
    engine.run_lockstep()
    assert cont_steps < engine.steps


# ---------------- per-slot sampling ----------------

def test_lockstep_pool_sampling_regression(engine):
    """Under run_lockstep one sampling pool mate switches the WHOLE pool
    to the shared stream, changing a co-batched greedy request."""
    engine.gen.manual_seed(0)
    solo = engine.submit(Request(prompt=[9, 8, 7, 6], max_new=5))
    engine.run_lockstep()
    engine.gen.manual_seed(0)
    greedy = engine.submit(Request(prompt=[9, 8, 7, 6], max_new=5))
    engine.submit(Request(prompt=[3, 4], max_new=5, temperature=1.0))
    engine.run_lockstep()
    assert greedy.out != solo.out


def test_sampling_requests_have_private_streams(engine):
    a = engine.submit(Request(prompt=[5, 6], max_new=8, temperature=1.0))
    b = engine.submit(Request(prompt=[5, 6], max_new=8, temperature=1.0))
    engine.run()
    assert a.out != b.out
    replay = Request(prompt=[5, 6], max_new=8, temperature=1.0)
    replay.seq = a.seq
    engine.submit(replay)
    engine.run()
    assert replay.out == a.out


# ---------------- slot accounting ----------------

def test_slot_accounting_never_leaks(engine):
    reqs = [engine.submit(Request(prompt=[2 + i], max_new=i % 3))
            for i in range(9)]
    done = engine.run()
    assert engine.occupied() == 0 and engine.pending() == 0
    assert not engine.has_work()
    assert all(r is None for r in engine._slot_req)
    assert sorted(r.seq for r in done) == sorted(r.seq for r in reqs)
    assert all(r.done and not r.dropped for r in reqs)


def test_shed_expired_drops_only_queued_best_effort(engine):
    hard = engine.submit(Request(prompt=[2], max_new=2, priority="hard",
                                 deadline=-1.0))
    engine.step()
    in_slot = engine.submit(Request(prompt=[3], max_new=2, deadline=-1.0))
    engine.step()
    queued = engine.submit(Request(prompt=[4], max_new=2, deadline=-1.0))
    live = engine.submit(Request(prompt=[5], max_new=2, deadline=1e9))
    shed = engine.shed_expired(engine.clock())
    assert shed == [queued] and queued.dropped
    engine.run()
    assert hard.done and in_slot.done and live.done and not queued.done


def test_engine_runs_on_its_parameters_device_and_cast_copy(engine):
    """The engine runs where its parameters lie, on a copy of the
    matrices cast once to the compute dtype."""
    assert engine.device.type == "cpu"
    assert engine.params["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert engine.cache["k"].shape == (engine.cfg.n_layers, 4, 64,
                                       engine.cfg.n_kv, engine.cfg.d_head)


# ---------------- mux integration ----------------

def _mux(engine, budget=None):
    clock = ManualClock()
    engine.clock = clock
    mux = SolverMux(lanes=4, max_wait=0.0, clock=clock, device="cpu",
                    policy=OverloadPolicy(budget=budget,
                                          cost_model=CostModel()))
    mux.attach_decode(engine)
    return mux, clock


def test_mux_decode_admission_validation():
    mux = SolverMux(lanes=4, device="cpu")
    with pytest.raises(RuntimeError):
        mux.submit_decode(Request(prompt=[2]))
    eng = _engine()
    mux.attach_decode(eng)
    with pytest.raises(ValueError):
        mux.submit_decode(Request(prompt=[2]), priority="urgent")
    with pytest.raises(ValueError):
        mux.attach_decode(eng)


def test_mux_serves_decode_alongside_solvers():
    eng = _engine()
    mux, clock = _mux(eng)
    jobs = [mux.submit("mmse_equalize",
                       *TS.job_args("mmse_equalize", 8, 2, i))
            for i in range(2)]
    reqs = [mux.submit_decode(Request(prompt=[2 + i], max_new=3),
                              priority="hard") for i in range(2)]
    for _ in range(4):
        mux.poll()
        clock.advance(1.0)
    mux.run()
    assert all(j.state == "done" for j in jobs)
    assert all(r.done for r in reqs)
    snap = mux.metrics()
    assert snap.decode.requests == 2 and snap.decode.tokens == 6
    assert snap.decode.insert.count == 2
    assert snap.decode.prefill.count == 2
    assert snap.decode.generate.count == 2
    assert snap.decode.tokens_per_step > 0
    kinds = {e["event"] for e in mux.drain_events()}
    assert {"decode_attach", "decode_insert", "decode_step",
            "decode_done", "flush"} <= kinds


def test_mux_sheds_expired_best_effort_decode_never_hard():
    eng = _engine(batch=1)
    mux, clock = _mux(eng, budget=1e-12)
    blocker = mux.submit_decode(Request(prompt=[2], max_new=8),
                                priority="hard")
    stale = mux.submit_decode(Request(prompt=[3], max_new=2), deadline=0.5)
    hard = mux.submit_decode(Request(prompt=[4], max_new=2),
                             priority="hard", deadline=0.5)
    for _ in range(8):
        mux.poll()
        clock.advance(1.0)
    assert stale.dropped and not stale.done
    assert blocker.done and hard.done
    snap = mux.metrics()
    assert snap.decode.shed == 1
    assert snap["decode"].dropped == 1
    assert any(e["event"] == "drop" and e.get("pipeline") == "decode"
               for e in mux.drain_events())
    assert mux.pending() == 0


def test_mux_budget_defers_best_effort_decode():
    eng = _engine()
    mux, clock = _mux(eng, budget=1e-12)
    r = mux.submit_decode(Request(prompt=[2], max_new=2))
    mux.poll()
    assert not r.done
    assert any(e["event"] == "decode_defer" for e in mux.drain_events())
    mux.run()
    assert r.done


def test_decode_prices_and_observes_through_the_cost_model():
    """A decode step is priced at decode_cost("generate", active x
    token_flops), the registry's DecodeSpec FLOPs equal the reference's,
    and the measured step wall reaches the drift monitor."""
    from repro import kernels as RK
    from repro.configs import get_smoke as rget_smoke
    from repro_torch import kernels as TK
    eng = _engine()
    assert TK.decode_names() == RK.decode_names() == ["lm_decode"]
    assert eng.token_flops == RK.get_decode("lm_decode").token_flops(
        rget_smoke("phi4-mini-3.8b"))
    mux, clock = _mux(eng)
    mux.submit_decode(Request(prompt=[2, 3], max_new=2), priority="hard")
    mux.poll()
    mux.run()
    assert any(k.startswith("decode/") for k in mux.metrics().drift)


# ---------------- golden mixed solver+decode replay ----------------

def test_golden_trace_matches_generator():
    committed = json.loads((DATA / "decode_trace.json").read_text())
    assert committed == decode_trace(4, seed=0) == RS.decode_trace(4, seed=0)


def test_golden_decode_replay_event_sequence():
    """The committed mixed trace on the virtual clock, through the port's
    mux on the CPU: the event stream equals the golden file byte for
    byte."""
    trace = json.loads((DATA / "decode_trace.json").read_text())
    mux, eng, requests, jobs = replay_decode(trace, device="cpu")
    assert all(r.done for r in requests)
    assert all(j.state == "done" for j in jobs)
    assert mux.pending() == 0
    got = json.dumps(mux.drain_events(), indent=1) + "\n"
    assert got == (DATA / "decode_golden.json").read_text()


def test_continuous_beats_lockstep_on_committed_trace():
    cont = run_decode_serve(True, ticks=4, device="cpu")
    base = run_decode_serve(False, ticks=4, device="cpu")
    assert cont["hard_lost"] == 0 and base["hard_lost"] == 0
    assert cont["tokens"] == base["tokens"] > 0
    assert cont["steps"] < base["steps"]
    assert cont["tokens_per_step"] > base["tokens_per_step"]
    assert cont["slot_reuses"] > 0
    assert cont["pending"] == 0


def test_decode_serve_counts_equal_the_reference():
    """Continuous and lockstep on the canonical trace: the port's steps,
    tokens, slot reuses and event stream equal the reference's."""
    for continuous in (True, False):
        mine = run_decode_serve(continuous, ticks=4, device="cpu")
        theirs = RS.run_decode_serve(continuous, ticks=4)
        for key in ("requests", "done", "dropped", "tokens", "steps",
                    "hard_lost", "solver_jobs", "solver_done",
                    "slot_reuses", "pending"):
            assert mine[key] == theirs[key], key
        assert mine["events"] == theirs["events"]


def test_main_decode_cpu_run(capsys):
    out = TS.main(["--decode", "--device", "cpu"])
    assert out["continuous"]["hard_lost"] == 0
    assert out["continuous"]["tokens"] == out["lockstep"]["tokens"]
    assert out["continuous"]["steps"] < out["lockstep"]["steps"]
    assert "continuous-batching speedup" in capsys.readouterr().out


def test_lm_serve_launcher_cpu_run(capsys):
    out = TLS.main(["--device", "cpu", "--requests", "5", "--max-new", "4"])
    assert out["done"] == 5 and out["tokens"] == 20
    assert [len(p) for p in out["prompts"]] == [3, 12, 21, 30, 40]
    # greedy outputs depend on the prompt only: each request served again
    # alone, on an engine over the launcher's weights, gives its output
    cfg = get_smoke("phi4-mini-3.8b")
    gen = torch.Generator()
    gen.manual_seed(0)
    engine = DecodeEngine(cfg, T.init_params(gen, cfg), batch=4,
                          max_len=128, eos_id=-1, device="cpu")
    assert [TLS.serve(engine, [p], 4)[0].out
            for p in out["prompts"]] == out["outputs"]
    assert "tok/s" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        TLS.main(["--device", "cpu", "--mesh", "2x2"])
    with pytest.raises(SystemExit):
        TLS.main(["--device", "cpu", "--max-len", "40"])


# ---------------- fuzzed properties ----------------

def _traffic_requests(entries):
    return [Request(prompt=decode_prompt(plen, 17 * i), max_new=max_new,
                    temperature=t10 / 10)
            for i, (plen, max_new, t10, _gap) in enumerate(entries)]


GRID_TRAFFIC = [
    [(1, 0, 0, 0)],
    [(3, 2, 0, 1), (1, 5, 13, 0), (2, 0, 7, 2), (6, 3, 0, 0)],
    [(2, 4, 0, 0)] * 5,
]


def _check_terminal(engine, entries):
    reqs = _traffic_requests(entries)
    for r, (_, _, _, gap) in zip(reqs, entries):
        engine.submit(r)
        for _ in range(gap):
            engine.step()
    engine.run()
    assert all(r.done and not r.dropped for r in reqs)
    assert [len(r.out) for r in reqs] == [e[1] for e in entries]
    assert engine.occupied() == 0 and engine.pending() == 0
    assert all(s is None for s in engine._slot_req)


@pytest.mark.parametrize("entries", GRID_TRAFFIC)
def test_traffic_terminal_grid(engine, entries):
    _check_terminal(engine, entries)


@fuzzed(max_examples=10, entries=decode_traffic())
def test_traffic_terminal_fuzzed(engine, entries):
    _check_terminal(engine, entries)


def _check_greedy_independent(engine, entries):
    solo = {}
    for i, (plen, max_new, t10, _gap) in enumerate(entries):
        if t10 == 0 and max_new > 0:
            solo[i] = _solo(engine, decode_prompt(plen, 17 * i), max_new)
    reqs = _traffic_requests(entries)
    for r, (_, _, _, gap) in zip(reqs, entries):
        engine.submit(r)
        for _ in range(gap):
            engine.step()
    engine.run()
    for i, out in solo.items():
        assert reqs[i].out == out


@pytest.mark.parametrize("entries", GRID_TRAFFIC[1:])
def test_traffic_greedy_independent_grid(engine, entries):
    _check_greedy_independent(engine, entries)


@fuzzed(max_examples=6, entries=decode_traffic(max_len=5))
def test_traffic_greedy_independent_fuzzed(engine, entries):
    _check_greedy_independent(engine, entries)


def _check_mux_hard_never_lost(entries, budget_steps):
    eng = _engine()
    mux, clock = _mux(eng, budget=budget_steps * 1e-4 or 1e-12)
    reqs = []
    for i, (plen, max_new, t10, gap) in enumerate(entries):
        r = Request(prompt=decode_prompt(plen, 17 * i), max_new=max_new,
                    temperature=t10 / 10)
        pri = "hard" if i % 2 == 0 else "best_effort"
        mux.submit_decode(r, priority=pri,
                          deadline=clock() + (2.0 if gap else 6.0))
        reqs.append(r)
        mux.poll()
        clock.advance(1.0)
    for _ in range(4):
        mux.poll()
        clock.advance(1.0)
    mux.run()
    for i, r in enumerate(reqs):
        assert r.done or r.dropped
        if i % 2 == 0:
            assert r.done and not r.dropped
    assert mux.pending() == 0 and eng.occupied() == 0


@pytest.mark.parametrize("entries,budget_steps",
                         [(GRID_TRAFFIC[1], 0), (GRID_TRAFFIC[2], 2)])
def test_mux_hard_decode_never_lost_grid(entries, budget_steps):
    _check_mux_hard_never_lost(entries, budget_steps)


@fuzzed(max_examples=6, entries=decode_traffic(), budget_steps=integers(0, 3))
def test_mux_hard_decode_never_lost_fuzzed(entries, budget_steps):
    _check_mux_hard_never_lost(entries, budget_steps)
