"""Mixed-traffic solver serving launcher: replay a PUSCH-style trace
through the registry-driven SolverMux on the GPU and report SLO metrics.

A 5G PUSCH receiver processes traffic in TTI slots; each slot carries a
mix of per-subcarrier-group MMSE equalizations (the bulk), plus control-
path Cholesky solves (noise-covariance whitening) and QR least squares
(channel estimation refits), at several antenna/user sizes.  This
launcher synthesizes that trace on a virtual clock — every job carries a
priority class (control-path solves and half the MMSE bulk are
``hard``-deadline; the rest is ``best_effort`` refinement traffic) —
submits each slot's jobs with a per-slot deadline, ``poll``s the mux
once per slot (full lane groups dispatch immediately; partials wait for
deadline / age / pressure), drains at the end, checks a sample of
results against the registry oracles, and prints per-pipeline p50/p99
latency (overall and per priority), throughput, lane utilization,
padded-lane waste, and — with ``--policy`` — the overload counters
(dropped / preempted / coalesced) and hard-deadline SLO attainment.

  PYTHONPATH=src python -m repro_torch.launch.serve_solvers \
      --slots 8 --lanes 8 --deadline-ms 2.0 --policy

Every lane group runs as one launch of a hand-written CUDA kernel on
``--device cuda`` (the default); ``--device cpu`` runs the kernels'
plain PyTorch versions instead.

``--pusch`` serves the canonical PUSCH-receiver DAG trace instead (one
hard ``pusch_receive`` DAG per tick — FFT -> channel estimate -> MMSE
equalize — plus a best-effort ``svd_solve`` DAG every other tick), once
stage by stage and once with the channel-estimate -> equalize tail
chained in one kernel, and prints the end-to-end DAG observables:

  PYTHONPATH=src python -m repro_torch.launch.serve_solvers --pusch

Helpers here are shared infrastructure rather than CLI plumbing:

* :func:`run_overload` — the deterministic synthetic overload scenario
  (offered load >= 2x lane capacity, mixed priorities, virtual clock)
  behind the SLO-attainment acceptance test.
* :func:`replay_trace` / :func:`load_trace` — replay a committed JSON
  trace (each entry a seed-keyed job, never raw arrays) through a mux on
  a virtual clock, returning the mux so callers can assert on its
  ``events`` decision log (the golden trace-replay regression test).
* :func:`pusch_trace` / :func:`replay_pusch` / :func:`run_pusch` — the
  same for served DAGs (the golden PUSCH replay and the staged vs
  chained comparison).
"""
from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch.kernels.common import sample_spd
from repro_torch.serve import CostModel, ManualClock, OverloadPolicy, SolverMux

SLOT_MS = 0.5          # 5G numerology-1 TTI


def job_args(pipeline: str, n: int, k: int, seed: int) -> tuple:
    """Deterministic per-job problem arrays, keyed by seed — the form
    committed traces store jobs in (never raw arrays)."""
    rng = np.random.default_rng(seed)
    if pipeline == "cholesky_solve":
        return (sample_spd(rng, 1, n)[0],
                rng.standard_normal((n, k)).astype(np.float32))
    m = n + 4
    return (rng.standard_normal((m, n)).astype(np.float32),
            rng.standard_normal((m, k)).astype(np.float32))


def hard_attainment(jobs) -> float:
    """Fraction of hard-deadline jobs that finished by their deadline
    (dropped or late = miss).  NaN when the trace has no hard jobs."""
    hard = [j for j in jobs
            if j.priority == "hard" and j.deadline is not None]
    if not hard:
        return math.nan
    met = sum(1 for j in hard
              if j.state == "done" and j.finished_at <= j.deadline)
    return met / len(hard)


def build_slot_jobs(rng, slot: int, sizes: list[int]):
    """One TTI's job mix: (pipeline, args, priority) tuples.  Alternate
    MMSE jobs arrive as SPLIT re/im planes (the form a real front end
    produces) — the mux routes their 4-arg buckets to the split_complex
    variant.  Control-path solves and the even MMSE groups are hard-
    deadline; odd MMSE groups are best-effort refinement passes."""
    jobs = []
    for n in sizes:
        m = n + 4
        # MMSE bulk: a few subcarrier groups per size per slot
        for i in range(2 + slot % 2):
            priority = "hard" if i % 2 == 0 else "best_effort"
            if i % 2:
                jobs.append(("mmse_equalize", (
                    rng.standard_normal((m, n)).astype(np.float32),
                    rng.standard_normal((m, n)).astype(np.float32),
                    rng.standard_normal((m, 2)).astype(np.float32),
                    rng.standard_normal((m, 2)).astype(np.float32)),
                    priority))
            else:
                h = rng.standard_normal((m, n)).astype(np.float32)
                y = rng.standard_normal((m, 2)).astype(np.float32)
                jobs.append(("mmse_equalize", (h, y), priority))
        # control path: whitening solve + channel refit, not every slot
        if slot % 2 == 0:
            a = sample_spd(rng, 1, n)[0]
            b = rng.standard_normal((n, 2)).astype(np.float32)
            jobs.append(("cholesky_solve", (a, b), "hard"))
        if slot % 3 == 0:
            qa = rng.standard_normal((m, n)).astype(np.float32)
            qb = rng.standard_normal((m, 1)).astype(np.float32)
            jobs.append(("qr_solve", (qa, qb), "hard"))
    return jobs


# ---------------- committed-trace replay (golden tests) ----------------

def load_trace(path: str) -> list[dict]:
    """A committed trace: a JSON list of job entries
    ``{"tick", "pipeline", "n", "k", "priority", "deadline_ticks",
    "seed"}`` — ``deadline_ticks`` null means no deadline."""
    with open(path) as f:
        return json.load(f)


def replay_trace(trace: list[dict], *, lanes: int = 4, tick: float = 1.0,
                 policy: OverloadPolicy | None = None,
                 max_wait: float | None = None,
                 pressure: int | None = None,
                 drain_ticks: int = 2, device=None) -> SolverMux:
    """Replay a committed trace on a virtual clock: submit each tick's
    jobs, ``poll`` once per tick, keep polling ``drain_ticks`` empty
    ticks, then ``run()``.  Returns the mux — its ``events`` list is the
    exact flush/drop/preempt/coalesce decision sequence a golden file
    pins."""
    clock = ManualClock()
    mux = SolverMux(lanes=lanes, max_wait=max_wait, pressure=pressure,
                    clock=clock, policy=policy, device=device)
    by_tick: dict[int, list[dict]] = {}
    for entry in trace:
        by_tick.setdefault(int(entry["tick"]), []).append(entry)
    last = max(by_tick) if by_tick else -1
    for t in range(last + 1 + drain_ticks):
        for e in by_tick.get(t, ()):
            deadline = e.get("deadline_ticks")
            mux.submit(e["pipeline"],
                       *job_args(e["pipeline"], e["n"], e["k"], e["seed"]),
                       deadline=(None if deadline is None
                                 else clock() + deadline * tick),
                       priority=e.get("priority", "best_effort"))
        mux.poll()
        clock.advance(tick)
    mux.run()
    return mux


# ---------------- synthetic overload scenario (tests) ----------------

OVERLOAD_TICK = 1.0


def overload_trace(ticks: int, lanes: int, seed: int = 0) -> list[dict]:
    """Synthetic overload: per tick, ``3.5 * lanes`` jobs arrive against
    a budget of ~2 launches = ``2 * lanes`` job-slots — offered load
    well over 2x lane capacity in launch terms (the hard MMSE chunk, two
    best-effort MMSE chunks, and the partial Cholesky buckets each need
    their own launch).  The mix:

      * ``lanes`` hard MMSE bulk (deadline 3 ticks) — the traffic the
        SLO is judged by,
      * ``2 * lanes`` best-effort MMSE refinement with a tight 1.2-tick
        deadline: under EDF admission these outrank the hard chunks
        (earlier deadlines) until preemption steps in, and once expired
        they are dead weight unless shed,
      * 1 hard n=12 Cholesky whitening solve (deadline 2 ticks) — a
        chronically partial bucket, and
      * 1 best-effort n=8 Cholesky solve (deadline 2 ticks) — the
        coalescing donor that can ride the n=12 partials' free lanes.
    """
    trace, seq = [], 0
    for t in range(ticks):
        for i in range(lanes):
            trace.append(dict(tick=t, pipeline="mmse_equalize", n=8, k=2,
                              priority="hard", deadline_ticks=3.0,
                              seed=seed * 100003 + seq)); seq += 1
        for i in range(2 * lanes):
            trace.append(dict(tick=t, pipeline="mmse_equalize", n=8, k=2,
                              priority="best_effort", deadline_ticks=1.2,
                              seed=seed * 100003 + seq)); seq += 1
        trace.append(dict(tick=t, pipeline="cholesky_solve", n=12,
                          k=2, priority="hard", deadline_ticks=2.0,
                          seed=seed * 100003 + seq)); seq += 1
        trace.append(dict(tick=t, pipeline="cholesky_solve", n=8,
                          k=2, priority="best_effort",
                          deadline_ticks=2.0,
                          seed=seed * 100003 + seq)); seq += 1
    return trace


def run_overload(policy: bool, *, ticks: int = 8, lanes: int = 4,
                 seed: int = 0, adaptive: bool = False,
                 device=None) -> dict:
    """Run the synthetic overload trace with the SAME lane-time budget
    in both modes; ``policy=True`` additionally enables shedding,
    preemption, and coalescing.  Returns the summary the acceptance test
    asserts on.

    ``adaptive=True`` runs the cost model with online calibration ON
    (real wall-clock measurements feed :meth:`CostModel.observe`) and
    adds the drift-observability fields (``drift`` /
    ``calibration_updates``) to the summary."""
    cm = CostModel(adaptive=adaptive)
    spec = K.get("mmse_equalize")
    unit = cm.launch_cost("mmse_equalize", spec.base,
                          ((12, 8), (12, 2)), lanes)
    pol = OverloadPolicy(shed=policy, preempt=policy, coalesce=policy,
                         budget=2.0 * unit, cost_model=cm)
    trace = overload_trace(ticks, lanes, seed)
    jobs, clock = [], ManualClock()
    mux = SolverMux(lanes=lanes, clock=clock, pressure=2 * lanes,
                    policy=pol, device=device)
    by_tick: dict[int, list[dict]] = {}
    for entry in trace:
        by_tick.setdefault(entry["tick"], []).append(entry)
    for t in range(ticks + ticks):        # arrival ticks + drain ticks
        for e in by_tick.get(t, ()):
            jobs.append(mux.submit(
                e["pipeline"],
                *job_args(e["pipeline"], e["n"], e["k"], e["seed"]),
                deadline=clock() + e["deadline_ticks"] * OVERLOAD_TICK,
                priority=e["priority"]))
        mux.poll()
        clock.advance(OVERLOAD_TICK)
    mux.run()
    snap = mux.metrics()
    summary = {
        "policy": policy,
        "jobs": len(jobs),
        "done": sum(1 for j in jobs if j.state == "done"),
        "attainment_hard": hard_attainment(jobs),
        "dropped": snap.total_dropped,
        "hard_dropped": sum(1 for j in jobs
                            if j.priority == "hard"
                            and j.state == "dropped"),
        "preempted": snap.total_preempted,
        "coalesced": snap.total_coalesced,
        "launches": snap.total_launches,
    }
    if adaptive:
        summary["drift"] = {
            key: {"ratio": st.ratio, "updates": st.updates,
                  "source": st.source, "alert": st.alert}
            for key, st in snap.drift.items() if st.updates > 0}
        summary["calibration_updates"] = snap.calibration_updates
    return summary


# ---------------- served PUSCH DAG (golden tests) ----------------

def dag_job_args(dag: str, n: int, seed: int) -> tuple:
    """Deterministic per-DAG-job problem arrays, keyed by seed — the
    form committed DAG traces store jobs in (never raw arrays)."""
    return K.get_dag(dag).make_case(np.random.default_rng(seed), n)


def pusch_trace(ticks: int, seed: int = 0, *, chained: bool = False,
                n: int = 8) -> list[dict]:
    """The canonical served-DAG workload: one hard ``pusch_receive``
    DAG per tick plus one best-effort ``svd_solve`` DAG every other
    tick (the generality traffic), all at antenna size ``n``.  The PUSCH
    deadlines are *staggered to the same absolute tick* in pairs (tick t
    gets ``8 - t % 2`` ticks), so consecutive DAGs compete at EQUAL
    deadline while sitting at different stages — the window where
    criticality-first admission is observable: the later DAG's critical
    channel-estimate stage must flush ahead of the earlier DAG's slack
    equalize stage (plain FIFO/seq order would invert that), which the
    golden event stream pins."""
    trace, seq = [], 0
    for t in range(ticks):
        trace.append(dict(tick=t, dag="pusch_receive", n=n,
                          priority="hard",
                          deadline_ticks=8.0 - t % 2,
                          chained=chained,
                          seed=seed * 100003 + seq)); seq += 1
        if t % 2 == 0:
            trace.append(dict(tick=t, dag="svd_solve", n=n,
                              priority="best_effort",
                              deadline_ticks=12.0, chained=False,
                              seed=seed * 100003 + seq)); seq += 1
    return trace


def replay_pusch(trace: list[dict], *, lanes: int = 4, tick: float = 1.0,
                 drain_ticks: int = 6, injector=None, device=None):
    """Replay a committed DAG trace on a virtual clock: submit each
    tick's DAGs, ``poll`` once per tick (each poll serves the ready
    stage frontier and advances the DAGs), keep polling ``drain_ticks``
    empty ticks, then ``run()``.  Returns ``(mux, dag_jobs)`` — the
    mux's ``events`` list is the stage-scheduling decision sequence the
    golden file pins."""
    clock = ManualClock()
    mux = SolverMux(lanes=lanes, max_wait=0.0, clock=clock,
                    policy=OverloadPolicy(budget=None,
                                          cost_model=CostModel()),
                    injector=injector, device=device)
    by_tick: dict[int, list[dict]] = {}
    for entry in trace:
        by_tick.setdefault(int(entry["tick"]), []).append(entry)
    last = max(by_tick) if by_tick else -1
    dags = []
    for t in range(last + 1 + drain_ticks):
        for e in by_tick.get(t, ()):
            deadline = e.get("deadline_ticks")
            dags.append(mux.submit_dag(
                e["dag"], *dag_job_args(e["dag"], e["n"], e["seed"]),
                deadline=(None if deadline is None
                          else clock() + deadline * tick),
                priority=e.get("priority", "best_effort"),
                chained=e.get("chained", False)))
        mux.poll()
        clock.advance(tick)
    mux.run()
    return mux, dags


def dag_hard_lost(dags) -> int:
    """Hard DAGs (or their stages) left unaccounted: a hard DAG is LOST
    iff it reached no terminal state, or any submitted stage job is
    neither terminal nor explicitly cancelled — the acceptance gate is
    zero (a mid-DAG fault must cascade cleanly, never orphan)."""
    lost = 0
    for d in dags:
        if d.priority != "hard":
            continue
        if d.state not in ("done", "failed", "dropped"):
            lost += 1
            continue
        for stage in d.spec.stage_list(chained=d.chained):
            sj = d.stages.get(stage.name)
            if sj == "cancelled":
                continue
            if sj is None or sj.state not in ("done", "failed",
                                              "dropped"):
                lost += 1
                break
    return lost


def run_pusch(chained: bool, *, ticks: int = 4, lanes: int = 4,
              seed: int = 0, n: int = 8,
              fault_trace: str | dict | None = None, fault_seed: int = 0,
              device=None) -> dict:
    """Run the canonical PUSCH DAG trace end to end — stage-independent
    (``chained=False``: FFT -> channel-estimate -> equalize as three
    launches with buffer handoffs) or stage-chained (``chained=True``:
    the channel-estimate->equalize tail fused lane-resident in one
    kernel) — and summarize the end-to-end view: e2e p50/p99 latency in
    virtual ticks, launch counts, the worst relative error of a done
    DAG's output against ``DagSpec.oracle`` (``max_rel_err``), and
    (under an injected fault trace) the containment observables with
    ``hard_lost`` required zero."""
    import os

    from repro_torch.serve import FaultInjector
    if fault_trace is None:
        injector = None
    elif isinstance(fault_trace, (str, os.PathLike)):
        injector = FaultInjector.from_json(fault_trace, seed=fault_seed)
    else:
        injector = FaultInjector(fault_trace, seed=fault_seed)
    trace = pusch_trace(ticks, seed, chained=chained, n=n)
    mux, dags = replay_pusch(trace, lanes=lanes, injector=injector,
                             device=device)
    snap = mux.metrics()
    pstats = snap.dags.get("pusch_receive")
    pusch = [d for d in dags if d.dag == "pusch_receive"]
    rel = [float(np.max(np.abs(d.out - want))
                 / (np.max(np.abs(want)) + 1e-12))
           for d in dags if d.state == "done"
           for want in (d.spec.oracle(*d.args),)]
    return {
        "chained": chained,
        "faulted": injector is not None,
        "dags": len(dags),
        "pusch_dags": len(pusch),
        "done": sum(1 for d in dags if d.state == "done"),
        "failed": sum(1 for d in dags if d.state == "failed"),
        "dropped": sum(1 for d in dags if d.state == "dropped"),
        "hard_lost": dag_hard_lost(dags),
        "e2e_p50": pstats.latency.p50 if pstats else math.nan,
        "e2e_p99": pstats.latency.p99 if pstats else math.nan,
        "launches": snap.total_launches,
        "retries": snap.faults.retries,
        "failed_jobs": snap.faults.failed_jobs,
        "max_rel_err": max(rel, default=math.nan),
        "pending": mux.pending(),
        "events": mux.drain_events(),
    }


# ---------------- mixed solver + decode traffic ----------------

_DECODE_MODELS: dict = {}


def decode_model(device=None):
    """The smoke-scale LM ``(cfg, params)`` shared by every decode
    scenario in this launcher: phi4-mini-3.8b's smoke config with random
    weights from a generator seeded 0 on ``device`` (default ``cuda``),
    built once per device.  Its weights are not the reference's (the two
    frameworks' generators differ); the committed decode golden does not
    depend on them (``eos_id=-1``)."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.common import resolve_device
    from repro_torch.models import transformer as T
    dev = resolve_device(device)
    if dev not in _DECODE_MODELS:
        cfg = get_smoke("phi4-mini-3.8b")
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        _DECODE_MODELS[dev] = (cfg, T.init_params(gen, cfg))
    return _DECODE_MODELS[dev]


def decode_prompt(length: int, seed: int) -> list[int]:
    """Deterministic seed-keyed prompt tokens — the form committed
    decode traces store prompts in (never raw token arrays)."""
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(2, 500, size=length)]


def decode_trace(ticks: int, seed: int = 0) -> list[dict]:
    """The canonical mixed solver+decode workload: per tick, one hard
    and one best-effort MMSE bulk chunk (solver lane traffic) plus two
    decode requests — one hard greedy, one best-effort (periodically
    sampled) — with prompt/output lengths that VARY per tick.  The
    heterogeneity is the point: lockstep pool decode runs every pool
    member to the longest prompt and longest ``max_new`` of its
    generation and rebuilds the cache between pools, so on this trace
    continuous per-slot batching strictly beats it in tokens per step at
    the same budget."""
    trace, seq = [], 0
    for t in range(ticks):
        for i in range(2):
            trace.append(dict(
                tick=t, kind="solve", pipeline="mmse_equalize", n=8, k=2,
                priority="hard" if i == 0 else "best_effort",
                deadline_ticks=3.0, seed=seed * 100003 + seq))
            seq += 1
        trace.append(dict(
            tick=t, kind="decode", prompt_len=1 + t % 4,
            max_new=2 + (3 * t) % 7, temperature=0.0, priority="hard",
            deadline_ticks=8.0, seed=seed * 100003 + seq))
        seq += 1
        trace.append(dict(
            tick=t, kind="decode", prompt_len=1 + (t * 2) % 5,
            max_new=1 + (t * 5) % 9,
            temperature=1.0 if t % 3 == 0 else 0.0,
            priority="best_effort", deadline_ticks=12.0,
            seed=seed * 100003 + seq))
        seq += 1
    return trace


def replay_decode(trace: list[dict], *, lanes: int = 4,
                  slots: int | None = None, max_len: int = 64,
                  tick: float = 1.0, drain_ticks: int = 4,
                  lockstep: bool = False, device=None):
    """Replay a committed mixed solver+decode trace on a virtual clock:
    submit each tick's solver jobs and decode requests, ``poll`` once
    per tick (the attached policy round serves solver flushes AND up to
    ``decode_steps_per_poll`` continuous-batching decode steps), keep
    polling ``drain_ticks`` empty ticks, then ``run()``.  Returns
    ``(mux, engine, requests, jobs)`` — the mux's event list interleaves
    solver flush decisions with decode insert/step/done decisions, the
    sequence ``tests/data/decode_golden.json`` pins.

    The replay engine uses ``eos_id=-1`` (token ids are non-negative,
    so EOS never fires): every request runs exactly ``max_new`` steps
    and the scheduling decision sequence depends only on the trace's
    lengths — never on model floating point.

    ``lockstep=True`` is the equal-budget baseline: the SAME trace,
    clock, mux and solver path, but the engine is NOT attached — decode
    requests go straight to its FIFO and each tick runs one lockstep
    pool drain (:meth:`~repro_torch.serve.decode.DecodeEngine.
    run_lockstep`) instead of continuous steps."""
    from repro_torch.serve import global_config
    from repro_torch.serve.decode import DecodeEngine, Request
    cfg, params = decode_model(device)
    clock = ManualClock()
    slots = global_config.decode_slots if slots is None else slots
    engine = DecodeEngine(cfg, params, batch=slots, max_len=max_len,
                          eos_id=-1, clock=clock)
    mux = SolverMux(lanes=lanes, max_wait=0.0, clock=clock,
                    policy=OverloadPolicy(budget=None,
                                          cost_model=CostModel()),
                    device=engine.device)
    if not lockstep:
        mux.attach_decode(engine)
    by_tick: dict[int, list[dict]] = {}
    for entry in trace:
        by_tick.setdefault(int(entry["tick"]), []).append(entry)
    last = max(by_tick) if by_tick else -1
    requests, jobs = [], []
    for t in range(last + 1 + drain_ticks):
        for e in by_tick.get(t, ()):
            deadline = e.get("deadline_ticks")
            deadline = None if deadline is None \
                else clock() + deadline * tick
            if e.get("kind") == "decode":
                r = Request(
                    prompt=decode_prompt(e["prompt_len"], e["seed"]),
                    max_new=e["max_new"],
                    temperature=e.get("temperature", 0.0))
                if lockstep:
                    r.priority = e.get("priority", "best_effort")
                    r.deadline = deadline
                    engine.submit(r)
                else:
                    mux.submit_decode(
                        r, deadline=deadline,
                        priority=e.get("priority", "best_effort"))
                requests.append(r)
            else:
                jobs.append(mux.submit(
                    e["pipeline"],
                    *job_args(e["pipeline"], e["n"], e["k"], e["seed"]),
                    deadline=deadline,
                    priority=e.get("priority", "best_effort")))
        mux.poll()
        if lockstep:
            engine.run_lockstep()
        clock.advance(tick)
    mux.run()
    if lockstep:
        engine.run_lockstep()
    return mux, engine, requests, jobs


def run_decode_serve(continuous: bool, *, ticks: int = 6, lanes: int = 4,
                     seed: int = 0, device=None) -> dict:
    """Run the canonical mixed solver+decode trace end to end —
    continuous per-slot batching through the mux (``continuous=True``)
    or the lockstep pool baseline at the same budget — and summarize:
    tokens per step (the throughput the continuous path must strictly
    win), per-phase latency, slot reuses, and ``hard_lost`` (hard solver
    jobs not done + hard decode requests not finished), required zero."""
    trace = decode_trace(ticks, seed)
    mux, engine, requests, jobs = replay_decode(
        trace, lanes=lanes, lockstep=not continuous, device=device)
    snap = mux.metrics() if continuous else engine.metrics()
    d = snap.decode
    tokens = sum(len(r.out) for r in requests)
    steps = engine.steps
    hard_lost = sum(1 for r in requests
                    if r.priority == "hard" and not r.done)
    hard_lost += sum(1 for j in jobs
                     if j.priority == "hard" and j.state != "done")
    return {
        "continuous": continuous,
        "requests": len(requests),
        "done": sum(1 for r in requests if r.done),
        "dropped": sum(1 for r in requests if r.dropped),
        "tokens": tokens,
        "steps": steps,
        "tokens_per_step": tokens / steps if steps else math.nan,
        "hard_lost": hard_lost,
        "solver_jobs": len(jobs),
        "solver_done": sum(1 for j in jobs if j.state == "done"),
        "slot_reuses": d.slot_reuses,
        "insert_p50": d.insert.p50,
        "prefill_p50": d.prefill.p50,
        "generate_p50": d.generate.p50,
        "pending": mux.pending(),
        "events": mux.drain_events(),
    }


def main(argv=None) -> dict | None:
    """Serve the TTI slot mix and print its SLO report.  Returns the
    run's summary (jobs, done, hard jobs dropped, the oracle spot-check's
    relative error, launches), or None for an empty trace.  With
    ``--pusch``: serve the DAG trace instead and return its staged and
    chained summaries (:func:`run_pusch`, without the event logs)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=8,
                    help="trace length in TTI slots")
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--sizes", default="8,12",
                    help="comma-separated antenna sizes n (m = n + 4): "
                         "n >= 128 with n %% 32 == 0 serves the blocked "
                         "kernels, n >= 512 the tiled ones; --pusch "
                         "serves its DAGs at the first size")
    ap.add_argument("--deadline-ms", type=float, default=2.0,
                    help="per-job deadline after arrival (virtual ms)")
    ap.add_argument("--max-wait-ms", type=float, default=1.0,
                    help="partial-bucket age flush threshold (virtual ms)")
    ap.add_argument("--policy", action="store_true",
                    help="enable the overload policy: shed expired "
                         "best-effort jobs and coalesce small ones; add "
                         "--budget-us for budgeted admission, which is "
                         "what makes preemption possible")
    ap.add_argument("--budget-us", type=float, default=None,
                    help="per-poll lane-time budget in cost-model "
                         "microseconds (requires --policy)")
    ap.add_argument("--adapt", action="store_true",
                    help="close the cost-model loop online: measure "
                         "every launch, re-fit sec/FLOP + overhead, tune "
                         "flush thresholds from observed traffic, and "
                         "report drift (predicted/measured) per variant")
    ap.add_argument("--device", default="cuda",
                    help="where every lane group runs: cuda (the "
                         "hand-written kernels, default) or cpu (their "
                         "plain PyTorch versions)")
    ap.add_argument("--mesh", type=int, default=None,
                    help="lane-shard count; only 1 until mesh sharding "
                         "is ported")
    ap.add_argument("--fault-trace", default=None,
                    help="JSON fault trace (see repro_torch.serve.faults) "
                         "to inject into the replay via a seeded "
                         "FaultInjector")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="seed for the fault injector's per-attempt rng "
                         "streams (requires --fault-trace; a seed in "
                         "the trace file wins)")
    ap.add_argument("--chaos", action="store_true",
                    help="not ported yet (needs mesh sharding)")
    ap.add_argument("--pusch", action="store_true",
                    help="serve the canonical PUSCH-receiver DAG trace "
                         "(staged vs stage-chained, criticality-ordered "
                         "admission) instead of the TTI replay and print "
                         "the end-to-end DAG observables; combine with "
                         "--fault-trace for a mid-DAG stage fault")
    ap.add_argument("--decode", action="store_true",
                    help="serve the canonical mixed solver+decode trace "
                         "(continuous per-slot batching through the mux "
                         "vs the lockstep pool baseline at the same "
                         "budget) instead of the TTI replay and print "
                         "the token-throughput observables")
    ap.add_argument("--ticks", type=int, default=4,
                    help="virtual ticks in the --pusch / --decode trace")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.chaos:
        ap.error("--chaos: the chaos scenario needs mesh-sharded lane "
                 "pools, a later slice of the port")
    if args.mesh is not None and args.mesh > 1:
        ap.error(f"--mesh {args.mesh}: mesh sharding is a later slice of "
                 f"the port")
    if args.budget_us is not None and not args.policy:
        ap.error("--budget-us requires --policy")
    if args.fault_seed is not None and args.fault_trace is None:
        ap.error("--fault-seed requires --fault-trace")
    sizes = [int(s) for s in args.sizes.split(",")]
    if args.pusch:
        return _main_pusch(args)
    if args.decode:
        return _main_decode(args)

    rng = np.random.default_rng(args.seed)
    clock = ManualClock()
    policy, cost_model = None, None
    budget = None if args.budget_us is None else args.budget_us * 1e-6
    if args.policy and args.adapt:
        policy = OverloadPolicy(budget=budget,
                                cost_model=CostModel(adaptive=True))
    elif args.policy:
        policy = OverloadPolicy(budget=budget)
    elif args.adapt:
        cost_model = CostModel(adaptive=True)
    injector = None
    if args.fault_trace is not None:
        from repro_torch.serve import FaultInjector
        injector = FaultInjector.from_json(args.fault_trace,
                                           seed=args.fault_seed or 0)
    mux = SolverMux(lanes=args.lanes, max_wait=args.max_wait_ms * 1e-3,
                    clock=clock, policy=policy, cost_model=cost_model,
                    adapt=args.adapt or None, mesh_size=args.mesh,
                    injector=injector, device=args.device)

    t0 = time.perf_counter()
    jobs, done, sample = [], [], None
    for slot in range(args.slots):
        for pipeline, job_arrays, priority in build_slot_jobs(rng, slot,
                                                              sizes):
            job = mux.submit(pipeline, *job_arrays,
                             deadline=clock() + args.deadline_ms * 1e-3,
                             priority=priority)
            jobs.append(job)
            if sample is None and pipeline == "mmse_equalize":
                sample = job
        done.extend(mux.poll())
        clock.advance(SLOT_MS * 1e-3)
    done.extend(mux.run())
    wall = time.perf_counter() - t0
    if mux.pending():
        raise RuntimeError("mux left jobs queued after drain")

    if not done:
        print(f"empty trace ({args.slots} slots): nothing served")
        return None

    # spot-check a served result against the registry oracle (under
    # fault injection some jobs may be terminally failed — skip those)
    if sample is None or sample.state != "done":
        sample = next((j for j in done if j.state == "done"), None)
    err = math.nan
    if sample is not None:
        want = K.get(sample.pipeline).run_oracle_lane(*sample.args)
        err = float(np.max(np.abs(sample.out - want))
                    / (np.max(np.abs(want)) + 1e-12))
        if not err < 1e-3:
            raise RuntimeError(
                f"oracle mismatch on sample job: rel err {err:.2e}")

    snap = mux.metrics()
    print(f"trace: {args.slots} slots x sizes {sizes}, lanes={args.lanes} "
          f"on {mux.device} -> {snap.total_jobs} jobs in "
          f"{snap.total_launches} grid launches ({wall:.2f}s wall, oracle "
          f"check ok)")
    hdr = (f"{'pipeline':<16} {'jobs':>5} {'launch':>6} {'util':>6} "
           f"{'waste':>6} {'p50_ms':>8} {'p99_ms':>8} {'hard_p99':>9} "
           f"{'jobs/s':>10} dispatch")
    print(hdr)
    print("-" * len(hdr))
    for name, st in sorted(snap.pipelines.items()):
        counts = ",".join(f"{v}:{c}" for v, c in
                          sorted(st.dispatch_counts.items()))
        hard = st.latency_by_priority.get("hard")
        hard_p99 = f"{hard.p99 * 1e3:>9.3f}" if hard else f"{'-':>9}"
        print(f"{name:<16} {st.jobs:>5} {st.launches:>6} "
              f"{st.lane_utilization:>6.2f} {st.padded_lane_waste:>6.2f} "
              f"{st.latency.p50 * 1e3:>8.3f} {st.latency.p99 * 1e3:>8.3f} "
              f"{hard_p99} {st.throughput:>10.1f} {counts}")
    missed = sum(1 for j in done
                 if j.deadline is not None and j.finished_at > j.deadline)
    print(f"deadline misses (virtual clock): {missed}/{len(done)}")
    print(f"hard-deadline SLO attainment: {hard_attainment(jobs):.2%}")
    if policy is not None:
        print(f"overload policy: dropped={snap.total_dropped} "
              f"preempted={snap.total_preempted} "
              f"coalesced={snap.total_coalesced}")
    if snap.drift:
        print("cost-model drift (predicted/measured, EWMA ratio):")
        for key, st in sorted(snap.drift.items()):
            flag = "  ALERT" if st.alert else ""
            print(f"  {key:<28} ratio {st.ratio:>8.3f} "
                  f"updates {st.updates:>4} source {st.source}{flag}")
        worst = snap.worst_drift
        if worst is not None:
            print(f"  worst offender: {worst.key} "
                  f"(ratio {worst.ratio:.3f})")
        ups = ",".join(f"{k}={v}" for k, v in
                       sorted(snap.calibration_updates.items()))
        print(f"  calibration updates: {ups}")
    return {
        "jobs": len(jobs),
        "done": sum(1 for j in jobs if j.state == "done"),
        "hard_dropped": sum(1 for j in jobs if j.priority == "hard"
                            and j.state == "dropped"),
        "oracle_rel_err": err,
        "launches": snap.total_launches,
        "dispatch": {name: dict(sorted(st.dispatch_counts.items()))
                     for name, st in sorted(snap.pipelines.items())},
    }


def _main_pusch(args) -> dict:
    """``--pusch``: the DAG trace staged (with ``--fault-trace`` if
    given) and chained; prints both summaries and returns them."""
    n = int(args.sizes.split(",")[0])
    staged = run_pusch(False, ticks=args.ticks, lanes=args.lanes,
                       seed=args.seed, n=n, fault_trace=args.fault_trace,
                       fault_seed=args.fault_seed or 0, device=args.device)
    chained = run_pusch(True, ticks=args.ticks, lanes=args.lanes,
                        seed=args.seed, n=n, device=args.device)
    for s in (staged, chained):
        mode = "chained" if s["chained"] else "staged"
        fault = " +faults" if s["faulted"] else ""
        print(f"pusch dag [{mode}{fault}] n={n} on {args.device}: "
              f"dags={s['dags']} done={s['done']} failed={s['failed']} "
              f"dropped={s['dropped']} hard_lost={s['hard_lost']}")
        print(f"  e2e latency (ticks): p50={s['e2e_p50']:.1f} "
              f"p99={s['e2e_p99']:.1f}  launches={s['launches']} "
              f"retries={s['retries']}  "
              f"oracle rel err={s['max_rel_err']:.2e}")
        if s["hard_lost"]:
            raise RuntimeError("hard DAGs silently lost")
    if staged["e2e_p50"] and chained["e2e_p50"]:
        print(f"  stage-chained speedup: "
              f"{staged['e2e_p50'] / chained['e2e_p50']:.2f}x e2e p50")
    return {"staged": {k: v for k, v in staged.items() if k != "events"},
            "chained": {k: v for k, v in chained.items() if k != "events"}}



def _main_decode(args) -> dict:
    """``--decode``: the mixed solver+decode trace, continuous through
    the mux and lockstep at the same budget; prints both summaries and
    returns them (without the event logs)."""
    cont = run_decode_serve(True, ticks=args.ticks, lanes=args.lanes,
                            seed=args.seed, device=args.device)
    base = run_decode_serve(False, ticks=args.ticks, lanes=args.lanes,
                            seed=args.seed, device=args.device)
    for s in (cont, base):
        mode = "continuous" if s["continuous"] else "lockstep"
        print(f"decode serve [{mode:>10}] on {args.device}: "
              f"requests={s['requests']} done={s['done']} "
              f"dropped={s['dropped']} tokens={s['tokens']} "
              f"steps={s['steps']} tokens/step={s['tokens_per_step']:.2f} "
              f"hard_lost={s['hard_lost']} "
              f"solver {s['solver_done']}/{s['solver_jobs']}")
    print(f"  continuous: slot_reuses={cont['slot_reuses']} "
          f"insert p50 (ticks)={cont['insert_p50']:.1f} "
          f"prefill p50 (s)={cont['prefill_p50']:.2e} "
          f"generate p50 (s)={cont['generate_p50']:.2e}")
    print(f"  continuous-batching speedup: "
          f"{cont['tokens_per_step'] / base['tokens_per_step']:.2f}x "
          f"tokens/step at equal budget")
    if cont["hard_lost"] or base["hard_lost"]:
        raise RuntimeError("hard jobs/requests silently lost")
    if cont["tokens"] != base["tokens"]:
        raise RuntimeError("the trace served different token counts "
                           "across modes")
    if not cont["tokens_per_step"] > base["tokens_per_step"]:
        raise RuntimeError("continuous batching failed to beat the "
                           "lockstep baseline")
    return {"continuous": {k: v for k, v in cont.items() if k != "events"},
            "lockstep": {k: v for k, v in base.items() if k != "events"}}


if __name__ == "__main__":
    main()
