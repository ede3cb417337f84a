"""SLO metrics for the serving stack — plain dataclasses, no deps.

Every engine built on :class:`repro_torch.serve.core.EngineCore` owns a
:class:`Recorder` that accumulates four event kinds:

  * **launches** — one per dispatched grid (a ``pallas_call`` over a
    lane group): pipeline name, shape key, how many lanes carried real
    jobs vs. benign padding, how many of the real lanes were
    cross-shape *coalesced* riders (small jobs embedded into a larger
    bucket's free lanes by the overload policy), and the launch's
    **measured wall-clock** — the feedback signal the self-tuning cost
    model (:mod:`repro_torch.serve.cost`) re-fits from.
  * **jobs** — one per completed job: submit and finish timestamps on
    the engine's clock (injectable — tests and trace replays use
    :class:`repro_torch.serve.core.ManualClock`) plus the job's priority
    class, so latency distributions split per priority.
  * **drops** — one per job shed by the overload policy (expired
    best-effort work under admission control).
  * **preemptions** — one per bucket flush abandoned so a pending
    hard-deadline bucket could take its lane-time budget.
  * **retries / failures** — launch supervision's trail: one retry per
    supervised relaunch of a failed group, one failure per job marked
    terminal ``state="failed"`` with a structured reason (exhausted
    retries, persistent non-finite lane, rejected non-finite input).
    Folded into :class:`FaultStats` (``MetricsSnapshot.faults``)
    together with the shard-quarantine and variant-demotion counters
    the mux attaches.

``Recorder.snapshot()`` folds the events into a :class:`MetricsSnapshot`
with per-pipeline p50/p99/mean/max latency (overall AND per priority
class), throughput over the active window, lane utilization (real lanes
/ dispatched lanes), padded-lane waste (the complement), and the
dropped / preempted / coalesced counters the overload policy exposes —
the SLO surface the ROADMAP asks ``benchmarks/bench_pipelines.py`` to
report for mixed traffic.
"""
from __future__ import annotations

import collections
import dataclasses
import math


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Linear-interpolated percentile of an already-sorted list."""
    if not sorted_vals:
        return math.nan
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = (q / 100.0) * (len(sorted_vals) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


@dataclasses.dataclass(frozen=True)
class LatencyStats:
    """Submit-to-finish latency distribution, in clock seconds."""

    count: int
    p50: float
    p99: float
    mean: float
    max: float

    @staticmethod
    def of(samples: list[float]) -> "LatencyStats":
        if not samples:
            return LatencyStats(0, math.nan, math.nan, math.nan, math.nan)
        s = sorted(samples)
        return LatencyStats(
            count=len(s),
            p50=_percentile(s, 50.0),
            p99=_percentile(s, 99.0),
            mean=sum(s) / len(s),
            max=s[-1])


@dataclasses.dataclass(frozen=True)
class LaunchRecord:
    """One dispatched grid: ``real + padded`` lanes went to the device.

    ``variant`` is the registry variant the dispatcher routed the lane
    group to (``"base"`` for the spec's own entry point) — the per-launch
    record behind :attr:`PipelineStats.dispatch_counts`.  ``coalesced``
    counts how many of the ``real`` lanes carried cross-shape riders
    (small jobs embedded at this launch's shape instead of filler)."""

    pipeline: str
    shape: tuple
    real: int
    padded: int
    t: float
    variant: str = "base"
    coalesced: int = 0
    measured: float = math.nan
    """Measured wall-clock seconds of the launch (stack + pad + execute
    + scatter), NaN when the engine did not time it — the per-launch
    truth the cost model's predictions are checked against."""
    mesh: int = 1
    """Shard count the launch spanned: 1 for a single-device launch,
    N > 1 when the lane axis was shard_map'd over an N-shard mesh."""
    shard: int = 0
    """Shard the launch was placed on (``-1`` for mesh-spanning
    launches, which occupy every shard)."""


@dataclasses.dataclass(frozen=True)
class ShardStats:
    """Aggregate view of one mesh shard's lane traffic.

    Lane counts are floats: a mesh-spanning launch splits its lanes
    evenly across the shards that executed it (the padded width is a
    multiple of the shard count, so dispatched lanes divide exactly;
    real lanes may not).  ``load`` is the accumulated priced cost
    (cost-model seconds) the scheduler charged this shard — the
    balancing signal :meth:`repro_torch.serve.shard.LaneShards.pick` uses."""

    shard: int
    launches: int
    lanes_dispatched: float
    lanes_real: float
    utilization: float           # real lanes / dispatched lanes
    load: float = 0.0


def shard_stats(launches, n_shards: int,
                load=None) -> tuple[dict, float]:
    """Fold launch records into per-shard stats + the imbalance ratio
    (max/mean dispatched lanes; NaN before any lanes).  A spanning
    launch (``mesh > 1``) counts on every shard it occupied; a placed
    launch on its ``shard`` alone."""
    lanes = [0.0] * n_shards
    real = [0.0] * n_shards
    count = [0] * n_shards
    for rec in launches:
        width = rec.real + rec.padded
        if rec.mesh > 1:
            for s in range(n_shards):
                lanes[s] += width / rec.mesh
                real[s] += rec.real / rec.mesh
                count[s] += 1
        elif 0 <= rec.shard < n_shards:
            lanes[rec.shard] += width
            real[rec.shard] += rec.real
            count[rec.shard] += 1
    total = sum(lanes)
    imbalance = (max(lanes) / (total / n_shards)) if total > 0 \
        else math.nan
    stats = {
        s: ShardStats(
            shard=s, launches=count[s],
            lanes_dispatched=lanes[s], lanes_real=real[s],
            utilization=(real[s] / lanes[s]) if lanes[s] else 0.0,
            load=(load[s] if load is not None else 0.0))
        for s in range(n_shards)}
    return stats, imbalance


@dataclasses.dataclass(frozen=True)
class DropRecord:
    """One job shed by the overload policy (terminal, never served)."""

    pipeline: str
    t: float
    priority: str = "best_effort"
    reason: str = "expired"


@dataclasses.dataclass(frozen=True)
class FailRecord:
    """One job launch supervision gave up on (terminal ``"failed"``)."""

    pipeline: str
    t: float
    priority: str = "best_effort"
    reason: str = "launch_failed"


@dataclasses.dataclass(frozen=True)
class FaultStats:
    """Fault-handling observables (``MetricsSnapshot.faults``): the
    supervision layer's health summary.  All zeros / empty on a
    fault-free run — the block exists unconditionally so dashboards can
    rely on its shape."""

    retries: int = 0
    """Supervised group relaunches (each charged backoff debt)."""
    failed_jobs: int = 0
    """Jobs marked terminal ``state="failed"`` with a reason."""
    quarantines: int = 0
    """Lifetime shard quarantine transitions."""
    reinstatements: int = 0
    """Quarantined shards returned to service by a surviving probe."""
    demotions: int = 0
    """Variant demotions (per-bucket fallback down the ladder)."""
    watchdog_flags: int = 0
    """Launches whose measured wall exceeded the predicted-cost
    watchdog ratio."""
    quarantined_shards: tuple = ()
    """Shard indices currently quarantined (empty when healthy)."""
    time_to_recover: float = math.nan
    """Mean quarantine downtime (scheduling-clock seconds) across
    reinstated shards; NaN before any reinstatement."""
    alerts: tuple = ()
    """Drift-style alert strings (e.g. ``"demote:cholesky_solve:
    blocked->base"``) — the degradations an operator should see."""


@dataclasses.dataclass(frozen=True)
class DagStats:
    """Aggregate view of one served DAG's end-to-end traffic
    (``MetricsSnapshot.dags``): terminal counts per state plus the
    submit-to-last-stage-done latency distribution — the per-*stage*
    latencies live in the stage pipelines' own :class:`PipelineStats`."""

    dag: str
    submitted: int
    done: int
    failed: int = 0
    dropped: int = 0
    latency: LatencyStats = dataclasses.field(
        default_factory=lambda: LatencyStats.of([]))
    """End-to-end (DAG submit -> final stage done) latency over the
    completed DAGs, in clock seconds."""
    latency_by_priority: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class DecodeStats:
    """Aggregate view of continuous-batching decode traffic
    (``MetricsSnapshot.decode``): per-phase latency in the
    maxtext-microbenchmark shape — **insert** (submit -> slot assigned,
    scheduling-clock queue wait), **prefill** (slot assigned -> final
    prompt token consumed, wall seconds) and **generate** (first output
    token -> request done, wall seconds) — plus the step/token counters
    the continuous-vs-lockstep throughput comparison is judged by.
    All-empty (the default) when no decode engine is attached, so the
    block's shape is always present."""

    requests: int = 0
    """Requests that reached ``done`` (EOS or ``max_new``)."""
    tokens: int = 0
    """Output tokens generated across all requests."""
    steps: int = 0
    """Pool-wide SPMD decode steps executed."""
    slot_reuses: int = 0
    """Inserts into a slot that previously held another request — the
    paged-KV reuse counter (no cache rebuild happened on these)."""
    shed: int = 0
    """Queued best-effort requests dropped past their deadline."""
    insert: LatencyStats = dataclasses.field(
        default_factory=lambda: LatencyStats.of([]))
    prefill: LatencyStats = dataclasses.field(
        default_factory=lambda: LatencyStats.of([]))
    generate: LatencyStats = dataclasses.field(
        default_factory=lambda: LatencyStats.of([]))
    tokens_per_step: float = math.nan
    """Continuous-batching throughput: generated tokens per SPMD step
    (the pool width is its ceiling; lockstep burns steps on idle lanes
    and trailing drain, pulling it down)."""


@dataclasses.dataclass(frozen=True)
class PipelineStats:
    """Aggregate SLO view of one pipeline's traffic."""

    pipeline: str
    jobs: int
    launches: int
    lanes_dispatched: int
    lanes_padded: int
    lane_utilization: float      # real lanes / dispatched lanes
    padded_lane_waste: float     # padded lanes / dispatched lanes
    latency: LatencyStats
    throughput: float
    """Jobs/s over [first submit, last finish].  ``0.0`` only for a
    genuinely empty pipeline (no completed jobs); a zero-width window
    (jobs that all completed at the same clock instant, e.g. one
    same-tick batch on a virtual clock) reports NaN — unknown, not
    dead."""
    dispatch_counts: dict = dataclasses.field(default_factory=dict)
    """Launches per registry variant name — the observable proof that a
    bucket of large / split-complex jobs landed on the fast path."""
    dropped: int = 0
    """Jobs shed by the overload policy (expired best-effort)."""
    failed: int = 0
    """Jobs launch supervision marked terminal ``"failed"`` (with a
    structured reason) — distinct from ``dropped``: these were admitted
    but could not be served."""
    retries: int = 0
    """Supervised launch retries attributed to this pipeline."""
    preempted: int = 0
    """Jobs whose bucket flush was abandoned for a hard-deadline bucket
    (they stay queued and are re-admitted later — not terminal)."""
    lanes_coalesced: int = 0
    """Real lanes that carried cross-shape riders."""
    latency_by_priority: dict = dataclasses.field(default_factory=dict)
    """Priority class -> LatencyStats — the per-priority p50/p99 view the
    overload policy is judged by."""


@dataclasses.dataclass(frozen=True)
class MetricsSnapshot:
    """Point-in-time fold of everything a Recorder has seen."""

    pipelines: dict[str, PipelineStats]
    launches: tuple[LaunchRecord, ...]
    total_jobs: int
    total_launches: int
    total_dropped: int = 0
    total_preempted: int = 0
    total_coalesced: int = 0
    total_failed: int = 0
    total_retries: int = 0
    faults: FaultStats = dataclasses.field(default_factory=FaultStats)
    """Fault-handling health block (see :class:`FaultStats`).  The
    Recorder fills retries/failed_jobs; ``SolverMux.metrics()`` attaches
    the shard-quarantine / demotion / watchdog side it owns."""
    drift: dict = dataclasses.field(default_factory=dict)
    """``"pipeline/variant" -> repro_torch.serve.cost.DriftStat`` — the cost
    model's predicted/measured health per pair (EWMA ratio, update
    count, calibration source).  Empty when the serving engine carries
    no cost model.  Attached by ``SolverMux.metrics()``; the Recorder
    itself never sees the cost model."""
    worst_drift: object | None = None
    """The DriftStat furthest from ratio 1.0 in log space, or None."""
    calibration_updates: dict = dataclasses.field(default_factory=dict)
    """Applied window-median update counts per estimator (``"overhead"``
    plus one ``"pipeline/variant"`` key per re-fit rate)."""
    shards: dict = dataclasses.field(default_factory=dict)
    """``shard index -> ShardStats`` for mesh-sharded muxes (empty on
    the single-device path).  Attached by ``SolverMux.metrics()`` —
    like ``drift``, the Recorder itself never sees the mesh."""
    shard_imbalance: float = math.nan
    """max/mean dispatched lanes across shards (1.0 = balanced; NaN
    when unsharded or before any launch)."""
    shard_imbalance_alert: bool = False
    """True when ``shard_imbalance`` exceeds the configured
    ``imbalance_alert`` ratio — the skew observability hook."""
    dags: dict = dataclasses.field(default_factory=dict)
    """``dag name -> DagStats`` for DAG jobs served via
    ``SolverMux.submit_dag`` (empty when no DAGs were submitted)."""
    decode: DecodeStats = dataclasses.field(default_factory=DecodeStats)
    """Continuous-batching decode traffic (see :class:`DecodeStats`).
    All-zero when no decode engine shares this recorder."""

    def __getitem__(self, pipeline: str) -> PipelineStats:
        return self.pipelines[pipeline]


class Recorder:
    """Accumulates launch/job/drop/preempt events; ``snapshot()`` builds
    the stats."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._launches: list[LaunchRecord] = []
        self._jobs: dict[str, list[tuple[float, float, str]]] = \
            collections.defaultdict(list)
        self._drops: list[DropRecord] = []
        self._preempts: dict[str, int] = collections.defaultdict(int)
        self._fails: list[FailRecord] = []
        self._retries: dict[str, int] = collections.defaultdict(int)
        self._dag_submits: dict[str, int] = collections.defaultdict(int)
        self._dag_records: list[tuple[str, float, float, str, str]] = []
        self._decode_phases: dict[str, list[float]] = \
            collections.defaultdict(list)
        self._decode_steps = 0
        self._decode_tokens = 0
        self._decode_requests = 0
        self._decode_reuses = 0
        self._decode_shed = 0

    def record_launch(self, pipeline: str, shape: tuple, real: int,
                      padded: int, t: float, variant: str = "base",
                      coalesced: int = 0,
                      measured: float = math.nan,
                      mesh: int = 1, shard: int = 0) -> None:
        self._launches.append(
            LaunchRecord(pipeline, shape, int(real), int(padded), t,
                         variant, int(coalesced), float(measured),
                         int(mesh), int(shard)))

    def record_job(self, pipeline: str, submitted_at: float,
                   finished_at: float,
                   priority: str = "best_effort") -> None:
        self._jobs[pipeline].append((submitted_at, finished_at, priority))

    def record_drop(self, pipeline: str, t: float,
                    priority: str = "best_effort",
                    reason: str = "expired") -> None:
        self._drops.append(DropRecord(pipeline, t, priority, reason))

    def record_preempt(self, pipeline: str, jobs: int, t: float) -> None:
        self._preempts[pipeline] += int(jobs)

    def record_retry(self, pipeline: str, t: float,
                     reason: str = "launch_failed") -> None:
        self._retries[pipeline] += 1

    def record_fail(self, pipeline: str, t: float,
                    priority: str = "best_effort",
                    reason: str = "launch_failed") -> None:
        self._fails.append(FailRecord(pipeline, t, priority, reason))

    def record_dag_submit(self, dag: str) -> None:
        self._dag_submits[dag] += 1

    def record_dag(self, dag: str, submitted_at: float,
                   finished_at: float, state: str,
                   priority: str = "best_effort") -> None:
        """One DAG job reaching a terminal state (``done`` / ``failed``
        / ``dropped``); latency folds only over ``done``."""
        self._dag_records.append((dag, submitted_at, finished_at, state,
                                  priority))

    def record_decode_phase(self, phase: str, seconds: float) -> None:
        """One per-request phase latency sample: ``insert`` /
        ``prefill`` / ``generate`` (see :class:`DecodeStats`)."""
        self._decode_phases[phase].append(float(seconds))

    def record_decode_step(self, tokens: int) -> None:
        """One pool-wide SPMD decode step that generated ``tokens``."""
        self._decode_steps += 1
        self._decode_tokens += int(tokens)

    def record_decode_insert(self, reused: bool) -> None:
        self._decode_reuses += bool(reused)

    def record_decode_request(self) -> None:
        self._decode_requests += 1

    def record_decode_shed(self) -> None:
        self._decode_shed += 1

    def snapshot(self) -> MetricsSnapshot:
        per: dict[str, PipelineStats] = {}
        names = (set(self._jobs) | {l.pipeline for l in self._launches}
                 | {d.pipeline for d in self._drops}
                 | {d.pipeline for d in self._fails}
                 | set(self._preempts) | set(self._retries))
        for name in sorted(names):
            jobs = self._jobs.get(name, [])
            launches = [l for l in self._launches if l.pipeline == name]
            real = sum(l.real for l in launches)
            padded = sum(l.padded for l in launches)
            dispatched = real + padded
            lat = LatencyStats.of([f - s for s, f, _ in jobs])
            by_prio: dict[str, list[float]] = collections.defaultdict(list)
            for s, f, prio in jobs:
                by_prio[prio].append(f - s)
            if jobs:
                window = (max(f for _, f, _ in jobs)
                          - min(s for s, _, _ in jobs))
                # zero-width window with jobs completed: throughput is
                # UNKNOWN (one instantaneous batch), not zero — 0.0
                # would read as a dead pipeline in SLO reports
                thr = len(jobs) / window if window > 0 else math.nan
            else:
                thr = 0.0
            per[name] = PipelineStats(
                pipeline=name,
                jobs=len(jobs),
                launches=len(launches),
                lanes_dispatched=dispatched,
                lanes_padded=padded,
                lane_utilization=(real / dispatched) if dispatched else 0.0,
                padded_lane_waste=(padded / dispatched) if dispatched
                else 0.0,
                latency=lat,
                throughput=thr,
                dispatch_counts=dict(collections.Counter(
                    l.variant for l in launches)),
                dropped=sum(1 for d in self._drops if d.pipeline == name),
                failed=sum(1 for d in self._fails if d.pipeline == name),
                retries=self._retries.get(name, 0),
                preempted=self._preempts.get(name, 0),
                lanes_coalesced=sum(l.coalesced for l in launches),
                latency_by_priority={p: LatencyStats.of(v)
                                     for p, v in sorted(by_prio.items())})
        dags: dict[str, DagStats] = {}
        dag_names = set(self._dag_submits) | {r[0]
                                              for r in self._dag_records}
        for dname in sorted(dag_names):
            recs = [r for r in self._dag_records if r[0] == dname]
            lat = [f - s for _, s, f, st, _ in recs if st == "done"]
            by_prio: dict[str, list[float]] = collections.defaultdict(list)
            for _, s, f, st, prio in recs:
                if st == "done":
                    by_prio[prio].append(f - s)
            dags[dname] = DagStats(
                dag=dname,
                submitted=self._dag_submits.get(dname, len(recs)),
                done=sum(1 for r in recs if r[3] == "done"),
                failed=sum(1 for r in recs if r[3] == "failed"),
                dropped=sum(1 for r in recs if r[3] == "dropped"),
                latency=LatencyStats.of(lat),
                latency_by_priority={p: LatencyStats.of(v)
                                     for p, v in sorted(by_prio.items())})
        decode = DecodeStats(
            requests=self._decode_requests,
            tokens=self._decode_tokens,
            steps=self._decode_steps,
            slot_reuses=self._decode_reuses,
            shed=self._decode_shed,
            insert=LatencyStats.of(self._decode_phases.get("insert", [])),
            prefill=LatencyStats.of(self._decode_phases.get("prefill", [])),
            generate=LatencyStats.of(
                self._decode_phases.get("generate", [])),
            tokens_per_step=(self._decode_tokens / self._decode_steps)
            if self._decode_steps else math.nan)
        return MetricsSnapshot(
            pipelines=per,
            dags=dags,
            decode=decode,
            launches=tuple(self._launches),
            total_jobs=sum(len(v) for v in self._jobs.values()),
            total_launches=len(self._launches),
            total_dropped=len(self._drops),
            total_preempted=sum(self._preempts.values()),
            total_coalesced=sum(l.coalesced for l in self._launches),
            total_failed=len(self._fails),
            total_retries=sum(self._retries.values()),
            faults=FaultStats(retries=sum(self._retries.values()),
                              failed_jobs=len(self._fails)))
