"""Registry-driven multi-pipeline serving front-end: :class:`SolverMux`.

A real 5G PUSCH chain mixes Cholesky-, QR-, and MMSE-shaped traffic in
one pipeline rather than one kernel at a time.  ``SolverMux`` accepts
that interleaved stream and serves it with the paper's lane model:

  * **routing** — each submitted job names its pipeline; the kernel
    registry resolves it to a per-pipeline :class:`_LanePool` (created
    lazily), and each shape bucket resolves through
    ``KernelSpec.dispatch_key`` to a variant (one options-bound entry
    point per pipeline × variant) — 4-plane MMSE buckets serve from the
    split-complex kernel, without the caller choosing anything.
  * **shape buckets** — within a pool, jobs are bucketed by their
    per-arg (shape, dtype) key; only bucket-mates share a lane group
    (unless the overload policy coalesces — below).
  * **continuous batching** — ``poll(now)`` dispatches full lane groups
    immediately and flushes *partial* buckets only when a deadline has
    expired, the bucket has waited ``max_wait``, or pool pressure
    (queued jobs in THAT pool >= ``pressure``) demands draining;
    ``run()`` drains everything.  Bucket flush order is deadline-aware:
    the bucket with the oldest (earliest) deadline flushes first, ties
    broken by submission order.
  * **padding** — a short lane group is topped up from the pipeline's
    ``KernelSpec.filler`` (a declared benign problem, e.g. identity
    system / zero rhs) so padded lanes stay finite and are discarded.

Every launch is one kernel over all lanes of the group on the mux's
``device`` (``cuda`` by default: the hand-written Hopper kernels;
``"cpu"``: their plain PyTorch versions).

Overload policy
---------------

With an :class:`OverloadPolicy` attached, ``poll`` becomes an
overload-aware scheduler.  Every decision is justified by one price:
``cost_model.launch_cost = overhead + lanes * model_flops * sec_per_flop``
(:mod:`repro_torch.serve.cost`; calibratable from the committed
``BENCH_pipelines.json`` baseline), evaluated through each bucket's
:class:`~repro_torch.serve.solver.VariantDispatcher` so a bucket prices
at its variant's cost.  The rules:

  * **shedding (admission control)** — a best-effort job whose deadline
    has already expired can no longer meet it; it is dropped *before*
    lanes are committed (terminal ``state="dropped"``, ``out`` stays
    ``None``, a ``drop`` event and metrics counter).  Hard-priority jobs
    are NEVER shed — at worst they finish late.
  * **budgeted admission** — each poll admits launch candidates (full
    chunks always; due partials) in earliest-deadline order while their
    summed launch cost fits ``policy.budget`` (``None`` = unlimited).
    A candidate that does not fit is deferred with a ``defer`` event
    recording the price that did not fit.
  * **priority preemption** — when a hard-deadline candidate does not
    fit, already-admitted best-effort flushes are abandoned until it
    does, cheapest-to-abandon first (lowest launch cost, partials over
    full groups, fewest delayed jobs — all cost-model-ranked;
    ``preempt`` events).  The abandoned bucket stays queued, ages
    toward the starvation bypass, and is re-admitted later.
  * **no starvation** — every defer/preemption ages the bucket; once a
    due bucket has been pushed back ``policy.max_defer`` times it is
    admitted ahead of everything on the next poll, so best-effort
    traffic cannot be starved by a hard-deadline flood.
  * **cross-shape coalescing** — an admitted partial launch's free
    lanes would execute benign filler; under pool pressure (or when the
    donor bucket is itself due) the policy instead embeds small jobs
    from a compatible smaller bucket of the same pool into those lanes
    (``KernelSpec.coalesce`` — block-diagonal embedding, exact
    extraction).  Applicability is checked at the padded shape:
    ``Coalescer.compatible`` on the (donor, host) keys, the host
    bucket's variant dispatched by its own predicate at exactly those
    shapes, and every embedded lane verified to conform to the host
    shapes/dtypes before launch.  The trade is scored by the cost
    model: ride iff k * lane_cost(big) < launch_cost(small, k) — i.e.
    the padded-lane waste is cheaper than the launch it avoids; a
    rejection is logged as a ``coalesce_reject`` event with both
    prices.  Absorbing a whole admitted smaller launch refunds its
    budget, which flows back to deferred candidates (``readmit``).

Every policy decision appends a JSON-able record to ``mux.events``
(``flush`` / ``drop`` / ``preempt`` / ``defer`` / ``coalesce`` /
``coalesce_reject`` / ``readmit``) — the audit trail golden-trace tests
replay; it is the reference's event stream, field for field.

Launch supervision (fault tolerance)
------------------------------------

Every mux launch is *supervised*: the attempt is wrapped, exceptions
are caught, and the real (non-filler) output lanes are scanned for
non-finite values.  A failed group is retried up to ``max_retries``
times with bounded exponential backoff **charged against the admission
budget** (``retry_backoff * 2**k`` debited from the next poll's budget —
the scheduling clock never blocks, so replays stay deterministic).
When retries exhaust, the failure is contained instead of propagated:

  * a launch carrying coalesced **riders** detaches them first (they
    stay queued) and relaunches the host alone — a poisoned donor never
    sinks its host;
  * a multi-job chunk **bisects** to isolate the poison lane — the
    single job left failing is marked terminal ``state="failed"`` with a
    structured ``reason`` and the healthy remainder is served;
  * a persistently **non-finite output lane** fails only the jobs on
    the poisoned lanes; the rest of the launch's results are kept
    (lanes are independent, so the good lanes are exact).

Variant failures feed the :class:`~repro_torch.serve.solver.
VariantDispatcher` demotion ladder (``demote_after`` consecutive
failures ban that variant for that bucket; on the card a rung whose
kernel cannot launch at the bucket's shape is passed over), and a
predicted-cost watchdog (``watchdog_ratio``; off by default — it
compares real wall-clock, which golden traces must not) flags launches
whose measured wall blows past the cost model's prediction.  All of it is observable:
``retry`` / ``fail`` / ``demote`` / ``watchdog`` events plus the
``MetricsSnapshot.faults`` block.  Faults are *injected* only via
:class:`repro_torch.serve.faults.FaultInjector`
(``REPRO_SERVE_FAULT_TRACE`` or the ``injector`` constructor arg).

DAG jobs (served pipelines)
---------------------------

``submit_dag(name, *args)`` serves a registered
:class:`repro_torch.kernels.DagSpec` — e.g. ``pusch_receive``'s FFT ->
channel-estimate -> MMSE-equalize chain — as a set of stage jobs the
mux advances through the declared producer->consumer edges: root stages
are routed to their stage pipelines' lane pools immediately, and each
``poll``/``run`` round harvests completed stage outputs and submits the
newly-ready frontier (stage inputs assembled by ``StageSpec.bind`` from
the DAG args + upstream outputs — the cross-launch handoff buffers
described by the stages' stream descriptors).  Stage buckets price
through the same cost model as everything else; at equal deadline,
buckets carrying **critical-path** stages (``DagSpec.criticality`` —
``core/criticality.plan_split`` over the stages' declared FLOPs models)
flush and admit ahead of slack-stage and standalone buckets.
``chained=True`` serves the spec's fused stage list (adjacent stages
lane-resident in one kernel, e.g. ``pusch_chain``) instead of the
stage-independent list.  Stage jobs inherit the DAG's deadline and
priority and run under the full overload/supervision machinery
unchanged: a failed mid-DAG stage retries / degrades / bisects through
the supervision ladder first, and only a *terminally* failed or dropped
stage ends the DAG (reason ``"stage:<name>:<reason>"``), cancelling
exactly the not-yet-submitted downstream stages — running siblings
finish normally, so every declared stage is accounted and none is
orphaned.  ``dag_submit`` / ``dag_stage`` / ``dag_done`` / ``dag_fail``
/ ``dag_drop`` events extend the audit trail, and
``MetricsSnapshot.dags`` reports end-to-end latency per DAG; muxes that
never see a DAG emit the same events and metrics as before.

Token decode (LM traffic)
-------------------------

``attach_decode(engine)`` makes a :class:`repro_torch.serve.decode.
DecodeEngine` the mux's token-traffic front-end: the engine shares the
mux's recorder, clocks and event log, and each ``poll`` serves up to
``decode_steps_per_poll`` continuous-batching steps, each priced by the
cost model (``decode_cost``) against the policy budget — expired
best-effort requests are shed, and a hard request overrides an
exhausted budget.  ``run`` drains decode beside the solver buckets.
``decode_insert`` / ``decode_step`` / ``decode_defer`` / ``decode_done``
events join the audit trail.

Not ported yet, and refused rather than approximated: mesh-sharded lane
pools (``mesh_size > 1``) — a later slice.

API sketch::

    mux = SolverMux(lanes=8, policy=OverloadPolicy(budget=2e-4))
    job = mux.submit("mmse_equalize", h, y, deadline=now + 2e-3,
                     priority="hard")
    mux.submit("cholesky_solve", a, b)          # best-effort
    done = mux.poll(now)        # schedule one overload-aware round
    snap = mux.metrics()        # per-pipeline p50/p99, drops, ...

All timing runs on an injectable clock (``time.monotonic`` by default,
:class:`repro_torch.serve.core.ManualClock` for deterministic tests and
trace replays).  Without a policy the mux never drops, preempts, or
coalesces.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.serve.config import global_config
from repro_torch.serve.core import EngineCore, pad_group
from repro_torch.serve.cost import CostModel
from repro_torch.serve.faults import FaultInjector, InjectedLaunchError
from repro_torch.serve.solver import (SolveJob, VariantDispatcher,
                                      resolve_pipeline_spec)
from repro_torch.serve.tuning import BucketTuner


def _bucket_priority(jobs: list[SolveJob]) -> tuple:
    """Oldest deadline first; among deadline ties, critical-path DAG
    stages (``job.crit``, from ``DagSpec.criticality``) rank ahead of
    slack stages and standalone jobs; FIFO (arrival seq) last.  Derived
    from the queued jobs each time, so a bucket whose oldest jobs were
    chunked away re-ranks correctly.  Buckets with no DAG stages all get
    rank 1, so non-DAG traffic orders exactly as before."""
    deadline = min((j.deadline for j in jobs if j.deadline is not None),
                   default=math.inf)
    rank = 0 if any(j.crit for j in jobs) else 1
    return (deadline, rank, min(j.seq for j in jobs))


def _round(x: float) -> float:
    """Stable 6-significant-digit rounding for event-log costs, so the
    golden trace files stay platform-independent."""
    return float(f"{x:.6g}")


def _shape_label(key: tuple) -> list:
    """JSON-able form of a shape-bucket key for the event log."""
    return [list(shape) for shape, _ in key]


@dataclasses.dataclass
class OverloadPolicy:
    """Overload-management knobs for :class:`SolverMux` (see the module
    docstring for the scheduling rules each one enables).

    ``shed`` / ``preempt`` / ``coalesce`` gate the three mechanisms
    independently (all on by default); ``budget`` is the per-poll
    lane-time budget in cost-model seconds (``None`` = unlimited, so
    only shedding and coalescing act); ``max_defer`` is the starvation
    bound — a due bucket deferred or preempted this many times is
    admitted ahead of everything on the next poll.  ``cost_model``
    prices every decision; pass ``CostModel.from_bench_json()`` for
    calibrated rates."""

    shed: bool = True
    preempt: bool = True
    coalesce: bool = True
    budget: float | None = None
    max_defer: int = 3
    cost_model: CostModel = dataclasses.field(default_factory=CostModel)


@dataclasses.dataclass(eq=False)
class _Candidate:
    """One potential grid launch in a policy poll round.

    ``eq=False``: candidates are identity objects.  The generated
    field-wise ``__eq__`` would compare ``jobs`` lists of SolveJobs
    holding numpy arrays — ``admitted.remove(victim)`` in ``_admit``
    then raises "truth value of an array is ambiguous" the moment a
    preemption plan coexists with another candidate from the same
    bucket."""

    pool: "_LanePool"
    key: tuple
    jobs: list
    partial: bool
    hard: bool
    aged: bool
    price: float
    deadline: float
    seq: int
    riders: tuple = ()
    rank: int = 1                   # 0: carries critical-path DAG stages


@dataclasses.dataclass(eq=False)
class DagJob:
    """One submitted DAG (``SolverMux.submit_dag``): a set of stage
    :class:`SolveJob` s the mux advances through the declared
    producer->consumer edges.  (``eq=False``: identity object, like
    SolveJob — field-wise ``__eq__`` would compare numpy arrays.)

    ``stages`` maps stage name -> its submitted SolveJob, or
    ``"cancelled"`` for downstream stages never submitted because an
    upstream stage terminated the DAG — every declared stage is
    accounted in exactly one of: submitted (terminal SolveJob) or
    cancelled; no stage is ever orphaned.  ``outs`` holds completed
    stage outputs (the cross-launch handoff buffers); ``crit`` is the
    criticality plan's critical-stage set.  ``state`` mirrors SolveJob:
    ``queued`` -> ``running`` once a stage is in flight -> terminal
    ``done`` (``out`` = final stage's output) / ``failed`` / ``dropped``
    (``reason`` = ``"stage:<name>:<stage reason>"``)."""

    dag: str
    spec: object
    args: tuple
    deadline: float | None
    priority: str
    submitted_at: float
    seq: int
    chained: bool = False
    stages: dict = dataclasses.field(default_factory=dict)
    outs: dict = dataclasses.field(default_factory=dict)
    crit: frozenset = frozenset()
    state: str = "queued"
    out: np.ndarray | None = None
    reason: str | None = None
    finished_at: float | None = None


class _LanePool:
    """Per-pipeline lane pool: variant dispatcher + shape buckets (lists
    of queued jobs keyed by per-arg shape/dtype).  Each bucket resolves
    through the registry's dispatch, so split-complex buckets serve from
    their own kernel.  ``age`` counts consecutive defer/preempt
    push-backs per bucket (the policy's starvation counter)."""

    def __init__(self, spec, options: dict, cost_model=None, device=None):
        self.spec = spec
        self.dispatcher = VariantDispatcher(spec, options, cost_model,
                                            device)
        self.buckets: dict[tuple, list[SolveJob]] = {}
        self.age: dict[tuple, int] = {}

    def enqueue(self, job: SolveJob) -> None:
        self.buckets.setdefault(job.shape_key(), []).append(job)

    def queued(self) -> int:
        return sum(len(jobs) for jobs in self.buckets.values())

    def remove(self, key: tuple, jobs: list) -> None:
        """Drop exactly ``jobs`` (by identity) from the ``key`` bucket,
        deleting the bucket (and its age counter) when emptied."""
        ids = {id(j) for j in jobs}
        left = [j for j in self.buckets.get(key, ()) if id(j) not in ids]
        if left:
            self.buckets[key] = left
        else:
            self.buckets.pop(key, None)
            self.age.pop(key, None)


class SolverMux(EngineCore):
    """Mixed-job-type solver serving with shape-bucketed continuous
    batching, a deadline-aware flush policy, and (optionally) the
    overload policy described in the module docstring.

    Parameters:
      lanes     lane-group width per grid launch (per-pipeline pools all
                share it; a launch never carries more than ``lanes`` jobs)
      max_wait  seconds a partial bucket may age before ``poll`` flushes
                it anyway (``None``: only deadlines/pressure flush
                partials)
      pressure  per-pool queued-job count at or above which ``poll``
                flushes that pool's partial buckets (oldest deadline
                first) until relieved; defaults to ``4 * lanes``.  The
                threshold is evaluated per pool — a backlog in one
                pipeline never flushes another pipeline's partials.
      policy    optional :class:`OverloadPolicy` enabling admission
                control, preemption, and cross-shape coalescing
      options   per-pipeline kwargs bound into the served kernel, e.g.
                ``{"mmse_equalize": {"sigma2": 0.05}}``
      clock     zero-arg time source (default ``time.monotonic``)
      wall      measurement clock for launch wall-clock (default
                ``time.perf_counter``) — feeds the cost model's
                calibration loop, independent of the scheduling clock
      cost_model  :class:`~repro_torch.serve.cost.CostModel` used WITHOUT
                a policy (pricing + drift observability only); with a
                policy the policy's model wins and this must stay unset
      adapt     enable the :class:`~repro_torch.serve.tuning.BucketTuner`
                (observed-traffic per-bucket ``max_wait`` + per-pool
                pressure); ``None`` defers to
                ``REPRO_SERVE_ADAPT_THRESHOLDS``
      mesh_size lane-shard count (``None`` defers to
                ``REPRO_SERVE_MESH_SIZE``, default 1); only 1 is
                supported until mesh sharding is ported
      injector  optional :class:`~repro_torch.serve.faults.FaultInjector`
                driving seeded chaos runs; ``None`` defers to
                ``REPRO_SERVE_FAULT_TRACE`` (no trace configured — the
                default — leaves every launch path uninjected)
      device    where launches run: ``cuda`` (default) or ``"cpu"``

    Every launch is measured (``wall``) and fed back through
    :meth:`observe_launch` to whichever cost model is attached — the
    predict -> measure -> re-fit loop whose drift metrics
    :meth:`metrics` folds into the snapshot.
    """

    def __init__(self, lanes: int = 8, *, max_wait: float | None = None,
                 pressure: int | None = None, clock=None, wall=None,
                 policy: OverloadPolicy | None = None,
                 cost_model: CostModel | None = None,
                 adapt: bool | None = None,
                 mesh_size: int | None = None,
                 injector: FaultInjector | None = None,
                 options: dict[str, dict] | None = None,
                 device=None):
        if mesh_size is None:
            mesh_size = global_config.mesh_size
        if mesh_size < 1:
            raise ValueError(f"mesh_size must be >= 1, got {mesh_size}")
        if mesh_size > 1:
            raise NotImplementedError(
                f"mesh_size={mesh_size}: mesh sharding is a later slice")
        super().__init__(lanes, clock=clock, wall=wall, device=device)
        if policy is not None and cost_model is not None:
            raise ValueError("pass cost_model either directly (no "
                             "policy) or on the policy, not both")
        self.mesh_size = 1
        self.max_wait = max_wait
        self.pressure = 4 * lanes if pressure is None else pressure
        self.policy = policy
        self._cost_model = cost_model
        if adapt is None:
            adapt = global_config.adapt_thresholds
        self.tuner = BucketTuner(lanes, cost_model=self.cost_model) \
            if adapt else None
        self._options = dict(options or {})
        self._pools: dict[str, _LanePool] = {}
        self._seq = 0
        self._dags: list[DagJob] = []
        # token-decode front-end (attach_decode); None = solver-only mux
        self.decode = None
        self._decode_steps_per_poll = global_config.decode_steps_per_poll
        self.events: list[dict] = []
        # ---- launch supervision (module docstring) ----
        # injector stays None with no trace configured, keeping every
        # launch path identical to the uninjected stack
        self.injector = injector if injector is not None \
            else FaultInjector.from_config()
        self.max_retries = global_config.max_retries
        self.retry_backoff = global_config.retry_backoff
        self.demote_after = global_config.demote_after
        self.watchdog_ratio = global_config.watchdog_ratio
        self._event_cap = global_config.event_cap
        self._fault_debt = 0.0
        self._watchdogs = 0
        self._events_dropped = 0

    @property
    def cost_model(self) -> CostModel | None:
        """The one model pricing and observing this mux's launches: the
        policy's when a policy is attached, else the directly-passed
        one, else None."""
        if self.policy is not None:
            return self.policy.cost_model
        return self._cost_model

    # ---------------- submission / routing ----------------

    def _pool(self, pipeline: str) -> _LanePool:
        pool = self._pools.get(pipeline)
        if pool is None:
            spec = resolve_pipeline_spec(pipeline)
            pool = _LanePool(spec, self._options.get(pipeline, {}),
                             self.cost_model, self.device)
            self._pools[pipeline] = pool
        return pool

    def submit(self, pipeline: str, *args, deadline: float | None = None,
               priority: str = "best_effort") -> SolveJob:
        """Route one job to its pipeline's lane pool and shape bucket.

        ``args`` are per-problem arrays WITHOUT the batch dimension;
        ``deadline`` is an absolute clock time (None = no deadline);
        ``priority`` is ``"hard"`` (never shed, may preempt) or
        ``"best_effort"`` (sheddable once expired, under a policy).
        Returns the queued :class:`SolveJob` (``out`` filled once a
        dispatch containing it runs; ``state`` becomes ``"done"`` or,
        under a shedding policy, possibly ``"dropped"``).

        Admission-time validation: a job whose float/complex args carry
        NaN/Inf is rejected here — terminal ``state="failed"`` with
        ``reason="nonfinite_input"`` — instead of being enqueued, so a
        poisoned input can never contaminate the lane group (and its
        coalesced riders) it would have been stacked into.
        """
        if priority not in SolveJob.PRIORITIES:
            raise ValueError(f"priority must be one of "
                             f"{SolveJob.PRIORITIES}, got {priority!r}")
        pool = self._pool(pipeline)
        job = SolveJob(args=tuple(np.asarray(a) for a in args),
                       pipeline=pipeline, deadline=deadline,
                       priority=priority)
        self._seq += 1
        job.seq = self._seq
        job.submitted_at = self.clock()
        if any(a.dtype.kind in "fc" and not np.all(np.isfinite(a))
               for a in job.args):
            job.state = "failed"
            job.reason = "nonfinite_input"
            job.finished_at = job.submitted_at
            self.recorder.record_fail(pipeline, job.submitted_at,
                                      job.priority, "nonfinite_input")
            self._event("fail", t=job.submitted_at, pipeline=pipeline,
                        seq=job.seq, reason="nonfinite_input")
            return job
        pool.enqueue(job)
        if self.tuner is not None:
            self.tuner.note_arrival(pipeline, job.shape_key(),
                                    job.submitted_at)
        return job

    # ---------------- DAG jobs ----------------

    def submit_dag(self, name: str, *args, deadline: float | None = None,
                   priority: str = "best_effort",
                   chained: bool = False) -> DagJob:
        """Submit one DAG job (a registered :class:`repro_torch.kernels.
        DagSpec`): its root stages (empty ``consumes``) are routed to
        their stage pipelines' lane pools immediately; downstream stages
        are submitted by :meth:`poll` / :meth:`run` as their producers'
        outputs land (``DagJob.outs`` — the cross-launch stage handoff
        buffers).  ``chained`` serves the spec's declared fused stage
        list (e.g. the one-launch channel-estimate->equalize chain)
        instead of the stage-independent list.

        Stage jobs inherit ``deadline`` and ``priority`` (``"hard"``
        stages are never shed, so a hard DAG either completes or fails
        through the supervision ladder — never silently dropped), and
        carry the criticality plan's per-stage flag: critical-path
        stages admit ahead of slack stages at equal deadline."""
        if priority not in SolveJob.PRIORITIES:
            raise ValueError(f"priority must be one of "
                             f"{SolveJob.PRIORITIES}, got {priority!r}")
        from repro_torch import kernels as K
        spec = K.get_dag(name)
        stages = spec.stage_list(chained=chained)
        shapes = tuple(np.shape(a) for a in args)
        critical, _slack = spec.criticality(shapes, chained=chained)
        now = self.clock()
        self._seq += 1
        dj = DagJob(dag=name, spec=spec,
                    args=tuple(np.asarray(a) for a in args),
                    deadline=deadline, priority=priority,
                    submitted_at=now, seq=self._seq, chained=chained,
                    crit=frozenset(critical))
        self._dags.append(dj)
        self.recorder.record_dag_submit(name)
        self._event("dag_submit", t=now, dag=name, seq=dj.seq,
                    stages=[s.name for s in stages],
                    critical=sorted(dj.crit), chained=chained)
        for stage in stages:
            if not stage.consumes:
                self._submit_stage(dj, stage, now)
        return dj

    def _submit_stage(self, dj: DagJob, stage, now: float) -> None:
        """Route one ready DAG stage to its pipeline's lane pool: the
        stage's ``bind`` assembles its inputs from the DAG args and the
        produced upstream outputs, and the resulting SolveJob is tagged
        back to the DAG (+ its criticality rank) for advancement."""
        bound = stage.bind(dj.args, dj.outs)
        job = self.submit(stage.pipeline, *bound, deadline=dj.deadline,
                          priority=dj.priority)
        job.dag = dj
        job.stage = stage.name
        job.crit = stage.name in dj.crit
        dj.stages[stage.name] = job
        if dj.state == "queued":
            dj.state = "running"
        self._event("dag_stage", t=now, dag=dj.dag, seq=dj.seq,
                    stage=stage.name, pipeline=stage.pipeline,
                    job=job.seq, critical=job.crit)

    def _advance_dags(self, now: float) -> bool:
        """Advance every in-flight DAG: harvest completed stage outputs,
        submit newly-ready stages (all ``consumes`` produced), finish
        DAGs whose stages are all done, and cascade a terminal stage
        failure — the failed/dropped stage ends the DAG with reason
        ``"stage:<name>:<reason>"`` and every not-yet-submitted
        downstream stage is marked ``"cancelled"`` (running sibling
        stages finish normally through their own launches), so no stage
        is ever orphaned.  Loops to a fixed point within one call (a
        stage rejected at submit, e.g. non-finite input, is cascaded in
        the same round).  Returns True when anything progressed."""
        progressed = False
        while True:
            round_progress = False
            for dj in self._dags:
                if dj.state in ("done", "failed", "dropped"):
                    continue
                stages = dj.spec.stage_list(chained=dj.chained)
                failed_stage = None
                for stage in stages:
                    sj = dj.stages.get(stage.name)
                    if not isinstance(sj, SolveJob):
                        continue
                    if sj.state == "done" and stage.name not in dj.outs:
                        dj.outs[stage.name] = sj.out
                        round_progress = True
                    elif sj.state in ("failed", "dropped") \
                            and failed_stage is None:
                        failed_stage = (stage.name, sj)
                if failed_stage is not None:
                    sname, sj = failed_stage
                    dj.state = sj.state
                    dj.reason = f"stage:{sname}:{sj.reason or sj.state}"
                    dj.finished_at = now
                    cancelled = [s.name for s in stages
                                 if s.name not in dj.stages]
                    for cname in cancelled:
                        dj.stages[cname] = "cancelled"
                    self.recorder.record_dag(dj.dag, dj.submitted_at,
                                             now, dj.state, dj.priority)
                    self._event(
                        "dag_fail" if dj.state == "failed" else
                        "dag_drop", t=now, dag=dj.dag, seq=dj.seq,
                        stage=sname, reason=dj.reason,
                        cancelled=cancelled)
                    round_progress = True
                    continue
                if all(s.name in dj.outs for s in stages):
                    dj.state = "done"
                    dj.out = dj.outs[stages[-1].name]
                    dj.finished_at = now
                    self.recorder.record_dag(dj.dag, dj.submitted_at,
                                             now, "done", dj.priority)
                    self._event("dag_done", t=now, dag=dj.dag,
                                seq=dj.seq,
                                latency=_round(now - dj.submitted_at))
                    round_progress = True
                    continue
                for stage in stages:
                    if stage.name in dj.stages:
                        continue
                    if all(c in dj.outs for c in stage.consumes):
                        self._submit_stage(dj, stage, now)
                        round_progress = True
            if not round_progress:
                return progressed
            progressed = True

    # ---------------- token decode traffic ----------------

    def attach_decode(self, engine) -> None:
        """Register a :class:`repro_torch.serve.decode.DecodeEngine` as
        this mux's token-traffic front-end, so ONE scheduler owns both
        solver and decode traffic:

        * the engine adopts the mux's recorder and both clocks — decode
          launches, per-request latencies and per-phase samples land in
          the same :meth:`metrics` snapshot (``snapshot.decode`` plus a
          ``"decode"`` entry in ``snapshot.pipelines``);
        * engine lifecycle events (``decode_insert`` / ``decode_done``)
          are folded into the mux event log, so virtual-clock replays
          pin decode scheduling decisions event for event like solver
          flushes;
        * measured step wall-clock feeds
          :meth:`repro_torch.serve.cost.CostModel.observe_decode`.

        :meth:`poll` then serves up to ``decode_steps_per_poll``
        continuous-batching steps per round under the attached
        :class:`OverloadPolicy`, and :meth:`run` drains decode alongside
        solver buckets."""
        if self.decode is not None:
            raise ValueError("a decode engine is already attached")
        engine.recorder = self.recorder
        engine.clock = self.clock
        engine.wall = self.wall
        engine.event_cb = lambda kind, t, **f: self._event(kind, t=t, **f)
        cm = self.cost_model
        if cm is not None:
            engine.observe_cb = cm.observe_decode
        self.decode = engine
        self._event("decode_attach", t=self.clock(),
                    spec=engine.spec.name, slots=engine.lanes,
                    max_len=engine.max_len)

    def submit_decode(self, request, *, deadline: float | None = None,
                      priority: str = "best_effort"):
        """Submit one decode :class:`~repro_torch.serve.decode.Request`
        to the attached engine under the mux's admission classes:
        ``priority`` and ``deadline`` mean exactly what they mean for
        :meth:`submit`.  The request joins the mux's global ``seq``
        numbering so decode and solver events interleave unambiguously
        in the event log."""
        if self.decode is None:
            raise RuntimeError("no decode engine attached; call "
                               "attach_decode() first")
        if priority not in SolveJob.PRIORITIES:
            raise ValueError(f"priority must be one of "
                             f"{SolveJob.PRIORITIES}, got {priority!r}")
        self._seq += 1
        request.seq = self._seq
        request.priority = priority
        request.deadline = deadline
        return self.decode.submit(request)

    def _poll_decode(self, now: float) -> list:
        """One decode service round: shed expired best-effort queue
        entries (hard never shed), then run up to
        ``decode_steps_per_poll`` continuous-batching steps, each priced
        through the cost model and admitted against the policy budget.
        Decode budget is accounted separately from the solver flush
        budget within a poll — the same per-poll figure, so a saturated
        solver round cannot starve token traffic to zero — and a pending
        hard-deadline request overrides budget exhaustion."""
        eng = self.decode
        if eng is None:
            return []
        pol = self.policy
        if pol is not None and pol.shed:
            for r in eng.shed_expired(now):
                self.recorder.record_drop("decode", now, r.priority,
                                          "expired")
                self.recorder.record_decode_shed()
                self._event("drop", t=now, pipeline="decode", seq=r.seq,
                            deadline=r.deadline, reason="expired")
        cm = self.cost_model
        budget = math.inf if pol is None or pol.budget is None \
            else pol.budget
        spent, steps = 0.0, 0
        done: list = []
        while eng.has_work() and steps < self._decode_steps_per_poll:
            active = eng.occupied() or min(eng.pending(), eng.lanes)
            price = cm.decode_cost("generate",
                                   active * eng.token_flops) \
                if cm is not None else 0.0
            if spent + price > budget and not eng.hard_waiting():
                self._event("decode_defer", t=now, queued=eng.pending(),
                            active=eng.occupied(), cost=_round(price))
                break
            done.extend(eng.step())
            spent += price
            steps += 1
        if steps:
            self._event("decode_step", t=now, steps=steps,
                        done=len(done), active=eng.occupied(),
                        queued=eng.pending(), cost=_round(spent))
        return done

    def observe_launch(self, spec, variant, key: tuple, lanes: int,
                       measured: float) -> None:
        """Close the calibration loop: every measured launch feeds the
        attached cost model (drift tracking always; rate/overhead
        re-fitting when the model is adaptive) and the threshold tuner
        when one is enabled."""
        cm = self.cost_model
        if cm is not None:
            shapes = tuple(shape for shape, _ in key)
            cm.observe(spec.name,
                       variant if variant is not None else spec.base,
                       shapes, lanes, measured)
        if self.tuner is not None:
            self.tuner.note_launch(spec.name, lanes, measured)

    def metrics(self):
        """Recorder snapshot plus — when a cost model is attached — the
        per-(pipeline, variant) drift stats, worst offender, and
        calibration update counts (the SLO-side view of the online
        loop), and the supervision counters."""
        snap = self.recorder.snapshot()
        cm = self.cost_model
        if cm is not None:
            snap = dataclasses.replace(
                snap, drift=cm.drift(), worst_drift=cm.worst_drift(),
                calibration_updates=cm.calibration_updates())
        demotions = [d for p in self._pools.values()
                     for d in p.dispatcher.demotions]
        snap = dataclasses.replace(snap, faults=dataclasses.replace(
            snap.faults, demotions=len(demotions),
            watchdog_flags=self._watchdogs,
            alerts=tuple(f"demote:{d['pipeline']}:"
                         f"{d['from']}->{d['to']}" for d in demotions)))
        return snap

    def pending(self) -> int:
        n = sum(p.queued() for p in self._pools.values())
        if self.decode is not None:
            # queued requests plus occupied slots: both are unfinished
            # work run() is on the hook to drain
            n += self.decode.pending() + self.decode.occupied()
        return n

    def drain_events(self) -> list[dict]:
        """Return and clear the scheduling-decision event log.  When the
        bounded buffer (``REPRO_SERVE_EVENT_CAP``) overflowed since the
        last drain, the batch is prefixed with one ``events_dropped``
        record counting the discarded oldest records — overflow is
        reported, never silent."""
        events, self.events = self.events, []
        if self._events_dropped:
            events = [{"event": "events_dropped",
                       "count": self._events_dropped}] + events
            self._events_dropped = 0
        return events

    def _event(self, kind: str, t: float, **fields) -> None:
        self.events.append({"event": kind, "t": t, **fields})
        if self._event_cap and len(self.events) > self._event_cap:
            drop = len(self.events) - self._event_cap
            del self.events[:drop]
            self._events_dropped += drop

    # ---------------- dispatch ----------------

    def _sorted_buckets(self) -> list[tuple[_LanePool, tuple]]:
        """All non-empty buckets across pools, deadline-priority order."""
        items = [(pool, key) for pool in self._pools.values()
                 for key, jobs in pool.buckets.items() if jobs]
        items.sort(key=lambda pk: _bucket_priority(pk[0].buckets[pk[1]]))
        return items

    def _launch(self, pool: _LanePool, key: tuple, chunk: list,
                riders: tuple = (), now: float | None = None) -> list:
        """One supervised grid launch: ``chunk`` jobs of the (pool, key)
        bucket plus optional cross-shape ``riders`` embedded into
        otherwise-padded lanes.  Records the launch + per-job latencies
        and logs a ``flush`` event.

        Preparation errors (coalesce-embed nonconformance, padding
        misdeclaration) propagate and leave the jobs queued — they are
        scheduler bugs, not launch faults; execution goes through
        :meth:`_supervise`, which contains failures instead (retry /
        bisect / terminal per-job ``failed``)."""
        spec = pool.spec
        t = self.clock() if now is None else now
        variant, _ = pool.dispatcher.resolve(key)
        riders = tuple(riders)
        if riders:
            big_shapes = tuple(shape for shape, _ in key)
            embedded = [spec.coalesce.embed(j.args, big_shapes)
                        for j in riders]
            for lane in embedded:
                for arr, (shape, dt) in zip(lane, key):
                    arr = np.asarray(arr)
                    if arr.shape != tuple(shape) or str(arr.dtype) != dt:
                        raise ValueError(
                            f"{spec.name!r} coalesce.embed produced a "
                            f"{arr.shape}/{arr.dtype} lane; the host "
                            f"bucket expects {tuple(shape)}/{dt}")
            stacked = [np.stack([np.asarray(j.args[i]) for j in chunk]
                                + [np.asarray(e[i]) for e in embedded])
                       for i in range(len(key))]
        else:
            stacked = [np.stack([np.asarray(j.args[i]) for j in chunk])
                       for i in range(len(chunk[0].args))]
        padded, pad = pad_group(spec, stacked, self.lanes, variant=variant)
        return self._supervise(pool, key, list(chunk), riders, padded,
                               pad, t)

    def _scatter(self, pool: _LanePool, chunk: list, riders: tuple,
                 res, t: float, bad: set | None = None) -> list:
        """Write per-lane results back onto the jobs.  Lanes in ``bad``
        (persistently non-finite output) fail their job terminally
        instead — lanes are independent, so the good lanes stay exact
        and are served."""
        spec = pool.spec
        done = []
        for i, job in enumerate(list(chunk) + list(riders)):
            if bad and i in bad:
                job.state = "failed"
                job.reason = "nonfinite_output"
                job.finished_at = t
                self.recorder.record_fail(spec.name, t, job.priority,
                                          "nonfinite_output")
                self._event("fail", t=t, pipeline=spec.name, seq=job.seq,
                            reason="nonfinite_output")
            else:
                if i < len(chunk):
                    job.out = res[i]
                else:
                    small = tuple(np.shape(a) for a in job.args)
                    job.out = spec.coalesce.extract(res[i], small)
                job.state = "done"
                self.record_job(spec.name, job)
            done.append(job)
        return done

    def _flush_event(self, pool: _LanePool, key: tuple, chunk: list,
                     riders: tuple, variant, t: float) -> None:
        self._event("flush", t=t, pipeline=pool.spec.name,
                    variant=variant.name, shape=_shape_label(key),
                    jobs=[j.seq for j in chunk],
                    coalesced=[j.seq for j in riders])

    def _watchdog(self, pool: _LanePool, key: tuple, variant,
                  measured: float, t: float) -> None:
        """Predicted-cost watchdog: flag a launch whose measured wall
        exceeds ``watchdog_ratio`` times the cost model's prediction.
        Off at ratio 0.0 (the default) — it compares real wall-clock,
        which golden traces must never depend on."""
        if self.watchdog_ratio <= 0.0 or self.cost_model is None \
                or not math.isfinite(measured):
            return
        predicted = pool.dispatcher.price(key, self.lanes)
        if predicted > 0.0 and measured > self.watchdog_ratio * predicted:
            self._watchdogs += 1
            self._event("watchdog", t=t, pipeline=pool.spec.name,
                        variant=variant.name, measured=_round(measured),
                        predicted=_round(predicted))

    def _supervise(self, pool: _LanePool, key: tuple, chunk: list,
                   riders: tuple, padded: list, pad: int,
                   t: float) -> list:
        """Supervised execution of one prepared launch: the attempt loop
        plus the containment ladder (module docstring).  Returns the
        terminal jobs — every ``chunk`` job comes back ``done`` or
        ``failed``; detached riders come back still ``queued`` (the
        policy dispatcher only dequeues terminal jobs)."""
        spec = pool.spec
        real = len(chunk) + len(riders)
        reason = "launch_failed"
        failed = False
        bad: list[int] = []
        res = measured = None
        for attempt in range(self.max_retries + 1):
            # re-resolve each attempt: a mid-supervision demotion swaps
            # the entry point (demotable variants share the spec's
            # calling convention, so the prepared group is reusable)
            variant, fn = pool.dispatcher.resolve(key)
            ctx = {"pipeline": spec.name, "variant": variant.name,
                   "width": self.lanes, "mesh": 1, "shard": None, "t": t}
            failed, bad = False, []
            try:
                res, measured = self._timed_call(fn, padded, fault_ctx=ctx)
            except InjectedLaunchError as e:
                failed, reason = True, str(e) or "launch_failed"
            except Exception as e:          # noqa: BLE001 — contained
                failed = True
                reason = f"launch_exception:{type(e).__name__}"
            if not failed:
                bad = [i for i in range(real)
                       if not np.all(np.isfinite(res[i]))]
                if not bad:
                    # ---- success ----
                    self.record_launch(spec.name, key, real, pad,
                                       variant.name,
                                       coalesced=len(riders),
                                       measured=measured)
                    self.observe_launch(spec, variant, key, real + pad,
                                        measured)
                    done = self._scatter(pool, chunk, riders, res, t)
                    pool.dispatcher.note_success(key, variant)
                    self._watchdog(pool, key, variant, measured, t)
                    self._flush_event(pool, key, chunk, riders, variant, t)
                    return done
            # ---- failure accounting ----
            if not failed:
                reason = "nonfinite_output"
            fallback = pool.dispatcher.note_failure(key, variant,
                                                    self.demote_after)
            if fallback is not None:
                self._event("demote", t=t, pipeline=spec.name,
                            shape=_shape_label(key),
                            from_variant=variant.name,
                            to_variant=fallback.name)
            if attempt < self.max_retries:
                # backoff never blocks the scheduling clock: it is
                # charged as debt against the next poll's budget
                backoff = self.retry_backoff * (2 ** attempt)
                self._fault_debt += backoff
                self.recorder.record_retry(spec.name, t, reason)
                self._event("retry", t=t, pipeline=spec.name,
                            shape=_shape_label(key),
                            jobs=[j.seq for j in chunk],
                            attempt=attempt + 1, reason=reason,
                            backoff=_round(backoff))
        # ---- retries exhausted: contain, never propagate ----
        if not failed and bad:
            # executed fine but some real lanes are persistently
            # non-finite: fail exactly those jobs, serve the rest
            self.record_launch(spec.name, key, real, pad, variant.name,
                               coalesced=len(riders), measured=measured)
            done = self._scatter(pool, chunk, riders, res, t,
                                 bad=set(bad))
            self._flush_event(pool, key, chunk, riders, variant, t)
            return done
        if riders:
            # a poisoned donor must never sink its host: detach the
            # riders (they stay queued) and relaunch the host alone
            self._event("retry", t=t, pipeline=spec.name,
                        shape=_shape_label(key),
                        jobs=[j.seq for j in chunk],
                        action="detach_riders", reason=reason)
            return self._launch(pool, key, chunk, riders=(), now=t)
        if len(chunk) > 1:
            # bisect to isolate the poison lane
            self._event("retry", t=t, pipeline=spec.name,
                        shape=_shape_label(key),
                        jobs=[j.seq for j in chunk],
                        action="bisect", reason=reason)
            mid = len(chunk) // 2
            return (self._launch(pool, key, chunk[:mid], now=t)
                    + self._launch(pool, key, chunk[mid:], now=t))
        job = chunk[0]
        job.state = "failed"
        job.reason = reason
        job.finished_at = t
        self.recorder.record_fail(spec.name, t, job.priority, reason)
        self._event("fail", t=t, pipeline=spec.name, seq=job.seq,
                    reason=reason)
        return [job]

    def _flush_bucket(self, pool: _LanePool, key: tuple, *,
                      full_only: bool,
                      now: float | None = None) -> list[SolveJob]:
        """Dispatch a bucket in lane-group chunks.  ``full_only`` leaves
        the trailing partial chunk queued (continuous-batching path)."""
        jobs = pool.buckets[key]
        done: list[SolveJob] = []
        while len(jobs) >= self.lanes:
            chunk, jobs = jobs[:self.lanes], jobs[self.lanes:]
            done.extend(self._launch(pool, key, chunk, now=now))
        if jobs and not full_only:
            done.extend(self._launch(pool, key, jobs, now=now))
            jobs = []
        if jobs:
            pool.buckets[key] = jobs
        else:
            del pool.buckets[key]
            pool.age.pop(key, None)
        return done

    def _bucket_max_wait(self, pool: "_LanePool | None", key: tuple,
                         queued: int) -> float | None:
        """Effective age threshold for one partial bucket: the tuner's
        observed-inter-arrival pick when enabled and warmed, else the
        constructor ``max_wait``."""
        if self.tuner is not None and pool is not None:
            return self.tuner.max_wait(pool.spec.name, key, queued,
                                       self.max_wait)
        return self.max_wait

    def _pool_pressure(self, pool: "_LanePool") -> int:
        """Effective pressure threshold for one pool: the tuner's
        launch-cost-amortizing pick when enabled and warmed, else the
        constructor ``pressure``."""
        if self.tuner is not None:
            return self.tuner.pressure(pool.spec.name, self.pressure)
        return self.pressure

    def _under_pressure(self, pool: "_LanePool") -> bool:
        return pool.queued() >= self._pool_pressure(pool)

    def _expired(self, jobs: list[SolveJob], now: float,
                 pool: "_LanePool | None" = None,
                 key: tuple | None = None) -> bool:
        deadline = _bucket_priority(jobs)[0]
        if deadline <= now:
            return True
        age = now - min(j.submitted_at for j in jobs)
        max_wait = self._bucket_max_wait(pool, key, len(jobs)) \
            if key is not None else self.max_wait
        return max_wait is not None and age >= max_wait

    def poll(self, now: float | None = None) -> list[SolveJob]:
        """One continuous-batching round: full lane groups always
        dispatch; partial buckets dispatch only on expired deadline,
        ``max_wait`` age, or per-pool pressure.  Oldest deadline flushes
        first throughout.  With an :class:`OverloadPolicy` attached the
        round additionally sheds expired best-effort jobs, admits
        launches against the lane-time budget (preempting best-effort
        partials for hard-deadline buckets), and coalesces small jobs
        into larger buckets' free lanes — see the module docstring."""
        now = self.clock() if now is None else now
        if self.policy is not None:
            done = self._poll_policy(now)
            self._advance_dags(now)
            self._poll_decode(now)
            return done
        done: list[SolveJob] = []
        for pool, key in self._sorted_buckets():
            done.extend(self._flush_bucket(pool, key, full_only=True,
                                           now=now))
        for pool, key in self._sorted_buckets():
            jobs = pool.buckets[key]
            if self._expired(jobs, now, pool, key) \
                    or self._under_pressure(pool):
                done.extend(self._flush_bucket(pool, key, full_only=False,
                                               now=now))
        self._advance_dags(now)
        self._poll_decode(now)
        return done

    def run(self) -> list[SolveJob]:
        """Drain everything queued (deadline-priority bucket order) and
        return the completed jobs.  Drain is unconditional: no budget,
        no shedding — every still-queued job is served (riders a
        supervised launch detached are picked up by the next pass).  An
        attached decode engine is drained the same way: unbudgeted
        continuous-batching steps interleave with the flush passes until
        its queue and every slot are empty."""
        done: list[SolveJob] = []
        while True:
            flushed = False
            for pool, key in self._sorted_buckets():
                served = self._flush_bucket(pool, key, full_only=False)
                done.extend(served)
                flushed = flushed or bool(served)
            advanced = self._advance_dags(self.clock())
            stepped = False
            if self.decode is not None and self.decode.has_work():
                self.decode.step()
                stepped = True
            if not flushed and not advanced and not stepped:
                return done

    # ---------------- overload policy ----------------

    def _shed(self, now: float) -> None:
        """Admission control: drop queued best-effort jobs whose deadline
        has already expired (they can no longer meet it; serving them
        would burn budget hard-deadline traffic needs).  Hard jobs are
        never shed."""
        for pool in self._pools.values():
            for key in list(pool.buckets):
                keep = []
                for job in pool.buckets[key]:
                    if (job.priority != "hard" and job.deadline is not None
                            and job.deadline < now):
                        job.state = "dropped"
                        self.recorder.record_drop(pool.spec.name, now,
                                                  job.priority, "expired")
                        self._event("drop", t=now, pipeline=pool.spec.name,
                                    seq=job.seq, deadline=job.deadline,
                                    reason="expired")
                    else:
                        keep.append(job)
                if keep:
                    pool.buckets[key] = keep
                else:
                    del pool.buckets[key]
                    pool.age.pop(key, None)

    def _candidates(self, now: float) -> list[_Candidate]:
        """Launch candidates this round: every full lane-group chunk,
        plus each due partial chunk (expired deadline / max_wait age /
        per-pool pressure / starvation-aged).  Priced at full pool width
        — padded lanes execute too — and sorted aged-first, then by
        (deadline, arrival)."""
        pol = self.policy
        cands: list[_Candidate] = []
        for pool in self._pools.values():
            under_pressure = self._under_pressure(pool)
            for key, jobs in pool.buckets.items():
                if not jobs:
                    continue
                price = pool.dispatcher.price(key, self.lanes)
                aged = pool.age.get(key, 0) >= pol.max_defer
                rest = jobs
                while len(rest) >= self.lanes:
                    chunk, rest = rest[:self.lanes], rest[self.lanes:]
                    cands.append(self._mk_cand(pool, key, chunk, False,
                                               aged, price))
                if rest and (aged or under_pressure
                             or self._expired(rest, now, pool, key)):
                    cands.append(self._mk_cand(pool, key, rest, True,
                                               aged, price))
        cands.sort(key=lambda c: (not c.aged, c.deadline, c.rank, c.seq))
        return cands

    @staticmethod
    def _mk_cand(pool, key, chunk, partial, aged, price) -> _Candidate:
        deadline, rank, seq = _bucket_priority(chunk)
        return _Candidate(pool=pool, key=key, jobs=list(chunk),
                          partial=partial,
                          hard=any(j.priority == "hard" for j in chunk),
                          aged=aged, price=price, deadline=deadline,
                          seq=seq, rank=rank)

    def _admit(self, cands: list[_Candidate],
               now: float) -> list[_Candidate]:
        """Budgeted admission with hard-deadline preemption.  Walks the
        candidates in priority order; a hard candidate that does not fit
        may abandon already-admitted best-effort launches (cheapest to
        abandon first; partials preferred) to free budget.  Deferred and
        preempted buckets age toward the starvation bypass: aged
        candidates sort first (budget priority), and ONE aged candidate
        per poll may borrow past the budget (the voucher drives the
        remaining budget negative, blocking this poll's later
        candidates; each poll starts afresh from ``policy.budget``) —
        bounded, so a backlog of aged buckets can never avalanche past
        admission control."""
        pol = self.policy
        base = math.inf if pol.budget is None else pol.budget
        # retry backoff charged by launch supervision since the last
        # poll debits the budget here (zero fault-free)
        budget = base - self._fault_debt
        self._fault_debt = 0.0
        admitted: list[_Candidate] = []
        voucher = True
        bumped: set[tuple] = set()

        def bump(cand):
            pool = cand.pool
            if (id(pool), cand.key) in bumped:
                return              # age once per bucket per poll
            bumped.add((id(pool), cand.key))
            pool.age[cand.key] = pool.age.get(cand.key, 0) + 1

        for cand in cands:
            ok = budget >= cand.price
            if ok or (cand.aged and voucher):
                if not ok:
                    voucher = False
                budget -= cand.price
                admitted.append(cand)
                continue
            if cand.hard and pol.preempt:
                victims = sorted(
                    (a for a in admitted if not a.hard and not a.aged),
                    key=lambda a: (a.price, not a.partial, len(a.jobs)))
                plan: list[_Candidate] = []
                freed = 0.0
                for v in victims:
                    if budget + freed >= cand.price:
                        break
                    plan.append(v)
                    freed += v.price
                if plan and budget + freed >= cand.price:
                    for v in plan:
                        admitted.remove(v)
                        bump(v)
                        budget += v.price
                        self.recorder.record_preempt(
                            v.pool.spec.name, len(v.jobs), now)
                        self._event(
                            "preempt", t=now,
                            pipeline=v.pool.spec.name,
                            shape=_shape_label(v.key),
                            jobs=[j.seq for j in v.jobs],
                            cost=_round(v.price),
                            for_pipeline=cand.pool.spec.name,
                            for_cost=_round(cand.price))
                    budget -= cand.price
                    admitted.append(cand)
                    continue
            bump(cand)
            self._event("defer", t=now, pipeline=cand.pool.spec.name,
                        shape=_shape_label(cand.key),
                        jobs=[j.seq for j in cand.jobs],
                        price=_round(cand.price),
                        budget=_round(budget))
        return admitted

    def _ride_score(self, cand: _Candidate, dkey: tuple, k: int,
                    host_variant) -> tuple[float, float]:
        """(ride, own) prices for embedding ``k`` jobs of donor bucket
        ``dkey`` into host ``cand``: ride = the padded-lane work the
        riders cost at the host shape; own = the launch they would need
        on their own.  Riding wins iff ride < own."""
        pool, spec = cand.pool, cand.pool.spec
        big_shapes = tuple(shape for shape, _ in cand.key)
        small_shapes = tuple(shape for shape, _ in dkey)
        donor_variant, _ = pool.dispatcher.resolve(dkey)
        cm = self.policy.cost_model
        ride = k * cm.lane_cost(spec.name, host_variant, big_shapes)
        own = cm.launch_cost(spec.name, donor_variant, small_shapes,
                             lanes=k)
        return ride, own

    def _plan_riders(self, admitted: list[_Candidate],
                     now: float) -> tuple[list[_Candidate], float]:
        """Cross-shape coalescing: fill admitted partial launches' free
        lanes with compatible smaller jobs from the same pool instead of
        filler.  Two donor sources, in order: (1) a whole *admitted*
        smaller partial launch that fits entirely — its own launch is
        cancelled and its already-charged budget refunded (the saved
        launch is the point); (2) queued jobs of due-or-pressured
        smaller buckets that were not admitted this round.  A ride is
        validated at the padded shape (``Coalescer.compatible`` on the
        (donor, host) keys; the host bucket's variant was dispatched by
        its applicability predicate at exactly those shapes, and
        ``_launch`` verifies every embedded lane conforms to them) and
        scored by the cost model: ride iff the padded-lane work is
        cheaper than the launch it avoids.  Returns the admitted list
        with absorbed launches removed, plus the refunded budget."""
        taken = {id(j) for c in admitted for j in c.jobs}
        absorbed: set[int] = set()
        refund = 0.0
        for cand in admitted:
            if not cand.partial or id(cand) in absorbed:
                continue
            free = self.lanes - len(cand.jobs)
            if free <= 0:
                continue
            pool, spec = cand.pool, cand.pool.spec
            if spec.coalesce is None:
                continue
            variant, _ = pool.dispatcher.resolve(cand.key)
            # (1) absorb whole admitted smaller partial launches
            for donor in admitted:
                if free <= 0:
                    break
                if (donor is cand or id(donor) in absorbed
                        or not donor.partial or donor.riders
                        or donor.pool is not pool
                        or len(donor.jobs) > free
                        or not spec.coalesce.compatible(donor.key,
                                                        cand.key)):
                    continue
                k = len(donor.jobs)
                ride, own = self._ride_score(cand, donor.key, k, variant)
                if ride >= own:
                    self._event("coalesce_reject", t=now,
                                pipeline=spec.name,
                                from_shape=_shape_label(donor.key),
                                into_shape=_shape_label(cand.key),
                                ride_cost=_round(ride),
                                own_cost=_round(own))
                    continue
                cand.riders += tuple(donor.jobs)
                free -= k
                absorbed.add(id(donor))
                refund += donor.price
                self._event("coalesce", t=now, pipeline=spec.name,
                            from_shape=_shape_label(donor.key),
                            into_shape=_shape_label(cand.key),
                            jobs=[j.seq for j in donor.jobs],
                            ride_cost=_round(ride), own_cost=_round(own))
            # (2) queued donors that were not admitted this round
            under_pressure = self._under_pressure(pool)
            for dkey, djobs in list(pool.buckets.items()):
                if free <= 0:
                    break
                if dkey == cand.key or not djobs:
                    continue
                if not spec.coalesce.compatible(dkey, cand.key):
                    continue
                if not (under_pressure or self._expired(djobs, now,
                                                        pool, dkey)):
                    continue        # no pressure, donor can keep waiting
                avail = [j for j in djobs if id(j) not in taken]
                k = min(free, len(avail))
                if k <= 0:
                    continue
                ride, own = self._ride_score(cand, dkey, k, variant)
                if ride >= own:
                    self._event("coalesce_reject", t=now,
                                pipeline=spec.name,
                                from_shape=_shape_label(dkey),
                                into_shape=_shape_label(cand.key),
                                ride_cost=_round(ride),
                                own_cost=_round(own))
                    continue
                riders = avail[:k]
                cand.riders += tuple(riders)
                free -= k
                taken.update(id(j) for j in riders)
                self._event("coalesce", t=now, pipeline=spec.name,
                            from_shape=_shape_label(dkey),
                            into_shape=_shape_label(cand.key),
                            jobs=[j.seq for j in riders],
                            ride_cost=_round(ride), own_cost=_round(own))
        return [c for c in admitted if id(c) not in absorbed], refund

    def _readmit(self, cands: list[_Candidate],
                 admitted: list[_Candidate], refund: float,
                 now: float) -> list[_Candidate]:
        """Budget refunded by absorbed launches flows back to this
        round's deferred candidates, in the original priority order —
        without this, a poll that saved a launch by coalescing would
        still under-admit by that launch's cost."""
        have = {id(c) for c in admitted}
        extra: list[_Candidate] = []
        for cand in cands:
            if id(cand) in have or not cand.jobs:
                continue
            taken = {id(j) for c in admitted + extra
                     for j in (*c.jobs, *c.riders)}
            if any(id(j) in taken for j in cand.jobs):
                continue            # its jobs already ride elsewhere
            if cand.price > refund:
                continue
            refund -= cand.price
            extra.append(cand)
            self._event("readmit", t=now,
                        pipeline=cand.pool.spec.name,
                        shape=_shape_label(cand.key),
                        jobs=[j.seq for j in cand.jobs],
                        price=_round(cand.price))
        return extra

    def _poll_policy(self, now: float) -> list[SolveJob]:
        """One overload-aware scheduling round: shed -> build candidates
        -> budgeted admission (with preemption) -> coalesce (refunding
        absorbed launches' budget to deferred candidates) -> dispatch in
        admission priority order."""
        pol = self.policy
        if pol.shed:
            self._shed(now)
        cands = self._candidates(now)
        admitted = self._admit(cands, now)
        if pol.coalesce:
            admitted, refund = self._plan_riders(admitted, now)
            if refund > 0.0:
                admitted.extend(self._readmit(cands, admitted, refund,
                                              now))
        done: list[SolveJob] = []
        order = {id(c): i for i, c in enumerate(cands)}
        for cand in sorted(admitted, key=lambda c: order[id(c)]):
            pool = cand.pool
            # launch BEFORE dequeuing: a launch that raises (e.g. a
            # nonconforming coalesce embedding) must leave its jobs
            # queued, exactly like the plain flush path
            served = self._launch(pool, cand.key, cand.jobs,
                                  riders=cand.riders, now=now)
            # dequeue only terminal jobs: supervision may have detached
            # riders back to the queue for a later round
            pool.remove(cand.key,
                        [j for j in cand.jobs if j.state != "queued"])
            by_key: dict[tuple, list] = {}
            for rider in cand.riders:
                if rider.state == "queued":
                    continue
                by_key.setdefault(rider.shape_key(), []).append(rider)
            for dkey, riders in by_key.items():
                pool.remove(dkey, riders)
            pool.age.pop(cand.key, None)
            done.extend(served)
        return done
