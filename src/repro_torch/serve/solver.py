"""Single-pipeline solver serving: :class:`SolveJob` + :class:`PipelineEngine`,
and the :class:`VariantDispatcher` shared with
:class:`repro_torch.serve.mux.SolverMux`.

``PipelineEngine`` is the one-pipeline-per-instance engine on
:class:`repro_torch.serve.core.EngineCore`: the queue, lane accounting
and registry-driven padding are shared with the multi-pipeline
``SolverMux`` (which is what you want for mixed traffic).
"""
from __future__ import annotations

import collections
import dataclasses
import functools

import numpy as np

from repro_torch.serve.core import FifoEngineCore


@dataclasses.dataclass(eq=False)
class SolveJob:
    """One solver problem.  (``eq=False``: jobs are identity objects —
    the generated field-wise ``__eq__`` would compare numpy array args,
    which raises instead of answering.)

    ``args`` are the per-problem arrays WITHOUT the batch dimension
    (e.g. cholesky_solve: ``(a (N,N), b (N,M))``); ``out`` is filled by
    the serving engine.  ``pipeline`` and ``deadline`` (absolute clock
    seconds; ``None`` = no deadline) are used by :class:`SolverMux`;
    ``submitted_at``/``finished_at`` are stamped by the engine clock and
    feed the SLO metrics; ``seq`` is the mux's global arrival order (the
    FIFO tiebreak among equal-deadline buckets).

    ``priority`` is the overload-policy traffic class: ``"hard"`` jobs
    must never be shed and may preempt; ``"best_effort"`` jobs may be
    dropped once their deadline has expired.  ``state`` is the lifecycle
    marker — ``"queued"`` until a dispatch serves it (``"done"``, ``out``
    filled), the overload policy sheds it (``"dropped"``, terminal,
    ``out`` stays ``None``), or launch supervision gives up on it
    (``"failed"``, terminal, ``out`` stays ``None``, ``reason`` set to
    the structured failure reason — e.g. ``"nonfinite_input"`` rejected
    at submit, ``"nonfinite_output"`` for a persistently poisoned lane,
    or the exhausted-retries launch error).  A job is never silently
    lost: every submitted job ends in exactly one of those states.
    """

    PRIORITIES = ("hard", "best_effort")

    args: tuple
    out: np.ndarray | None = None
    pipeline: str | None = None
    deadline: float | None = None
    submitted_at: float | None = None
    finished_at: float | None = None
    seq: int = 0
    priority: str = "best_effort"
    state: str = "queued"
    reason: str | None = None
    dag: object | None = None
    """The :class:`repro_torch.serve.mux.DagJob` this job is a stage of
    (``None`` for ordinary standalone jobs)."""
    stage: str | None = None
    """Stage name within ``dag`` (``None`` for standalone jobs)."""
    crit: bool = False
    """True when criticality planning (``DagSpec.criticality``) put this
    stage on the DAG's critical path — the mux admits critical-stage
    buckets ahead of slack ones at equal deadline."""

    def shape_key(self) -> tuple:
        """Shape bucket: per-arg (shape, dtype) — jobs sharing it can be
        stacked into one lane group / one kernel launch."""
        return tuple((np.shape(a), str(np.asarray(a).dtype))
                     for a in self.args)


def resolve_pipeline_spec(pipeline: str):
    """Registry lookup + kind check shared by the solver engines."""
    from repro_torch import kernels as K
    spec = K.get(pipeline)
    if spec.kind != "pipeline":
        raise ValueError(f"{pipeline!r} is a {spec.kind}, "
                         "not a servable pipeline")
    return spec


class VariantDispatcher:
    """Shape-bucket -> (Variant, options-bound entry point) resolution
    with a per-variant cache, shared by PipelineEngine and the SolverMux
    pools.

    Every serve-side launch goes through :meth:`resolve` — the engines
    never touch ``spec.kernel`` directly — so a bucket of split-complex
    jobs lands on the registry's split variant.  ``options`` (e.g.
    ``sigma2``) are bound into every variant entry point alike with
    ``functools.partial``; PyTorch runs eagerly, so there is no
    per-bucket compile to cache beyond that binding.

    ``cost_model`` (a :class:`repro_torch.serve.cost.CostModel`, lazily
    defaulted) makes the dispatcher the one place a bucket flush gets
    priced: :meth:`price` resolves the bucket's variant and returns the
    estimated launch cost, so admission / preemption / coalescing
    decisions all price through the same dispatch the launch will use.

    **Demotion ladder.**  Launch supervision feeds per-bucket failure
    streaks back through :meth:`note_failure` / :meth:`note_success`.
    A variant that fails ``demote_after`` consecutive supervised
    launches on one shape bucket is *banned* for that bucket: resolution
    falls to the next applicable variant in registration order, so a
    buggy fast path degrades gracefully instead of failing the same jobs
    forever.  Only variants sharing the spec's calling convention
    (``variant.filler is None``) are demotable — a variant with its own
    filler (e.g. split-complex MMSE's 4 planes) takes different
    arguments, so there is nothing below it to fall to and its jobs fail
    terminally instead.

    On a CUDA ``device`` resolution also passes over a variant whose
    kernel cannot launch at the bucket's shape (``Variant.fits``): a
    1024 tiled bucket demotes straight to the base, since the blocked
    K10/K11 keep a whole panel in shared memory.
    """

    def __init__(self, spec, options: dict | None = None, cost_model=None,
                 device=None):
        self.spec = spec
        self.options = dict(options or {})
        self.cost_model = cost_model
        self.on_card = device is not None and device.type == "cuda"
        self._fns: dict[str, object] = {}
        self._bans: dict[tuple, set[str]] = {}
        self._fail_streaks: dict[tuple, int] = {}
        self.demotions: list[dict] = []

    def _dispatch(self, key: tuple):
        """``dispatch_key`` with this dispatcher's per-bucket bans
        applied: first applicable non-banned variant in registration
        order (on the card, one whose kernel fits the shape), the spec's
        base otherwise (base is never banned)."""
        shapes = tuple(tuple(s) for s, _ in key)
        dtypes = tuple(np.dtype(dt) for _, dt in key)
        banned = self._bans.get(key, ())
        for v in self.spec.variants:
            if v.name in banned or not v.when(shapes, dtypes):
                continue
            if self.on_card and v.fits is not None and not v.fits(shapes):
                continue
            return v
        return self.spec.base

    def demotable(self, key: tuple, variant) -> bool:
        """True when a failing ``variant`` on ``key`` has somewhere to
        fall: it is not the base and it shares the spec's calling
        convention (``filler is None`` — same args, so the queued jobs
        can re-resolve to the demoted variant unchanged)."""
        return variant is not self.spec.base and variant.filler is None

    def note_failure(self, key: tuple, variant,
                     demote_after: int) -> object | None:
        """Account one supervised-launch failure of ``variant`` on shape
        bucket ``key``.  When the consecutive streak reaches
        ``demote_after`` and the variant is demotable, ban it for this
        bucket and return the variant resolution falls to (the mux turns
        that into a ``demote`` event + alert); otherwise return None."""
        sk = (key, variant.name)
        self._fail_streaks[sk] = self._fail_streaks.get(sk, 0) + 1
        if (demote_after > 0 and self._fail_streaks[sk] >= demote_after
                and self.demotable(key, variant)):
            self._bans.setdefault(key, set()).add(variant.name)
            self._fail_streaks.pop(sk, None)
            fallback = self._dispatch(key)
            self.demotions.append({
                "pipeline": self.spec.name, "key": key,
                "from": variant.name, "to": fallback.name})
            return fallback
        return None

    def note_success(self, key: tuple, variant) -> None:
        self._fail_streaks.pop((key, variant.name), None)

    def resolve(self, key: tuple):
        """``key`` is a SolveJob.shape_key(): per-arg ((shape, dtype)).
        Returns the dispatched registry Variant and its options-bound
        entry point."""
        variant = self._dispatch(key)
        fn = self._fns.get(variant.name)
        if fn is None:
            fn = functools.partial(variant.fn, **self.options)
            self._fns[variant.name] = fn
        return variant, fn

    def resolve_sharded(self, key: tuple):
        """Mesh-spanning resolution: not ported yet."""
        raise NotImplementedError("mesh sharding: later slice")

    def price(self, key: tuple, lanes: int = 1) -> float:
        """Estimated launch cost (cost-model seconds) of flushing one
        ``lanes``-wide grid of this shape bucket through whichever
        variant :meth:`resolve` dispatches it to."""
        if self.cost_model is None:
            from repro_torch.serve.cost import CostModel
            self.cost_model = CostModel()
        variant, _ = self.resolve(key)
        shapes = tuple(shape for shape, _ in key)
        return self.cost_model.launch_cost(self.spec.name, variant,
                                           shapes, lanes)


class PipelineEngine(FifoEngineCore):
    """Batched solver service over a single registered pipeline.

    Jobs are grouped by problem shape, stacked, padded to a multiple of
    the ``lanes`` pool size with the spec's declared benign filler
    (padded lanes' results are discarded), and executed as one kernel
    launch per group on ``device`` (default ``cuda``), routed through
    the registry's dispatch so each shape group lands on the right
    variant.  ``pipeline`` is any ``kind="pipeline"`` name in the kernel
    registry; extra keyword ``options`` (e.g. ``sigma2`` for
    mmse_equalize) are bound into the served kernel.
    """

    def __init__(self, pipeline: str = "cholesky_solve", lanes: int = 8,
                 clock=None, device=None, **options):
        super().__init__(lanes, clock=clock, device=device)
        self.spec = resolve_pipeline_spec(pipeline)
        self._dispatcher = VariantDispatcher(self.spec, options,
                                             device=self.device)

    def submit(self, job: SolveJob) -> SolveJob:
        job.pipeline = self.spec.name
        return super().submit(job)

    def observe_launch(self, spec, variant, key, lanes, measured):
        """Feed measured launch wall-clock to the dispatcher's cost
        model when one is attached (set ``engine._dispatcher.cost_model``
        or pass one to the dispatcher) — same calibration loop as the
        mux, no-op otherwise."""
        cm = self._dispatcher.cost_model
        if cm is not None:
            shapes = tuple(shape for shape, _ in key)
            cm.observe(spec.name,
                       variant if variant is not None else spec.base,
                       shapes, lanes, measured)

    def run(self) -> list[SolveJob]:
        done: list[SolveJob] = []
        groups: dict[tuple, list[SolveJob]] = collections.defaultdict(list)
        for job in self.drain():
            groups[job.shape_key()].append(job)
        for key, jobs in groups.items():
            variant, fn = self._dispatcher.resolve(key)
            done.extend(self.dispatch_group(self.spec, fn, key, jobs,
                                            variant=variant))
        return done
