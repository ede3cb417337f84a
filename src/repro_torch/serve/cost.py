"""Self-tuning launch-cost model: predict -> measure -> re-fit.

The mux's overload policy
(:class:`repro_torch.serve.mux.OverloadPolicy`) must price a bucket flush
*before* committing lanes: shed / preempt / coalesce decisions are only
defensible if "how expensive is this launch?" has one answer everywhere.
That answer is::

    launch_cost = launch_overhead + lanes * model_flops * sec_per_flop

``model_flops`` comes from the registry (each
:class:`repro_torch.kernels.Variant` carries a closed-form per-lane FLOP
model); ``sec_per_flop`` is a per-(pipeline, variant) rate and ``launch_overhead`` the fixed per-launch
cost (dispatch + compile-cache lookup + host sync) that batching and
coalescing amortize.  Both start as guesses or as an offline calibration
(:meth:`CostModel.from_bench_json` — medians of the committed
``BENCH_pipelines.json`` wall-clock) and, unlike the one-shot model this
replaces, neither is trusted forever:

**The online loop.**  Every serve-side flush measures its wall-clock
(:meth:`repro_torch.serve.core.EngineCore.dispatch_group` stamps it onto the
:class:`~repro_torch.serve.metrics.LaunchRecord`) and feeds it back through
:meth:`CostModel.observe`.  Each observation

1. records the **drift** of that (pipeline, variant) pair — the EWMA of
   predicted/measured launch-cost ratios, exposed per pair (with its
   calibration source: ``default`` / ``bench`` / ``online``) through
   :meth:`drift` and folded into ``MetricsSnapshot`` so a mispriced
   variant is visible in SLO reports *before* it costs attainment; and
2. when the model is **adaptive** (``CostModel(adaptive=True)`` or
   ``REPRO_SERVE_CALIBRATE=1`` — see :mod:`repro_torch.serve.config`),
   re-fits the pair's ``sec_per_flop`` and the shared
   ``launch_overhead`` by coordinate descent on the residuals::

       overhead_sample = measured - flops * rate[pair]     # rate held
       rate_sample     = (measured - overhead) / flops     # oh held

   Each sample stream runs through a :class:`RobustEstimator` — the
   MEDIAN of every ``calibration_window`` samples is EWMA-blended
   (``calibration_alpha``), and the estimate only *replaces* the seeded
   value after ``calibration_warmup`` window-medians — so one outlier
   flush (GC pause, first-touch page faults, a neighbor's compile)
   cannot destabilize admission.  Samples are clamped to positivity
   floors: no measurement stream can drive an estimate non-positive.

All costs are seconds-shaped floats; with the default constants they are
only *relatively* meaningful (bigger = more lane time), which is all the
scheduler needs — budgets, preemption and coalescing decisions compare
costs against each other, never against the wall clock.  Once the online
loop has warmed up they converge toward real wall-clock seconds, which
is what makes the drift ratio (predicted/measured, 1.0 = perfectly
priced) a meaningful SLO-side observable.

Every knob (alpha, window, warmup, floors, alert threshold, master
switch) lives in :class:`repro_torch.serve.config.ServeConfig` behind a
``REPRO_SERVE_*`` env var — deployments pin or free calibration without
code edits.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math

from repro_torch.serve.config import global_config

log = logging.getLogger(__name__)

# Uncalibrated defaults: ~0.5 GFLOP/s/lane of useful work and a 50 us
# dispatch quantum per grid launch.  Arbitrary but *orderable* — they
# preserve the two facts the policy relies on (cost grows with model
# FLOPs; a launch has a fixed overhead worth amortizing) until the
# online loop replaces them with measured values.
DEFAULT_SEC_PER_FLOP = 2e-9
DEFAULT_LAUNCH_OVERHEAD = 5e-5
# Decode pricing phases (maxtext's experimental_decode_microbenchmark
# shape): "prefill" steps consume prompt tokens, "generate" steps
# consume previously generated tokens, "insert" is the slot-assignment
# bookkeeping between them (no model FLOPs — pure fixed cost).
DECODE_PHASES = ("prefill", "insert", "generate")
# Extra fixed cost per additional mesh shard participating in a sharded
# flush (collective setup + multi-device dispatch) — 20% of the launch
# overhead per shard until the sharded bench rows calibrate the real
# per-mesh overhead table.  Monotone in mesh size, so splitting is never
# priced as free.
DEFAULT_SHARD_OVERHEAD = 1e-5


def _median(vals) -> float:
    """True median: the average of the two middle elements for
    even-length inputs (``sorted(v)[len(v) // 2]`` is the UPPER middle
    element, which biased every calibrated rate upward)."""
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    if n % 2:
        return s[mid]
    return 0.5 * (s[mid - 1] + s[mid])


class RobustEstimator:
    """EWMA-of-window-medians with an update-count warmup.

    ``value`` stays at the seeded ``initial`` until ``warmup`` full
    windows have been folded; from then on it is the running EWMA of
    window medians.  Because every applied value is a convex combination
    of medians of observed (floored) samples, the warmed estimate always
    lies within the observed sample envelope ``[min(sample),
    max(sample)]`` and can never go non-positive — the property the
    fuzzed calibration tests pin.
    """

    def __init__(self, initial: float, *, alpha: float, window: int,
                 warmup: int, floor: float):
        self.initial = float(initial)
        self.alpha = float(alpha)
        self.window = max(1, int(window))
        self.warmup = max(1, int(warmup))
        self.floor = float(floor)
        self.updates = 0            # window-medians folded so far
        self.samples = 0
        self._est = math.nan        # EWMA of window medians
        self._buf: list[float] = []

    @property
    def warmed(self) -> bool:
        return self.updates >= self.warmup

    @property
    def value(self) -> float:
        return self._est if self.warmed else self.initial

    def observe(self, sample: float) -> bool:
        """Fold one sample; returns True when a full window was folded
        (i.e. the running estimate moved)."""
        self.samples += 1
        self._buf.append(max(self.floor, float(sample)))
        if len(self._buf) < self.window:
            return False
        med = _median(self._buf)
        self._buf.clear()
        self.updates += 1
        if self.updates == 1:
            self._est = med         # jump to the first median: the
        else:                       # seeded value never leaks into the
            self._est += self.alpha * (med - self._est)   # envelope
        return True


@dataclasses.dataclass(frozen=True)
class DriftStat:
    """Predicted-vs-measured health of one (pipeline, variant) pair.

    ``ratio`` is the EWMA of per-launch predicted/measured launch-cost
    ratios (1.0 = perfectly priced, >1 overpriced, <1 underpriced;
    NaN until the pair has been observed); ``last`` the most recent
    ratio; ``updates`` how many flushes have been observed; ``source``
    where the pair's current rate comes from (``"default"`` /
    ``"bench"`` / ``"online"``); ``alert`` whether ``|log(ratio)|``
    exceeds the configured ``drift_alert_ratio``.

    ``mesh`` is the shard count the launches spanned: drift is
    attributed per (pipeline, variant, mesh_size), so a mispriced
    sharded path is visible separately from the single-device path it
    shares rates with.  Single-device stats keep the legacy
    ``"pipeline/variant"`` key; sharded ones append ``"@meshN"``."""

    pipeline: str
    variant: str
    ratio: float
    last: float
    updates: int
    source: str
    alert: bool
    mesh: int = 1

    @property
    def key(self) -> str:
        base = f"{self.pipeline}/{self.variant}"
        return base if self.mesh <= 1 else f"{base}@mesh{self.mesh}"


class _PairDrift:
    """Mutable per-pair drift accumulator behind :class:`DriftStat`."""

    __slots__ = ("ratio", "last", "updates")

    def __init__(self):
        self.ratio = math.nan
        self.last = math.nan
        self.updates = 0

    def observe(self, ratio: float, alpha: float) -> None:
        self.last = ratio
        self.updates += 1
        if math.isnan(self.ratio):
            self.ratio = ratio
        else:
            self.ratio += alpha * (ratio - self.ratio)


class CostModel:
    """Prices one grid launch of a dispatched variant — and, when
    adaptive, re-fits itself from measured launch wall-clock.

    ``table`` maps ``(pipeline, variant_name) -> sec_per_flop`` rates;
    pairs absent from the table fall back to the uniform
    ``sec_per_flop``.  ``launch_overhead`` is the fixed per-launch cost
    that batching and coalescing amortize — the coalescing lever, and
    the number the online loop most needs to measure (module docstring).

    ``adaptive=None`` defers to ``config.calibrate``
    (``REPRO_SERVE_CALIBRATE``); ``config`` defaults to the process-wide
    :data:`repro_torch.serve.config.global_config`.
    """

    def __init__(self, sec_per_flop: float = DEFAULT_SEC_PER_FLOP,
                 launch_overhead: float = DEFAULT_LAUNCH_OVERHEAD,
                 table: dict | None = None, *,
                 adaptive: bool | None = None, config=None,
                 calibrated: frozenset | None = None,
                 shard_overhead: float = DEFAULT_SHARD_OVERHEAD,
                 mesh_overhead: dict | None = None):
        self.config = config if config is not None else global_config
        self.sec_per_flop = float(sec_per_flop)
        self.launch_overhead = float(launch_overhead)
        self.table = dict(table or {})
        self.adaptive = (self.config.calibrate if adaptive is None
                         else bool(adaptive))
        #: pairs whose rate came from the offline bench calibration —
        #: surfaced as ``source="bench"`` in the drift metrics so
        #: "calibrated vs default" is visible per pair.
        self.calibrated = frozenset(calibrated if calibrated is not None
                                    else self.table)
        #: per-extra-shard fixed cost used by :meth:`overhead` for mesh
        #: sizes absent from the calibrated ``mesh_overhead`` table.
        self.shard_overhead = float(shard_overhead)
        #: ``mesh_size -> fixed overhead`` of one mesh-spanning launch,
        #: calibrated from the sharded bench rows
        #: (:meth:`from_bench_json`) or re-fit online per mesh size.
        self.mesh_overhead = dict(mesh_overhead or {})
        self._drift: dict[tuple, _PairDrift] = {}
        self._rate_est: dict[tuple, RobustEstimator] = {}
        self._oh_est = self._estimator(self.launch_overhead,
                                       self.config.overhead_floor)
        self._mesh_oh_est: dict[int, RobustEstimator] = {}

    def _estimator(self, initial: float, floor: float) -> RobustEstimator:
        cfg = self.config
        return RobustEstimator(initial, alpha=cfg.calibration_alpha,
                               window=cfg.calibration_window,
                               warmup=cfg.calibration_warmup, floor=floor)

    # ---------------- offline calibration ----------------

    @classmethod
    def from_bench_json(cls, path: str | None = None,
                        **kwargs) -> "CostModel":
        """Calibrate per-(pipeline, variant) sec/FLOP rates from the
        persisted benchmark baseline: for every ``variants`` record with
        a positive FLOP model, rate = wall_us * 1e-6 / model_flops; the
        true median across that variant's measured sizes becomes the
        table entry.  Unmeasured pairs keep the uniform default rate.

        A missing, unreadable, or malformed baseline — and a baseline
        with no usable rows — falls back to an UNCALIBRATED model with a
        logged warning instead of raising deep inside mux construction;
        the resulting all-``default`` sources show up in the drift
        metrics."""
        config = kwargs.get("config") or global_config
        if path is None:
            path = config.bench_json
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError) as e:
            log.warning("cost model: cannot read bench baseline %s (%s); "
                        "falling back to uncalibrated defaults", path, e)
            return cls(**kwargs)
        rates: dict[tuple, list[float]] = {}
        try:
            for rec in payload.get("variants", ()):
                flops = rec.get("model_flops", 0.0)
                wall = rec.get("wall_us", 0.0)
                if flops > 0.0 and wall > 0.0:
                    key = (rec["pipeline"], rec["variant"])
                    rates.setdefault(key, []).append(wall * 1e-6 / flops)
        except (KeyError, TypeError, AttributeError) as e:
            log.warning("cost model: malformed bench baseline %s (%s); "
                        "falling back to uncalibrated defaults", path, e)
            return cls(**kwargs)
        # decode phase rows (optional — older baselines lack them): each
        # carries one phase's measured wall + token FLOPs; the median
        # rate lands in the table under the ("decode", phase) pseudo-pair
        # (see decode_rate).  Zero-FLOP phases (insert) stay uncalibrated
        # — they are priced as pure overhead.
        try:
            for rec in payload.get("decode", ()):
                flops = rec.get("flops", 0.0)
                wall = rec.get("wall_us", 0.0)
                if flops > 0.0 and wall > 0.0:
                    key = ("decode", rec["phase"])
                    rates.setdefault(key, []).append(wall * 1e-6 / flops)
        except (KeyError, TypeError, AttributeError) as e:
            log.warning("cost model: malformed decode rows in %s (%s); "
                        "ignoring them", path, e)
        if not rates:
            log.warning("cost model: bench baseline %s has no usable "
                        "variant rows; falling back to uncalibrated "
                        "defaults", path)
            return cls(**kwargs)
        table = {k: _median(v) for k, v in rates.items()}
        # sharded rows (optional — older baselines lack them): each
        # carries the median measured wall of mesh-spanning launches;
        # the residual over the calibrated lane work is that mesh
        # size's fixed overhead.
        mesh_oh: dict[int, list[float]] = {}
        try:
            for rec in payload.get("sharded", ()):
                mesh = int(rec.get("mesh", 1))
                wall = rec.get("wall_us", 0.0)
                flops = rec.get("model_flops", 0.0)
                lanes = int(rec.get("lanes", 0))
                if mesh <= 1 or wall <= 0.0 or lanes <= 0:
                    continue
                rate = table.get((rec["pipeline"], rec["variant"]),
                                 DEFAULT_SEC_PER_FLOP)
                residual = wall * 1e-6 \
                    - math.ceil(lanes / mesh) * flops * rate
                mesh_oh.setdefault(mesh, []).append(residual)
        except (KeyError, TypeError, AttributeError, ValueError) as e:
            log.warning("cost model: malformed sharded rows in %s (%s); "
                        "ignoring them", path, e)
            mesh_oh = {}
        if mesh_oh and "mesh_overhead" not in kwargs:
            floor = config.overhead_floor
            kwargs["mesh_overhead"] = {m: max(_median(v), floor)
                                       for m, v in mesh_oh.items()}
        return cls(table=table, **kwargs)

    # ---------------- pricing ----------------

    def rate(self, pipeline: str, variant_name: str) -> float:
        return self.table.get((pipeline, variant_name), self.sec_per_flop)

    def lane_cost(self, pipeline: str, variant, shapes) -> float:
        """Seconds of lane time for ONE lane of ``variant`` at per-lane
        ``shapes`` (``variant`` is a registry Variant)."""
        return variant.model_flops(shapes) * self.rate(pipeline,
                                                       variant.name)

    def overhead(self, mesh: int = 1) -> float:
        """Fixed cost of one launch spanning ``mesh`` shards: the plain
        ``launch_overhead`` for a single-device launch, the calibrated
        per-mesh entry when the sharded bench rows (or the online loop)
        have measured that mesh size, else a linear
        ``launch_overhead + (mesh - 1) * shard_overhead`` estimate —
        monotone in mesh size, so a sharded flush is never priced
        cheaper than the same work on one shard plus zero."""
        if mesh <= 1:
            return self.launch_overhead
        got = self.mesh_overhead.get(int(mesh))
        if got is not None:
            return got
        return self.launch_overhead + (mesh - 1) * self.shard_overhead

    def launch_cost(self, pipeline: str, variant, shapes,
                    lanes: int = 1, mesh: int = 1) -> float:
        """Seconds for one grid launch ``lanes`` wide.  Padded filler
        lanes execute the same program, so callers price the full pool
        width — which is also why a coalesced rider lane is free at the
        margin: its lane time was already paid for as filler.

        ``mesh > 1`` prices a mesh-spanning sharded flush: shards run
        their lane slabs in parallel, so the lane term divides by the
        shard count (``ceil`` — the padded width is what each shard
        executes) while the fixed term grows to :meth:`overhead`.

        ``mesh`` is the count of shards actually PARTICIPATING in the
        launch, not the configured mesh size: under graceful
        degradation (a quarantined shard, see
        :class:`repro_torch.serve.shard.LaneShards`) the scheduler stops
        spanning and falls back to per-shard local launches priced at
        ``mesh=1`` — capacity loss shows up as honestly higher
        predicted cost rather than a stale full-mesh price.
        """
        if mesh <= 1:
            return self.launch_overhead + lanes * self.lane_cost(
                pipeline, variant, shapes)
        return self.overhead(mesh) + math.ceil(lanes / mesh) \
            * self.lane_cost(pipeline, variant, shapes)

    # ---------------- decode pricing ----------------

    def decode_rate(self, phase: str) -> float:
        """sec/FLOP of one decode ``phase`` (:data:`DECODE_PHASES`).
        Decode rates live in the same ``table`` under the pseudo-pair
        ``("decode", phase)``, so calibration source ("default" /
        "bench" / "online") and drift reporting come for free from the
        machinery above."""
        return self.table.get(("decode", phase), self.sec_per_flop)

    def decode_cost(self, phase: str, flops: float = 0.0) -> float:
        """Seconds for one pool-wide SPMD decode step of ``phase``:
        the fixed launch overhead plus the step's token FLOPs (active
        slots x per-token FLOPs from the decode spec) at the phase's
        rate.  ``insert`` carries no FLOPs — it is priced as pure
        overhead."""
        return self.launch_overhead + flops * self.decode_rate(phase)

    def observe_decode(self, phase: str, flops: float,
                       measured: float) -> None:
        """Feed one measured decode step back into the model: drift is
        tracked under the ``("decode", phase)`` pseudo-pair (surfacing
        as ``"decode/<phase>"`` in :meth:`drift`), and — when adaptive —
        the phase's sec/FLOP rate is re-fit through the same robust
        estimator stream the solver rates use.  The shared launch
        overhead is NOT re-fit from decode steps: solver flushes own
        that estimator, and a decode step's fixed cost is far smaller
        than a padded grid launch's."""
        if measured is None or not math.isfinite(measured) \
                or measured <= 0.0:
            return
        pair = ("decode", phase)
        predicted = self.decode_cost(phase, flops)
        drift = self._drift.get((*pair, 1))
        if drift is None:
            drift = self._drift[(*pair, 1)] = _PairDrift()
        drift.observe(predicted / measured, self.config.calibration_alpha)
        if not self.adaptive or flops <= 0.0:
            return
        est = self._rate_est.get(pair)
        if est is None:
            est = self._rate_est[pair] = self._estimator(
                self.decode_rate(phase), self.config.rate_floor)
        rate_sample = (measured - self.launch_overhead) / flops
        if est.observe(rate_sample) and est.warmed:
            self.table[pair] = est.value

    # ---------------- the online loop ----------------

    def observe(self, pipeline: str, variant, shapes, lanes: int,
                measured: float, mesh: int = 1) -> None:
        """Feed one measured launch back into the model (module
        docstring): record the pair's drift ratio, and — when adaptive —
        re-fit its ``sec_per_flop`` and the shared ``launch_overhead``
        through the robust estimators.  Non-positive / non-finite
        measurements are ignored.

        ``mesh > 1`` attributes the observation to the (pipeline,
        variant, mesh_size) triple: drift is tracked separately per mesh
        size, and — when adaptive — the measurement re-fits that mesh's
        :attr:`mesh_overhead` entry (the wall-clock is parallel time, so
        it must NOT feed the per-lane rate stream)."""
        if measured is None or not math.isfinite(measured) \
                or measured <= 0.0:
            return
        mesh = max(1, int(mesh))
        pair = (pipeline, variant.name)
        predicted = self.launch_cost(pipeline, variant, shapes, lanes,
                                     mesh=mesh)
        drift = self._drift.get((*pair, mesh))
        if drift is None:
            drift = self._drift[(*pair, mesh)] = _PairDrift()
        drift.observe(predicted / measured, self.config.calibration_alpha)
        if not self.adaptive:
            return
        cfg = self.config
        if mesh > 1:
            # sharded flush: measured is the parallel makespan.  The
            # per-shard lane work is ceil(lanes/mesh) lanes; the
            # residual re-fits this mesh size's fixed overhead.
            per_shard = math.ceil(lanes / mesh) \
                * self.lane_cost(pipeline, variant, shapes)
            est = self._mesh_oh_est.get(mesh)
            if est is None:
                est = self._mesh_oh_est[mesh] = self._estimator(
                    self.overhead(mesh), cfg.overhead_floor)
            if est.observe(measured - per_shard) and est.warmed:
                self.mesh_overhead[mesh] = est.value
            return
        flops = lanes * variant.model_flops(shapes)
        # coordinate descent on the residuals: overhead sample with the
        # pair's CURRENT rate held fixed, then the rate sample with the
        # current overhead held fixed — a wrong overhead cannot poison
        # the rate stream once its own estimator has warmed, and vice
        # versa.
        oh_sample = measured - flops * self.rate(*pair)
        if self._oh_est.observe(oh_sample) and self._oh_est.warmed:
            self.launch_overhead = self._oh_est.value
        if flops > 0.0:
            est = self._rate_est.get(pair)
            if est is None:
                est = self._rate_est[pair] = self._estimator(
                    self.rate(*pair), cfg.rate_floor)
            rate_sample = (measured - self.launch_overhead) / flops
            if est.observe(rate_sample) and est.warmed:
                self.table[pair] = est.value

    def source(self, pipeline: str, variant_name: str) -> str:
        """Where the pair's current rate comes from: ``"online"`` once
        its estimator has warmed, else ``"bench"`` for offline-calibrated
        pairs, else ``"default"``."""
        pair = (pipeline, variant_name)
        est = self._rate_est.get(pair)
        if est is not None and est.warmed:
            return "online"
        return "bench" if pair in self.calibrated else "default"

    def drift(self) -> dict[str, DriftStat]:
        """Per-pair drift health, keyed ``"pipeline/variant"``
        (single-device) or ``"pipeline/variant@meshN"`` (sharded) —
        every (pipeline, variant, mesh) triple that has been observed,
        plus every pair that carries a calibrated rate (so
        bench-calibrated pairs that never see traffic still report
        their source with ``updates=0``)."""
        alert_logratio = math.log(self.config.drift_alert_ratio)
        out: dict[str, DriftStat] = {}
        keys = set(self._drift) | {(p, v, 1) for p, v in
                                   self.calibrated | set(self.table)}
        for pipeline, vname, mesh in sorted(keys):
            d = self._drift.get((pipeline, vname, mesh))
            ratio = d.ratio if d is not None else math.nan
            alert = bool(ratio > 0
                         and abs(math.log(ratio)) > alert_logratio) \
                if (d is not None and math.isfinite(ratio)) else False
            stat = DriftStat(pipeline=pipeline, variant=vname,
                             ratio=ratio,
                             last=d.last if d is not None else math.nan,
                             updates=d.updates if d is not None else 0,
                             source=self.source(pipeline, vname),
                             alert=alert, mesh=mesh)
            out[stat.key] = stat
        return out

    def worst_drift(self) -> DriftStat | None:
        """The observed pair whose EWMA ratio is furthest from 1.0 in
        log space — the first place to look when attainment slips."""
        worst, worst_mag = None, -1.0
        for stat in self.drift().values():
            if stat.updates == 0 or not math.isfinite(stat.ratio) \
                    or stat.ratio <= 0:
                continue
            mag = abs(math.log(stat.ratio))
            if mag > worst_mag:
                worst, worst_mag = stat, mag
        return worst

    def calibration_updates(self) -> dict[str, int]:
        """Applied window-median update counts per estimator (the
        ``"overhead"`` key plus one per pair, plus one
        ``"overhead@meshN"`` per observed mesh size) — the observability
        hook for "is the loop actually learning?"."""
        out = {"overhead": self._oh_est.updates}
        for (pipeline, vname), est in sorted(self._rate_est.items()):
            out[f"{pipeline}/{vname}"] = est.updates
        for mesh, est in sorted(self._mesh_oh_est.items()):
            out[f"overhead@mesh{mesh}"] = est.updates
        return out
