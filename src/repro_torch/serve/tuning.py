"""Adaptive flush thresholds: per-bucket ``max_wait`` and per-pool
pressure picked from observed traffic instead of hand-set constants.

The mux's continuous-batching knobs — how long a partial bucket may age
before flushing (``max_wait``) and how deep a pool's backlog may grow
before partials drain (``pressure``) — are tuning knobs in exactly the
Buttari-et-al. tiled-LA sense: the right value depends on measured
behavior (inter-arrival times, launch cost), not on anything knowable at
construction time.  :class:`BucketTuner` closes that loop from two
observation streams the serving stack already produces:

* **arrivals** — ``note_arrival`` maintains a per-(pipeline, bucket)
  EWMA of inter-arrival times.  The tuned per-bucket ``max_wait`` is
  the *expected time for the partial to fill*::

      max_wait = clamp(missing_lanes * ewma_interarrival,
                       wait_floor, wait_cap)

  A bucket with fast arrivals flushes stragglers quickly (if the group
  were going to fill, it would have filled by then — holding longer
  only adds latency); a slow bucket is allowed its expected fill time,
  capped so no job is held hostage to a dried-up stream.

* **launches** — ``note_launch`` maintains a per-pipeline EWMA of
  measured per-lane launch cost.  The tuned per-pool pressure is the
  backlog at which draining amortizes the launch overhead
  ``pressure_gain`` times over::

      pressure = clamp(pressure_gain * overhead / lane_cost,
                       lanes, pressure_cap_lanes * lanes)

  When overhead dominates lane cost (tiny problems), batches should be
  deep before partials drain; when lanes are expensive, holding a
  backlog buys nothing and partials drain early.

Until a stream has ``calibration_warmup`` observations the tuner
returns the configured defaults — the same warmup discipline as the
cost model.  Every constant above is a ``ServeConfig`` knob
(``REPRO_SERVE_ADAPT_THRESHOLDS`` masters the whole tuner; see
:mod:`repro_torch.serve.config`).
"""
from __future__ import annotations

from repro_torch.serve.config import global_config


class _Ewma:
    __slots__ = ("value", "count", "alpha")

    def __init__(self, alpha: float):
        self.value = 0.0
        self.count = 0
        self.alpha = float(alpha)

    def observe(self, x: float) -> None:
        x = float(x)
        if self.count == 0:
            self.value = x
        else:
            self.value += self.alpha * (x - self.value)
        self.count += 1


class BucketTuner:
    """Observed-traffic flush-threshold tuner (module docstring).

    ``cost_model`` supplies the launch-overhead estimate the pressure
    rule amortizes (falling back to the config default when absent); the
    tuner itself never prices anything else through it.
    """

    def __init__(self, lanes: int, config=None, cost_model=None):
        self.lanes = int(lanes)
        self.config = config if config is not None else global_config
        self.cost_model = cost_model
        self._interarrival: dict[tuple, _Ewma] = {}
        self._last_arrival: dict[tuple, float] = {}
        self._lane_cost: dict[str, _Ewma] = {}

    # ---------------- observation ----------------

    def note_arrival(self, pipeline: str, key: tuple, t: float) -> None:
        bkey = (pipeline, key)
        last = self._last_arrival.get(bkey)
        self._last_arrival[bkey] = t
        if last is None:
            return
        gap = t - last
        if gap < 0:
            return
        ewma = self._interarrival.get(bkey)
        if ewma is None:
            ewma = self._interarrival[bkey] = _Ewma(
                self.config.interarrival_alpha)
        ewma.observe(gap)

    def note_launch(self, pipeline: str, lanes: int,
                    measured: float) -> None:
        if measured is None or not measured > 0.0 or lanes < 1:
            return
        ewma = self._lane_cost.get(pipeline)
        if ewma is None:
            ewma = self._lane_cost[pipeline] = _Ewma(
                self.config.interarrival_alpha)
        ewma.observe(measured / lanes)

    # ---------------- tuned thresholds ----------------

    def max_wait(self, pipeline: str, key: tuple, queued: int,
                 default: float | None) -> float | None:
        """Tuned age threshold for a partial bucket holding ``queued``
        jobs, or ``default`` until the bucket's arrival stream has
        warmed up."""
        cfg = self.config
        ewma = self._interarrival.get((pipeline, key))
        if ewma is None or ewma.count < cfg.calibration_warmup:
            return default
        missing = max(1, self.lanes - queued % self.lanes)
        wait = missing * ewma.value
        cap = cfg.wait_cap if default is None else min(cfg.wait_cap,
                                                       default)
        return min(max(wait, cfg.wait_floor), cap)

    def pressure(self, pipeline: str, default: int) -> int:
        """Tuned per-pool pressure threshold, or ``default`` until the
        pipeline's launch-cost stream has warmed up."""
        cfg = self.config
        ewma = self._lane_cost.get(pipeline)
        if ewma is None or ewma.count < cfg.calibration_warmup:
            return default
        overhead = (self.cost_model.launch_overhead
                    if self.cost_model is not None
                    else cfg.overhead_floor)
        lane_cost = max(ewma.value, 1e-12)
        want = cfg.pressure_gain * overhead / lane_cost
        return int(min(max(want, self.lanes),
                       cfg.pressure_cap_lanes * self.lanes))
