"""Seeded fault injection for the serving stack: :class:`FaultInjector`.

Production serving has to survive the launches that DON'T come back: a
``pallas_call`` that raises, a lane that returns NaN, a launch whose
wall-clock spikes, a device that silently stops answering.  The
supervision machinery that contains those failures (retry/bisect in
:class:`repro_torch.serve.mux.SolverMux`, shard quarantine in
:class:`repro_torch.serve.shard.LaneShards`, the variant demotion ladder in
:class:`repro_torch.serve.solver.VariantDispatcher`) is only trustworthy if it
can be exercised deterministically — which is what this module provides.

``FaultInjector`` sits on the one seam every launch already goes through
(:meth:`repro_torch.serve.core.EngineCore._timed_call`): before/after each
attempt it may

  * **raise** — the launch dies with :class:`InjectedLaunchError`
    *before* the kernel executes (so chaos replays stay fast);
  * **nan** — poison specific output lanes with NaN (a sick lane the
    supervisor must isolate without sinking its group);
  * **stall** — inflate the measured wall-clock (feeds the predicted-
    cost watchdog and the drift loop, never the scheduling clock);
  * **blackhole** — a specific shard fails every launch placed on it
    (and every mesh-spanning launch) for a clock-time window — the
    scenario quarantine + probe-based reinstatement is judged by.

Faults are drawn from a committed JSON **fault trace** plus a seed:
every attempt gets its own ``np.random.default_rng([seed, attempt])``
stream, so a replay of the same trace produces the identical fault
sequence — chaos runs are golden-file-pinnable exactly like the
overload traces.  With no trace configured (the default) the injector
is never constructed and every serving path is bit-identical to the
uninjected stack.

Fault-trace JSON schema (all fields optional)::

    {
      "seed": 7,                  // overrides the constructor seed
      "launch_fail_rate": 0.1,    // P(attempt raises)
      "nan_rate": 0.08,           // P(attempt returns a poisoned lane)
      "nan_lanes": 1,             // lanes poisoned per nan fault
      "stall_rate": 0.0,          // P(measured wall-clock spikes)
      "stall_s": 0.02,            // spike size (seconds)
      "raise_on_nonfinite_input": false,  // NaN input lane crashes the
                                          // kernel (bisect-isolation
                                          // scenario)
      "blackhole": [{"shard": 2, "from_t": 0.0, "until_t": 6.0}],
      "target": [{"pipeline": "cholesky_solve", "variant": "blocked",
                  "kind": "raise", "count": 4}]
    }

``target`` entries fire deterministically on the first ``count``
attempts matching (pipeline, variant) — the lever that forces a variant
demotion; rate-based faults redraw per attempt, so retries can succeed.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.serve.config import global_config


class InjectedLaunchError(RuntimeError):
    """A launch failure manufactured by :class:`FaultInjector` — raised
    at the ``_timed_call`` seam before the kernel executes, so the
    supervisor sees exactly what a real raising ``pallas_call`` looks
    like without paying for one."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One drawn fault: ``kind`` in {"raise", "nan", "stall"}; ``reason``
    is the structured failure reason surfaced in retry/fail events;
    ``lanes`` the output lanes a nan fault poisons; ``stall`` the
    seconds a stall fault adds to the measured wall-clock."""

    kind: str
    reason: str
    lanes: tuple[int, ...] = ()
    stall: float = 0.0


class FaultInjector:
    """Deterministic, seed-keyed launch-fault source (module docstring).

    ``trace`` is the parsed fault-trace dict (see the schema above);
    ``seed`` keys the per-attempt rng streams (a ``seed`` in the trace
    wins).  ``enabled=False`` makes :meth:`draw` always return None —
    the injector can be threaded everywhere and switched off without
    touching behavior.
    """

    def __init__(self, trace: dict | None = None, seed: int = 0,
                 enabled: bool = True):
        trace = dict(trace or {})
        self.seed = int(trace.get("seed", seed))
        self.enabled = bool(enabled)
        self.launch_fail_rate = float(trace.get("launch_fail_rate", 0.0))
        self.nan_rate = float(trace.get("nan_rate", 0.0))
        self.nan_lanes = max(1, int(trace.get("nan_lanes", 1)))
        self.stall_rate = float(trace.get("stall_rate", 0.0))
        self.stall_s = float(trace.get("stall_s", 0.0))
        self.raise_on_nonfinite_input = bool(
            trace.get("raise_on_nonfinite_input", False))
        self.blackhole = [dict(b) for b in trace.get("blackhole", ())]
        # mutable remaining-count copies: the injector owns its trace
        self.target = [dict(t) for t in trace.get("target", ())]
        self.attempt = 0            # global attempt counter (rng key)

    # ---------------- construction ----------------

    @classmethod
    def from_json(cls, path: str, seed: int = 0) -> "FaultInjector":
        with open(path) as f:
            return cls(json.load(f), seed=seed)

    @classmethod
    def from_config(cls, config=None) -> "FaultInjector | None":
        """The env-driven default: an injector loaded from
        ``REPRO_SERVE_FAULT_TRACE`` (seeded by
        ``REPRO_SERVE_FAULT_SEED``), or None when no trace is configured
        — the golden-trace-deterministic default."""
        config = config if config is not None else global_config
        path = getattr(config, "fault_trace", "")
        if not path:
            return None
        return cls.from_json(path, seed=getattr(config, "fault_seed", 0))

    # ---------------- the draw ----------------

    def _blackholed(self, ctx: dict) -> bool:
        """True when the attempt touches a blackholed shard inside its
        outage window: a placed launch on that shard, or any mesh-
        spanning launch (which occupies every shard)."""
        t = float(ctx.get("t", 0.0))
        shard = ctx.get("shard")
        mesh = int(ctx.get("mesh", 1))
        for b in self.blackhole:
            if not (float(b.get("from_t", 0.0)) <= t
                    < float(b.get("until_t", np.inf))):
                continue
            if mesh > 1 or (shard is not None
                            and int(b["shard"]) == int(shard)):
                return True
        return False

    def _targeted(self, ctx: dict) -> dict | None:
        for entry in self.target:
            if entry.get("count", 0) <= 0:
                continue
            if entry.get("pipeline") not in (None, ctx.get("pipeline")):
                continue
            if entry.get("variant") not in (None, ctx.get("variant")):
                continue
            entry["count"] -= 1
            return entry
        return None

    def draw(self, ctx: dict) -> Fault | None:
        """Draw the fault (or None) for one launch attempt.  ``ctx``
        carries the attempt's identity: ``pipeline``, ``variant``,
        ``width`` (padded lane count), ``mesh``, ``shard`` (placed shard
        or None), ``t`` (scheduling-clock time), and optionally
        ``inputs`` (the padded arrays, for the nonfinite-input trigger).

        Every call consumes one attempt index whether or not a fault
        fires, so the rate-based stream is a fixed function of (seed,
        attempt order) — replays are bit-identical."""
        if not self.enabled:
            return None
        idx = self.attempt
        self.attempt += 1
        if self._blackholed(ctx):
            return Fault("raise", reason="blackhole")
        if self.raise_on_nonfinite_input:
            inputs = ctx.get("inputs") or ()
            if any(not np.all(np.isfinite(np.asarray(a)))
                   for a in inputs):
                return Fault("raise", reason="nonfinite_input_crash")
        hit = self._targeted(ctx)
        if hit is not None:
            kind = hit.get("kind", "raise")
            if kind == "nan":
                lane = int(hit.get("lane", 0))
                return Fault("nan", reason="targeted_nan", lanes=(lane,))
            if kind == "stall":
                return Fault("stall", reason="targeted_stall",
                             stall=float(hit.get("stall_s",
                                                 self.stall_s)))
            return Fault("raise", reason="targeted_fault")
        if not (self.launch_fail_rate or self.nan_rate
                or self.stall_rate):
            return None
        rng = np.random.default_rng([self.seed, idx])
        u = float(rng.random())
        if u < self.launch_fail_rate:
            return Fault("raise", reason="injected_fault")
        u -= self.launch_fail_rate
        if u < self.nan_rate:
            width = max(1, int(ctx.get("width", 1)))
            k = min(self.nan_lanes, width)
            lanes = tuple(int(x) for x in
                          rng.choice(width, size=k, replace=False))
            return Fault("nan", reason="injected_nan", lanes=lanes)
        u -= self.nan_rate
        if u < self.stall_rate:
            return Fault("stall", reason="injected_stall",
                         stall=self.stall_s)
        return None
