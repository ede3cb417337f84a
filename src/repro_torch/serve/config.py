"""Env-tunable serving configuration: one ``ServeConfig`` instance,
every calibration/tuning knob behind an environment variable.

The self-tuning cost model (:mod:`repro_torch.serve.cost`) and the adaptive
flush-threshold tuner (:mod:`repro_torch.serve.tuning`) both read their knobs
from the module-level :data:`global_config` — the alpa ``global_env.py``
pattern — so a deployment can pin or free every part of the calibration
loop without code edits::

    REPRO_SERVE_CALIBRATE=1 python -m repro_torch.launch.serve_solvers --policy

Knob reference (name / env var / default / effect) — the same table is
kept in ROADMAP.md's serving notes:

========================  =================================  ========
attribute                 env var                            default
========================  =================================  ========
calibrate                 REPRO_SERVE_CALIBRATE              0 (off)
calibration_alpha         REPRO_SERVE_CALIBRATION_ALPHA      0.35
calibration_window        REPRO_SERVE_CALIBRATION_WINDOW     5
calibration_warmup        REPRO_SERVE_CALIBRATION_WARMUP     3
rate_floor                REPRO_SERVE_RATE_FLOOR             1e-15
overhead_floor            REPRO_SERVE_OVERHEAD_FLOOR         1e-9
drift_alert_ratio         REPRO_SERVE_DRIFT_ALERT_RATIO      1.5
bench_json                REPRO_SERVE_BENCH_JSON             BENCH_pipelines.json
adapt_thresholds          REPRO_SERVE_ADAPT_THRESHOLDS       0 (off)
interarrival_alpha        REPRO_SERVE_INTERARRIVAL_ALPHA     0.3
wait_floor                REPRO_SERVE_WAIT_FLOOR             0.0
wait_cap                  REPRO_SERVE_WAIT_CAP               5e-3
pressure_gain             REPRO_SERVE_PRESSURE_GAIN          8.0
pressure_cap_lanes        REPRO_SERVE_PRESSURE_CAP_LANES     8
mesh_size                 REPRO_SERVE_MESH_SIZE              1
shard_split_pressure      REPRO_SERVE_SHARD_SPLIT_PRESSURE   2.0
steal_ratio               REPRO_SERVE_STEAL_RATIO            1.0
imbalance_alert           REPRO_SERVE_IMBALANCE_ALERT        1.5
fault_trace               REPRO_SERVE_FAULT_TRACE            "" (off)
fault_seed                REPRO_SERVE_FAULT_SEED             0
max_retries               REPRO_SERVE_MAX_RETRIES            2
retry_backoff             REPRO_SERVE_RETRY_BACKOFF          1e-4
quarantine_after          REPRO_SERVE_QUARANTINE_AFTER       3
probe_after               REPRO_SERVE_PROBE_AFTER            3.0
demote_after              REPRO_SERVE_DEMOTE_AFTER           2
watchdog_ratio            REPRO_SERVE_WATCHDOG_RATIO         0.0 (off)
event_cap                 REPRO_SERVE_EVENT_CAP              100000
decode_slots              REPRO_SERVE_DECODE_SLOTS           4
decode_max_len            REPRO_SERVE_DECODE_MAX_LEN         128
decode_steps_per_poll     REPRO_SERVE_DECODE_STEPS_PER_POLL  8
========================  =================================  ========

* ``calibrate`` — master switch for ONLINE re-fitting: with it off, a
  ``CostModel`` built without an explicit ``adaptive=True`` stays
  frozen at its seeded/bench-calibrated rates (predictions are still
  compared against measurements and drift is still tracked whenever a
  model IS adaptive).  Off by default so replayable tests and committed
  golden traces price deterministically.
* ``calibration_alpha`` — EWMA weight of each new window-median; higher
  adapts faster, lower smooths more.
* ``calibration_window`` — samples per robust window; the estimator
  updates on the MEDIAN of each full window, so up to
  ``(window - 1) // 2`` outlier flushes per window cannot move it.
* ``calibration_warmup`` — window-median updates required before an
  online estimate replaces the seeded value (one weird first flush
  cannot repoint admission control).
* ``rate_floor`` / ``overhead_floor`` — positivity clamps (sec/FLOP,
  seconds): no measurement stream, however adversarial, can drive an
  estimate to zero or below.
* ``drift_alert_ratio`` — |log ratio| threshold above which a
  (pipeline, variant) pair is flagged ``alert`` in drift reports.
* ``bench_json`` — default path ``CostModel.from_bench_json`` reads.
* ``adapt_thresholds`` — master switch for the per-bucket flush tuner
  (``max_wait`` from observed inter-arrival, pool pressure from
  observed launch cost).  Off by default for the same determinism
  reason as ``calibrate``.
* ``interarrival_alpha`` — EWMA weight for per-bucket inter-arrival
  estimates.
* ``wait_floor`` / ``wait_cap`` — clamp (seconds) on the tuned
  per-bucket ``max_wait``.
* ``pressure_gain`` — tuned pressure aims to amortize the launch
  overhead ``pressure_gain`` times over a drain's lane time.
* ``pressure_cap_lanes`` — tuned pressure never exceeds this many
  multiples of the pool width (and never drops below one pool width).
* ``mesh_size`` — default lane-shard count for :class:`SolverMux`
  instances built without an explicit ``mesh_size``: 1 keeps the
  single-device path (bit-identical to the pre-mesh stack); N > 1
  spans each pool's lane axis over the first N local devices via
  ``distributed.sharding.shard_map`` (aggregate capacity
  ``lanes * mesh_size``).
* ``shard_split_pressure`` — a shape bucket whose backlog reaches
  ``shard_split_pressure * lanes`` jobs is *hot*: the mux offers it as
  mesh-spanning sharded flushes (cross-shard work stealing) instead of
  serial per-shard launches, subject to the cost comparison below.
* ``steal_ratio`` — safety margin on the steal pricing: a hot bucket
  splits across shards only when ``sharded_cost * steal_ratio <
  local_cost`` (the serial per-shard launches it replaces), so stealing
  never beats a cheaper local partial.  1.0 = pure cost comparison;
  > 1.0 biases toward local launches.
* ``imbalance_alert`` — per-shard lane-load imbalance ratio
  (max/mean dispatched lanes) above which ``MetricsSnapshot`` flags
  ``shard_imbalance_alert``.
* ``fault_trace`` — path to a JSON fault trace for
  :class:`repro_torch.serve.faults.FaultInjector`; empty (the default) means
  no injector is built and every serving path is bit-identical to the
  fault-free stack (golden traces stay pinned).
* ``fault_seed`` — seed keying the injector's per-attempt rng streams
  (a ``seed`` field inside the trace file wins).
* ``max_retries`` — supervised relaunch attempts per failed group
  beyond the first try.  Hard-deadline jobs are ALWAYS retried to this
  bound; a best-effort group whose retries exhaust is failed with a
  structured reason rather than silently dropped.
* ``retry_backoff`` — base of the bounded exponential backoff charged
  (in seconds of launch budget) against the failing group's shard for
  each retry: retry k debits ``retry_backoff * 2**k``.  The debit
  starves the admission budget, not the wall-clock — replays stay
  deterministic.
* ``quarantine_after`` — consecutive launch failures on one shard
  before :class:`LaneShards` quarantines it (placement stops, capacity
  shrinks, the CostModel re-prices spanning launches at the reduced
  mesh).
* ``probe_after`` — scheduling-clock seconds a quarantined shard sits
  out before the mux routes a single probe launch at it; a surviving
  probe reinstates the shard, a failing one re-arms the timer.
* ``demote_after`` — consecutive supervised-launch failures of one
  (pipeline, variant, shape-bucket) before ``VariantDispatcher``
  demotes that bucket down the ladder (tiled → blocked → base) with a
  ``demote`` event and a drift-style alert.  Only variants that share
  the spec's calling convention (``variant.filler is None``) demote.
* ``watchdog_ratio`` — a launch whose measured wall exceeds
  ``watchdog_ratio x`` the CostModel's prediction emits a ``watchdog``
  event and counts against shard health.  0 (the default) disables the
  watchdog: it compares real wall-clock against predictions, which is
  machine-dependent — leaving it off keeps golden traces bit-exact.
* ``event_cap`` — ring-buffer bound on ``mux.events``; once the cap is
  hit the oldest events are dropped (``drain_events()`` reports how
  many) so a long-running serve loop cannot leak memory through its
  event log.
* ``decode_slots`` — default continuous-batching slot count (the pool
  width) for :class:`repro_torch.serve.decode.DecodeEngine` instances built
  by the trace-replay / benchmark entry points.
* ``decode_max_len`` — default per-slot KV-cache length (tokens) for
  the same entry points; a request's ``max_new`` is clamped so prompt
  plus output always fits its slot's pages.
* ``decode_steps_per_poll`` — how many continuous-batching decode
  steps one ``SolverMux.poll()`` runs at most once a decode engine is
  attached: the fairness lever between token traffic and solver
  flushes on the shared front-end (``run()`` drains are unbounded).
"""
from __future__ import annotations

import os


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    return default if raw is None else float(raw)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return default if raw is None else int(raw)


class ServeConfig:
    """All serving-stack tuning knobs (see the module docstring for the
    per-knob reference).  Construction reads the environment once;
    :meth:`reload` re-reads it (tests use this around ``monkeypatch``).
    """

    def __init__(self):
        self.reload()

    def reload(self) -> "ServeConfig":
        # ---- online cost-model calibration ----
        self.calibrate = _env_bool("REPRO_SERVE_CALIBRATE", False)
        self.calibration_alpha = _env_float(
            "REPRO_SERVE_CALIBRATION_ALPHA", 0.35)
        self.calibration_window = _env_int(
            "REPRO_SERVE_CALIBRATION_WINDOW", 5)
        self.calibration_warmup = _env_int(
            "REPRO_SERVE_CALIBRATION_WARMUP", 3)
        self.rate_floor = _env_float("REPRO_SERVE_RATE_FLOOR", 1e-15)
        self.overhead_floor = _env_float(
            "REPRO_SERVE_OVERHEAD_FLOOR", 1e-9)
        self.drift_alert_ratio = _env_float(
            "REPRO_SERVE_DRIFT_ALERT_RATIO", 1.5)
        self.bench_json = os.environ.get(
            "REPRO_SERVE_BENCH_JSON", "BENCH_pipelines.json")
        # ---- adaptive flush thresholds ----
        self.adapt_thresholds = _env_bool(
            "REPRO_SERVE_ADAPT_THRESHOLDS", False)
        self.interarrival_alpha = _env_float(
            "REPRO_SERVE_INTERARRIVAL_ALPHA", 0.3)
        self.wait_floor = _env_float("REPRO_SERVE_WAIT_FLOOR", 0.0)
        self.wait_cap = _env_float("REPRO_SERVE_WAIT_CAP", 5e-3)
        self.pressure_gain = _env_float("REPRO_SERVE_PRESSURE_GAIN", 8.0)
        self.pressure_cap_lanes = _env_int(
            "REPRO_SERVE_PRESSURE_CAP_LANES", 8)
        # ---- mesh-sharded lane pools ----
        self.mesh_size = _env_int("REPRO_SERVE_MESH_SIZE", 1)
        self.shard_split_pressure = _env_float(
            "REPRO_SERVE_SHARD_SPLIT_PRESSURE", 2.0)
        self.steal_ratio = _env_float("REPRO_SERVE_STEAL_RATIO", 1.0)
        self.imbalance_alert = _env_float(
            "REPRO_SERVE_IMBALANCE_ALERT", 1.5)
        # ---- fault injection + launch supervision ----
        self.fault_trace = os.environ.get("REPRO_SERVE_FAULT_TRACE", "")
        self.fault_seed = _env_int("REPRO_SERVE_FAULT_SEED", 0)
        self.max_retries = _env_int("REPRO_SERVE_MAX_RETRIES", 2)
        self.retry_backoff = _env_float(
            "REPRO_SERVE_RETRY_BACKOFF", 1e-4)
        self.quarantine_after = _env_int(
            "REPRO_SERVE_QUARANTINE_AFTER", 3)
        self.probe_after = _env_float("REPRO_SERVE_PROBE_AFTER", 3.0)
        self.demote_after = _env_int("REPRO_SERVE_DEMOTE_AFTER", 2)
        self.watchdog_ratio = _env_float(
            "REPRO_SERVE_WATCHDOG_RATIO", 0.0)
        self.event_cap = _env_int("REPRO_SERVE_EVENT_CAP", 100000)
        # ---- continuous-batching decode ----
        self.decode_slots = _env_int("REPRO_SERVE_DECODE_SLOTS", 4)
        self.decode_max_len = _env_int("REPRO_SERVE_DECODE_MAX_LEN", 128)
        self.decode_steps_per_poll = _env_int(
            "REPRO_SERVE_DECODE_STEPS_PER_POLL", 8)
        return self


global_config = ServeConfig()
