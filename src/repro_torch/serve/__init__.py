"""Serving stack of the port (one concern per module, all sharing the
``EngineCore`` lane-pool accounting + batch lifecycle):

  core     EngineCore (+ FifoEngineCore), ManualClock, registry-driven
           pad_group; the device launches run on
  decode   DecodeEngine / Request       (LM continuous batching:
                                         per-slot positions, paged KV
                                         slot reuse, per-slot sampling;
                                         attaches to SolverMux)
  solver   PipelineEngine / SolveJob / VariantDispatcher
  mux      SolverMux / OverloadPolicy   (mixed pipelines, shape-bucketed
                                         continuous batching, deadline-
                                         aware flush; admission control,
                                         preemption, coalescing, launch
                                         supervision)
  cost     CostModel / DriftStat        (launch pricing, offline
                                         calibration from
                                         BENCH_pipelines.json + online
                                         re-fit, drift observability)
  config   ServeConfig / global_config  (REPRO_SERVE_* env-tunable knobs)
  tuning   BucketTuner                  (observed-traffic flush
                                         thresholds)
  metrics  SLO dataclasses: p50/p99 latency, throughput, lane
           utilization, padded-lane waste, dropped/preempted/coalesced
           counters
  faults   FaultInjector                (seeded fault injection driving
                                         the supervision paths)

The kernel registry (``repro_torch.kernels``) is the routing table: any
``kind="pipeline"`` spec is servable, and its declared ``filler``
supplies benign padding lanes.
"""
from repro_torch.serve.config import ServeConfig, global_config  # noqa: F401
from repro_torch.serve.core import (EngineCore, FifoEngineCore,  # noqa: F401
                                    ManualClock, pad_group)
from repro_torch.serve.cost import (CostModel, DriftStat,  # noqa: F401
                                    RobustEstimator)
from repro_torch.serve.faults import (Fault, FaultInjector,  # noqa: F401
                                      InjectedLaunchError)
from repro_torch.serve.metrics import (DagStats, DecodeStats,  # noqa: F401
                                       DropRecord, FailRecord,
                                       FaultStats, LatencyStats,
                                       LaunchRecord, MetricsSnapshot,
                                       PipelineStats, Recorder)
from repro_torch.serve.mux import DagJob, OverloadPolicy, SolverMux  # noqa: F401
from repro_torch.serve.solver import (PipelineEngine,  # noqa: F401
                                      SolveJob, VariantDispatcher)
from repro_torch.serve.tuning import BucketTuner  # noqa: F401


def __getattr__(name):
    # decode pulls in the model stack; load it lazily (PEP 562) so
    # solver-only consumers do not pay for it
    if name in ("DecodeEngine", "Request"):
        from repro_torch.serve import decode
        return getattr(decode, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "EngineCore", "FifoEngineCore", "ManualClock", "pad_group",
    "DecodeEngine", "Request",
    "PipelineEngine", "SolveJob", "SolverMux", "VariantDispatcher",
    "DagJob", "DagStats", "DecodeStats",
    "OverloadPolicy", "CostModel", "DriftStat", "RobustEstimator",
    "ServeConfig", "global_config", "BucketTuner",
    "DropRecord", "FailRecord", "FaultStats", "LatencyStats",
    "LaunchRecord", "MetricsSnapshot", "PipelineStats", "Recorder",
    "Fault", "FaultInjector", "InjectedLaunchError",
]
