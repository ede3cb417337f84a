"""Common engine core of the solver serving stack.

Solver serving is, at this altitude: submitted work, a fixed pool of
``lanes`` the device executes in lockstep (one CUDA block per lane), and
a batch lifecycle of *take → pad to the pool → dispatch → scatter results
→ record metrics*.  :class:`EngineCore` owns the shared clock, lane-pool
accounting (a :class:`repro_torch.serve.metrics.Recorder`), the device
launches run on, and the group-dispatch lifecycle; :class:`FifoEngineCore`
adds the single-FIFO queue used by ``PipelineEngine`` (``SolverMux``
keeps per-pipeline shape buckets instead).

Padding is registry-driven: a lane group short of the pool size is
filled from the pipeline's declared ``KernelSpec.filler`` — a benign
per-lane problem (identity system, zero right-hand side) whose result
is discarded.  There is deliberately no shape-sniffing fallback here;
a spec that wants to be served padded must declare its filler.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.serve.metrics import MetricsSnapshot, Recorder


class ManualClock:
    """Deterministic clock for tests and trace replays: ``clock()``
    returns the current virtual time; ``advance()`` moves it."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t

    def __call__(self) -> float:
        return self.t


class EngineCore:
    """Lane-pool accounting + batch lifecycle, engine-agnostic.

    ``lanes`` is the lockstep pool width (grid lanes per launch).
    ``clock`` is any zero-arg callable returning seconds —
    ``time.monotonic`` by default, :class:`ManualClock` in tests/replays.
    ``device`` is where every launch runs: ``cuda`` (the hand-written
    kernels) unless the caller passes ``"cpu"`` (their plain PyTorch
    versions); with no GPU and no explicit CPU device construction
    raises.

    ``wall`` is the *measurement* clock (``time.perf_counter`` by
    default) used by :meth:`_timed_call` to stamp real launch wall-clock
    onto every :class:`~repro_torch.serve.metrics.LaunchRecord` —
    deliberately separate from the scheduling ``clock`` so virtual-clock
    replays still measure true execution cost.  Each measured launch is
    also fed to :meth:`observe_launch`, the hook engines override to
    close the cost-model calibration loop (the base hook is a no-op).
    """

    def __init__(self, lanes: int, clock=None, wall=None, device=None):
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        self.lanes = int(lanes)
        self.device = resolve_device(device)
        self.clock = clock if clock is not None else time.monotonic
        self.wall = wall if wall is not None else time.perf_counter
        self.recorder = Recorder()
        # optional repro_torch.serve.faults.FaultInjector: None (the
        # default) keeps every launch path identical to the uninjected
        # stack
        self.injector = None

    # ---------------- accounting ----------------

    def record_launch(self, pipeline: str, shape: tuple, real: int,
                      padded: int, variant: str = "base",
                      coalesced: int = 0, measured: float = None) -> None:
        self.recorder.record_launch(
            pipeline, shape, real, padded, self.clock(), variant,
            coalesced, math.nan if measured is None else measured)

    def record_job(self, pipeline: str, item) -> None:
        """Stamp ``finished_at`` and log the job's latency sample (keyed
        by the item's priority class when it declares one)."""
        item.finished_at = self.clock()
        self.recorder.record_job(pipeline, item.submitted_at,
                                 item.finished_at,
                                 getattr(item, "priority", "best_effort"))

    def metrics(self) -> MetricsSnapshot:
        return self.recorder.snapshot()

    def _timed_call(self, fn, padded: list,
                    fault_ctx: dict | None = None
                    ) -> tuple[np.ndarray, float]:
        """Execute one padded lane-group launch and measure its wall
        clock on ``self.wall``: numpy in (copied to ``self.device``),
        the launch, numpy out (copied back), with the device synchronised
        before the clock is read, so the measurement holds the copies and
        the kernel's execution, never just its enqueue.  The one seam
        every launch goes through: deterministic tests replace it with a
        synthetic wall model to drive the calibration loop without
        real-timer noise.

        ``fault_ctx`` identifies the attempt to an attached
        :class:`repro_torch.serve.faults.FaultInjector`
        (``self.injector``): a drawn ``raise`` fault aborts BEFORE the
        kernel executes (:class:`~repro_torch.serve.faults.
        InjectedLaunchError` — failed attempts cost no kernel time), a
        ``nan`` fault poisons the drawn output lanes, a ``stall`` fault
        inflates the measured wall-clock (never the scheduling clock).
        With no injector or no context the call is exactly the plain
        path."""
        fault = None
        if self.injector is not None and fault_ctx is not None:
            ctx = dict(fault_ctx)
            ctx["inputs"] = padded
            fault = self.injector.draw(ctx)
            if fault is not None and fault.kind == "raise":
                from repro_torch.serve.faults import InjectedLaunchError
                raise InjectedLaunchError(fault.reason)
        cuda = self.device.type == "cuda"
        t0 = self.wall()
        inputs = [torch.from_numpy(np.ascontiguousarray(p)).to(self.device)
                  for p in padded]
        res = fn(*inputs).cpu().numpy()
        if cuda:
            torch.cuda.synchronize(self.device)
        dt = self.wall() - t0
        if fault is not None:
            if fault.kind == "nan":
                res = np.array(res)            # writable copy
                for lane in fault.lanes:
                    if 0 <= lane < res.shape[0]:
                        res[lane] = np.nan
            elif fault.kind == "stall":
                dt += fault.stall
        return res, dt

    def observe_launch(self, spec, variant, key: tuple, lanes: int,
                       measured: float) -> None:
        """Per-launch feedback hook: called after every measured launch
        with the dispatched variant, the bucket key, the full padded
        lane width, and the measured wall-clock seconds.  The base engine
        does nothing; cost-model-carrying engines override it to feed
        :meth:`repro_torch.serve.cost.CostModel.observe`."""

    # ---------------- batch lifecycle ----------------

    def dispatch_group(self, spec, fn, key: tuple, jobs: list,
                       variant=None) -> list:
        """The one lane-group batch lifecycle of the single-pipeline
        engine: stack per-arg, pad to the pool from the (variant's or
        spec's) filler, launch ``fn`` once (measured — the wall-clock is
        stamped on the LaunchRecord and fed to :meth:`observe_launch`),
        scatter per-lane results back onto the jobs, and account the
        launch + per-job latencies.

        ``fn`` is the options-bound entry point the caller resolved
        through ``KernelSpec.dispatch_key`` for this shape bucket;
        ``variant`` is the matching registry Variant (None = the spec's
        base)."""
        stacked = [np.stack([np.asarray(j.args[i]) for j in jobs])
                   for i in range(len(jobs[0].args))]
        padded, pad = pad_group(spec, stacked, self.lanes, variant=variant)
        res, measured = self._timed_call(fn, padded)
        self.record_launch(spec.name, key, len(jobs), pad,
                           variant.name if variant is not None else "base",
                           measured=measured)
        self.observe_launch(spec, variant, key, len(jobs) + pad, measured)
        for i, job in enumerate(jobs):
            job.out = res[i]
            if hasattr(job, "state"):
                job.state = "done"
            self.record_job(spec.name, job)
        return jobs


class FifoEngineCore(EngineCore):
    """EngineCore plus the single-FIFO queue lifecycle: submitted items
    are stamped with ``submitted_at`` and popped oldest-first a lane
    pool at a time."""

    def __init__(self, lanes: int, clock=None, device=None):
        super().__init__(lanes, clock=clock, device=device)
        self._queue: list = []

    def submit(self, item):
        if getattr(item, "submitted_at", None) is None:
            item.submitted_at = self.clock()
        self._queue.append(item)
        return item

    def pending(self) -> int:
        return len(self._queue)

    def take(self, k: int | None = None) -> list:
        """Pop the oldest ``k`` (default: one lane pool) queued items."""
        k = self.lanes if k is None else k
        taken, self._queue = self._queue[:k], self._queue[k:]
        return taken

    def drain(self) -> list:
        return self.take(len(self._queue))


def pad_group(spec, stacked: list[np.ndarray], lanes: int, variant=None
              ) -> tuple[list[np.ndarray], int]:
    """Pad a stacked arg group's batch dim up to a multiple of ``lanes``
    using the spec's (or the dispatched variant's) declared benign filler.

    ``stacked`` holds one batched array per kernel argument.  Returns the
    padded arrays and the pad count.  Raises if padding is needed but no
    filler is declared — padding semantics are the kernel's to declare,
    not the engine's to guess.  A variant with its own calling convention
    (e.g. split-complex MMSE's 4 planes) declares its own filler;
    variants that only change the execution schedule inherit the spec's.
    """
    b = stacked[0].shape[0]
    pad = (-b) % lanes
    if pad == 0:
        return stacked, 0
    filler = spec.filler
    if variant is not None and variant.filler is not None:
        filler = variant.filler
    if filler is None:
        raise ValueError(
            f"pipeline {spec.name!r} declares no padding filler; cannot "
            f"pad a {b}-job group to the {lanes}-lane pool")
    lane = filler(tuple(a.shape[1:] for a in stacked),
                  tuple(a.dtype for a in stacked))
    if len(lane) != len(stacked):
        raise ValueError(
            f"{spec.name!r} filler returned {len(lane)} arrays for "
            f"{len(stacked)} kernel args")
    out = []
    for arr, fill in zip(stacked, lane):
        fill = np.asarray(fill, dtype=arr.dtype)
        if fill.shape != arr.shape[1:]:
            raise ValueError(
                f"{spec.name!r} filler shape {fill.shape} != per-lane "
                f"shape {arr.shape[1:]}")
        reps = np.broadcast_to(fill, (pad,) + fill.shape)
        out.append(np.concatenate([arr, reps], axis=0))
    return out, pad
