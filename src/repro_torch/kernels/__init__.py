"""The kernel registry — the single enumeration point for tests,
benchmarks and serving — for the served solver pipelines, the served
pipeline DAGs, the kernels they run and the primitive kernels of
``ops`` (``kind="kernel"``).

Every pipeline registers a ``KernelSpec`` binding together its kernel
entry point (``repro_torch.pipelines.*_fused``: the hand-written CUDA
kernel on a CUDA tensor, its plain PyTorch version on a CPU tensor), its
oracle (``repro_torch.kernels.ref``), its characteristic stream
descriptor (``repro_torch.core.streams`` — the paper's F2-F4
classification), a deterministic case generator, its benign padding
filler, its cross-shape coalescer and its model-FLOP count, so consumers
iterate ``specs()`` instead of hand-importing each pipeline:

    for spec in repro_torch.kernels.specs():
        args = spec.make_case(rng, n)
        assert close(spec.kernel(*args), spec.run_oracle(*args))

Pipeline DAGs (:class:`DagSpec`, :func:`register_dag`) chain registered
pipelines as named stages; ``SolverMux.submit_dag`` serves them.  Token
decode (:class:`DecodeSpec`, :func:`register_decode`) describes the LM
traffic ``SolverMux.attach_decode`` serves.  The package also re-exports
the primitive API of :mod:`repro_torch.kernels.ops` (``cholesky``,
``gemm``, ``flash_attention``, ...), as the reference's does, so
``repro_torch.kernels.cholesky`` is the function; import a kernel's
module by its full name (``from repro_torch.kernels.cholesky import
cholesky_fused``).

Names, sizes, tolerances, variant order, ``when`` predicates, flops
models and DAG declarations are the reference's
(``repro/kernels/__init__.py``), so dispatch, pricing and criticality
agree with it on every shape.  The ``blocked`` variants (n >= 128,
n % 32 == 0) run the port's K10 and K11, the HBM-scale ``tiled``
variants (n >= 512, listed before ``blocked``) its K12-K14.

The registry is built lazily on first access: ``repro_torch.pipelines``
imports ``repro_torch.kernels.common``, so eager registration here would
be circular.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels.ops import (  # noqa: F401
    cholesky,
    trisolve,
    qr,
    svd,
    gemm,
    fir,
    fft,
    flash_attention,
    ssm_scan,
)

__all__ = ["cholesky", "trisolve", "qr", "svd", "gemm", "fir", "fft",
           "flash_attention", "ssm_scan", "KernelSpec", "Variant",
           "Coalescer",
           "register", "get", "names", "specs", "StageSpec", "DagSpec",
           "register_dag", "get_dag", "dag_names", "dag_specs",
           "DecodeSpec", "register_decode", "get_decode", "decode_names"]


@dataclasses.dataclass(frozen=True)
class Coalescer:
    """Cross-shape ragged-batching adapter for a served pipeline.

    Under overload the mux may pad a *small* job into a *larger*
    compatible bucket's free lanes instead of benign filler — one fewer
    grid launch at the price of padded-lane FLOPs.  The spec declares
    how (the engine never guesses):

    ``compatible(small_key, big_key)`` — both are SolveJob shape keys
    (per-arg ``(shape, dtype_str)`` tuples); True iff a small job can be
    embedded into a big-bucket lane AND the embedding is exact (the
    small solution is recoverable from the big one).
    ``embed(args, big_shapes)`` — per-lane small arrays -> per-lane
    arrays at the big bucket's shapes.
    ``extract(out_lane, small_shapes)`` — slice the small job's answer
    back out of the big lane's result.
    """

    compatible: Callable
    embed: Callable
    extract: Callable


@dataclasses.dataclass(frozen=True)
class Variant:
    """One performance variant of a registered pipeline.

    ``fn`` is a batched entry point with the same calling convention as
    the spec's ``kernel`` (serving binds per-pipeline options into it);
    ``when(shapes, dtypes)`` — per-lane (unbatched) arg shapes and numpy
    dtypes — is the applicability predicate the dispatcher evaluates in
    registration order (first match wins, ``base`` otherwise).

    A variant that changes the calling convention (e.g. split-complex
    MMSE takes 4 planes instead of one expanded matrix) carries its own
    ``oracle`` (batched run_oracle-style adapter), ``filler`` (benign
    padding lane), and ``make_case``; ``None`` inherits the spec's.
    ``sizes`` is the variant's default bench/test sweep and ``flops`` an
    optional closed-form model-FLOP count over per-lane shapes.

    ``fits(shapes)``, where given, says whether the variant's CUDA
    kernel can launch at these per-lane shapes (its shared memory within
    the card's limit).  A dispatcher serving on a CUDA device passes
    over a variant that does not fit; the plain versions on the CPU take
    every shape, so there it is never asked.
    """

    name: str
    fn: Callable
    when: Callable
    oracle: Callable | None = None
    filler: Callable | None = None
    make_case: Callable | None = None
    sizes: tuple[int, ...] = ()
    flops: Callable | None = None
    fits: Callable | None = None

    def model_flops(self, shapes) -> float:
        """Closed-form model FLOPs for ONE lane at per-lane arg shapes —
        the launch-cost model's workload term.  Falls back to the first
        arg's element count when the variant declares no flops model, so
        a cost is always orderable (bigger problems price higher)."""
        shapes = tuple(tuple(s) for s in shapes)
        if self.flops is not None:
            return float(self.flops(shapes))
        if shapes and shapes[0]:
            return float(np.prod(shapes[0]))
        return 1.0


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One registered pipeline.

    ``kernel`` is the batched entry point (tensors in, tensor out) and
    ``run_oracle`` its signature-aligned oracle adapter — both accept the
    tensors produced by ``make_case(rng, n)`` and return comparable
    tensors.  ``stream``
    maps a problem size to the kernel's characteristic StreamDescriptor
    (paper F2-F4); ``sizes`` is the default sweep for registry-driven
    tests/benchmarks.

    ``filler`` is the spec's benign-padding descriptor for lane-pooled
    serving: ``filler(shapes, dtypes)`` — per-lane (unbatched) arg shapes
    and dtypes — returns one well-conditioned problem (e.g. identity
    system, zero rhs) whose result padded lanes can safely discard.  The
    serving engines pad exclusively from this declaration.

    ``variants`` is the spec's performance-variant table; consumers that
    execute a spec go through :meth:`dispatch_key` so large or
    split-complex jobs land on the right entry point.

    ``coalesce`` is the spec's optional :class:`Coalescer` — the
    declared cross-shape embedding that lets the serving mux ragged-
    batch a small job into a larger bucket's free lanes under overload.

    ``run_kernel`` is an optional conformance adapter around ``kernel``
    whose output compares with ``run_oracle`` (``None``: ``kernel``
    itself) — the SVD specs compare the sorted spectrum and the
    reconstruction, since their factors are sign/order ambiguous.
    ``kind`` is ``"pipeline"`` for a servable spec, ``"kernel"`` for a
    kernel the serving stack reaches only through a pipeline.
    """

    name: str
    kernel: Callable
    run_oracle: Callable
    make_case: Callable
    stream: Callable
    sizes: tuple[int, ...]
    rtol: float = 1e-4
    kind: str = "pipeline"
    filler: Callable | None = None
    variants: tuple[Variant, ...] = ()
    flops: Callable | None = None
    coalesce: Coalescer | None = None
    run_kernel: Callable | None = None
    serve_oracle: Callable | None = None
    """Optional serving-side ground truth overriding ``run_oracle`` for
    per-job spot checks (:meth:`run_oracle_lane`): needed when the
    served output is not what the conformance faces compare — e.g.
    ``svd_factor`` serves sign/order-ambiguous packed factors, so its
    serving oracle is a standalone run of the kernel itself
    (bit-identity) while ``run_kernel``/``run_oracle`` check the sorted
    spectrum + reconstruction."""

    @property
    def base(self) -> Variant:
        """The spec's own entry point as the fallback Variant."""
        oracle = self.serve_oracle if self.serve_oracle is not None \
            else self.run_oracle
        return Variant(name="base", fn=self.kernel, when=lambda s, d: True,
                       oracle=oracle, filler=self.filler,
                       make_case=self.make_case, sizes=self.sizes,
                       flops=self.flops)

    def dispatch_key(self, shapes, dtypes) -> Variant:
        """Pick the variant for per-lane (unbatched) arg shapes/dtypes —
        the serving engines' entry (a shape bucket IS such a key)."""
        dtypes = tuple(np.dtype(d) for d in dtypes)
        shapes = tuple(tuple(s) for s in shapes)
        for v in self.variants:
            if v.when(shapes, dtypes):
                return v
        return self.base

    def model_flops(self, shapes, dtypes) -> float:
        """Model FLOPs of one lane at per-lane shapes under whichever
        variant :meth:`dispatch_key` would route it to — the registry
        side of the serving cost model."""
        return self.dispatch_key(shapes, dtypes).model_flops(shapes)

    def run_oracle_lane(self, *args) -> np.ndarray:
        """Oracle answer for ONE unbatched problem (numpy in, numpy out):
        adds the batch dim, runs the dispatched variant's oracle adapter
        on the CPU (so split-complex jobs check against the right ground
        truth), strips it again — the serving stack's per-job spot
        check."""
        arrays = [np.asarray(a) for a in args]
        variant = self.dispatch_key(tuple(a.shape for a in arrays),
                                    tuple(a.dtype for a in arrays))
        oracle = variant.oracle if variant.oracle is not None \
            else self.run_oracle
        batched = [torch.from_numpy(np.ascontiguousarray(a))[None]
                   for a in arrays]
        return oracle(*batched)[0].numpy()


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One named stage of a pipeline DAG.

    ``pipeline`` names the registered ``kind="pipeline"`` KernelSpec that
    serves the stage — the stage's entry point, variants, filler,
    coalescer, and cost model are all the pipeline's own, so a DAG stage
    rides every serving mechanism (padding, coalescing, fault
    supervision) a plain job does.  ``bind(args, outs)`` maps the DAG
    job's per-lane input args plus the completed producer outputs (by
    stage name) to this stage's per-lane args — the declared dataflow.
    ``consumes`` lists producer stage names; the DagSpec's ``deps``
    (:class:`repro_torch.core.dependence.OrderedDep`) must carry exactly
    these edges.  ``stream`` maps the DAG's problem size to the
    StreamDescriptor of the stage's output handoff buffer (how results
    travel between launches when the stage is NOT fused with its
    consumer).  ``flops(shapes)`` — per-lane DAG input arg shapes — is
    the stage's model-FLOP weight for criticality planning, and
    ``transcendental`` marks stages dominated by special functions
    rather than bulk multiply-adds (excluded from threshold criticality
    by :func:`repro_torch.core.criticality.plan_split`).  ``oracle``
    optionally overrides the stage pipeline's ``run_oracle_lane`` for
    per-stage ground truth (stages with ambiguous outputs, e.g. SVD
    factors, leave it None and are checked by bit-identity against a
    standalone run instead)."""

    name: str
    pipeline: str
    bind: Callable
    consumes: tuple[str, ...] = ()
    stream: Callable | None = None
    oracle: Callable | None = None
    flops: Callable | None = None
    transcendental: bool = False

    def model_flops(self, shapes) -> float:
        if self.flops is None:
            return 1.0
        return float(self.flops(tuple(tuple(s) for s in shapes)))


@dataclasses.dataclass(frozen=True)
class DagSpec:
    """A served pipeline DAG: named stages + ordered producer->consumer
    edges, the registry's extension of KernelSpec from one entry point
    to a stage graph (``SolverMux.submit_dag`` executes it).

    ``stages`` is the stage-independent decomposition (one launch per
    stage, handoff through stage output buffers); ``chained`` is the
    optional lane-resident alternative where adjacent stages are fused
    into one kernel (shared-memory handoff), reducing DAG depth.  Both
    lists are topologically ordered by declaration; a stage may only
    consume earlier stages.  ``deps`` declares the staged edges as
    :class:`OrderedDep` s and must match the stages' ``consumes``
    exactly (chained edges are derived from ``chained[i].consumes``).
    The DAG's terminal output is the LAST stage's output.

    ``make_case(rng, n)`` builds one PER-LANE (unbatched) set of DAG
    input args — the ``submit_dag`` calling convention — and ``oracle``
    maps those args to the terminal output (ground truth for end-to-end
    checks, compared at ``rtol``).

    ``crit_threshold`` is the criticality knob: :meth:`criticality`
    weighs every stage's ``flops`` model and hands the shares to
    :func:`repro_torch.core.criticality.plan_split` at this threshold —
    stages planned critical are admitted ahead of slack stages at equal
    deadline by the mux."""

    name: str
    stages: tuple[StageSpec, ...]
    deps: tuple
    make_case: Callable
    oracle: Callable
    chained: tuple[StageSpec, ...] = ()
    crit_threshold: float = 0.25
    rtol: float = 1e-4

    def __post_init__(self):
        for stages, label in ((self.stages, "stages"),
                              (self.chained, "chained")):
            seen: set[str] = set()
            for s in stages:
                if s.name in seen:
                    raise ValueError(
                        f"dag {self.name!r}: duplicate {label} stage "
                        f"{s.name!r}")
                missing = [c for c in s.consumes if c not in seen]
                if missing:
                    raise ValueError(
                        f"dag {self.name!r}: stage {s.name!r} consumes "
                        f"{missing} before they are produced")
                seen.add(s.name)
        if not self.stages:
            raise ValueError(f"dag {self.name!r}: no stages")
        declared = {(d.producer, d.consumer) for d in self.deps}
        consumed = {(c, s.name) for s in self.stages for c in s.consumes}
        if declared != consumed:
            raise ValueError(
                f"dag {self.name!r}: OrderedDep edges {sorted(declared)} "
                f"do not match stage consumes {sorted(consumed)}")

    def stage_list(self, chained: bool = False) -> tuple[StageSpec, ...]:
        if chained:
            if not self.chained:
                raise ValueError(
                    f"dag {self.name!r} declares no chained stage list")
            return self.chained
        return self.stages

    def criticality(self, shapes, chained: bool = False):
        """(critical, slack) stage-name lists from the per-stage model-
        FLOP shares via ``plan_split`` at ``crit_threshold``."""
        from repro_torch.core.criticality import RegionCost, plan_split
        costs = [RegionCost(s.name, max(s.model_flops(shapes), 1.0),
                            has_transcendental=s.transcendental)
                 for s in self.stage_list(chained)]
        return plan_split(costs, threshold=self.crit_threshold)

    def region_graph(self, shapes, chained: bool = False):
        """The DAG as a validated :class:`RegionGraph`, critical flags
        planned from the model-FLOP shares at these input shapes."""
        from repro_torch.core.dependence import (OrderedDep, Region,
                                                 RegionGraph)
        stages = self.stage_list(chained)
        crit, _ = self.criticality(shapes, chained)
        regions = [Region(s.name, fn=None, critical=s.name in crit)
                   for s in stages]
        deps = tuple(self.deps) if not chained else tuple(
            OrderedDep(c, s.name) for s in stages for c in s.consumes)
        return RegionGraph(regions=regions, deps=list(deps))


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    """A servable token-decode workload: the registry's description of
    continuous-batching LM decode (:class:`repro_torch.serve.decode.
    DecodeEngine`), the third traffic class next to solver pipelines
    (:class:`KernelSpec`) and stage DAGs (:class:`DagSpec`).

    Its unit of dispatch is one decode *step* over the slot pool, not a
    kernel over a lane group, so it has a registry of its own rather
    than a ``kind`` on KernelSpec (whose consumers expect ``make_case``
    and ``kernel``).  What the mux needs to price and admit decode
    traffic lives here: the phase names (prefill / insert / generate)
    and a closed-form per-token FLOP model over the serving
    :class:`~repro_torch.models.config.ArchConfig` — the decode analogue
    of ``Variant.model_flops``."""

    name: str
    phases: tuple[str, ...] = ("prefill", "insert", "generate")
    description: str = ""
    flops_fn: Callable | None = None
    """Optional override: ``flops_fn(cfg) -> float`` per-token FLOPs."""

    def token_flops(self, cfg) -> float:
        """Model FLOPs to decode ONE token on one slot: ~2 FLOPs per
        weight touched (QKVO projections, the FFN at the config's
        arity, the LM head); attention over the live cache depends on
        the position and is left out, as the solver FLOP models count
        shapes only."""
        if self.flops_fn is not None:
            return float(self.flops_fn(cfg))
        d = cfg.d_model
        attn = 2 * d * (cfg.n_heads + cfg.n_kv) * cfg.d_head \
            + 2 * d * cfg.n_heads * cfg.d_head
        ffn_mats = 3 if cfg.act == "swiglu" else 2
        ffn = ffn_mats * 2 * d * cfg.d_ff
        return float(cfg.n_layers * (attn + ffn) + 2 * d * cfg.vocab)


_REGISTRY: dict[str, KernelSpec] = {}
_DAGS: dict[str, DagSpec] = {}
_DECODES: dict[str, DecodeSpec] = {}
_BUILT = False
_LOCK = threading.Lock()


def register(spec: KernelSpec) -> KernelSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"duplicate kernel registration: {spec.name!r}")
    _REGISTRY[spec.name] = spec
    return spec


def register_dag(spec: DagSpec) -> DagSpec:
    if spec.name in _DAGS:
        raise ValueError(f"duplicate dag registration: {spec.name!r}")
    for s in spec.stages + spec.chained:
        pipe = _REGISTRY.get(s.pipeline)
        if pipe is None or pipe.kind != "pipeline":
            raise ValueError(
                f"dag {spec.name!r}: stage {s.name!r} references "
                f"{s.pipeline!r}, which is not a registered pipeline")
    _DAGS[spec.name] = spec
    return spec


def register_decode(spec: DecodeSpec) -> DecodeSpec:
    if spec.name in _DECODES:
        raise ValueError(f"duplicate decode registration: {spec.name!r}")
    _DECODES[spec.name] = spec
    return spec


def _build() -> None:
    """Populate the registry (idempotent, thread-safe, atomic: a failed
    build clears the partial state so the root-cause error — not a
    misleading duplicate-registration one — resurfaces on every call)."""
    global _BUILT
    with _LOCK:
        if _BUILT:
            return
        try:
            _register_all()
        except BaseException:
            _REGISTRY.clear()
            _DAGS.clear()
            _DECODES.clear()
            raise
        _BUILT = True


def _tensor(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _register_all() -> None:
    from repro_torch import pipelines as pp
    from repro_torch.core.streams import inductive, rect
    from repro_torch.kernels import ref
    from repro_torch.kernels.cholesky import cholesky_fused
    from repro_torch.kernels.common import sample_spd as _spd
    from repro_torch.kernels.fft import fft_fused
    from repro_torch.kernels.attention import flash_attention_fused
    from repro_torch.kernels.fir import fir_fused
    from repro_torch.kernels.gemm import gemm_fused
    from repro_torch.kernels.qr import qr_fused
    from repro_torch.kernels.ssm_scan import ssm_scan_fused
    from repro_torch.kernels.svd import spectrum_recon, svd_fused
    from repro_torch.kernels.trisolve import trisolve_fused

    tri_ri = lambda n: inductive(outer_trip=n, inner_base=n,
                                 inner_stretch=-1)

    # ---------------- factorizations (the primitives) ----------------
    register(KernelSpec(
        name="cholesky", kernel=cholesky_fused, run_oracle=ref.cholesky,
        make_case=lambda rng, n: (_tensor(_spd(rng, 2, n)),),
        stream=tri_ri, sizes=(8, 12, 16, 24, 32), kind="kernel"))

    def _tri_case(rng, n):
        l = np.linalg.cholesky(_spd(rng, 2, n))
        b = rng.standard_normal((2, n, 3)).astype(np.float32)
        return _tensor(l), _tensor(b)

    register(KernelSpec(
        name="trisolve", kernel=trisolve_fused,
        run_oracle=lambda l, b: ref.trisolve(l, b, lower=True),
        make_case=_tri_case, stream=tri_ri, sizes=(8, 12, 16, 24, 32),
        rtol=1e-3, kind="kernel"))

    register(KernelSpec(
        name="qr", kernel=qr_fused, run_oracle=ref.qr,
        make_case=lambda rng, n: (_tensor(
            rng.standard_normal((2, n + 4, n)).astype(np.float32)),),
        stream=tri_ri, sizes=(8, 12, 16, 24), kind="kernel"))

    # ---------------- kernels the served DAGs run ----------------
    def _svd_adapter(a):
        """Reconstruction-based conformance adapter: check the sorted
        spectrum AND that U diag(S) V^T rebuilds A — one-sided Jacobi
        guarantees A V = U S, so reconstruction is exact up to float32
        rounding and catches U/V corruption that a singular-values-only
        check cannot."""
        return spectrum_recon(*svd_fused(a, sweeps=14))

    # dtype-relative tolerance: one-sided Jacobi converges to working
    # precision, so the reconstruction check budget is a small multiple
    # of sqrt(eps(float32)) (~3.5e-4)
    svd_rtol = float(4.0 * np.sqrt(np.finfo(np.float32).eps))

    register(KernelSpec(
        name="svd", kernel=svd_fused, run_kernel=_svd_adapter,
        run_oracle=lambda a: (ref.svd_vals(a), a),
        make_case=lambda rng, n: (_tensor(
            rng.standard_normal((2, n + 4, n)).astype(np.float32)),),
        stream=lambda n: inductive(outer_trip=n, inner_base=n - 1,
                                   inner_stretch=-1),
        sizes=(8, 12, 16), rtol=svd_rtol, kind="kernel"))

    # ---------------- dense / DSP ----------------
    register(KernelSpec(
        name="gemm", kernel=gemm_fused, run_oracle=ref.gemm,
        run_kernel=lambda x, y: gemm(x, y, device=x.device),
        make_case=lambda rng, n: (
            _tensor(rng.standard_normal((4 * n, 4 * n)).astype(np.float32)),
            _tensor(rng.standard_normal((4 * n, 4 * n)).astype(np.float32))),
        stream=lambda n: rect(4 * n, 4 * n), sizes=(16, 32), kind="kernel"))

    def _fir_case(rng, n):
        x = rng.standard_normal((16 * n,)).astype(np.float32)
        h = rng.standard_normal((9,)).astype(np.float32)
        h = (h + h[::-1]) / 2
        return _tensor(x), _tensor(h)

    register(KernelSpec(
        name="fir", kernel=fir_fused, run_oracle=ref.fir,
        make_case=_fir_case, stream=lambda n: rect(16 * n - 8, 9),
        sizes=(8, 16, 32), kind="kernel"))

    register(KernelSpec(
        name="fft", kernel=fft_fused,
        run_oracle=lambda xr, xi: ref.fft(xr, xi),
        make_case=lambda rng, n: (
            _tensor(rng.standard_normal((2, n)).astype(np.float32)),
            _tensor(rng.standard_normal((2, n)).astype(np.float32))),
        stream=lambda n: rect(int(np.log2(n)), n // 2),
        sizes=(64, 128, 256, 1024), rtol=1e-3, kind="kernel"))

    # ---------------- LM-side ----------------
    def _attn_case(rng, n):
        s, d = 128, 64
        mk = lambda sc: _tensor(
            (rng.standard_normal((1, 2, s, d)) * sc).astype(np.float32))
        return mk(0.3), mk(0.3), mk(1.0)

    register(KernelSpec(
        name="flash_attention", kernel=flash_attention_fused,
        run_oracle=lambda q, k, v: ref.mha(q, k, v, causal=True),
        make_case=_attn_case,
        stream=lambda n: inductive(outer_trip=n, inner_base=1,
                                   inner_stretch=1),
        sizes=(128,), rtol=1e-3, kind="kernel"))

    def _ssm_case(rng, n):
        b, h, nn, p = 1, 2, 8, 4
        return (_tensor(rng.standard_normal((b, h, n, p))
                        .astype(np.float32)),
                _tensor(rng.uniform(0.8, 0.999, (b, h, n))
                        .astype(np.float32)),
                _tensor(rng.standard_normal((b, n, nn)).astype(np.float32)),
                _tensor(rng.standard_normal((b, n, nn)).astype(np.float32)))

    def _ssm_oracle(x, a, b, c):
        y, hf = ref.ssm_scan(x.transpose(1, 2), a.transpose(1, 2), b, c)
        return y.transpose(1, 2), hf

    register(KernelSpec(
        name="ssm_scan", kernel=ssm_scan_fused,
        run_kernel=lambda x, a, b, c: ssm_scan_fused(x, a, b, c, chunk=16),
        run_oracle=_ssm_oracle, make_case=_ssm_case,
        stream=lambda n: rect(n // 16, 16), sizes=(64,), rtol=1e-3,
        kind="kernel"))

    # ---------------- token decode (continuous batching) ----------------
    register_decode(DecodeSpec(
        name="lm_decode",
        description="continuous-batching LM token decode: per-slot "
                    "positions, slot-level paged KV reuse, one step "
                    "over the slot pool"))

    def _identity_system_filler(shapes, dtypes):
        """Benign padding lane for (matrix, rhs) solver pipelines: an
        identity(-embedded) matrix and a zero right-hand side.  Works for
        square SPD systems (cholesky_solve) and tall least-squares /
        channel matrices (qr_solve, mmse_equalize): eye(m, n) is full
        rank with unit singular values, so padded lanes stay perfectly
        conditioned and solve to exactly zero."""
        (m, n), rhs_shape = shapes
        return (np.eye(m, n, dtype=dtypes[0]),
                np.zeros(rhs_shape, dtype=dtypes[1]))

    # Cross-shape coalescing for (matrix, rhs) solver pipelines: embed
    # the small problem block-diagonally —
    #     A_big = [[A, 0], [0, I]],  b_big = [[b, 0], [0, 0]]
    # with A in the top-left (ms, ns) corner, an identity block on the
    # trailing (N - ns) columns placed BELOW A's rows (rows ms..), and b
    # zero-padded.  The blocks touch disjoint rows, so the factor /
    # least-squares / MMSE solution of the big system is exactly
    # block-separable: x_big[:ns, :ks] IS the small solution —
    # bit-identical in float (the padded zeros contribute exact +0
    # terms).  Requires M - ms >= N - ns so the identity block fits
    # below A (square systems: always; tall m = n + c systems: same
    # overhang c).
    def _solver_coalesce_compatible(small_key, big_key):
        if len(small_key) != 2 or len(big_key) != 2:
            return False                     # e.g. 4-plane split-complex
        (sa, sda), (sb, sdb) = small_key
        (ba, bda), (bb, bdb) = big_key
        if (sda, sdb) != (bda, bdb):
            return False
        if any(len(s) != 2 for s in (sa, sb, ba, bb)):
            return False
        (ms, ns), (M, N) = sa, ba
        ks, K = sb[1], bb[1]
        if sb[0] != ms or bb[0] != M:        # rhs rows ride the matrix
            return False
        return (ms <= M and ns <= N and ks <= K
                and (ms, ns, ks) != (M, N, K)
                and M - ms >= N - ns)

    def _solver_coalesce_embed(args, big_shapes):
        a, b = (np.asarray(x) for x in args)
        (M, N), (_, K) = big_shapes
        ms, ns = a.shape
        big_a = np.zeros((M, N), dtype=a.dtype)
        big_a[:ms, :ns] = a
        t = N - ns
        if t:
            big_a[ms:ms + t, ns:] = np.eye(t, dtype=a.dtype)
        big_b = np.zeros((M, K), dtype=b.dtype)
        big_b[:ms, :b.shape[1]] = b
        return big_a, big_b

    def _solver_coalesce_extract(out_lane, small_shapes):
        (_, ns), (_, ks) = small_shapes
        return np.asarray(out_lane)[:ns, :ks]

    _solver_coalescer = Coalescer(compatible=_solver_coalesce_compatible,
                                  embed=_solver_coalesce_embed,
                                  extract=_solver_coalesce_extract)

    def _blocked_when(shapes, dtypes):
        """Blocked factor applicability: two (matrix, rhs) args whose
        inner dimension reaches panel scale and tiles evenly."""
        return (len(shapes) == 2 and len(shapes[0]) == 2
                and shapes[0][-1] >= 128 and shapes[0][-1] % 32 == 0)

    def _tiled_when(shapes, dtypes):
        """HBM-scale tiled applicability: two (matrix, rhs) args at
        n >= 512 tiling evenly into 32-wide slabs.  Listed BEFORE
        ``blocked`` in each variants table, as in the reference."""
        return (len(shapes) == 2 and len(shapes[0]) == 2
                and shapes[0][-1] >= 512 and shapes[0][-1] % 32 == 0)

    def _chol_tiled_case(rng, n):
        a = _tensor(_spd(rng, 1, n))
        b = _tensor(rng.standard_normal((1, n, 2)).astype(np.float32))
        return a, b

    def _tall_tiled_case(rng, n):
        a = _tensor(rng.standard_normal((1, n + 16, n)).astype(np.float32))
        b = _tensor(rng.standard_normal((1, n + 16, 2)).astype(np.float32))
        return a, b

    def _chol_solve_case(rng, n):
        a = _tensor(_spd(rng, 2, n))
        b = _tensor(rng.standard_normal((2, n, 3)).astype(np.float32))
        return a, b

    def _chol_solve_flops(shapes):
        """Closed-form model: n^3/3 factor + 2 n^2 k substitutions."""
        (n, _), (_, k) = shapes
        return n ** 3 / 3.0 + 2.0 * n * n * k

    register(KernelSpec(
        name="cholesky_solve", kernel=pp.cholesky_solve_fused,
        run_oracle=lambda a, b: ref.cholesky_solve(a, b),
        make_case=_chol_solve_case, stream=tri_ri,
        sizes=(8, 12, 16, 24, 32),
        filler=_identity_system_filler,
        coalesce=_solver_coalescer,
        flops=_chol_solve_flops,
        variants=(
            Variant(name="tiled", fn=pp.cholesky_solve_tiled_fused,
                    when=_tiled_when, make_case=_chol_tiled_case,
                    sizes=(512, 1024), flops=_chol_solve_flops),
            Variant(name="blocked", fn=pp.cholesky_solve_blocked_fused,
                    when=_blocked_when, sizes=(128, 256),
                    flops=_chol_solve_flops,
                    fits=lambda s: pp.cholesky_solve_blocked_fits(
                        s[0][0], s[1][-1])))))

    def _qr_solve_case(rng, n):
        a = _tensor(rng.standard_normal((2, n + 4, n)).astype(np.float32))
        b = _tensor(rng.standard_normal((2, n + 4, 2)).astype(np.float32))
        return a, b

    def _qr_solve_flops(shapes):
        """Closed-form model: Householder 2(m n^2 - n^3/3) + rhs
        reflections 4 m n k + back substitution n^2 k."""
        (m, n), (_, k) = shapes
        return (2.0 * (m * n * n - n ** 3 / 3.0) + 4.0 * m * n * k
                + n * n * k)

    register(KernelSpec(
        name="qr_solve", kernel=pp.qr_solve_fused,
        run_oracle=lambda a, b: ref.qr_solve(a, b),
        make_case=_qr_solve_case, stream=tri_ri,
        sizes=(8, 12, 16, 24, 32),
        filler=_identity_system_filler,
        coalesce=_solver_coalescer,
        flops=_qr_solve_flops,
        variants=(
            Variant(name="tiled", fn=pp.qr_solve_tiled_fused,
                    when=_tiled_when, make_case=_tall_tiled_case,
                    sizes=(512, 1024), flops=_qr_solve_flops),
            Variant(name="blocked", fn=pp.qr_solve_blocked_fused,
                    when=_blocked_when, sizes=(128, 256),
                    flops=_qr_solve_flops,
                    fits=lambda s: pp.qr_solve_blocked_fits(
                        s[0][0], s[0][1], s[1][-1])))))

    def _mmse_case(rng, n):
        h = _tensor(rng.standard_normal((2, n + 4, n)).astype(np.float32))
        y = _tensor(rng.standard_normal((2, n + 4, 2)).astype(np.float32))
        return h, y

    def _mmse_flops(shapes):
        """Real-path model: Gram 2 m n^2 + matched filter 2 m n k +
        n^3/3 factor + 2 n^2 k substitutions (on whatever real/expanded
        shapes arrive)."""
        (m, n), (_, k) = shapes
        return (2.0 * m * n * n + 2.0 * m * n * k + n ** 3 / 3.0
                + 2.0 * n * n * k)

    def _mmse_split_when(shapes, dtypes):
        """Split-complex jobs present 4 planes (Hr, Hi, yr, yi)."""
        return len(shapes) == 4

    def _mmse_split_filler(shapes, dtypes):
        """Benign split-complex lane: identity real channel, zero
        imaginary part, zero observations -> x = 0 exactly."""
        (m, n), _, yr_shape, yi_shape = shapes
        return (np.eye(m, n, dtype=dtypes[0]),
                np.zeros((m, n), dtype=dtypes[1]),
                np.zeros(yr_shape, dtype=dtypes[2]),
                np.zeros(yi_shape, dtype=dtypes[3]))

    def _mmse_split_case(rng, n):
        m = n + 4
        mk = lambda *s: _tensor(rng.standard_normal(s).astype(np.float32))
        return (mk(2, m, n), mk(2, m, n), mk(2, m, 2), mk(2, m, 2))

    def _mmse_split_flops(shapes):
        """Split-complex model: stacked Gram 4 m n^2 + cross product
        2 m n^2 + two stacked matched filters 8 m n k + the real-embedded
        (2n)^3/3 factor + 2 (2n)^2 k substitutions."""
        (m, n), _, (_, k), _ = shapes
        return (6.0 * m * n * n + 8.0 * m * n * k
                + (2 * n) ** 3 / 3.0 + 2.0 * (2 * n) ** 2 * k)

    register(KernelSpec(
        name="mmse_equalize", kernel=pp.mmse_equalize_fused,
        run_oracle=lambda h, y: ref.mmse_equalize(h, y, sigma2=0.1),
        make_case=_mmse_case, stream=tri_ri,
        sizes=(8, 12, 16, 24, 32),
        filler=_identity_system_filler,
        coalesce=_solver_coalescer,
        flops=_mmse_flops,
        variants=(
            Variant(name="split_complex",
                    fn=pp.mmse_equalize_split_fused,
                    when=_mmse_split_when,
                    oracle=lambda hr, hi, yr, yi: ref.mmse_equalize_split(
                        hr, hi, yr, yi, sigma2=0.1),
                    filler=_mmse_split_filler,
                    make_case=_mmse_split_case,
                    sizes=(8, 16, 24),
                    flops=_mmse_split_flops),
            Variant(name="tiled", fn=pp.mmse_equalize_tiled_fused,
                    when=_tiled_when, make_case=_tall_tiled_case,
                    sizes=(512, 1024), flops=_mmse_flops))))

    # ---------------- DAG stage pipelines (PUSCH + SVD-solve) ----------
    from repro_torch.core.dependence import OrderedDep

    # Per-lane DAG geometry: A = n + 4 antennas, NF-point OFDM FFT, the
    # first P = 2n frequency bins carry pilots and the next K_SYMS carry
    # the data symbols the equalizer recovers.
    NFFT = 64
    K_SYMS = 2

    def _lane(x):
        """One numpy lane through a batched torch oracle on the CPU."""
        return _tensor(np.asarray(x))[None]

    def _pusch_fft_case(rng, n):
        a = n + 4
        mk = lambda: _tensor(rng.standard_normal((2, a, NFFT))
                             .astype(np.float32))
        return mk(), mk()

    def _pusch_fft_filler(shapes, dtypes):
        return tuple(np.zeros(s, dtype=d) for s, d in zip(shapes, dtypes))

    def _pusch_fft_flops(shapes):
        a, nf = shapes[0]
        return 5.0 * a * nf * np.log2(nf)

    register(KernelSpec(
        name="pusch_fft", kernel=pp.pusch_fft_fused,
        run_oracle=lambda xr, xi: ref.pusch_fft(xr, xi),
        make_case=_pusch_fft_case,
        stream=lambda n: rect(2, n + 4, NFFT),
        sizes=(8, 12), rtol=1e-3,
        filler=_pusch_fft_filler, flops=_pusch_fft_flops))

    def _chanest_case(rng, n):
        p, a = 2 * n, n + 4
        xp = _tensor(rng.standard_normal((2, n, p)).astype(np.float32))
        yp = _tensor(rng.standard_normal((2, a, p)).astype(np.float32))
        return xp, yp

    def _chanest_filler(shapes, dtypes):
        """Benign pilot lane: orthonormal pilot rows, zero observation
        -> Gram = I + ridge, H = 0 exactly."""
        (n, p), yp_shape = shapes
        return (np.eye(n, p, dtype=dtypes[0]),
                np.zeros(yp_shape, dtype=dtypes[1]))

    def _chanest_flops(shapes):
        """Pilot Gram 2 p n^2 + rhs GEMM 2 n p a + n^3/3 factor +
        2 n^2 a substitutions (a rhs columns = antennas)."""
        (n, p), (a, _) = shapes
        return (2.0 * p * n * n + 2.0 * n * p * a + n ** 3 / 3.0
                + 2.0 * n * n * a)

    register(KernelSpec(
        name="pusch_chanest", kernel=pp.channel_estimate_fused,
        run_oracle=lambda xp, yp: ref.channel_estimate(xp, yp),
        make_case=_chanest_case, stream=tri_ri, sizes=(8, 12),
        filler=_chanest_filler, flops=_chanest_flops))

    def _pusch_chain_case(rng, n):
        xp, yp = _chanest_case(rng, n)
        y = _tensor(rng.standard_normal((2, n + 4, K_SYMS))
                    .astype(np.float32))
        return xp, yp, y

    def _pusch_chain_filler(shapes, dtypes):
        (n, p), yp_shape, y_shape = shapes
        return (np.eye(n, p, dtype=dtypes[0]),
                np.zeros(yp_shape, dtype=dtypes[1]),
                np.zeros(y_shape, dtype=dtypes[2]))

    def _pusch_chain_flops(shapes):
        (n, p), (a, _), (_, k) = shapes
        est = _chanest_flops(shapes[:2])
        eq = (2.0 * a * n * n + 2.0 * a * n * k + n ** 3 / 3.0
              + 2.0 * n * n * k)
        return est + eq

    register(KernelSpec(
        name="pusch_chain", kernel=pp.pusch_chain_fused,
        run_oracle=lambda xp, yp, y: ref.pusch_chain(xp, yp, y),
        make_case=_pusch_chain_case, stream=tri_ri, sizes=(8, 12),
        filler=_pusch_chain_filler, flops=_pusch_chain_flops))

    def _svd_factor_check(a):
        """Conformance adapter: packed factors are sign/order ambiguous,
        so check the sorted spectrum + the reconstruction (same contract
        as the ``svd`` kernel spec)."""
        return spectrum_recon(*pp.unpack_factors(pp.svd_factor_fused(a)))

    def _svd_factor_filler(shapes, dtypes):
        (m, n), = shapes
        return (np.eye(m, n, dtype=dtypes[0]),)

    def _svd_factor_flops(shapes):
        """One-sided Jacobi: 14 sweeps x n(n-1)/2 pairs x (6m dot work
        + 12(m+n) rotation work)."""
        m, n = shapes[0]
        return 14.0 * n * (n - 1) / 2.0 * (6.0 * m + 12.0 * (m + n))

    register(KernelSpec(
        name="svd_factor", kernel=pp.svd_factor_fused,
        run_kernel=_svd_factor_check,
        run_oracle=lambda a: (ref.svd_vals(a), a),
        make_case=lambda rng, n: (_tensor(
            rng.standard_normal((2, n + 4, n)).astype(np.float32)),),
        stream=lambda n: inductive(outer_trip=n, inner_base=n - 1,
                                   inner_stretch=-1),
        sizes=(8, 12), rtol=svd_rtol,
        filler=_svd_factor_filler, flops=_svd_factor_flops,
        serve_oracle=lambda a: pp.svd_factor_fused(a)))

    def _svd_apply_case(rng, n):
        m = n + 4
        f = rng.standard_normal((2, m + n + 1, n)).astype(np.float32)
        f[:, m + n] = np.abs(f[:, m + n]) + 0.1      # s row: positive
        b = rng.standard_normal((2, m, K_SYMS)).astype(np.float32)
        return _tensor(f), _tensor(b)

    def _svd_apply_filler(shapes, dtypes):
        """Benign packed-identity factors + zero rhs -> x = 0."""
        (mn1, n), b_shape = shapes
        m = mn1 - n - 1
        f = np.zeros((mn1, n), dtype=dtypes[0])
        f[:m] = np.eye(m, n, dtype=dtypes[0])
        f[m:m + n] = np.eye(n, dtype=dtypes[0])
        f[m + n] = 1.0
        return f, np.zeros(b_shape, dtype=dtypes[1])

    def _svd_apply_flops(shapes):
        (mn1, n), (m, k) = shapes
        return 2.0 * m * n * k + 2.0 * n * n * k + 3.0 * n * k

    register(KernelSpec(
        name="svd_apply", kernel=pp.svd_apply_fused,
        run_oracle=lambda f, b: ref.svd_apply(f, b),
        make_case=_svd_apply_case,
        stream=lambda n: rect(n, K_SYMS), sizes=(8, 12),
        filler=_svd_apply_filler, flops=_svd_apply_flops))

    # ---------------- the served DAGs ----------------
    def _pusch_dag_case(rng, n):
        a, p = n + 4, 2 * n
        return (rng.standard_normal((a, NFFT)).astype(np.float32),
                rng.standard_normal((a, NFFT)).astype(np.float32),
                rng.standard_normal((n, p)).astype(np.float32))

    def _pusch_dag_oracle(tdr, tdi, xp):
        f = ref.pusch_fft(_lane(tdr), _lane(tdi))[0]
        p = xp.shape[1]
        h = ref.channel_estimate(_lane(xp), f[0][:, :p][None])
        return ref.mmse_equalize(h, f[0][:, p:p + K_SYMS][None],
                                 sigma2=0.1)[0].numpy()

    def _bind_fft(args, outs):
        return args[0], args[1]

    def _bind_chanest(args, outs):
        xp = args[2]
        return xp, outs["fft"][0][:, :xp.shape[1]]

    def _bind_equalize(args, outs):
        p = args[2].shape[1]
        return outs["chanest"], outs["fft"][0][:, p:p + K_SYMS]

    def _bind_chain(args, outs):
        xp = args[2]
        p = xp.shape[1]
        f0 = outs["fft"][0]
        return xp, f0[:, :p], f0[:, p:p + K_SYMS]

    def _stage_flops_chanest(shapes):
        (a, _), _, (n, p) = shapes
        return _chanest_flops(((n, p), (a, p)))

    def _stage_flops_equalize(shapes):
        (a, _), _, (n, p) = shapes
        return (2.0 * a * n * n + 2.0 * a * n * K_SYMS + n ** 3 / 3.0
                + 2.0 * n * n * K_SYMS)

    _fft_stage = StageSpec(
        name="fft", pipeline="pusch_fft", bind=_bind_fft,
        stream=lambda n: rect(2, n + 4, NFFT),
        oracle=lambda tdr, tdi: ref.pusch_fft(_lane(tdr),
                                              _lane(tdi))[0].numpy(),
        flops=lambda shapes: _pusch_fft_flops(shapes[:2]),
        transcendental=True)       # twiddle sin/cos chains, not bulk FMA

    register_dag(DagSpec(
        name="pusch_receive",
        stages=(
            _fft_stage,
            StageSpec(name="chanest", pipeline="pusch_chanest",
                      bind=_bind_chanest, consumes=("fft",),
                      stream=tri_ri, flops=_stage_flops_chanest),
            StageSpec(name="equalize", pipeline="mmse_equalize",
                      bind=_bind_equalize, consumes=("fft", "chanest"),
                      stream=tri_ri, flops=_stage_flops_equalize),
        ),
        deps=(OrderedDep("fft", "chanest"),
              OrderedDep("fft", "equalize"),
              OrderedDep("chanest", "equalize")),
        chained=(
            _fft_stage,
            StageSpec(name="chain", pipeline="pusch_chain",
                      bind=_bind_chain, consumes=("fft",),
                      stream=tri_ri,
                      flops=lambda shapes: (
                          _stage_flops_chanest(shapes)
                          + _stage_flops_equalize(shapes))),
        ),
        make_case=_pusch_dag_case, oracle=_pusch_dag_oracle,
        # knob: 0.15 keeps the mid-chain channel-estimate stage (share
        # ~0.2 of the DAG's model FLOPs) on the critical path while the
        # transcendental FFT front-end and the small equalize tail stay
        # slack — the admission ordering the golden trace pins.
        crit_threshold=0.15, rtol=2e-3))

    def _svd_dag_case(rng, n):
        return (rng.standard_normal((n + 4, n)).astype(np.float32),
                rng.standard_normal((n + 4, K_SYMS)).astype(np.float32))

    def _svd_dag_oracle(a, b):
        return ref.ridge_solve(_lane(a), _lane(b))[0].numpy()

    register_dag(DagSpec(
        name="svd_solve",
        stages=(
            StageSpec(name="factor", pipeline="svd_factor",
                      bind=lambda args, outs: (args[0],),
                      stream=lambda n: inductive(outer_trip=n,
                                                 inner_base=n - 1,
                                                 inner_stretch=-1),
                      flops=lambda shapes: _svd_factor_flops(
                          shapes[:1])),
            StageSpec(name="apply", pipeline="svd_apply",
                      bind=lambda args, outs: (outs["factor"], args[1]),
                      consumes=("factor",),
                      stream=lambda n: rect(n, K_SYMS),
                      oracle=lambda f, b: ref.svd_apply(
                          _lane(f), _lane(b))[0].numpy(),
                      flops=lambda shapes: _svd_apply_flops(
                          (((shapes[0][0] + shapes[0][1] + 1),
                            shapes[0][1]), shapes[1]))),
        ),
        deps=(OrderedDep("factor", "apply"),),
        make_case=_svd_dag_case, oracle=_svd_dag_oracle, rtol=2e-3))


def get(name: str) -> KernelSpec:
    _build()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown kernel {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def names(kind: str | None = None) -> list[str]:
    _build()
    return [n for n, s in _REGISTRY.items()
            if kind is None or s.kind == kind]


def specs(kind: str | None = None) -> list[KernelSpec]:
    _build()
    return [s for s in _REGISTRY.values()
            if kind is None or s.kind == kind]


def get_dag(name: str) -> DagSpec:
    _build()
    try:
        return _DAGS[name]
    except KeyError:
        raise KeyError(f"unknown dag {name!r}; registered: "
                       f"{sorted(_DAGS)}") from None


def dag_names() -> list[str]:
    _build()
    return sorted(_DAGS)


def dag_specs() -> list[DagSpec]:
    _build()
    return [_DAGS[n] for n in sorted(_DAGS)]


def get_decode(name: str) -> DecodeSpec:
    _build()
    try:
        return _DECODES[name]
    except KeyError:
        raise KeyError(f"unknown decode spec {name!r}; registered: "
                       f"{sorted(_DECODES)}") from None


def decode_names() -> list[str]:
    _build()
    return sorted(_DECODES)
