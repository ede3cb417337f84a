"""The kernel registry — the single enumeration point for tests,
benchmarks and serving — for the served solver pipelines.

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

Names, sizes, tolerances, variant order and ``when`` predicates are the
reference's (``repro/kernels/__init__.py``), so dispatch and pricing
agree with it on every shape.  The ``tiled`` and ``blocked`` large-n
variants keep their rows and predicates but are not ported yet: their
entry point is :func:`later_slice`, which raises, and the serving stack
refuses a bucket that dispatches to them instead of serving it on the
base kernel.

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

__all__ = ["KernelSpec", "Variant", "Coalescer", "register", "get",
           "names", "specs", "later_slice"]


def later_slice(*args, **kwargs):
    """Entry point of a registered variant that is not ported yet (the
    blocked and tiled large-n kernels, K10-K14)."""
    raise NotImplementedError("K10–K14: later slice")


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
    """

    name: str
    fn: Callable
    when: Callable
    oracle: Callable | None = None
    filler: Callable | None = None
    make_case: Callable | None = None
    sizes: tuple[int, ...] = ()
    flops: Callable | None = None

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

    @property
    def base(self) -> Variant:
        """The spec's own entry point as the fallback Variant."""
        return Variant(name="base", fn=self.kernel, when=lambda s, d: True,
                       oracle=self.run_oracle, filler=self.filler,
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


_REGISTRY: dict[str, KernelSpec] = {}
_BUILT = False
_LOCK = threading.Lock()


def register(spec: KernelSpec) -> KernelSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"duplicate kernel registration: {spec.name!r}")
    _REGISTRY[spec.name] = spec
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
            raise
        _BUILT = True


def _tensor(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _register_all() -> None:
    from repro_torch import pipelines as pp
    from repro_torch.core.streams import inductive
    from repro_torch.kernels import ref
    from repro_torch.kernels.common import sample_spd as _spd

    tri_ri = lambda n: inductive(outer_trip=n, inner_base=n,
                                 inner_stretch=-1)

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
            Variant(name="tiled", fn=later_slice,
                    when=_tiled_when, make_case=_chol_tiled_case,
                    sizes=(512, 1024), flops=_chol_solve_flops),
            Variant(name="blocked", fn=later_slice,
                    when=_blocked_when, sizes=(128, 256),
                    flops=_chol_solve_flops))))

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
            Variant(name="tiled", fn=later_slice,
                    when=_tiled_when, make_case=_tall_tiled_case,
                    sizes=(512, 1024), flops=_qr_solve_flops),
            Variant(name="blocked", fn=later_slice,
                    when=_blocked_when, sizes=(128, 256),
                    flops=_qr_solve_flops))))

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
            Variant(name="tiled", fn=later_slice,
                    when=_tiled_when, make_case=_tall_tiled_case,
                    sizes=(512, 1024), flops=_mmse_flops))))


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
