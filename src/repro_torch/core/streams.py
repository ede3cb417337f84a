"""FGOP stream descriptors (paper §4, Features 2-4).

A *stream* describes an affine-plus-stretch iteration domain and address
function.  REVEL encodes these in hardware state machines; here they are a
small IR, executable in pure Python / numpy so properties can be tested:
the registry specs' ``stream`` descriptors, and the paper's analytical
control-overhead model over them (:func:`command_count`).

Capability letters follow the paper: each dimension is either
  'R' — rectangular: trip count is a constant
  'I' — inductive: trip count is a linear function of lexicographically
        earlier iterators (the "stretch" multipliers s_ji).

So "RI" is a 2D stream whose inner trip count varies with the outer
iterator — the pattern of Cholesky / QR / Solver inner loops, and of
causal attention (kv-trip-count = q_block + 1).
"""
from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Sequence

import numpy as np

__all__ = ["StreamDim", "StreamDescriptor", "rect", "inductive",
           "command_count", "commands_per_iteration",
           "average_stream_length"]


@dataclasses.dataclass(frozen=True)
class StreamDim:
    """One dimension of a stream's iteration domain.

    trip(outer) = base_trip + sum_j stretch[j] * outer[j]
    where outer are the values of lexicographically-earlier iterators.
    ``stride`` is this iterator's multiplier in the address function (c_i).
    Stretch entries may be fractional (paper F4: vectorization divides the
    reuse/trip rate by the vector width), hence Fraction.
    """

    base_trip: Fraction
    stride: int = 1
    stretch: tuple[Fraction, ...] = ()  # one entry per earlier dim

    @property
    def is_inductive(self) -> bool:
        return any(s != 0 for s in self.stretch)

    def trip(self, outer: Sequence[int]) -> int:
        t = Fraction(self.base_trip)
        for s, o in zip(self.stretch, outer):
            t += Fraction(s) * o
        return max(0, math.ceil(t))


@dataclasses.dataclass(frozen=True)
class StreamDescriptor:
    """N-D stream: iteration domain + affine address function.

    ``dims`` are ordered outermost-first.  ``base`` is the address offset.
    ``reuse`` / ``reuse_stretch`` describe the production:consumption rate
    (paper F2): each produced element is consumed ``reuse`` times, with the
    rate itself changing by ``reuse_stretch`` per outer iteration.
    """

    dims: tuple[StreamDim, ...]
    base: int = 0
    reuse: Fraction = Fraction(1)
    reuse_stretch: Fraction = Fraction(0)
    name: str = "stream"

    # ---------------- capability / classification ----------------
    @property
    def capability(self) -> str:
        """Pattern string, e.g. 'RI' — paper's notation."""
        return "".join("I" if d.is_inductive else "R" for d in self.dims)

    @property
    def ndim(self) -> int:
        return len(self.dims)

    # ---------------- executable semantics ----------------
    def iterate(self):
        """Yield (index_tuple, address) lexicographically.

        Reference implementation of the hardware state machine; used by
        property tests and by the masking helpers.
        """

        def rec(level: int, outer: tuple[int, ...]):
            if level == len(self.dims):
                addr = self.base + sum(
                    d.stride * i for d, i in zip(self.dims, outer)
                )
                yield outer, addr
                return
            d = self.dims[level]
            for i in range(d.trip(outer)):
                yield from rec(level + 1, outer + (i,))

        yield from rec(0, ())

    def addresses(self) -> np.ndarray:
        return np.array([a for _, a in self.iterate()], dtype=np.int64)

    def length(self) -> int:
        """Total number of iterations described by one stream command."""
        return sum(1 for _ in self.iterate())

    def trip_counts(self) -> list[int]:
        """Innermost trip count per outer iteration (diagnostics)."""
        if self.ndim == 1:
            return [self.dims[0].trip(())]
        out = []

        def rec(level: int, outer: tuple[int, ...]):
            if level == len(self.dims) - 1:
                out.append(self.dims[level].trip(outer))
                return
            d = self.dims[level]
            for i in range(d.trip(outer)):
                rec(level + 1, outer + (i,))

        rec(0, ())
        return out


# ---------------- constructors ----------------

def rect(*trips: int, strides: Sequence[int] | None = None,
         base: int = 0, name: str = "stream") -> StreamDescriptor:
    """Rectangular stream (R/RR/RRR)."""
    if strides is None:
        strides = [1] * len(trips)
        # row-major default: stride of dim k = product of inner trips
        for k in range(len(trips) - 2, -1, -1):
            strides[k] = strides[k + 1] * trips[k + 1]
    dims = tuple(
        StreamDim(Fraction(t), s, (Fraction(0),) * k)
        for k, (t, s) in enumerate(zip(trips, strides))
    )
    return StreamDescriptor(dims=dims, base=base, name=name)


def inductive(outer_trip: int, inner_base: int, inner_stretch,
              outer_stride: int = 0, inner_stride: int = 1,
              base: int = 0, name: str = "stream") -> StreamDescriptor:
    """2D RI stream: inner trip = inner_base + inner_stretch * j."""
    dims = (
        StreamDim(Fraction(outer_trip), outer_stride),
        StreamDim(Fraction(inner_base), inner_stride,
                  (Fraction(inner_stretch),)),
    )
    return StreamDescriptor(dims=dims, base=base, name=name)


# ---------------- analytical control-overhead model ----------------
# Reproduces the paper's Fig. 11 / Fig. 21 / Fig. 22 methodology: how many
# control commands must a Von-Neumann core issue to express a given
# iteration pattern, under a hardware capability?

_CAPABILITY_ORDER = ["V", "R", "RR", "RI", "RRR", "RII"]


def _supports(capability: str, pattern: StreamDescriptor) -> bool:
    """Can one command of class `capability` express `pattern` directly?"""
    if capability == "V":
        return False  # vectors always decompose (handled in command_count)
    if len(capability) < pattern.ndim:
        return False
    # align capability letters to the innermost dims of the pattern
    cap = capability[-pattern.ndim:] if len(capability) >= pattern.ndim else capability
    for letter, dim in zip(cap, pattern.dims):
        if dim.is_inductive and letter != "I":
            return False
    return True


def command_count(pattern: StreamDescriptor, capability: str,
                  vector_width: int = 8) -> int:
    """Number of control commands to express `pattern` at `capability`.

    'V'  — classic vector ISA: one instruction per vector_width elements
           of the innermost dimension (ceil), issued per inner loop, per
           outer iteration (this is the paper's "V" baseline).
    'R'  — 1D streams: one command per innermost loop instance.
    'RR' — 2D rectangular: one command expresses a rectangle; inductive
           patterns decompose into per-outer-iteration 1D commands.
    'RI' — 2D inductive: one command for any 2D (possibly inductive)
           pattern (paper: solver 3+5n -> 8 total commands).
    """
    if capability not in _CAPABILITY_ORDER:
        raise ValueError(f"unknown capability {capability!r}")

    # degenerate stream: a pattern with no iterations at all (e.g. an
    # inductive inner dim with inner_base=0 and non-positive stretch, or
    # a zero outer trip) needs no commands — without this guard the V
    # path's max(1, ...) and the _supports fast path both claim 1.
    # Individual empty rows inside a non-empty decomposed pattern still
    # charge one command each (the core issues the per-outer-iteration
    # command before the zero trip count is known — the paper's 3+5n
    # accounting), which the max(1, ...) below preserves.
    if pattern.length() == 0:
        return 0

    if capability == "V":
        total = 0
        if pattern.ndim == 1:
            return max(1, math.ceil(pattern.dims[0].trip(()) / vector_width))
        for t in pattern.trip_counts():
            total += max(1, math.ceil(t / vector_width))
        return total

    if _supports(capability, pattern):
        return 1

    if pattern.ndim == 1:
        return 1  # any stream capability covers a 1D run

    # decompose: peel the outermost dimension, recurse
    d0 = pattern.dims[0]
    total = 0
    for j in range(d0.trip(())):
        inner_dims = []
        for d in pattern.dims[1:]:
            # fold iterator-0's contribution into the base trip
            stretch0 = d.stretch[0] if d.stretch else Fraction(0)
            inner_dims.append(
                StreamDim(
                    base_trip=Fraction(d.base_trip) + stretch0 * j,
                    stride=d.stride,
                    stretch=d.stretch[1:],
                )
            )
        sub = StreamDescriptor(
            dims=tuple(inner_dims),
            base=pattern.base + d0.stride * j,
            name=pattern.name,
        )
        total += max(1, command_count(sub, capability, vector_width))
    return total


def commands_per_iteration(pattern: StreamDescriptor, capability: str,
                           vector_width: int = 8) -> float:
    """Paper Fig. 22 metric: control instructions per inner-loop iteration."""
    n = pattern.length()
    if n == 0:
        return 0.0
    return command_count(pattern, capability, vector_width) / n


def average_stream_length(pattern: StreamDescriptor, capability: str,
                          vector_width: int = 8) -> float:
    """Paper Fig. 21 metric: mean iterations covered by one command."""
    c = command_count(pattern, capability, vector_width)
    return pattern.length() / max(1, c)
