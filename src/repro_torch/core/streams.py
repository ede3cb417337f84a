"""FGOP stream descriptors (paper §4, Features 2-4).

A *stream* describes an affine-plus-stretch iteration domain and address
function.  REVEL encodes these in hardware state machines; here they are a
small IR, executable in pure Python / numpy so properties can be tested.
This is the subset the served solver pipelines' registry specs use (their
``stream`` descriptors); the paper's control-overhead model lives with
the reference package until a later slice needs it.

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

__all__ = ["StreamDim", "StreamDescriptor", "rect", "inductive"]


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
