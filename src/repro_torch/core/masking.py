"""Implicit vector masking (paper §4 Feature 4, §6.2).

REVEL's stream-control unit compares the remaining stream length against
the destination port's vector width and predicates off the unused lanes.
On the card the same idea is: a thread block's tile is full-shape, and a
mask derived from the *stream descriptor's* current trip count
predicates the tail.  These helpers build those masks as tensors, the
counterparts of the reference's ``repro/core/masking.py``.
"""
from __future__ import annotations

import torch

__all__ = [
    "lane_mask",
    "tail_mask",
    "tri_mask",
    "masked_fill",
    "vector_utilization",
]


def _iota(shape: tuple[int, ...], axis: int) -> torch.Tensor:
    """int32 indices along ``axis``, broadcast to ``shape``."""
    view = [1] * len(shape)
    view[axis] = shape[axis]
    return torch.arange(shape[axis], dtype=torch.int32).reshape(
        view).expand(shape)


def lane_mask(length, width: int, dtype=torch.bool) -> torch.Tensor:
    """1D mask of `width` lanes, True for lanes < length."""
    return (_iota((width,), 0)
            < torch.as_tensor(length, dtype=torch.int32)).to(dtype)


def tail_mask(shape: tuple[int, ...], axis: int, length) -> torch.Tensor:
    """N-D mask, True where index along `axis` < length."""
    return _iota(tuple(shape), axis) < torch.as_tensor(length,
                                                      dtype=torch.int32)


def tri_mask(shape: tuple[int, ...], row_axis: int, col_axis: int,
             row_offset=0, lower: bool = True) -> torch.Tensor:
    """Triangular (inductive-domain) mask: col <= row + row_offset.

    The triangular iteration space of Cholesky/solver/causal-attention is
    exactly an RI stream; its in-tile predication is this mask.
    """
    shape = tuple(shape)
    r = _iota(shape, row_axis) + torch.as_tensor(row_offset,
                                                 dtype=torch.int32)
    c = _iota(shape, col_axis)
    return (c <= r) if lower else (c >= r)


def masked_fill(x: torch.Tensor, mask: torch.Tensor,
                fill=0.0) -> torch.Tensor:
    return torch.where(mask, x, torch.as_tensor(fill, dtype=x.dtype,
                                                device=x.device))


def vector_utilization(trip_counts, width: int) -> float:
    """Fraction of vector lanes doing useful work over a set of inner-loop
    trips — the paper's Fig. 2(c,d) utilization argument, computable for
    any stream descriptor via .trip_counts()."""
    useful = sum(int(t) for t in trip_counts)
    issued = sum(-(-int(t) // width) * width for t in trip_counts)
    return useful / issued if issued else 1.0
