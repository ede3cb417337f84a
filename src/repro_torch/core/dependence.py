"""Ordered dependences between concurrent regions (paper §4 Feature 1-2).

REVEL expresses a kernel as multiple dataflow *regions* connected by FIFOs
with production:consumption rate annotations.  This module gives that
structure a name: the served DAGs (``repro_torch.kernels.DagSpec``)
declare their stage edges as :class:`OrderedDep` s and expose themselves
as a validated :class:`RegionGraph`, and :func:`fuse_scan` runs a chain of
ordered-dependent regions as one loop whose carry is the FIFO (the sLSTM
time loop).  The dataclasses are the reference's
(``repro/core/dependence.py``).
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Any, Callable, Sequence

import torch

__all__ = ["Region", "OrderedDep", "RegionGraph", "fuse_scan"]


@dataclasses.dataclass(frozen=True)
class Region:
    """One computation region (paper: point / vector / matrix).

    ``critical`` marks the region that should own the wide datapath
    (paper Feature 5); non-critical regions hold sqrt/div-style point ops.
    """

    name: str
    fn: Callable[..., Any]
    critical: bool = False


@dataclasses.dataclass(frozen=True)
class OrderedDep:
    """producer -> consumer channel with (possibly inductive) rates.

    production:consumption = prod_rate : cons_rate, each optionally
    stretched per outer iteration (paper F2's s_p / s_c).
    """

    producer: str
    consumer: str
    prod_rate: Fraction = Fraction(1)
    cons_rate: Fraction = Fraction(1)
    prod_stretch: Fraction = Fraction(0)
    cons_stretch: Fraction = Fraction(0)

    def consumptions_at(self, k: int) -> int:
        """How many times the value produced at outer-iteration k is read."""
        return max(0, int(self.cons_rate + self.cons_stretch * k))


@dataclasses.dataclass
class RegionGraph:
    """A static FGOP region graph, validated on construction."""

    regions: Sequence[Region]
    deps: Sequence[OrderedDep]

    def __post_init__(self):
        names = {r.name for r in self.regions}
        for d in self.deps:
            if d.producer not in names or d.consumer not in names:
                raise ValueError(f"dep {d} references unknown region")
        if not any(r.critical for r in self.regions):
            raise ValueError("region graph needs >=1 critical region")

    @property
    def critical(self) -> Region:
        return next(r for r in self.regions if r.critical)

    def total_consumptions(self, dep: OrderedDep, n_outer: int) -> int:
        return sum(dep.consumptions_at(k) for k in range(n_outer))


def _tree_map(fn, *trees):
    """``fn`` over the leaves of equally shaped trees of tuples, lists and
    dicts (None stays None)."""
    head = trees[0]
    if head is None:
        return None
    if isinstance(head, (tuple, list)):
        return type(head)(_tree_map(fn, *kids) for kids in zip(*trees))
    if isinstance(head, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in head}
    return fn(*trees)


def _leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for kid in tree for leaf in _leaves(kid)]
    if isinstance(tree, dict):
        return [leaf for kid in tree.values() for leaf in _leaves(kid)]
    return [tree]


def fuse_scan(step_fn: Callable, init_carry, xs=None, length=None,
              unroll: int = 1):
    """Fuse ordered-dependent regions into one loop: ``lax.scan``'s
    contract.

    ``step_fn(carry, x) -> (carry, y)`` runs once per leading index of the
    tree ``xs`` (or ``length`` times with x = None); returns the last carry
    and the ys stacked along a new leading axis, a tree like y.  The carry
    is the FIFO between the regions: it never leaves the loop.  At length
    0 the carry is ``init_carry`` and the ys are empty (leading axis 0):
    ``step_fn`` is called once on zeros to learn their shapes, where
    ``lax.scan`` traces it, and that call's result is dropped.  ``unroll``
    is the reference's knob; a Python loop has nothing to unroll."""
    del unroll
    leaves = _leaves(xs)
    if leaves:
        n = leaves[0].shape[0]
        if any(leaf.shape[0] != n for leaf in leaves) \
                or (length is not None and length != n):
            raise ValueError("fuse_scan: xs leaves and length disagree on "
                             "the leading axis")
    elif length is None:
        raise ValueError("fuse_scan: give xs or length")
    else:
        n = length
    carry, ys = init_carry, []
    for i in range(n):
        carry, y = step_fn(carry, _tree_map(lambda t: t[i], xs))
        ys.append(y)
    if ys:
        return carry, _tree_map(lambda *y: torch.stack(
            [torch.as_tensor(v) for v in y]), *ys)
    _, y = step_fn(init_carry, _tree_map(
        lambda t: t.new_zeros(t.shape[1:]), xs))
    return init_carry, _tree_map(
        lambda v: torch.as_tensor(v).new_empty((0,) + tuple(
            torch.as_tensor(v).shape)), y)
