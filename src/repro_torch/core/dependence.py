"""Ordered dependences between concurrent regions (paper §4 Feature 1-2).

REVEL expresses a kernel as multiple dataflow *regions* connected by FIFOs
with production:consumption rate annotations.  This module gives that
structure a name: the served DAGs (``repro_torch.kernels.DagSpec``)
declare their stage edges as :class:`OrderedDep` s and expose themselves
as a validated :class:`RegionGraph`.  The dataclasses are the
reference's (``repro/core/dependence.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

__all__ = ["Region", "OrderedDep", "RegionGraph"]


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
    """producer -> consumer channel.  (The reference also annotates the
    channel's production:consumption rates, which no served DAG reads.)"""

    producer: str
    consumer: str


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
