"""Criticality planning (paper §4 Feature 5, §6.3).

REVEL splits its fabric into a dedicated (critical) and temporal
(non-critical) region: the critical dataflow is the easily vectorized
bulk update, the non-critical one the sqrt/div point chains.  This
module holds the planning arithmetic the served DAGs use
(``DagSpec.criticality``): given per-region work estimates, decide which
regions are critical; and the reference's MXU-tile padding arithmetic
(:func:`mxu_padded`, :func:`dedicated_efficiency`), kept as it computes
it on the TPU's 128-wide tiles.  The arithmetic is the reference's
(``repro/core/criticality.py``) operation for operation, because the
mux's event stream records its result.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["RegionCost", "plan_split", "mxu_padded", "dedicated_efficiency",
           "MXU_DIM"]

MXU_DIM = 128      # the reference's TPU MXU systolic dimension


@dataclasses.dataclass(frozen=True)
class RegionCost:
    name: str
    flops_per_outer: float      # work per outer iteration
    has_transcendental: bool = False  # sqrt/div/rsqrt => non-critical hint


def plan_split(regions: list[RegionCost], threshold: float = 0.25):
    """Partition regions into critical (wide datapath) / non-critical.

    A region is critical if it carries >= `threshold` of total work and has
    no transcendental-dominated body.  Mirrors the paper's observation that
    critical regions are the easily-vectorized bulk updates while
    sub-critical ones are sqrt/div chains.
    Returns (critical_names, noncritical_names).
    """
    total = sum(r.flops_per_outer for r in regions) or 1.0
    crit, non = [], []
    for r in regions:
        share = r.flops_per_outer / total
        if share >= threshold and not r.has_transcendental:
            crit.append(r.name)
        else:
            non.append(r.name)
    if not crit:  # largest region is critical by definition
        biggest = max(regions, key=lambda r: r.flops_per_outer)
        crit = [biggest.name]
        non = [r.name for r in regions if r.name != biggest.name]
    return crit, non


def mxu_padded(n: int, dim: int = MXU_DIM) -> int:
    """Tile-aligned size the MXU would execute for an n-wide op."""
    return max(dim, math.ceil(n / dim) * dim)


def dedicated_efficiency(n: int, dim: int = MXU_DIM) -> float:
    """Utilization if a point/vector region were forced onto MXU tiles —
    the quantitative version of 'don't waste FP units on non-critical
    dataflows' (paper Q9)."""
    return n / mxu_padded(n, dim)
