"""The port's criticality planning and region graph against the JAX
reference's (``repro/core/criticality.py``, ``repro/core/dependence.py``):
the served DAGs' ``critical`` flags, which the golden event stream
records, come from this arithmetic."""
import pytest

pytest.importorskip("torch")

from repro.core import criticality as RC  # noqa: E402
from repro.core import dependence as RD  # noqa: E402
from repro_torch.core import criticality as TC  # noqa: E402
from repro_torch.core import dependence as TD  # noqa: E402

# (flops, transcendental) per region, threshold
CASES = [
    ([(25.0, False), (75.0, False)], 0.25),     # share exactly at threshold
    ([(24.0, False), (76.0, False)], 0.25),
    ([(80.0, True), (20.0, False)], 0.25),      # transcendental excluded
    ([(50.0, True), (50.0, True)], 0.25),       # none qualifies: biggest
    ([(0.0, False), (0.0, False)], 0.15),       # zero total
    ([(3.0, True), (1.0, False), (1.0, False)], 0.15),
]


@pytest.mark.parametrize("regions,threshold", CASES)
def test_plan_split_matches_reference(regions, threshold):
    t = [TC.RegionCost(f"r{i}", f, has_transcendental=x)
         for i, (f, x) in enumerate(regions)]
    r = [RC.RegionCost(f"r{i}", f, has_transcendental=x)
         for i, (f, x) in enumerate(regions)]
    assert TC.plan_split(t, threshold=threshold) == \
        RC.plan_split(r, threshold=threshold)


def test_region_graph_validates_as_the_reference():
    regions = [TD.Region("a", fn=None), TD.Region("b", fn=None,
                                                  critical=True)]
    g = TD.RegionGraph(regions=regions, deps=[TD.OrderedDep("a", "b")])
    assert g.critical.name == "b"
    with pytest.raises(ValueError, match="unknown region"):
        TD.RegionGraph(regions=regions, deps=[TD.OrderedDep("a", "c")])
    with pytest.raises(ValueError, match="critical"):
        TD.RegionGraph(regions=[TD.Region("a", fn=None)], deps=[])
    with pytest.raises(ValueError, match="critical"):
        RD.RegionGraph(regions=[RD.Region("a", fn=None)], deps=[])


def test_mxu_padding_arithmetic_matches_reference():
    """``mxu_padded`` and ``dedicated_efficiency`` on the reference's
    128-wide MXU tiles, equal to the reference's values over n = 1..600
    (and at another tile width)."""
    assert TC.MXU_DIM == RC.MXU_DIM == 128
    for n in range(1, 601):
        assert TC.mxu_padded(n) == RC.mxu_padded(n)
        assert TC.dedicated_efficiency(n) == RC.dedicated_efficiency(n)
        assert TC.mxu_padded(n, 32) == RC.mxu_padded(n, 32)
