"""The port's implicit vector masks (paper F4, ``repro_torch.core.masking``)
against the reference's (``repro.core.masking``), case for case as
``tests/test_masking.py`` holds the reference: the masks agree with the
stream-descriptor semantics and with the reference's masks element for
element, and the utilization model matches brute force and the
reference's value.

hypothesis is optional (see tests/strategies.py): the properties always
run over a deterministic parametrized grid; the ``@fuzzed`` variants
widen the space when hypothesis is installed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import masking as RM  # noqa: E402
from repro_torch.core import (lane_mask, masked_fill, tail_mask,  # noqa: E402
                              tri_mask, vector_utilization)
from repro_torch.core.streams import inductive  # noqa: E402

from strategies import fuzzed, integers, sampled  # noqa: E402


def test_lane_mask_basic():
    m = lane_mask(5, 8).numpy()
    assert m.tolist() == [1, 1, 1, 1, 1, 0, 0, 0]
    np.testing.assert_array_equal(m, np.asarray(RM.lane_mask(5, 8)))


def test_lane_mask_tensor_length():
    """A length held in a tensor (the reference's traced length)."""
    m = lane_mask(torch.tensor(3), 8)
    assert int(m.sum()) == 3
    np.testing.assert_array_equal(m.numpy(),
                                  np.asarray(RM.lane_mask(jnp.int32(3), 8)))
    assert lane_mask(3, 8, dtype=torch.float32).dtype == torch.float32


def test_tail_mask_axis():
    m = tail_mask((2, 6), axis=1, length=4).numpy()
    assert m[:, :4].all() and not m[:, 4:].any()
    np.testing.assert_array_equal(
        m, np.asarray(RM.tail_mask((2, 6), axis=1, length=4)))


@pytest.mark.parametrize("lower", [True, False])
def test_tri_mask_matches_numpy(lower):
    m = tri_mask((8, 8), 0, 1, lower=lower).numpy()
    want = np.tril(np.ones((8, 8), bool)) if lower \
        else np.triu(np.ones((8, 8), bool))
    assert (m == want).all()
    np.testing.assert_array_equal(
        m, np.asarray(RM.tri_mask((8, 8), 0, 1, lower=lower)))


def test_tri_mask_row_offset():
    """row_offset shifts the diagonal — the per-tile view of a global
    triangular domain (tile r starts at global row r*bm)."""
    m = tri_mask((4, 8), 0, 1, row_offset=4).numpy()
    for r in range(4):
        for c in range(8):
            assert m[r, c] == (c <= r + 4)
    np.testing.assert_array_equal(
        m, np.asarray(RM.tri_mask((4, 8), 0, 1, row_offset=4)))


def test_masked_fill():
    x = torch.ones((4, 4))
    out = masked_fill(x, tri_mask((4, 4), 0, 1), fill=-1.0).numpy()
    assert out[0, 0] == 1 and out[0, 1] == -1
    want = RM.masked_fill(jnp.ones((4, 4)), RM.tri_mask((4, 4), 0, 1),
                          fill=-1.0)
    np.testing.assert_array_equal(out, np.asarray(want))


# ---------------- utilization model (paper Fig. 2c,d) ----------------

def test_vector_utilization_full():
    assert vector_utilization([8, 8, 8], 8) == 1.0


def test_vector_utilization_triangular():
    """n=4 triangle at width 4: trips 4,3,2,1 -> 10 useful / 16 issued."""
    assert vector_utilization([4, 3, 2, 1], 4) == pytest.approx(10 / 16)
    assert vector_utilization([4, 3, 2, 1], 4) == \
        RM.vector_utilization([4, 3, 2, 1], 4)


def _check_utilization_matches_bruteforce(n, w):
    tri = inductive(outer_trip=n, inner_base=n, inner_stretch=-1)
    trips = tri.trip_counts()
    got = vector_utilization(trips, w)
    useful = sum(trips)
    issued = sum(-(-t // w) * w for t in trips)
    assert got == pytest.approx(useful / issued if issued else 1.0)
    assert 0.0 < got <= 1.0
    assert got == RM.vector_utilization(trips, w)


def _check_masking_beats_padding_scalarization(n, w):
    """Masked execution issues ceil(t/w)*w lanes; scalar fallback issues
    t*w lane-slots (1 useful lane per issue).  Masking is never worse."""
    tri = inductive(outer_trip=n, inner_base=n, inner_stretch=-1)
    trips = tri.trip_counts()
    masked_issued = sum(-(-t // w) * w for t in trips)
    scalar_issued = sum(t * w for t in trips)
    assert masked_issued <= scalar_issued
    m = tail_mask((len(trips), max(trips)), axis=1,
                  length=torch.tensor(trips)[:, None])
    assert int(m.sum()) == sum(trips)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 21, 32])
@pytest.mark.parametrize("w", [2, 4, 8, 16])
def test_utilization_matches_bruteforce(n, w):
    _check_utilization_matches_bruteforce(n, w)


@pytest.mark.parametrize("n", [1, 2, 5, 9, 16])
@pytest.mark.parametrize("w", [4, 8])
def test_masking_beats_padding_scalarization(n, w):
    _check_masking_beats_padding_scalarization(n, w)


@fuzzed(max_examples=60, n=integers(1, 32), w=sampled(2, 4, 8, 16))
def test_utilization_matches_bruteforce_fuzzed(n, w):
    _check_utilization_matches_bruteforce(n, w)


@fuzzed(max_examples=40, n=integers(1, 16), w=sampled(4, 8))
def test_masking_beats_padding_scalarization_fuzzed(n, w):
    _check_masking_beats_padding_scalarization(n, w)
