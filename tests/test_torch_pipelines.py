"""The port's fused solver pipelines (K1-K4) against the JAX reference
(the DAG stages K5-K9: ``tests/test_torch_pusch.py``).

The same numpy inputs, made from a seed, go through the reference's
Pallas kernels (interpret mode on the CPU) and oracles, and through the
port's kernel wrappers on ``device="cpu"`` — which run the kernels'
plain PyTorch versions.  Those keep the reference's per-lane op order, so
they are held at each spec's rtol (1e-4).  The CUDA kernels themselves
are held against these plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import kernels as RK  # noqa: E402
from repro.pipelines import (cholesky_solve_pallas,  # noqa: E402
                             mmse_equalize_pallas, qr_solve_pallas)
from repro.pipelines import \
    expand_complex_channel as ref_expand  # noqa: E402
from repro_torch import kernels as TK  # noqa: E402
from repro_torch import pipelines as tp  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

from conftest import assert_close  # noqa: E402

# (spec, variant) pairs the port serves; sizes are the registry's own
SERVED = [("cholesky_solve", "base"), ("qr_solve", "base"),
          ("mmse_equalize", "base"), ("mmse_equalize", "split_complex")]


def _variant(spec, name):
    if name == "base":
        return spec.base
    return next(v for v in spec.variants if v.name == name)


CASES = [(spec, var, n) for spec, var in SERVED
         for n in _variant(TK.get(spec), var).sizes]


def _t(x):
    return torch.from_numpy(np.array(x))      # a writable copy


@pytest.mark.parametrize("spec_name,variant_name,n", CASES)
def test_plain_matches_pallas_and_oracle(spec_name, variant_name, n):
    """Registry case at every registry size: identical inputs from the
    two packages' case generators, the port's wrapper on the CPU against
    the reference's Pallas kernel (interpret mode) and its oracle, and
    the port's torch oracle against the reference oracle."""
    tspec, jspec = TK.get(spec_name), RK.get(spec_name)
    tv, jv = _variant(tspec, variant_name), _variant(jspec, variant_name)
    targs = tv.make_case(np.random.default_rng(100 + n), n)
    jargs = jv.make_case(np.random.default_rng(100 + n), n)
    for t, j in zip(targs, jargs):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    got = tv.fn(*targs).numpy()
    pallas = np.asarray(jv.fn(*jargs))
    joracle = np.asarray((jv.oracle or jspec.run_oracle)(*jargs))
    toracle = (tv.oracle or tspec.run_oracle)(*targs).numpy()
    rtol = tspec.rtol
    assert tspec.rtol == jspec.rtol
    label = f"{spec_name}/{variant_name} n={n}"
    assert_close(got, pallas, rtol=rtol, name=f"{label} vs pallas")
    assert_close(got, joracle, rtol=rtol, name=f"{label} vs oracle")
    assert_close(toracle, joracle, rtol=rtol, name=f"{label} oracles")


# ---------------- degenerate inputs (guard paths) ----------------

def _rng():
    return np.random.default_rng(7)


def test_cholesky_solve_ignores_upper_triangle_garbage():
    """Only the lower triangle is read: NaN-poisoning the strict upper
    half changes nothing, bit for bit, and agrees with the reference's
    kernel on the same poisoned input."""
    rng = _rng()
    a = RK.get("cholesky_solve").make_case(rng, 16)[0]
    a = np.asarray(a)
    rhs = rng.standard_normal((2, 16, 2)).astype(np.float32)
    clean = tp.cholesky_solve_fused(_t(a), _t(rhs)).numpy()
    poisoned = a.copy()
    iu = np.triu_indices(16, k=1)
    poisoned[:, iu[0], iu[1]] = np.nan
    got = tp.cholesky_solve_fused(_t(poisoned), _t(rhs)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, clean)
    ref = np.asarray(cholesky_solve_pallas(jnp.asarray(poisoned),
                                           jnp.asarray(rhs)))
    assert_close(got, ref, rtol=1e-4, name="poisoned vs pallas")


def test_cholesky_solve_singular_zeroes_deficient_components():
    """Rank-2 SPD (outer product) of size 16: the eps pivot guard keeps
    every lane finite and zeroes exactly the deficient components — the
    same ones the reference's kernel zeroes."""
    rng = _rng()
    v = rng.standard_normal((2, 16, 2)).astype(np.float32)
    a = v @ v.swapaxes(-1, -2)
    rhs = rng.standard_normal((2, 16, 3)).astype(np.float32)
    got = tp.cholesky_solve_fused(_t(a), _t(rhs)).numpy()
    ref = np.asarray(cholesky_solve_pallas(jnp.asarray(a),
                                           jnp.asarray(rhs)))
    assert np.isfinite(got).all()
    zeros = np.all(got == 0.0, axis=-1)
    np.testing.assert_array_equal(zeros, np.all(ref == 0.0, axis=-1))
    assert zeros.sum(axis=-1).min() >= 14      # rank 2 of 16


def test_qr_solve_rank_deficient_stays_finite():
    """Duplicate columns -> zero householder norm + zero R diagonal: the
    tau=0 and zeroing guards fire; deficient components are exactly 0
    where the reference's are."""
    rng = _rng()
    col = rng.standard_normal((2, 16, 1)).astype(np.float32)
    a = np.repeat(col, 8, axis=2)
    b = rng.standard_normal((2, 16, 2)).astype(np.float32)
    got = tp.qr_solve_fused(_t(a), _t(b)).numpy()
    ref = np.asarray(qr_solve_pallas(jnp.asarray(a), jnp.asarray(b)))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(np.all(got == 0.0, axis=-1),
                                  np.all(ref == 0.0, axis=-1))


def test_qr_solve_exact_zero_pivot_is_zeroed_not_clamped():
    """R = [[0,1],[0,0]] pattern: the deficient component is ZEROED
    (a clamped divisor would cascade to inf)."""
    a = np.array([[[0.0, 1.0], [0.0, 0.0], [0.0, 0.0]]], np.float32)
    b = np.ones((1, 3, 1), np.float32)
    got = tp.qr_solve_fused(_t(a), _t(b)).numpy()
    ref = np.asarray(qr_solve_pallas(jnp.asarray(a), jnp.asarray(b)))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, ref)


def test_qr_solve_zero_matrix_solves_to_zero():
    b = _rng().standard_normal((1, 12, 1)).astype(np.float32)
    got = tp.qr_solve_fused(torch.zeros((1, 12, 8)), _t(b)).numpy()
    assert np.isfinite(got).all() and not got.any()


def test_mmse_zero_channel_stays_finite():
    """All-zero channel: G = sigma2 I, rhs = 0 -> x = 0 exactly, on both
    the real and the split path."""
    y = _rng().standard_normal((1, 16, 1)).astype(np.float32)
    h = np.zeros((1, 16, 12), np.float32)
    x = tp.mmse_equalize_fused(_t(h), _t(y)).numpy()
    ref = np.asarray(mmse_equalize_pallas(jnp.asarray(h), jnp.asarray(y)))
    np.testing.assert_array_equal(x, ref)
    assert not x.any()
    xs = tp.mmse_equalize_split_fused(_t(h), _t(h), _t(y), _t(y)).numpy()
    assert np.isfinite(xs).all() and not xs.any()


# ---------------- complex handling ----------------

def test_expand_complex_channel_matches_reference():
    rng = _rng()
    planes = [rng.standard_normal(s).astype(np.float32)
              for s in ((2, 12, 8), (2, 12, 8), (2, 12, 2), (2, 12, 2))]
    th, ty = tp.expand_complex_channel(*(_t(p) for p in planes))
    jh, jy = ref_expand(*(jnp.asarray(p) for p in planes))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("n", [8, 16])
def test_split_answers_the_expanded_problem(n):
    """The split re/im path and the real expansion answer the same
    complex problem: [Re x; Im x] at the spec's rtol, and both agree
    with the complex oracle."""
    rng = _rng()
    m = n + 4
    hr, hi = (_t(rng.standard_normal((2, m, n)).astype(np.float32))
              for _ in range(2))
    yr, yi = (_t(rng.standard_normal((2, m, 2)).astype(np.float32))
              for _ in range(2))
    split = tp.mmse_equalize_split_fused(hr, hi, yr, yi).numpy()
    h, y = tp.expand_complex_channel(hr, hi, yr, yi)
    expanded = tp.mmse_equalize_fused(h.contiguous(), y.contiguous())
    oracle = tref.mmse_equalize_split(hr, hi, yr, yi).numpy()
    assert_close(split, expanded.numpy(), rtol=1e-4, name="split vs exp")
    assert_close(split, oracle, rtol=1e-4, name="split vs oracle")


# ---------------- wrappers ----------------

def test_wrappers_take_arrays_and_device():
    rng = _rng()
    a, b = (np.array(x) for x in
            RK.get("cholesky_solve").make_case(rng, 8))
    x = tp.cholesky_solve(a, b, device="cpu")
    assert x.device.type == "cpu" and x.shape == b.shape
    assert_close(x.numpy(), tref.cholesky_solve(_t(a), _t(b)).numpy(),
                 rtol=1e-4)


@pytest.mark.parametrize("bad", ["float64", "noncontiguous"])
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(bad):
    a = torch.eye(4).repeat(2, 1, 1)
    b = torch.ones((2, 4, 2))
    if bad == "float64":
        a, b = a.double(), b.double()
        with pytest.raises(TypeError):
            tp.cholesky_solve_fused(a, b)
    else:
        with pytest.raises(ValueError):
            tp.cholesky_solve_fused(a.transpose(-1, -2)[:, :, :], b[:, :, :1]
                                    .expand(2, 4, 2))
