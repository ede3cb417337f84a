"""The port's primitive kernels (K15 Cholesky, K16 triangular solve, K17
Householder QR, K19 centro-symmetric FIR), its ``ops`` API, the unfused
baselines and the DSP receiver chain against the JAX reference.

The same numpy inputs, made from a seed, go through the reference's
Pallas kernels (interpret mode on the CPU), oracles, ``ops`` and
unfused pipelines, and through the port's wrappers on CPU tensors —
which run the kernels' plain PyTorch versions.  Tolerances are the
registry specs' own (1e-4; 1e-3 for the triangular solve, whose
reciprocal-then-multiply rounds once more than a divide) and, for the
baselines against the fused pipelines, the reference's
``tests/test_pipelines.py`` ones (1e-4 Cholesky and MMSE, 1e-3 QR).  The
CUDA kernels are held against these plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import kernels as RK  # noqa: E402
from repro import pipelines as jp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.cholesky import cholesky_pallas  # noqa: E402
from repro.kernels.qr import qr_pallas  # noqa: E402
from repro.kernels.trisolve import trisolve_pallas  # noqa: E402
from repro_torch import kernels as TK  # noqa: E402
from repro_torch import pipelines as tp  # noqa: E402
tchol = importlib.import_module("repro_torch.kernels.cholesky")
tfir = importlib.import_module("repro_torch.kernels.fir")
from repro_torch.kernels import ops as tops  # noqa: E402
tqr = importlib.import_module("repro_torch.kernels.qr")
from repro_torch.kernels import ref as tref  # noqa: E402
ttri = importlib.import_module("repro_torch.kernels.trisolve")
from repro_torch.kernels.common import sample_spd  # noqa: E402
from repro_torch.launch import dsp_pipeline as tdsp  # noqa: E402

from conftest import assert_close  # noqa: E402

PRIMITIVES = ["cholesky", "trisolve", "qr", "fir"]
EXAMPLE = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
    "dsp_pipeline.py"


def _t(x):
    return torch.from_numpy(np.array(x))      # a writable copy


def _tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _pallas(name, *args):
    """The reference's Pallas kernel of ``name`` in interpret mode (the
    FIR through ``ops.fir``, which pads to whole tiles as its grid
    needs)."""
    if name == "cholesky":
        return cholesky_pallas(*args, interpret=True)
    if name == "trisolve":
        return trisolve_pallas(*args, lower=True, interpret=True)
    if name == "qr":
        return qr_pallas(*args, interpret=True)
    return jops.fir(*args, backend="pallas")


CASES = [(name, n) for name in PRIMITIVES for n in TK.get(name).sizes]


@pytest.mark.parametrize("name,n", CASES)
def test_plain_matches_pallas_and_oracle(name, n):
    """Registry case at every registry size: identical inputs from the
    two packages' case generators, the port's kernel wrapper on the CPU
    (the plain version) against the reference's Pallas kernel and its
    oracle, and the two oracles against each other, at the spec's
    rtol."""
    tspec, jspec = TK.get(name), RK.get(name)
    assert (tspec.sizes, tspec.rtol, tspec.kind) == \
        (jspec.sizes, jspec.rtol, jspec.kind)
    targs = tspec.make_case(np.random.default_rng(300 + n), n)
    jargs = jspec.make_case(np.random.default_rng(300 + n), n)
    for t, j in zip(targs, jargs):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    got = _tuple(tspec.kernel(*targs))
    pallas = _tuple(_pallas(name, *jargs))
    joracle = _tuple(jspec.run_oracle(*jargs))
    toracle = _tuple(tspec.run_oracle(*targs))
    rtol = tspec.rtol
    for i, (g, p, jo, to) in enumerate(zip(got, pallas, joracle, toracle)):
        label = f"{name} n={n} out {i}"
        assert_close(g.numpy(), np.asarray(p), rtol=rtol,
                     name=f"{label} vs pallas")
        assert_close(g.numpy(), np.asarray(jo), rtol=rtol,
                     name=f"{label} vs oracle")
        assert_close(to.numpy(), np.asarray(jo), rtol=rtol,
                     name=f"{label} oracles")


# ---------------- guard cases ----------------

def test_cholesky_upper_triangle_nan_never_leaks():
    """K15 reads only the lower triangle: NaN in the strict upper half
    changes nothing, bit for bit, and the reference's kernel agrees."""
    a = sample_spd(np.random.default_rng(1), 2, 16)
    clean = tchol.cholesky_fused(_t(a)).numpy()
    poisoned = a.copy()
    iu = np.triu_indices(16, k=1)
    poisoned[:, iu[0], iu[1]] = np.nan
    got = tchol.cholesky_fused(_t(poisoned)).numpy()
    np.testing.assert_array_equal(got, clean)
    assert np.all(np.triu(got, 1) == 0.0)
    ref = np.asarray(cholesky_pallas(jnp.asarray(poisoned), interpret=True))
    assert_close(got, ref, rtol=1e-4, name="poisoned vs pallas")


def test_cholesky_unguarded_pivot_gives_nan_as_reference():
    """No pivot guard (that is K1's): a lane with a negative pivot gives
    NaN in the same places as the reference's kernel, a clean lane
    beside it stays exact."""
    a = sample_spd(np.random.default_rng(2), 2, 8)
    a[1, 3, 3] = -1.0
    got = tchol.cholesky_fused(_t(a)).numpy()
    ref = np.asarray(cholesky_pallas(jnp.asarray(a), interpret=True))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[1]).any() and np.isfinite(got[0]).all()


@pytest.mark.parametrize("lower", [True, False])
def test_trisolve_unused_triangle_nan_never_leaks(lower):
    """K16 reads column k of the named triangle only: NaN in the other
    strict triangle changes nothing, bit for bit, in both directions,
    and the reference's kernel agrees."""
    rng = np.random.default_rng(3)
    l = np.linalg.cholesky(sample_spd(rng, 2, 12))
    if not lower:
        l = np.ascontiguousarray(l.swapaxes(-1, -2))
    b = rng.standard_normal((2, 12, 3)).astype(np.float32)
    clean = ttri.trisolve_fused(_t(l), _t(b), lower=lower).numpy()
    poisoned = l.copy()
    idx = np.triu_indices(12, k=1) if lower else np.tril_indices(12, k=-1)
    poisoned[:, idx[0], idx[1]] = np.nan
    got = ttri.trisolve_fused(_t(poisoned), _t(b), lower=lower).numpy()
    np.testing.assert_array_equal(got, clean)
    ref = np.asarray(trisolve_pallas(jnp.asarray(poisoned), jnp.asarray(b),
                                     lower=lower, interpret=True))
    assert_close(got, ref, rtol=1e-3, name=f"trisolve lower={lower}")
    want = np.asarray(jref.trisolve(l, b, lower=lower))
    assert_close(got, want, rtol=1e-3, name="vs oracle")


@pytest.mark.parametrize("m,n", [(9, 8), (17, 16), (1, 1), (2, 2)])
def test_qr_reflector_count_edges(m, n):
    """min(n, m - 1) reflectors: m = n + 1 runs n, m = n runs n - 1,
    m = 1 runs none (Q = I, R = A); the plain version against the
    reference's kernel and both oracles, and Q R = A, Q orthogonal."""
    a = np.random.default_rng(4).standard_normal((2, m, n)).astype(
        np.float32)
    q, r = (x.numpy() for x in tqr.qr_fused(_t(a)))
    jq, jr = (np.asarray(x) for x in qr_pallas(jnp.asarray(a),
                                               interpret=True))
    oq, orr = (np.asarray(x) for x in jref.qr(jnp.asarray(a)))
    tq, tr = (x.numpy() for x in tref.qr(_t(a)))
    for got, want, label in ((q, jq, "Q"), (r, jr, "R"), (q, oq, "Q"),
                             (r, orr, "R"), (tq, oq, "Q"), (tr, orr, "R")):
        assert_close(got, want, rtol=1e-4, name=f"qr {m}x{n} {label}")
    assert np.all(np.tril(r, -1) == 0.0)
    assert_close(q @ r, a, rtol=1e-4, name="QR = A")
    assert_close(q.swapaxes(-1, -2) @ q, np.broadcast_to(np.eye(m), q.shape),
                 rtol=1e-4, name="Q^T Q = I")
    if m == 1:
        np.testing.assert_array_equal(q, np.ones((2, 1, 1), np.float32))
        np.testing.assert_array_equal(r, a)


def test_qr_zero_column_takes_identity_reflector():
    """A zero column gives tau = 0 (no reflection) and stays finite, as
    the reference's kernel."""
    a = np.random.default_rng(5).standard_normal((1, 10, 6)).astype(
        np.float32)
    a[:, :, 2] = 0.0
    q, r = (x.numpy() for x in tqr.qr_fused(_t(a)))
    jq, jr = (np.asarray(x) for x in qr_pallas(jnp.asarray(a),
                                               interpret=True))
    assert np.isfinite(q).all() and np.isfinite(r).all()
    assert_close(q, jq, rtol=1e-4, name="Q")
    assert_close(r, jr, rtol=1e-4, name="R")


@pytest.mark.parametrize("samples,taps", [(2048, 31), (2048, 30),
                                          (1000, 65), (300, 1), (700, 2)])
def test_fir_taps_and_ragged_tiles(samples, taps):
    """Even and odd tap counts, and outputs that are no multiple of 256
    (the kernel masks its last tile; the reference pads to whole tiles):
    the plain version against the reference's kernel, both oracles and
    numpy's convolution."""
    rng = np.random.default_rng(samples + taps)
    x = rng.standard_normal(samples).astype(np.float32)
    h = rng.standard_normal(taps).astype(np.float32)
    h = (h + h[::-1]) / 2
    got = tfir.fir_fused(_t(x), _t(h)).numpy()
    assert got.shape == (samples - taps + 1,)
    pallas = np.asarray(jops.fir(jnp.asarray(x), jnp.asarray(h),
                                 backend="pallas"))
    for want, label in ((pallas, "pallas"),
                        (np.asarray(jref.fir(jnp.asarray(x),
                                             jnp.asarray(h))), "oracle"),
                        (tref.fir(_t(x), _t(h)).numpy(), "torch oracle"),
                        (np.convolve(x, h[::-1], mode="valid"), "numpy")):
        assert_close(got, want, rtol=1e-4, name=f"fir {taps} vs {label}")


@pytest.mark.parametrize("name,shapes", [
    ("cholesky", [(2, 4, 5)]), ("trisolve", [(2, 4, 4), (2, 5, 1)]),
    ("qr", [(3, 4)]), ("fir", [(4,), (5,)])])
def test_wrappers_refuse_bad_shapes(name, shapes):
    fused = {"cholesky": tchol.cholesky_fused, "trisolve":
             ttri.trisolve_fused, "qr": tqr.qr_fused,
             "fir": tfir.fir_fused}[name]
    with pytest.raises(ValueError):
        fused(*(torch.zeros(s) for s in shapes))


# ---------------- ops ----------------

def test_ops_match_reference_ops():
    """``repro_torch.kernels.ops`` on ``device="cpu"`` against
    ``repro.kernels.ops`` on the same inputs (the reference's default
    backend off the TPU); the SVD by sorted spectrum, reconstruction and
    V's orthogonality, its factors being sign ambiguous."""
    rng = np.random.default_rng(6)
    a = sample_spd(rng, 3, 12)
    l = tops.cholesky(a, device="cpu")
    assert_close(l.numpy(), np.asarray(jops.cholesky(jnp.asarray(a))),
                 rtol=1e-4, name="ops.cholesky")
    b = rng.standard_normal((3, 12, 2)).astype(np.float32)
    ln = l.numpy()
    for lower, mat in ((True, ln), (False, ln.swapaxes(-1, -2).copy())):
        got = tops.trisolve(mat, b, lower=lower, device="cpu").numpy()
        want = np.asarray(jops.trisolve(jnp.asarray(mat), jnp.asarray(b),
                                        lower=lower))
        assert_close(got, want, rtol=1e-3, name=f"ops.trisolve {lower}")
    t = rng.standard_normal((3, 14, 10)).astype(np.float32)
    for got, want in zip(tops.qr(t, device="cpu"), jops.qr(jnp.asarray(t))):
        assert_close(got.numpy(), np.asarray(want), rtol=1e-4,
                     name="ops.qr")
    x = rng.standard_normal(600).astype(np.float32)
    h = rng.standard_normal(9).astype(np.float32)
    h = (h + h[::-1]) / 2
    assert_close(tops.fir(x, h, device="cpu").numpy(),
                 np.asarray(jops.fir(jnp.asarray(x), jnp.asarray(h))),
                 rtol=1e-4, name="ops.fir")
    xr, xi = (rng.standard_normal((2, 64)).astype(np.float32)
              for _ in range(2))
    for got, want in zip(tops.fft(xr, xi, device="cpu"),
                         jops.fft(jnp.asarray(xr), jnp.asarray(xi))):
        assert_close(got.numpy(), np.asarray(want), rtol=1e-3,
                     name="ops.fft")
    s_in = rng.standard_normal((2, 16, 12)).astype(np.float32)
    u, s, v = (x.numpy() for x in tops.svd(s_in, device="cpu"))
    ju, js, jv = (np.asarray(x) for x in jops.svd(jnp.asarray(s_in)))
    assert np.all(np.diff(s, axis=-1) <= 0), "ops.svd: not descending"
    rtol = RK.get("svd").rtol
    assert_close(s, js, rtol=rtol, name="ops.svd S")
    assert_close(np.einsum("bmn,bn,bkn->bmk", u, s, v), s_in, rtol=rtol,
                 name="ops.svd U S V^T")
    assert_close(np.abs(u), np.abs(ju), rtol=rtol, name="ops.svd |U|")
    assert_close(v.swapaxes(-1, -2) @ v, np.broadcast_to(np.eye(12),
                                                         v.shape),
                 rtol=rtol, name="ops.svd V^T V")


def test_ops_default_device_is_cuda():
    """Without ``device`` an entry point runs on the card: on a machine
    with no CUDA device it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.fir(np.zeros(8, np.float32), np.ones(3, np.float32))


# ---------------- the unfused baselines ----------------

def _baseline_case(name, rng, n):
    if name == "cholesky_solve":
        return sample_spd(rng, 2, n), \
            rng.standard_normal((2, n, 2)).astype(np.float32)
    m = n + 4
    k = 1 if name == "qr_solve" else 2
    return rng.standard_normal((2, m, n)).astype(np.float32), \
        rng.standard_normal((2, m, k)).astype(np.float32)


BASELINES = {"cholesky_solve": (tp.cholesky_solve_unfused,
                                jp.cholesky_solve_unfused,
                                tp.cholesky_solve_fused, 1e-4),
             "qr_solve": (tp.qr_solve_unfused, jp.qr_solve_unfused,
                          tp.qr_solve_fused, 1e-3),
             "mmse_equalize": (tp.mmse_equalize_composed,
                               jp.mmse_equalize_composed,
                               tp.mmse_equalize_fused, 1e-4)}


@pytest.mark.parametrize("name", sorted(BASELINES))
@pytest.mark.parametrize("n", [8, 16, 32])
def test_unfused_baseline_matches_reference_and_fused(name, n):
    """Each baseline of the port (a chain of primitive kernels' plain
    versions on the CPU) against the reference's own baseline (its
    Pallas kernels in interpret mode), the port's fused pipeline and the
    oracle, at the reference's fused-vs-unfused tolerance."""
    unfused, ref_unfused, fused, rtol = BASELINES[name]
    a, b = _baseline_case(name, np.random.default_rng(400 + n), n)
    got = unfused(_t(a), _t(b)).numpy()
    want = np.asarray(ref_unfused(jnp.asarray(a), jnp.asarray(b),
                                  interpret=True))
    assert_close(got, want, rtol=rtol, name=f"{name} n={n} vs reference")
    assert_close(got, fused(_t(a), _t(b)).numpy(), rtol=rtol,
                 name=f"{name} n={n} vs fused")
    oracle = getattr(tref, name)(_t(a), _t(b)).numpy()
    assert_close(got, oracle, rtol=rtol, name=f"{name} n={n} vs oracle")


# ---------------- the DSP receiver chain ----------------

def _example():
    spec = importlib.util.spec_from_file_location("ref_dsp_pipeline",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dsp_chain_matches_reference_example():
    """The port's chain (``device="cpu"``: the plain versions) against
    the reference example's own functions on the same inputs, and its
    ``main`` at the reference's defaults against the example's numbers:
    the same NMSE, and errors of the same size."""
    ex = _example()
    assert (tdsp.ANTENNAS, tdsp.SUBCARRIERS, tdsp.BATCH) == \
        (ex.ANTENNAS, ex.SUBCARRIERS, ex.BATCH)
    rng = np.random.default_rng(9)
    hr, hi = tdsp.make_channel(rng, 4, tdsp.ANTENNAS)
    yr, yi = (rng.standard_normal((4, tdsp.ANTENNAS)).astype(np.float32)
              for _ in range(2))
    got = tdsp.lmmse_equalize(*(_t(a) for a in (hr, hi, yr, yi)))
    want = ex.lmmse_equalize(*(jnp.asarray(a) for a in (hr, hi, yr, yi)))
    for g, w in zip(got, want):
        assert_close(g.numpy(), np.asarray(w), rtol=1e-4, name="lmmse")
    sym = rng.standard_normal((4, tdsp.SUBCARRIERS)).astype(np.float32)
    zero = np.zeros_like(sym)
    for g, w in zip(tdsp.ofdm_demod(_t(sym), _t(zero)),
                    ex.ofdm_demod(jnp.asarray(sym), jnp.asarray(zero))):
        assert_close(g.numpy(), np.asarray(w), rtol=1e-3, name="ofdm")
    taps = rng.standard_normal(31).astype(np.float32)
    taps = (taps + taps[::-1]) / 2
    sig = rng.standard_normal(2048).astype(np.float32)
    assert_close(tdsp.channel_filter(_t(sig), _t(taps)).numpy(),
                 np.asarray(ex.channel_filter(jnp.asarray(sig),
                                              jnp.asarray(taps))),
                 rtol=1e-4, name="fir")
    errors = tdsp.main(["--device", "cpu"])
    # the example's NMSE from its own equalizer on main's inputs
    rng = np.random.default_rng(0)
    hr, hi = ex.make_channel(rng, ex.BATCH, ex.ANTENNAS)
    xr_t, xi_t = (rng.standard_normal((ex.BATCH, ex.ANTENNAS)).astype(
        np.float32) for _ in range(2))
    yr = np.einsum("bij,bj->bi", hr, xr_t) - np.einsum("bij,bj->bi", hi, xi_t)
    yi = np.einsum("bij,bj->bi", hr, xi_t) + np.einsum("bij,bj->bi", hi, xr_t)
    xr, xi = (np.asarray(x) for x in ex.lmmse_equalize(
        *(jnp.asarray(a) for a in (hr, hi, yr, yi))))
    nmse = (np.linalg.norm(xr - xr_t) ** 2 + np.linalg.norm(xi - xi_t) ** 2) \
        / (np.linalg.norm(xr_t) ** 2 + np.linalg.norm(xi_t) ** 2)
    assert errors["nmse"] == pytest.approx(float(nmse), rel=1e-3)
    for key in ("fft_err", "fir_err", "svd_err"):
        assert errors[key] < 1e-4, (key, errors)


def test_dsp_chain_widens_without_changing_the_math(capsys):
    """``--batch`` and ``--samples`` widen the run; every error stays at
    float32 size and the run ends with the example's last line."""
    errors = tdsp.main(["--device", "cpu", "--batch", "3",
                        "--samples", "300"])
    assert capsys.readouterr().out.rstrip().endswith("pipeline OK.")
    assert errors["nmse"] < 1.0
    for key in ("fft_err", "fir_err", "svd_err"):
        assert errors[key] < 1e-4, (key, errors)
