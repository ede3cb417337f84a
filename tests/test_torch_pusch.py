"""The port's PUSCH/SVD DAG stage kernels (K5-K9) against the JAX
reference.

The same numpy inputs, made from a seed, go through the reference's
Pallas kernels (interpret mode on the CPU) and oracles, and through the
port's kernel wrappers on CPU tensors — which run the kernels' plain
PyTorch versions.  Tolerances are the registry specs' own: 1e-4 for the
solver stages, 1e-3 for the FFT (float32 twiddle products over log2 N
stages), and 4 sqrt(eps_f32) for the SVD, held by sorted spectrum and
reconstruction because its factors are sign/order ambiguous.  The CUDA
kernels are held against these plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import kernels as RK  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fft import fft_pallas  # noqa: E402
from repro.kernels.fft import fft_tables as jfft_tables  # noqa: E402
from repro_torch import kernels as TK  # noqa: E402
from repro_torch import pipelines as tp  # noqa: E402
tfft = importlib.import_module("repro_torch.kernels.fft")
from repro_torch.kernels import ref as tref  # noqa: E402
tsvd = importlib.import_module("repro_torch.kernels.svd")

from conftest import assert_close  # noqa: E402


def _same_case(name, n, seed):
    """The registry case of ``name`` at size ``n`` from both packages'
    generators, checked identical."""
    targs = TK.get(name).make_case(np.random.default_rng(seed), n)
    jargs = RK.get(name).make_case(np.random.default_rng(seed), n)
    for t, j in zip(targs, jargs):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    return targs, jargs


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


@pytest.mark.parametrize("name", ["pusch_chanest", "pusch_chain",
                                  "svd_apply"])
@pytest.mark.parametrize("n", [8, 12])
def test_solver_stage_plain_matches_pallas_and_oracle(name, n):
    """K5, K6 and K9: the port's wrapper on the CPU against the
    reference's Pallas kernel and oracle, and the two oracles against
    each other, at the spec's rtol."""
    tspec, jspec = TK.get(name), RK.get(name)
    assert tspec.sizes == jspec.sizes and tspec.rtol == jspec.rtol == 1e-4
    targs, jargs = _same_case(name, n, 200 + n)
    got = tspec.kernel(*targs).numpy()
    label = f"{name} n={n}"
    assert_close(got, np.asarray(jspec.pallas(*jargs)), rtol=tspec.rtol,
                 name=f"{label} vs pallas")
    joracle = np.asarray(jspec.run_oracle(*jargs))
    assert_close(got, joracle, rtol=tspec.rtol, name=f"{label} vs oracle")
    assert_close(tspec.run_oracle(*targs).numpy(), joracle,
                 rtol=tspec.rtol, name=f"{label} oracles")


def test_fft_tables_are_the_references():
    for n in (2, 64, 1024):
        for t, j in zip(tfft.fft_tables(n), jfft_tables(n)):
            np.testing.assert_array_equal(t, j)
            assert t.dtype == j.dtype


@pytest.mark.parametrize("n", [64, 256, 1024])
def test_fft_plain_matches_pallas_and_oracle(n):
    """K7 at rtol 1e-3; at 1024 points against the oracle only (the
    interpret-mode kernel is slow there)."""
    targs, jargs = _same_case("fft", n, 300 + n)
    got = tfft.fft_fused(*targs)
    want = jref.fft(*jargs)
    for g, w, part in zip(got, want, ("re", "im")):
        assert_close(g.numpy(), np.asarray(w), rtol=1e-3,
                     name=f"fft n={n} {part} vs oracle")
    for g, w in zip(tref.fft(*targs), want):
        assert_close(g.numpy(), np.asarray(w), rtol=1e-3, name="oracles")
    if n <= 256:
        for g, w, part in zip(got, fft_pallas(*jargs), ("re", "im")):
            assert_close(g.numpy(), np.asarray(w), rtol=1e-3,
                         name=f"fft n={n} {part} vs pallas")


@pytest.mark.parametrize("n", [8, 12])
def test_pusch_fft_plain_matches_pallas_and_oracle(n):
    tspec, jspec = TK.get("pusch_fft"), RK.get("pusch_fft")
    assert tspec.rtol == jspec.rtol == 1e-3
    targs, jargs = _same_case("pusch_fft", n, 400 + n)
    got = tspec.kernel(*targs).numpy()
    assert got.shape == (2, 2, n + 4, 64)
    assert_close(got, np.asarray(jspec.pallas(*jargs)), rtol=1e-3,
                 name=f"pusch_fft n={n} vs pallas")
    assert_close(got, np.asarray(jspec.run_oracle(*jargs)), rtol=1e-3,
                 name=f"pusch_fft n={n} vs oracle")


@pytest.mark.parametrize("name", ["svd", "svd_factor"])
@pytest.mark.parametrize("n", [8, 12])
def test_svd_plain_matches_pallas_by_spectrum_and_reconstruction(name, n):
    """K8 (and its packed stage adapter): the sorted spectrum and the
    reconstruction U diag(s) V^T of the port's conformance adapter
    against the reference's adapter (Pallas, interpret mode) and
    oracle, at svd_rtol = 4 sqrt(eps_f32)."""
    tspec, jspec = TK.get(name), RK.get(name)
    rtol = tspec.rtol
    assert rtol == jspec.rtol == pytest.approx(
        4 * np.sqrt(np.finfo(np.float32).eps))
    targs, jargs = _same_case(name, n, 500 + n)
    got = tspec.run_kernel(*targs)
    pallas = jspec.run_pallas(*jargs)
    oracle = jspec.run_oracle(*jargs)
    for g, p, o, part in zip(got, pallas, oracle, ("spectrum", "recon")):
        assert_close(g.numpy(), np.asarray(p), rtol=rtol,
                     name=f"{name} n={n} {part} vs pallas")
        assert_close(g.numpy(), np.asarray(o), rtol=rtol,
                     name=f"{name} n={n} {part} vs oracle")
    for g, o in zip(tspec.run_oracle(*targs), oracle):
        assert_close(_np(g), np.asarray(o), rtol=rtol, name="oracles")


def test_svd_factor_packs_u_v_s():
    a = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 12, 8)).astype(np.float32))
    f = tp.svd_factor_fused(a)
    u, s, v = tsvd.svd_fused(a, sweeps=14)
    assert f.shape == (2, 21, 8)
    assert torch.equal(f[:, :12], u)
    assert torch.equal(f[:, 12:20], v)
    assert torch.equal(f[:, 20], s)


# ---------------- fillers and guard cases ----------------

def _filler(name, n):
    spec = TK.get(name)
    case = spec.make_case(np.random.default_rng(0), n)
    shapes = tuple(tuple(a.shape[1:]) for a in case)
    dtypes = tuple(np.dtype("float32") for _ in case)
    lane = spec.filler(shapes, dtypes)
    want = RK.get(name).filler(shapes, dtypes)
    for g, w in zip(lane, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    return [torch.from_numpy(np.ascontiguousarray(a))[None] for a in lane]


@pytest.mark.parametrize("name", ["pusch_fft", "pusch_chanest",
                                  "pusch_chain", "svd_factor",
                                  "svd_apply"])
def test_fillers_are_the_references_and_benign(name):
    """Each stage's padding lane equals the reference's and serves to a
    finite answer; the channel-estimate, chain and apply fillers give
    exactly zero (orthonormal pilots or packed identity factors, zero
    observations)."""
    out = TK.get(name).kernel(*_filler(name, 8))
    assert torch.isfinite(out).all()
    if name in ("pusch_fft", "pusch_chanest", "pusch_chain", "svd_apply"):
        assert torch.equal(out, torch.zeros_like(out))


def test_svd_stays_finite_on_rank_deficient_input():
    """A rank-2 (12, 8) matrix and an all-zero one: the Jacobi guard
    (|gamma| <= 1e-12 sqrt(alpha beta) + 1e-30 keeps the identity
    rotation) and the 1e-30 floor on s keep every factor finite."""
    rng = np.random.default_rng(8)
    low = rng.standard_normal((1, 12, 2)) @ rng.standard_normal((1, 2, 8))
    a = torch.from_numpy(np.concatenate(
        [low, np.zeros((1, 12, 8))]).astype(np.float32))
    u, s, v = tsvd.svd_fused(a, sweeps=14)
    for t in (u, s, v):
        assert torch.isfinite(t).all()
    assert torch.equal(s[1], torch.zeros(8))
    recon = torch.einsum("bmn,bn,bkn->bmk", u, s, v)
    assert_close(recon.numpy(), a.numpy(), rtol=TK.get("svd").rtol,
                 name="rank-deficient reconstruction")
    assert int((s[0] > 1e-3 * s[0].max()).sum()) == 2


def test_fft_unit_impulse_gives_all_ones():
    xr = torch.zeros((3, 64))
    xr[:, 0] = 1.0
    re, im = tfft.fft_fused(xr, torch.zeros((3, 64)))
    assert torch.equal(re, torch.ones((3, 64)))
    assert torch.equal(im, torch.zeros((3, 64)))


def test_fft_refuses_non_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        tfft.fft_fused(torch.zeros((1, 48)), torch.zeros((1, 48)))


def test_plain_versions_do_not_depend_on_the_batch():
    """A lane's answer is bit-identical alone and inside a batch (the
    plain versions reduce in a fixed order), which the DAG's stage
    bit-identity rests on."""
    for name in ("pusch_fft", "pusch_chanest", "pusch_chain",
                 "svd_factor", "svd_apply"):
        spec = TK.get(name)
        args = spec.make_case(np.random.default_rng(9), 8)
        full = spec.kernel(*args)
        alone = spec.kernel(*(a[1:].contiguous() for a in args))
        assert torch.equal(full[1:], alone), name


def test_public_wrappers_run_on_the_cpu():
    rng = np.random.default_rng(10)
    a = rng.standard_normal((1, 12, 8)).astype(np.float32)
    b = rng.standard_normal((1, 12, 2)).astype(np.float32)
    f = tp.svd_factor(a, device="cpu")
    x = tp.svd_apply(f, b, device="cpu")
    assert_close(x.numpy(), np.asarray(jref.ridge_solve(
        jnp.asarray(a), jnp.asarray(b))), rtol=2e-3, name="svd_solve")
