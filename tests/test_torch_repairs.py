"""Three faults of the port against the JAX reference, each held here on
the CPU (their card faces are in ``tests/test_torch_gpu.py``):

1. ``ops.qr`` / K17 on a wide matrix (M < N): the reference runs
   min(N, M - 1) reflectors and masks R to its upper trapezoid;
2. the public names the reference's packages export (``repro.kernels``,
   ``repro.core``, ``repro.serve``), for every slice ported so far;
3. K1 (``cholesky_solve``) on bfloat16, at the reference's own case and
   rtol of 8e-2 (``tests/test_pipelines.py::test_cholesky_solve_bf16``).
"""
import importlib
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402
import repro.kernels  # noqa: E402
import repro.serve  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.common import sample_spd  # noqa: E402
from repro.kernels.qr import qr_pallas  # noqa: E402
from repro.pipelines.cholesky_solve import cholesky_solve_pallas  # noqa: E402
import repro_torch.core  # noqa: E402
import repro_torch.kernels  # noqa: E402
import repro_torch.serve  # noqa: E402
from repro_torch import pipelines as tp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

from conftest import assert_close  # noqa: E402

tqr = importlib.import_module("repro_torch.kernels.qr")


# ---------------- 1. wide QR ----------------

@pytest.mark.parametrize("shape", [(2, 4, 6), (3, 1, 5), (2, 5, 9)])
def test_qr_takes_a_wide_matrix(shape):
    """The reference's qr_pallas (interpret mode) and ops.qr on M < N:
    the port's Q (B, M, M) and R (B, M, N) equal them, R is zero below
    its diagonal and QR rebuilds A."""
    a = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    q, r = tops.qr(a, device="cpu")
    b, m, n = shape
    assert q.shape == (b, m, m) and r.shape == (b, m, n)
    jq, jr = qr_pallas(jnp.asarray(a), interpret=True)
    assert_close(q.numpy(), np.asarray(jq), rtol=1e-4, name="Q")
    assert_close(r.numpy(), np.asarray(jr), rtol=1e-4, name="R")
    oq, orr = jops.qr(jnp.asarray(a), backend="pallas")
    assert_close(r.numpy(), np.asarray(orr), rtol=1e-4, name="ops R")
    assert torch.all(torch.tril(r, -1) == 0)
    assert_close((q @ r).numpy(), a, rtol=1e-4, name="QR = A")
    assert torch.equal(tqr.qr_fused(torch.from_numpy(a))[1], r)


def test_svd_still_refuses_a_wide_matrix():
    with pytest.raises(ValueError):
        tops.svd(np.zeros((1, 4, 6), np.float32), device="cpu")


# ---------------- 2. public names ----------------

# names of a reference ``__all__`` whose slice is still to come
LATER = {
    "repro.kernels": set(),
    "repro.core": set(),
    "repro.serve": {"LaneShards", "ShardStats", "shard_stats"},  # shard
}
PACKAGES = [("repro.kernels", repro.kernels, repro_torch.kernels),
            ("repro.core", repro.core, repro_torch.core),
            ("repro.serve", repro.serve, repro_torch.serve)]


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in dir(mod) if not n.startswith("_")
                 and not n.isupper()]
    return list(names)


def _kind(obj):
    if inspect.ismodule(obj):
        return "module"
    if inspect.isclass(obj):
        return "class"
    if callable(obj):
        return "function"
    return type(obj).__name__


@pytest.mark.parametrize("label,ref,port", PACKAGES,
                         ids=[p[0] for p in PACKAGES])
def test_port_exports_what_the_reference_exports(label, ref, port):
    """Every name of the reference package's ``__all__`` (``repro.core``
    has none: its public names) is an object of the same kind in the
    port — a function, a class or a module — but the names listed in
    ``LATER``, whose slices are still to come."""
    missing, wrong = [], []
    for name in _public(ref):
        if name in LATER[label]:
            continue
        if not hasattr(port, name):
            missing.append(name)
        elif _kind(getattr(port, name)) != _kind(getattr(ref, name)):
            wrong.append((name, _kind(getattr(port, name)),
                          _kind(getattr(ref, name))))
    assert not missing, f"{label}: the port lacks {missing}"
    assert not wrong, f"{label}: kinds differ {wrong}"
    for name in LATER[label]:
        assert hasattr(ref, name)


def test_kernels_cholesky_is_the_function():
    """``repro_torch.kernels.cholesky`` is the ops function, as in the
    reference, and computes the reference's factor."""
    assert inspect.isfunction(repro_torch.kernels.cholesky)
    a = sample_spd(np.random.default_rng(0), 2, 8)
    got = repro_torch.kernels.cholesky(a, device="cpu")
    assert_close(got.numpy(), np.asarray(jref.cholesky(jnp.asarray(a))),
                 rtol=1e-4)
    assert "flash_attention" in repro_torch.kernels.__all__
    assert repro_torch.serve.DecodeEngine.__name__ == "DecodeEngine"
    assert repro_torch.core.command_count is not None


# ---------------- 3. bf16 K1 ----------------

def test_cholesky_solve_takes_bf16():
    """The reference's case: SPD a (2, 16, 16), two right-hand sides, in
    bf16 — the port solves in float32 and answers in bf16, within the
    reference's rtol of 8e-2 of the float32 oracle, as the reference's
    kernel is."""
    rng = np.random.default_rng(0)
    a = sample_spd(rng, 2, 16)
    rhs = rng.standard_normal((2, 16, 2)).astype(np.float32)
    got = tp.cholesky_solve_fused(torch.from_numpy(a).bfloat16(),
                                  torch.from_numpy(rhs).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == (2, 16, 2)
    want = np.asarray(jref.cholesky_solve(a, rhs))
    assert_close(got.float().numpy(), want, rtol=8e-2,
                 name="chol_solve-bf16")
    theirs = cholesky_solve_pallas(jnp.asarray(a, jnp.bfloat16),
                                   jnp.asarray(rhs, jnp.bfloat16))
    assert_close(np.asarray(theirs, np.float32), want, rtol=8e-2,
                 name="reference bf16")
