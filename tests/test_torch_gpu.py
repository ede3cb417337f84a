"""The hand-written Hopper kernels (K1-K4) on the card, held against
their plain PyTorch versions on the same card inputs.

Marked ``gpu``; every test takes the ``hopper`` fixture, which skips when
there is no compute-capability 9.0 card.  On the card:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as TK  # noqa: E402
from repro_torch import pipelines as tp  # noqa: E402
from repro_torch.kernels.common import KERNELS, on_hopper  # noqa: E402
from repro_torch.serve import ManualClock, SolverMux  # noqa: E402

from conftest import assert_close  # noqa: E402

pytestmark = pytest.mark.gpu

PAIRS = {"cholesky_solve": (tp.cholesky_solve_fused,
                            tp.cholesky_solve_plain),
         "mmse_equalize": (tp.mmse_equalize_fused, tp.mmse_equalize_plain),
         "mmse_equalize_split": (tp.mmse_equalize_split_fused,
                                 tp.mmse_equalize_split_plain),
         "qr_solve": (tp.qr_solve_fused, tp.qr_solve_plain)}
CASES = [("cholesky_solve", "cholesky_solve", "base"),
         ("qr_solve", "qr_solve", "base"),
         ("mmse_equalize", "mmse_equalize", "base"),
         ("mmse_equalize_split", "mmse_equalize", "split_complex")]


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if not on_hopper():
        pytest.skip(f"{torch.cuda.get_device_name(0)} is not a Hopper card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _variant(spec, name):
    return spec.base if name == "base" else next(
        v for v in spec.variants if v.name == name)


@pytest.mark.parametrize("kernel,spec_name,variant", CASES)
def test_kernel_matches_plain_version(hopper, kernel, spec_name, variant):
    fused, plain = PAIRS[kernel]
    spec = TK.get(spec_name)
    v = _variant(spec, variant)
    for n in v.sizes:
        args = [a.to(hopper) for a in v.make_case(
            np.random.default_rng(n), n)]
        before = next(k for k in KERNELS if k.name == kernel).launches
        got = fused(*args)
        torch.cuda.synchronize()
        assert next(k for k in KERNELS if k.name == kernel).launches \
            == before + 1
        assert_close(got.cpu().numpy(), plain(*args).cpu().numpy(),
                     rtol=spec.rtol, name=f"{kernel} n={n}")


def test_upper_triangle_is_never_read(hopper):
    a, b = (x.to(hopper) for x in TK.get("cholesky_solve").make_case(
        np.random.default_rng(0), 16))
    clean = tp.cholesky_solve_fused(a, b)
    poisoned = a.clone()
    iu = torch.triu_indices(16, 16, offset=1)
    poisoned[:, iu[0], iu[1]] = float("nan")
    assert torch.equal(tp.cholesky_solve_fused(poisoned, b), clean)


@pytest.mark.parametrize("name", ["cholesky_solve", "qr_solve",
                                  "mmse_equalize"])
def test_coalesced_corner_bit_identical_on_card(hopper, name):
    spec = TK.get(name)
    rng = np.random.default_rng(3)
    small = [a[0].numpy() for a in spec.make_case(rng, 8)]
    big = [a[0].numpy() for a in spec.make_case(rng, 12)]
    embedded = spec.coalesce.embed(small, tuple(a.shape for a in big))
    solo = spec.kernel(*(torch.from_numpy(a[None]).to(hopper)
                         for a in small))[0].cpu().numpy()
    out = spec.kernel(*(torch.from_numpy(np.stack([e, b])).to(hopper)
                        for e, b in zip(embedded, big)))[0].cpu().numpy()
    got = spec.coalesce.extract(out, tuple(a.shape for a in small))
    np.testing.assert_array_equal(got, solo)


def test_lane_too_large_for_shared_memory_raises(hopper):
    a = torch.eye(256, device=hopper)[None].contiguous()
    b = torch.ones((1, 256, 1), device=hopper)
    with pytest.raises(ValueError, match="shared memory"):
        tp.cholesky_solve_fused(a, b)


def test_mux_serves_every_kernel_on_card(hopper):
    from repro_torch.launch.serve_solvers import build_slot_jobs
    for k in KERNELS:
        k.launches = 0
    mux = SolverMux(lanes=8, clock=ManualClock())
    rng = np.random.default_rng(0)
    jobs = []
    for slot in range(4):
        for pipeline, arrays, priority in build_slot_jobs(rng, slot, [8]):
            jobs.append(mux.submit(pipeline, *arrays, priority=priority))
    mux.run()
    assert all(j.state == "done" for j in jobs)
    assert all(k.launches > 0 for k in KERNELS)
    for job in jobs:
        want = TK.get(job.pipeline).run_oracle_lane(*job.args)
        assert_close(job.out, want, rtol=1e-4, name=job.pipeline)
