"""The hand-written Hopper kernels (K1-K9) on the card, held against
their plain PyTorch versions on the same card inputs, and the served
DAGs' golden replay on the card.

Marked ``gpu``; every test takes the ``hopper`` fixture, which skips when
there is no compute-capability 9.0 card.  On the card:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as TK  # noqa: E402
from repro_torch import pipelines as tp  # noqa: E402
from repro_torch.kernels import fft as tfft  # noqa: E402
from repro_torch.kernels import svd as tsvd  # noqa: E402
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
    assert all(k.launches > 0 for k in KERNELS if k.name in PAIRS)
    for job in jobs:
        want = TK.get(job.pipeline).run_oracle_lane(*job.args)
        assert_close(job.out, want, rtol=1e-4, name=job.pipeline)


# ---------------- the DAG slice: K5-K9 ----------------

DAG_PAIRS = {
    "channel_estimate": ("pusch_chanest", tp.channel_estimate_fused,
                         tp.channel_estimate_plain),
    "pusch_chain": ("pusch_chain", tp.pusch_chain_fused,
                    tp.pusch_chain_plain),
    "fft": ("pusch_fft", tp.pusch_fft_fused, tp.pusch_fft_plain),
    "svd_apply": ("svd_apply", tp.svd_apply_fused, tp.svd_apply_plain),
}


def _launches(kernel):
    return next(k for k in KERNELS if k.name == kernel).launches


@pytest.mark.parametrize("kernel", sorted(DAG_PAIRS))
def test_dag_kernel_matches_plain_version(hopper, kernel):
    spec_name, fused, plain = DAG_PAIRS[kernel]
    spec = TK.get(spec_name)
    for n in spec.sizes:
        args = [a.to(hopper) for a in spec.make_case(
            np.random.default_rng(n), n)]
        before = _launches(kernel)
        got = fused(*args)
        torch.cuda.synchronize()
        assert _launches(kernel) == before + 1
        assert_close(got.cpu().numpy(), plain(*args).cpu().numpy(),
                     rtol=spec.rtol, name=f"{kernel} n={n}")


@pytest.mark.parametrize("n", [64, 128, 256, 1024])
def test_fft_kernel_matches_plain_version(hopper, n):
    args = [a.to(hopper) for a in TK.get("fft").make_case(
        np.random.default_rng(n), n)]
    for g, w in zip(tfft.fft_fused(*args), tfft.fft_plain(*args)):
        assert_close(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-3,
                     name=f"fft n={n}")


@pytest.mark.parametrize("name", ["svd", "svd_factor"])
def test_svd_kernel_matches_plain_by_spectrum_and_reconstruction(hopper,
                                                                  name):
    spec = TK.get(name)
    for n in spec.sizes:
        (a,) = (x.to(hopper) for x in spec.make_case(
            np.random.default_rng(n), n))
        before = _launches("svd")
        got = spec.run_kernel(a)
        assert _launches("svd") == before + 1
        want = tsvd.spectrum_recon(*tsvd.svd_plain(a, sweeps=14))
        for g, w in zip(got, want):
            assert_close(g.cpu().numpy(), w.cpu().numpy(), rtol=spec.rtol,
                         name=f"{name} n={n}")


def test_dag_guard_cases_on_card(hopper):
    xp = torch.eye(8, 16, device=hopper)[None].contiguous()
    assert torch.equal(tp.channel_estimate_fused(
        xp, torch.zeros((1, 12, 16), device=hopper)),
        torch.zeros((1, 12, 8), device=hopper))
    impulse = torch.zeros((2, 64), device=hopper)
    impulse[:, 0] = 1.0
    re, im = tfft.fft_fused(impulse, torch.zeros_like(impulse))
    assert torch.equal(re, torch.ones_like(re))
    assert torch.equal(im, torch.zeros_like(im))
    rank2 = torch.ones((1, 12, 8), device=hopper)
    rank2[:, :, 4:] = 2.0
    assert all(torch.isfinite(t).all() for t in tsvd.svd_fused(rank2, 14))


def test_pusch_golden_replay_on_card(hopper):
    from repro_torch.launch.serve_solvers import replay_pusch
    data = pathlib.Path(__file__).parent / "data"
    trace = json.loads((data / "pusch_trace.json").read_text())
    before = {k.name: k.launches for k in KERNELS}
    mux, dags = replay_pusch(trace)
    assert mux.device.type == "cuda"
    got = json.dumps(mux.drain_events(), indent=1) + "\n"
    assert got == (data / "pusch_golden.json").read_text()
    for d in dags:
        assert d.state == "done"
        assert_close(d.out, d.spec.oracle(*d.args), rtol=d.spec.rtol,
                     name=d.dag)
    for name in ("fft", "channel_estimate", "mmse_equalize", "svd",
                 "svd_apply"):
        assert next(k for k in KERNELS if k.name == name).launches \
            > before[name]
