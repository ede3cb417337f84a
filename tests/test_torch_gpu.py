"""The hand-written Hopper kernels (K1-K21) on the card, held against
their plain PyTorch versions on the same card inputs, K1-K4 and K15-K17
on lanes past shared memory (their global form; K1-K4's panel chains bit
for bit their shared forms at every panel width; K16's warp form bit for
bit its CTA form), the tiled K12-K14 with
slabs streamed past shared memory (K11-K14 under every cluster form bit
for bit), the served DAGs' golden replay, the
launch counts of the unfused baselines and the DSP chain, K17 on a wide
matrix and K1 on bf16, K18 and K20 at their registry cases and the LM
shapes (K18's bf16 tensor-core form and float32 SIMT form at ragged,
long-k and many-wave shapes; K20's bf16 tensor-core form and float32
SIMT form at ragged and narrow shapes and at the full-width prefill
shapes, and its strided route equal bit for bit to the contiguous one),
the smoke model's prefill on K20 (every bf16 launch in the tensor-core
form) and the decode golden replay on the card; K21 at its registry
case, at zamba2-2.7b's and xlstm-125m's prefill shapes and at 16
chunks, every cluster form bit for bit the plan's, its phase stamps, and
the hybrid and xLSTM smoke prefills with their exact K21 and K20 launch
counts; K7 equal to its plain version bit for bit at every size from 2
to 16384 points (the warp route up to 1024, the wide route past it), at
the PUSCH DAG's rows in the stacked layout and on non-finite inputs; K8
under every plan bit for bit (zero, rank-2 and NaN lanes; a lane alone
and in a batch; svd_factor and svd) and its phase stamps; K3's and K6's
warp forms (a lane on a warp, n <= 32) bit for bit their CTA forms at
every slot-mix and DAG size and batch, odd sizes and every right-hand
side instance, deficient, zero and NaN lanes, K3's global form still
its warp form's bits, the C entries' refusals and lane bytes, and the
warp forms' phase stamps; K2's and K5's warp forms and K2's wide form (a
lane on a CTA of W warps, 32 < n <= 168) bit for bit their CTA forms at
every edge shape, W and right-hand-side instance, deficient, zero and
NaN lanes, within rtol of their plain versions, their refusals, lane
bytes and phase stamps.

Marked ``gpu``; every test takes the ``hopper`` fixture, which skips when
there is no compute-capability 9.0 card.  On the card:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

(``-k flash`` for K20's cases alone, ``-k gemm`` for K18's, ``-k fft``
for K7's, ``-k "warp or wide or lane_phase"`` for the warp forms of K2,
K3, K5 and K6 and K2's wide form.)
"""
import ctypes
import importlib
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as TK  # noqa: E402
from repro_torch import pipelines as tp  # noqa: E402
tchol = importlib.import_module("repro_torch.kernels.cholesky")
tfft = importlib.import_module("repro_torch.kernels.fft")
tfir = importlib.import_module("repro_torch.kernels.fir")
tqr = importlib.import_module("repro_torch.kernels.qr")
tsvd = importlib.import_module("repro_torch.kernels.svd")
ttri = importlib.import_module("repro_torch.kernels.trisolve")
from repro_torch.kernels import common  # noqa: E402
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


def test_lane_past_shared_memory_runs_global_form(hopper):
    """An n = 256 lane is more than a CTA's shared memory: K1 takes the
    global form (the lane in a device work buffer) and agrees with its
    plain version."""
    a = torch.eye(256, device=hopper)[None].contiguous()
    b = torch.ones((1, 256, 1), device=hopper)
    k1 = next(k for k in KERNELS if k.name == "cholesky_solve")
    before = (k1.launches, k1.launches_global)
    got = tp.cholesky_solve_fused(a, b)
    torch.cuda.synchronize()
    assert (k1.launches, k1.launches_global) == (before[0] + 1,
                                                 before[1] + 1)
    assert torch.equal(got, tp.cholesky_solve_plain(a, b))


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
    slot_mix = ("cholesky_solve", "mmse_equalize", "mmse_equalize_split",
                "qr_solve")
    assert all(_launches(name) > 0 for name in slot_mix)
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


FFT_SIZES = [2 ** k for k in range(1, 15)]
PUSCH_LANES, PUSCH_ANTENNAS = 3276, 36     # a carrier's lanes, n = 32 + 4


def _fft_rows(seed, shape, device):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device) for _ in range(2))


def _equal_nan_where_nan(got, want):
    """Bit for bit where ``want`` is a number, NaN where it is NaN."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) \
        and torch.equal(got[~nan], want[~nan])


@pytest.mark.parametrize("rows", [1, 7, 3276])
@pytest.mark.parametrize("n", FFT_SIZES)
def test_fft_kernel_equals_plain_bit_for_bit(hopper, n, rows):
    """K7's stages in registers round every product and sum as the plain
    version does: equal, not close, at every size it compiles."""
    xr, xi = _fft_rows(n + rows, (rows, n), hopper)
    before = _launches("fft")
    got = tfft.fft_fused(xr, xi)
    torch.cuda.synchronize()
    assert _launches("fft") == before + 1
    for g, w in zip(got, tfft.fft_plain(xr, xi)):
        assert torch.equal(g, w), f"fft n={n} rows={rows}"


def test_fft_kernel_equals_plain_bit_for_bit_at_the_pusch_rows(hopper):
    """The DAG's shape: 3276 x 36 rows of 64 points."""
    xr, xi = _fft_rows(64, (PUSCH_LANES * PUSCH_ANTENNAS, 64), hopper)
    before = _launches("fft")
    got = tfft.fft_fused(xr, xi)
    torch.cuda.synchronize()
    assert _launches("fft") == before + 1
    for g, w in zip(got, tfft.fft_plain(xr, xi)):
        assert torch.equal(g, w)


def test_pusch_fft_equals_plain_bit_for_bit_in_the_stacked_layout(hopper):
    """pusch_fft_fused writes the (B, 2, A, 64) planes in place."""
    xr, xi = _fft_rows(65, (PUSCH_LANES, PUSCH_ANTENNAS, 64), hopper)
    before = _launches("fft")
    got = tp.pusch_fft_fused(xr, xi)
    torch.cuda.synchronize()
    assert _launches("fft") == before + 1
    assert got.shape == (PUSCH_LANES, 2, PUSCH_ANTENNAS, 64)
    assert torch.equal(got, tp.pusch_fft_plain(xr, xi))


@pytest.mark.parametrize("n", [2, 64, 1024, 4096])
def test_fft_kernel_spreads_non_finite_inputs_as_plain(hopper, n):
    """inf and NaN inputs (the table's exact 1 and 0 multiplied too):
    the kernel's output is the plain version's, NaN where NaN."""
    xr, xi = _fft_rows(n + 1, (6, n), hopper)
    xr[0, 1] = float("inf")
    xi[1, n - 1] = float("nan")
    xr[2, 0], xi[2, 0] = float("-inf"), float("inf")
    xr[3] = float("inf")
    before = _launches("fft")
    got = tfft.fft_fused(xr, xi)
    torch.cuda.synchronize()
    assert _launches("fft") == before + 1
    want = tfft.fft_plain(xr, xi)
    assert any(torch.isnan(w).any() for w in want)
    for g, w in zip(got, want):
        assert _equal_nan_where_nan(g, w)
        assert torch.equal(g[5], w[5])            # a clean row untouched


@pytest.mark.parametrize("n", [2, 64, 1024, 4096])
def test_fft_kernel_takes_rows_off_16_byte_alignment(hopper, n):
    """Rows that start 4 bytes past an allocation: staged rows (cp.async
    copies 16 bytes) are copied to an aligned tensor first; rows loaded
    straight into registers are read where they are."""
    flat = _fft_rows(n + 2, (3 * n + 1,), hopper)
    xr, xi = (f[1:].view(3, n) for f in flat)
    assert xr.data_ptr() % 16 and xi.data_ptr() % 16
    before = _launches("fft")
    got = tfft.fft_fused(xr, xi)
    torch.cuda.synchronize()
    assert _launches("fft") == before + 1
    for g, w in zip(got, tfft.fft_plain(xr, xi)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [2 * tfft.MAX_POINTS, 48])
def test_fft_kernel_refuses_rows_past_its_plans(hopper, n):
    """A row no plan covers is refused before any launch."""
    before = _launches("fft")
    with pytest.raises(ValueError):
        tfft.fft_fused(*_fft_rows(0, (2, n), hopper))
    assert _launches("fft") == before


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


# K8 on its plans: (n, lanes) at which every form of svd_forms (each group
# size) must give the same bits: the svd_solve DAG's served shapes, 64
# lanes of the slot mixes' largest n and an odd n; m = n + 4
SVD_FORM_CASES = [(24, 32), (8, 4), (32, 64), (13, 8)]


def _svd_lanes(dev, n, b, seed):
    """b >= 4 lanes at (n + 4) x n: lane 1 zero, lane 2 rank 2, lane 3 a
    NaN; the others Gaussian (numpy seed)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, n + 4, n)).astype(np.float32)
    a[1] = 0.0
    a[2] = rng.standard_normal((n + 4, 2)) @ rng.standard_normal((2, n))
    a[3, n // 3, n // 5] = np.nan
    return torch.from_numpy(a).to(dev)


@pytest.mark.parametrize("n,b", SVD_FORM_CASES)
def test_svd_forms_equal_bit_for_bit(hopper, n, b):
    """K8 under every plan of svd_forms gives one U, S and V bit for bit,
    each one launch; a lane alone gives its bits in the batch; the DAG
    stage (svd_factor) gives svd's bits; the clean lanes match the plain
    version by spectrum and reconstruction at the spec's rtol, the zero
    lane gives s = 0 exactly, the rank-2 lane stays finite."""
    a = _svd_lanes(hopper, n, b, seed=n + b)
    forms = tsvd.svd_forms(n + 4, n)
    assert {p.group for p in forms} == set(tsvd.SVD_GROUPS)
    assert {p.cache for p in forms} == {0, -(-(n + 4) // 32)}
    outs = []
    for plan in forms:
        before = _launches("svd")
        outs.append(tsvd.svd_fused(a, 14, plan=plan))
        torch.cuda.synchronize()
        assert _launches("svd") == before + 1
    for plan, out in zip(forms, outs):
        for x, y in zip(out, outs[0]):
            assert torch.equal(_bits(x), _bits(y)), str(plan)
    u, s, v = outs[0]
    alone = tsvd.svd_fused(a[2:3].contiguous(), 14)
    for x, y in zip(alone, (u[2:3], s[2:3], v[2:3])):
        assert torch.equal(_bits(x), _bits(y))
    f = tp.svd_factor_fused(a, sweeps=14)
    for x, y in zip(tp.unpack_factors(f), (u, s, v)):
        assert torch.equal(_bits(x), _bits(y))
    clean = [i for i in range(b) if i not in (1, 2, 3)]
    rtol = TK.get("svd").rtol
    got = tsvd.spectrum_recon(u[clean], s[clean], v[clean])
    want = tsvd.spectrum_recon(*tsvd.svd_plain(a[clean], sweeps=14))
    for g, w in zip(got, want):
        assert_close(g.cpu().numpy(), w.cpu().numpy(), rtol=rtol,
                     name=f"svd n={n} B={b}")
    assert torch.equal(s[1], torch.zeros_like(s[1]))
    assert all(bool(torch.isfinite(t[2]).all()) for t in (u, s, v))


def test_svd_plan_refused_off_its_forms(hopper):
    """A plan that is not one of the shape's forms raises before any
    launch; the C entry refuses threads off svd_threads and held rows off
    m's row blocks."""
    a = _svd_lanes(hopper, 8, 4, seed=1)
    before = _launches("svd")
    with pytest.raises(ValueError, match="not a form"):
        tsvd.svd_fused(a, 14, plan=tsvd.SvdPlan(64, 128, 0))
    with pytest.raises(ValueError, match="not a form"):
        tsvd.svd_fused(a, 14, plan=tsvd.SvdPlan(8, 64, 0))
    assert _launches("svd") == before
    u, s, v = (torch.empty_like(x) for x in tsvd.svd_fused(a, 14))
    with pytest.raises(RuntimeError, match="launch failed"):
        tsvd._KERNEL.launch(hopper, (12, 8), a.data_ptr(), u.data_ptr(),
                            s.data_ptr(), v.data_ptr(), 4, 12, 8, 14, 96, 8,
                            64, 8, 64, 0)
    with pytest.raises(RuntimeError, match="launch failed"):
        tsvd._KERNEL.launch(hopper, (12, 8), a.data_ptr(), u.data_ptr(),
                            s.data_ptr(), v.data_ptr(), 4, 12, 8, 14, 96, 8,
                            64, 8, 32, 2)


@pytest.mark.parametrize("n,b", [(24, 32), (32, 64)])
def test_svd_phase_stamps_are_ordered_and_cover_the_kernel(hopper, n, b):
    """The phase-stamped instance gives the served bits on every form;
    each lane's stamps are ordered and its phases add up to its time."""
    a = _svd_lanes(hopper, n, b, seed=5)
    for plan in tsvd.svd_forms(n + 4, n):
        before = _launches("svd")
        factors, stamps = tsvd.svd_phases(a, 14, plan=plan)
        torch.cuda.synchronize()
        assert _launches("svd") == before
        for x, y in zip(factors, tsvd.svd_fused(a, 14, plan=plan)):
            assert torch.equal(_bits(x), _bits(y))
        st = stamps.cpu()
        assert st.shape == (b, 2 + len(tsvd.SVD_PHASES))
        assert bool((st[:, 1] > st[:, 0]).all() and (st[:, 2:] >= 0).all())
        assert torch.equal(st[:, 2:].sum(dim=1), st[:, 1] - st[:, 0])


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


# ---------------- the mid-range slice: K10, K11, K1-K4 past smem --------

# At n >= 128 the reference holds blocked QR to 1e-3 (tests/test_variants
# .py); the MMSE Gram at m = n + 4 has condition ~9.4e3 at n = 256, where
# fp32 solves differ from float64 by ~1.5e-4, so MMSE past shared memory
# is held to 1e-3, the serving spot check's tolerance.
MID_RTOL = 1e-3
BLOCKED = {"cholesky_solve_blocked": ("cholesky_solve",
                                      tp.cholesky_solve_blocked_fused,
                                      tp.cholesky_solve_blocked_plain, 1e-4),
           "qr_solve_blocked": ("qr_solve", tp.qr_solve_blocked_fused,
                                tp.qr_solve_blocked_plain, MID_RTOL)}


def _card_case(dev, key, b, n, m=None, seed=0):
    """The mid-range slot mix's per-lane shapes (m = n + 4, k = 2; k = 1
    for QR; SPD systems as sample_spd makes them), from a seeded numpy
    generator."""
    rng = np.random.default_rng(seed)
    m = n + 4 if m is None else m
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev)
    if key.startswith("cholesky_solve"):
        from repro_torch.kernels.common import sample_spd
        return torch.from_numpy(sample_spd(rng, b, n)).to(dev), f(b, n, 2)
    if key.startswith("qr_solve"):
        return f(b, m, n), f(b, m, 1)
    if key == "mmse_equalize":
        return f(b, m, n), f(b, m, 2)
    return f(b, m, n), f(b, m, n), f(b, m, 2), f(b, m, 2)


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("kernel", sorted(BLOCKED))
def test_blocked_kernel_matches_plain_version(hopper, kernel, n):
    spec_name, fused, plain, rtol = BLOCKED[kernel]
    spec = TK.get(spec_name)
    v = next(v for v in spec.variants if v.name == "blocked")
    assert n in v.sizes
    args = [a.to(hopper) for a in spec.make_case(np.random.default_rng(n),
                                                 n)]
    assert spec.dispatch_key(tuple(tuple(a.shape[1:]) for a in args),
                             ("float32",) * 2).name == "blocked"
    for bs in (32, 64):
        before = _launches(kernel)
        got = fused(*args, bs=bs)
        torch.cuda.synchronize()
        assert _launches(kernel) == before + 1
        assert_close(got.cpu().numpy(), plain(*args, bs=bs).cpu().numpy(),
                     rtol=rtol, name=f"{kernel} n={n} bs={bs}")


def test_blocked_qr_tall_shape_matches_plain_version(hopper):
    """The reference's tall blocked shape (tests/test_variants.py):
    m = 160, n = 128, at both panel widths."""
    rng = np.random.default_rng(160)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(hopper) for s in ((4, 160, 128), (4, 160, 2)))
    for bs in (32, 64):
        got = tp.qr_solve_blocked_fused(a, b, bs=bs)
        assert_close(got.cpu().numpy(),
                     tp.qr_solve_blocked_plain(a, b, bs=bs).cpu().numpy(),
                     rtol=MID_RTOL, name=f"qr_solve_blocked 160x128 bs={bs}")


@pytest.mark.parametrize("kernel,n", [("cholesky_solve", 128),
                                      ("cholesky_solve", 97),
                                      ("cholesky_solve", 200),
                                      ("mmse_equalize", 128),
                                      ("mmse_equalize", 100),
                                      ("mmse_equalize_split", 96),
                                      ("mmse_equalize_split", 90),
                                      ("qr_solve", 128)])
def test_global_form_equals_shared_form_bit_for_bit(hopper, monkeypatch,
                                                    kernel, n):
    """At a size where a lane fits in shared memory, the shared form
    agrees with the plain version, and the global form (forced by a
    shared-memory limit of 0) gives its answer bit for bit: the same op
    order, only the memory differs (K1-K3's global form runs the panel
    chain, whose panels need not tile n)."""
    fused, plain = PAIRS[kernel]
    args = _card_case(hopper, kernel, 64, n, seed=n)
    k = next(k for k in KERNELS if k.name == kernel)
    before = k.launches_global
    shared = fused(*args)
    assert k.launches_global == before
    rtol = 1e-4 if kernel == "cholesky_solve" else MID_RTOL
    assert_close(shared.cpu().numpy(), plain(*args).cpu().numpy(),
                 rtol=rtol, name=f"{kernel} shared n={n}")
    monkeypatch.setattr(common, "MAX_SMEM_BYTES", 0)
    glob = fused(*args)
    torch.cuda.synchronize()
    assert k.launches_global == before + 1
    assert torch.equal(shared, glob)


def _panel_width_case(dev, n, b=8):
    """K1 systems at n whose lanes hold a rank-deficient pivot inside a
    later panel (lane 1: row 150 of X copies row 3 before X X^T, so pivot
    150 lies in the fifth 32-wide panel) and NaN in the upper triangle
    (lane 2), beside well-posed lanes."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((b, n, n + 16)).astype(np.float32)
    x[1, 150] = x[1, 3]
    a = x @ x.swapaxes(-1, -2)
    a[[0] + list(range(2, b))] += n * np.eye(n, dtype=np.float32)
    iu = np.triu_indices(n, 1)
    a[2][iu] = np.nan
    return (torch.from_numpy(a).to(dev),
            torch.from_numpy(rng.standard_normal((b, n, 2)).astype(
                np.float32)).to(dev))


def test_global_form_bit_for_bit_at_every_panel_width(hopper, monkeypatch):
    """K1's global form at n = 200 under each panel width bs in {1, 8, 16,
    32, 64} (1 is the per-column chain; 8 and 16 leave a ragged last
    panel) gives the shared form's bits, on lanes with a rank-deficient
    pivot inside a later panel and with NaN in the upper triangle; the
    poisoned lane solves to its clean copy's bits and every lane stays
    finite."""
    n = 200
    a, b = _panel_width_case(hopper, n)
    k = next(k for k in KERNELS if k.name == "cholesky_solve")
    shared = tp.cholesky_solve_fused(a, b)
    clean = a.clone()
    clean[2] = torch.tril(a[2]) + torch.tril(a[2], -1).mT
    assert torch.equal(shared, tp.cholesky_solve_fused(clean, b))
    assert bool(torch.isfinite(shared).all())
    monkeypatch.setattr(common, "MAX_SMEM_BYTES", 0)
    C = importlib.import_module("repro_torch.pipelines.cholesky_solve")
    for bs in (1, 8, 16, 32, 64):
        monkeypatch.setattr(C, "PANEL_WIDTH", bs)
        assert tp.chol_panel_plan(n, 2).bs == bs
        before = k.launches_global
        glob = tp.cholesky_solve_fused(a, b)
        torch.cuda.synchronize()
        assert k.launches_global == before + 1
        assert torch.equal(shared, glob), f"bs={bs}"


def test_global_form_refuses_a_plan_it_was_not_compiled_for(hopper,
                                                           monkeypatch):
    """The C entry checks the plan it is given: a panel width past the
    compiled widest (64), or shared-memory bytes off the formula, raise;
    its global shared-memory queries are the plan's formula."""
    a, b = _card_case(hopper, "cholesky_solve", 2, 64, seed=1)
    monkeypatch.setattr(common, "MAX_SMEM_BYTES", 0)
    C = importlib.import_module("repro_torch.pipelines.cholesky_solve")
    plan = C.chol_panel_plan(64, 2)
    with monkeypatch.context() as mp:
        mp.setattr(C, "PANEL_WIDTH", 128)
        with pytest.raises(RuntimeError, match="launch failed"):
            tp.cholesky_solve_fused(a, b)
    with monkeypatch.context() as mp:
        mp.setattr(C, "chol_panel_plan", lambda n, m: plan._replace(
            smem_bytes=plan.smem_bytes + 4))
        with pytest.raises(RuntimeError, match="launch failed"):
            tp.cholesky_solve_fused(a, b)
    lib = common.load_library()
    for name, dims in (("cholesky_solve_global_smem", (64, 2)),
                       ("mmse_equalize_global_smem", (68, 64, 2)),
                       ("mmse_equalize_split_global_smem", (68, 32, 2))):
        q = getattr(lib, name)
        q.restype = ctypes.c_size_t
        for bs in (1, 16, 32):
            assert q(*dims, bs) == C.chol_panel_smem(64, 2, bs), name


def _bits(t):
    """A float32 tensor's bits: equal bits are equal values, NaN too."""
    return t.contiguous().view(torch.int32)


def _qr_special_lanes(dev, n, b=8):
    """K4 lanes at (n + 4) x n: lane 1 has column 150 (or 3n/4) a copy of
    column 3 (a deficient pivot inside a later panel), lane 2 an exact
    zero column, lane 3 a NaN; the others Gaussian."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal((b, n + 4, n)).astype(np.float32)
    a[1, :, min(150, 3 * n // 4)] = a[1, :, 3]
    a[2, :, n // 2] = 0.0
    a[3, n // 3, n // 5] = np.nan
    return (torch.from_numpy(a).to(dev),
            torch.from_numpy(rng.standard_normal((b, n + 4, 1)).astype(
                np.float32)).to(dev))


@pytest.mark.parametrize("n", [128, 200])
def test_qr_global_form_bit_for_bit_at_every_panel_width(hopper, monkeypatch,
                                                        n):
    """K4's global form (the panel chain) at (n + 4) x n under each panel
    width bs in {1, 8, 16, 32} and the plan's own (200 leaves ragged last
    panels) gives the shared form's bits on every lane, the deficient,
    zero-column and NaN lanes too; the lanes beside the NaN lane equal
    their clean batch's bit for bit, and they stay finite."""
    a, b = _qr_special_lanes(hopper, n)
    k = next(k for k in KERNELS if k.name == "qr_solve")
    shared = tp.qr_solve_fused(a, b)
    clean = a.clone()
    clean[3] = a[0]
    same = tp.qr_solve_fused(clean, b)
    keep = [i for i in range(a.shape[0]) if i != 3]
    assert torch.equal(shared[keep], same[keep])
    assert bool(torch.isfinite(shared[keep]).all())
    assert torch.equal(shared[2, n // 2], torch.zeros_like(shared[2, 0]))
    monkeypatch.setattr(common, "MAX_SMEM_BYTES", 0)
    Qm = importlib.import_module("repro_torch.pipelines.qr_solve")
    default = Qm.QR_PANEL_WIDTH
    for bs in (1, 8, 16, 32, default):
        monkeypatch.setattr(Qm, "QR_PANEL_WIDTH", bs)
        assert tp.qr_panel_plan(n + 4, n, 1).bs == bs
        before = k.launches_global
        glob = tp.qr_solve_fused(a, b)
        torch.cuda.synchronize()
        assert k.launches_global == before + 1
        assert torch.equal(_bits(shared), _bits(glob)), f"bs={bs}"


@pytest.mark.parametrize("tile", [1, 5, 32, 128])
def test_qr_global_form_bit_for_bit_at_every_tile_width(hopper,
                                                       monkeypatch, tile):
    """The tile width (a thread a column right of the panel; 1 and 5
    leave ragged tiles, 128 four warps) moves no bit either."""
    a, b = _card_case(hopper, "qr_solve", 16, 128, m=160, seed=7)
    shared = tp.qr_solve_fused(a, b)
    monkeypatch.setattr(common, "MAX_SMEM_BYTES", 0)
    Qm = importlib.import_module("repro_torch.pipelines.qr_solve")
    monkeypatch.setattr(Qm, "QR_TILE_WIDTH", tile)
    assert tp.qr_panel_plan(160, 128, 1).tile == tile
    assert torch.equal(shared, tp.qr_solve_fused(a, b))


def test_qr_global_form_refuses_a_plan_it_was_not_compiled_for(hopper,
                                                              monkeypatch):
    """The C entry checks the plan it is given: a panel width past 32, a
    tile past 128, or shared-memory bytes off the formula, raise; its
    global shared-memory query is the plan's formula."""
    a, b = _card_case(hopper, "qr_solve", 2, 64, seed=1)
    monkeypatch.setattr(common, "MAX_SMEM_BYTES", 0)
    Qm = importlib.import_module("repro_torch.pipelines.qr_solve")
    plan = Qm.qr_panel_plan(68, 64, 1)
    for name, value in (("QR_PANEL_WIDTH", 64), ("QR_TILE_WIDTH", 256)):
        with monkeypatch.context() as mp:
            mp.setattr(Qm, name, value)
            with pytest.raises(RuntimeError, match="launch failed"):
                tp.qr_solve_fused(a, b)
    with monkeypatch.context() as mp:
        mp.setattr(Qm, "qr_panel_plan", lambda m, n, k: plan._replace(
            smem_bytes=plan.smem_bytes + 4))
        with pytest.raises(RuntimeError, match="launch failed"):
            tp.qr_solve_fused(a, b)
    q = common.load_library().qr_solve_global_smem
    q.restype = ctypes.c_size_t
    for bs, tile in ((1, 1), (16, 32), (32, 64), (32, 128)):
        assert q(68, 2, bs, tile) == Qm.qr_panel_smem(68, 2, bs, tile)


@pytest.mark.parametrize("kernel,n,m", [("cholesky_solve", 250, None),
                                        ("cholesky_solve", 1024, None),
                                        ("mmse_equalize", 256, None),
                                        ("mmse_equalize_split", 128, None),
                                        ("mmse_equalize_split", 256, None),
                                        ("qr_solve", 250, 254)])
def test_base_kernel_past_shared_memory_matches_plain(hopper, kernel, n, m):
    fused, plain = PAIRS[kernel]
    args = _card_case(hopper, kernel, 16, n, m, seed=n)
    k = next(k for k in KERNELS if k.name == kernel)
    before = k.launches_global
    got = fused(*args)
    torch.cuda.synchronize()
    assert k.launches_global == before + 1
    rtol = 1e-4 if kernel == "cholesky_solve" else MID_RTOL
    assert_close(got.cpu().numpy(), plain(*args).cpu().numpy(), rtol=rtol,
                 name=f"{kernel} global n={n}")


@pytest.mark.parametrize("name", ["cholesky_solve", "qr_solve"])
def test_coalesced_corner_bit_identical_in_blocked_bucket(hopper, name):
    """A 128 job embedded in a 256 blocked bucket's lane solves to exactly
    its solo blocked answer on the card (both at panel width 64)."""
    spec = TK.get(name)
    rng = np.random.default_rng(4)
    small = [a[0].numpy() for a in spec.make_case(rng, 128)]
    big = [a[0].numpy() for a in spec.make_case(rng, 256)]
    assert spec.dispatch_key(tuple(a.shape for a in big),
                             ("float32",) * 2).name == "blocked"
    embedded = spec.coalesce.embed(small, tuple(a.shape for a in big))
    fused = BLOCKED[f"{name}_blocked"][1]
    solo = fused(*(torch.from_numpy(a[None]).to(hopper)
                   for a in small))[0].cpu().numpy()
    out = fused(*(torch.from_numpy(np.stack([e, b])).to(hopper)
                  for e, b in zip(embedded, big)))[0].cpu().numpy()
    got = spec.coalesce.extract(out, tuple(a.shape for a in small))
    np.testing.assert_array_equal(got, solo)


def test_mux_serves_mid_range_mix_on_card(hopper):
    """The mid-range slot mix (n = 128 and 256) served on the card runs
    K10, K11 and the global forms of K2 and K3."""
    from repro_torch.launch.serve_solvers import build_slot_jobs
    for k in KERNELS:
        k.launches = k.launches_global = 0
    mux = SolverMux(lanes=4, clock=ManualClock())
    rng = np.random.default_rng(0)
    jobs = []
    for slot in range(2):
        for pipeline, arrays, priority in build_slot_jobs(rng, slot,
                                                          [128, 256]):
            jobs.append(mux.submit(pipeline, *arrays, priority=priority))
    mux.run()
    assert all(j.state == "done" for j in jobs)
    for name in ("cholesky_solve_blocked", "qr_solve_blocked",
                 "mmse_equalize", "mmse_equalize_split"):
        assert _launches(name) > 0, name
    for name in ("mmse_equalize", "mmse_equalize_split"):
        assert next(k for k in KERNELS
                    if k.name == name).launches_global > 0, name
    for job in jobs:
        want = TK.get(job.pipeline).run_oracle_lane(*job.args)
        assert_close(job.out, want, rtol=MID_RTOL, name=job.pipeline)


@pytest.mark.parametrize("n,bs", [(128, 16), (192, 48), (140, 35)])
@pytest.mark.parametrize("kernel", sorted(BLOCKED))
def test_blocked_kernel_takes_any_panel_width(hopper, kernel, n, bs):
    """K10's SYRK tiles and K11's reflector pairs cover a remainder: panel
    widths that are not multiples of 32 (an odd one too: K11's last pair
    holds one reflector) agree with the plain version."""
    _, fused, plain, rtol = BLOCKED[kernel]
    args = _card_case(hopper, kernel, 8, n, seed=bs)
    got = fused(*args, bs=bs)
    torch.cuda.synchronize()
    assert_close(got.cpu().numpy(), plain(*args, bs=bs).cpu().numpy(),
                 rtol=rtol, name=f"{kernel} n={n} bs={bs}")


# ---------------- the HBM-scale path: K12-K14 ----------------

# The reference's large-n tolerances (tests/test_tiled.py): the Cholesky
# kernel at 1e-4 of its plain version, QR and MMSE at 2e-3 for n >= 512.
TILED = {"cholesky_solve": ("cholesky_solve_tiled",
                            tp.cholesky_solve_tiled_fused,
                            tp.cholesky_solve_tiled_plain, 1e-4),
         "qr_solve": ("qr_solve_tiled", tp.qr_solve_tiled_fused,
                      tp.qr_solve_tiled_plain, 2e-3),
         "mmse_equalize": ("mmse_equalize_tiled",
                           tp.mmse_equalize_tiled_fused,
                           tp.mmse_equalize_tiled_plain, 2e-3)}


@pytest.mark.parametrize("n", [512, 1024])
@pytest.mark.parametrize("name", sorted(TILED))
def test_tiled_kernel_matches_plain_version(hopper, name, n):
    kernel, fused, plain, rtol = TILED[name]
    spec = TK.get(name)
    v = next(v for v in spec.variants if v.name == "tiled")
    assert n in v.sizes
    args = [a.to(hopper) for a in v.make_case(np.random.default_rng(n), n)]
    assert spec.dispatch_key(tuple(tuple(a.shape[1:]) for a in args),
                             ("float32",) * 2).name == "tiled"
    for bs in (128, 64):
        before = _launches(kernel)
        got = fused(*args, bs=bs)
        torch.cuda.synchronize()
        assert _launches(kernel) == before + 1
        assert_close(got.cpu().numpy(), plain(*args, bs=bs).cpu().numpy(),
                     rtol=rtol, name=f"{kernel} n={n} bs={bs}")


def test_tiled_cholesky_guards_on_card(hopper):
    """K12 never reads the upper triangle (NaN there leaves the answer bit
    for bit), and a deficient pivot in the third slab (column 300 repeats
    column 3) zeroes the components the plain version zeroes."""
    n = 512
    a, b = _card_case(hopper, "cholesky_solve", 2, n, seed=7)
    clean = tp.cholesky_solve_tiled_fused(a, b)
    poisoned = a.clone()
    iu = torch.triu_indices(n, n, offset=1)
    poisoned[:, iu[0], iu[1]] = float("nan")
    assert torch.equal(tp.cholesky_solve_tiled_fused(poisoned, b), clean)
    rng = np.random.default_rng(3)
    mm = rng.standard_normal((1, n, n)).astype(np.float32)
    mm[:, 300] = mm[:, 3]
    sys_a = torch.from_numpy(mm @ mm.transpose(0, 2, 1)).to(hopper)
    rhs = b[:1].contiguous()
    got = tp.cholesky_solve_tiled_fused(sys_a, rhs)
    want = tp.cholesky_solve_tiled_plain(sys_a, rhs)
    assert torch.isfinite(got).all()
    zeros = torch.all(got == 0, dim=-1)
    assert bool(zeros[0, 300])
    assert torch.equal(zeros, torch.all(want == 0, dim=-1))


# K13 (the tiled qr_solve) runs a lane on a cluster whose shared memory
# grows with m (the panel's row bands): tests/test_torch_qr_cluster.py
# holds its plans to the card's shared memory
@pytest.mark.parametrize("name", sorted(set(TILED) - {"qr_solve"}))
def test_tiled_shared_memory_is_independent_of_n(hopper, name):
    """A tiled CTA's dynamic shared memory depends on bs, k and the plan's
    product tile only, and fits a block at bs = 128 (every form of
    chol_tiled_forms, at n = 512 and 1024)."""
    kernel = TILED[name][0]
    smem = {n: {(p.tile, p.smem_bytes) for p in tp.chol_tiled_forms(
        n, 2, 128, kernel, None if name == "cholesky_solve" else n + 16)}
        for n in (512, 1024)}
    assert smem[512] == smem[1024]
    assert all(b <= common.MAX_SMEM_BYTES for _, b in smem[512])


# K12 and K14 on thread-block clusters: every plan of chol_tiled_forms
# (each cluster size and product tile) gives the same bits, at the served
# shapes, a tall channel and the odd slab widths
CHOL_TILED_CASES = [("mmse_equalize_tiled", 516, 512, 128),
                    ("mmse_equalize_tiled", 1028, 1024, 128),
                    ("mmse_equalize_tiled", 2052, 512, 128),
                    ("mmse_equalize_tiled", 516, 512, 64),
                    ("mmse_equalize_tiled", 516, 512, 32),
                    ("cholesky_solve_tiled", 512, 512, 128),
                    ("cholesky_solve_tiled", 1024, 1024, 128),
                    ("cholesky_solve_tiled", 512, 512, 64),
                    ("cholesky_solve_tiled", 512, 512, 32)]
CHOL_TILED_PAIRS = {
    "cholesky_solve_tiled": (tp.cholesky_solve_tiled_fused,
                             tp.cholesky_solve_tiled_plain, 1e-4),
    "mmse_equalize_tiled": (tp.mmse_equalize_tiled_fused,
                            tp.mmse_equalize_tiled_plain, 2e-3)}


def _chol_tiled_lanes(dev, kernel, m, n, seed):
    """Four lanes (numpy seed): K12 lane 1 rank-deficient (column 3n/5 of
    its factor repeats column 3), lane 2 lane 0 (its right-hand sides
    too) with NaN in its upper triangle; K14 lane 1 a channel whose
    column 3n/5 repeats column 3, lane 2 a NaN in H; the others clean."""
    rng = np.random.default_rng(seed)
    if kernel == "cholesky_solve_tiled":
        from repro_torch.kernels.common import sample_spd
        a = sample_spd(rng, 4, n)
        f = rng.standard_normal((n, n)).astype(np.float32)
        f[:, 3 * n // 5] = f[:, 3]
        a[1] = f @ f.T
        a[2] = a[0]
        iu = np.triu_indices(n, 1)
        a[2][iu] = np.nan
    else:
        a = rng.standard_normal((4, m, n)).astype(np.float32)
        a[1, :, 3 * n // 5] = a[1, :, 3]
        a[2, m // 3, n // 5] = np.nan
    b = rng.standard_normal((4, n if m is None else m, 2)).astype(np.float32)
    if kernel == "cholesky_solve_tiled":
        b[2] = b[0]
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


@pytest.mark.parametrize("kernel,m,n,bs", CHOL_TILED_CASES)
def test_chol_tiled_forms_equal_bit_for_bit(hopper, kernel, m, n, bs):
    """K12 / K14 under every plan of chol_tiled_forms give C = 1's answer
    bit for bit, each one launch; the clean lanes are within the spec's
    rtol of the plain version and the oracle; K12's poisoned upper
    triangle leaves its lane equal to the clean one, its deficient lane
    finite; K14's NaN lane leaves its neighbours equal to their clean
    batch's."""
    fused, plain, rtol = CHOL_TILED_PAIRS[kernel]
    k14 = kernel == "mmse_equalize_tiled"
    a, rhs = _chol_tiled_lanes(hopper, kernel, m if k14 else None, n,
                               seed=n + bs)
    forms = tp.chol_tiled_forms(n, 2, bs, kernel, m if k14 else None)
    assert {p.clusters for p in forms} == {1, 2, 4, 8}
    outs = []
    for plan in forms:
        before = _launches(kernel)
        outs.append(fused(a, rhs, bs=bs, plan=plan))
        torch.cuda.synchronize()
        assert _launches(kernel) == before + 1
    one = next(o for p, o in zip(forms, outs) if p.clusters == 1)
    for plan, out in zip(forms, outs):
        assert torch.equal(_bits(out), _bits(one)), str(plan)
    from repro_torch.kernels import ref
    clean = [0, 3]
    want = plain(a[clean], rhs[clean], bs=bs)
    assert_close(one[clean].cpu().numpy(), want.cpu().numpy(), rtol=rtol,
                 name=f"{kernel} {m}x{n} bs={bs}")
    oracle = (ref.mmse_equalize(a[clean], rhs[clean]) if k14
              else ref.cholesky_solve(a[clean], rhs[clean]))
    assert_close(one[clean].cpu().numpy(), oracle.cpu().numpy(), rtol=rtol,
                 name=f"{kernel} {m}x{n} oracle")
    assert bool(torch.isfinite(one[1]).all())
    if k14:
        again = fused(a[[0, 1, 3]].contiguous(), rhs[[0, 1, 3]].contiguous(),
                      bs=bs, plan=forms[0])
        assert torch.equal(_bits(one[[0, 1, 3]]), _bits(again))
    else:
        assert torch.equal(_bits(one[2]), _bits(one[0]))


def test_chol_tiled_plan_refused_off_its_forms(hopper):
    """A plan that is not one of the shape's forms raises before any
    launch; the C entry refuses bytes off its formula."""
    a, rhs = _card_case(hopper, "cholesky_solve", 2, 512, seed=3)
    plan = tp.chol_tiled_plan(2, 512, 2, 128)
    with pytest.raises(ValueError, match="not a form"):
        tp.cholesky_solve_tiled_fused(a, rhs, plan=plan._replace(tile=96))
    k = next(k for k in KERNELS if k.name == "cholesky_solve_tiled")
    x = torch.empty_like(rhs)
    work = torch.empty((2, 512, 512), device=hopper)
    with pytest.raises(RuntimeError, match="launch failed"):
        k.launch(hopper, (plan.smem_bytes,), a.data_ptr(), rhs.data_ptr(),
                 x.data_ptr(), work.data_ptr(), 2, 512, 2, 128, 1e-5,
                 plan.clusters, plan.tile, plan.smem_bytes + 4)


@pytest.mark.parametrize("kernel,m,n,b", [
    ("cholesky_solve_tiled", 512, 512, 32),
    ("mmse_equalize_tiled", 516, 512, 32)])
def test_chol_tiled_phase_stamps_are_ordered_and_cover_the_kernel(
        hopper, kernel, m, n, b):
    """The phase-stamped instance gives the served answer bit for bit on
    every form; each lane's stamps are ordered and its phases add up to
    its time."""
    CHm = importlib.import_module("repro_torch.pipelines.cholesky_solve")
    a, rhs = _card_case(hopper, kernel.removesuffix("_tiled"), b, n, m=m,
                        seed=5)
    mm = m if kernel == "mmse_equalize_tiled" else None
    for plan in tp.chol_tiled_forms(n, 2, 128, kernel, mm):
        before = _launches(kernel)
        x, stamps = CHm.chol_tiled_phases(kernel, a, rhs, plan=plan)
        torch.cuda.synchronize()
        assert _launches(kernel) == before
        assert torch.equal(x, CHOL_TILED_PAIRS[kernel][0](a, rhs, plan=plan))
        st = stamps.cpu()
        assert st.shape == (b, 2 + len(CHm.TILED_PHASES))
        assert bool((st[:, 1] > st[:, 0]).all() and (st[:, 2:] >= 0).all())
        assert torch.equal(st[:, 2:].sum(dim=1), st[:, 1] - st[:, 0])


# K10 on the tiled core's clusters: (n, bs, k) at which every plan of
# chol_tiled_forms gives C = 1's bits, the mid-range sizes at the default
# panel width, the panel widths 32, 16 and 48, and lanes of one panel (n =
# bs, no rows below it), the second past a CTA's room for right-hand sides
BLOCKED_CLUSTER_CASES = [
    pytest.param(n, bs, k, id=f"{n}-{bs}" + (f"-k{k}" if k != 2 else ""))
    for n, bs, k in ((128, 64, 2), (256, 64, 2), (128, 32, 2), (128, 16, 2),
                     (192, 48, 2), (128, 128, 2), (224, 224, 33))]


@pytest.mark.parametrize("n,bs,k", BLOCKED_CLUSTER_CASES)
def test_blocked_forms_equal_bit_for_bit(hopper, n, bs, k):
    """K10 under every plan of chol_tiled_forms gives C = 1's answer bit
    for bit, one launch a column group; the clean lanes are within the
    spec's rtol of the plain version; the poisoned upper triangle leaves
    its lane equal to the clean one, the deficient lane finite."""
    kernel = "cholesky_solve_blocked"
    a, rhs = _chol_tiled_lanes(hopper, "cholesky_solve_tiled", None, n,
                               seed=n + bs)
    if k != 2:
        rng = np.random.default_rng(n + bs + k)
        rhs = torch.from_numpy(rng.standard_normal((4, n, k))
                               .astype(np.float32)).to(hopper)
        rhs[2] = rhs[0]
    width, groups = tp.blocked_rhs_groups(n, k, bs)
    forms = tp.chol_tiled_forms(n, width, bs, kernel)
    assert {p.clusters for p in forms} == {1, 2, 4, 8}
    outs = []
    for plan in forms:
        before = _launches(kernel)
        outs.append(tp.cholesky_solve_blocked_fused(a, rhs, bs=bs,
                                                    plan=plan))
        torch.cuda.synchronize()
        assert _launches(kernel) == before + len(groups)
    one = next(o for p, o in zip(forms, outs) if p.clusters == 1)
    for plan, out in zip(forms, outs):
        assert torch.equal(_bits(out), _bits(one)), str(plan)
    clean = [0, 3]
    want = tp.cholesky_solve_blocked_plain(a[clean], rhs[clean], bs=bs)
    assert_close(one[clean].cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                 name=f"{kernel} n={n} bs={bs}")
    assert bool(torch.isfinite(one[1]).all())
    assert torch.equal(_bits(one[2]), _bits(one[0]))


def test_blocked_rhs_alone_equal_inside_the_whole_k(hopper):
    """A few right-hand sides solved alone give their bits inside the
    whole k, on the deficient and poisoned lanes too; past the core's
    room for right-hand sides (k = 300 at n = 128) the wrapper solves
    column groups, a launch each, with the same bits."""
    kernel = "cholesky_solve_blocked"
    a, _ = _chol_tiled_lanes(hopper, "cholesky_solve_tiled", None, 128,
                             seed=11)
    rng = np.random.default_rng(12)
    rhs = torch.from_numpy(rng.standard_normal((4, 128, 300))
                           .astype(np.float32)).to(hopper)
    rhs[2] = rhs[0]
    width, groups = tp.blocked_rhs_groups(128, 300, 64)
    assert len(groups) == 2 and width == 150
    before = _launches(kernel)
    whole = tp.cholesky_solve_blocked_fused(a, rhs)
    torch.cuda.synchronize()
    assert _launches(kernel) == before + 2
    six = tp.cholesky_solve_blocked_fused(a, rhs[:, :, :6].contiguous())
    assert torch.equal(_bits(six), _bits(whole[:, :, :6].contiguous()))
    for cols in ([0], [2, 3], [5], [149, 150], [299]):
        alone = tp.cholesky_solve_blocked_fused(
            a, rhs[:, :, cols].contiguous())
        assert torch.equal(_bits(alone),
                           _bits(whole[:, :, cols].contiguous())), cols
    assert torch.equal(_bits(whole[2]), _bits(whole[0]))


def test_blocked_plan_refused_off_its_forms(hopper):
    """A K10 plan that is not one of the shape's forms raises before any
    launch; the C entry refuses bytes off its formula."""
    a, rhs = _card_case(hopper, "cholesky_solve", 2, 256, seed=3)
    plan = tp.chol_tiled_plan(2, 256, 2, 64, "cholesky_solve_blocked")
    with pytest.raises(ValueError, match="not a form"):
        tp.cholesky_solve_blocked_fused(a, rhs, plan=plan._replace(tile=96))
    k = next(k for k in KERNELS if k.name == "cholesky_solve_blocked")
    x = torch.empty_like(rhs)
    work = torch.empty((2, 256, 256), device=hopper)
    with pytest.raises(RuntimeError, match="launch failed"):
        k.launch(hopper, (plan.smem_bytes,), a.data_ptr(), rhs.data_ptr(),
                 x.data_ptr(), work.data_ptr(), 2, 256, 2, 64, 1e-5,
                 plan.clusters, plan.tile, plan.smem_bytes + 4)


def test_blocked_phase_stamps_are_ordered_and_cover_the_kernel(hopper):
    """K10's phase-stamped instance gives the served answer bit for bit on
    every form at n = 256 on 32 lanes; each lane's stamps are ordered and
    its phases add up to its time, the chain's among them."""
    CHm = importlib.import_module("repro_torch.pipelines.cholesky_solve")
    kernel = "cholesky_solve_blocked"
    a, rhs = _card_case(hopper, "cholesky_solve", 32, 256, seed=5)
    for plan in tp.chol_tiled_forms(256, 2, 64, kernel):
        before = _launches(kernel)
        x, stamps = CHm.chol_tiled_phases(kernel, a, rhs, plan=plan)
        torch.cuda.synchronize()
        assert _launches(kernel) == before
        assert torch.equal(x, tp.cholesky_solve_blocked_fused(a, rhs,
                                                              plan=plan))
        st = stamps.cpu()
        assert st.shape == (32, 2 + len(CHm.TILED_PHASES))
        assert bool((st[:, 1] > st[:, 0]).all() and (st[:, 2:] >= 0).all())
        assert torch.equal(st[:, 2:].sum(dim=1), st[:, 1] - st[:, 0])
        assert bool((st[:, 2 + CHm.TILED_PHASES.index("chain")] > 0).all())


# K11 and K13 on thread-block clusters: every cluster size and both
# places of the panel's bands (the CTAs' shared memory, the device work
# buffer) give the same bits; 2052 x 512 has its bands in the work buffer
# at every size
QR_CLUSTER_CASES = [("qr_solve_tiled", 516, 512, 128, 4),
                    ("qr_solve_tiled", 1028, 1024, 128, 4),
                    ("qr_solve_tiled", 2052, 512, 128, 4),
                    ("qr_solve_blocked", 132, 128, 16, 8),
                    ("qr_solve_blocked", 132, 128, 32, 8),
                    ("qr_solve_blocked", 132, 128, 64, 8),
                    ("qr_solve_blocked", 260, 256, 16, 8),
                    ("qr_solve_blocked", 260, 256, 32, 8),
                    ("qr_solve_blocked", 260, 256, 64, 8),
                    ("qr_solve_blocked", 160, 128, 16, 8),
                    ("qr_solve_blocked", 160, 128, 32, 8),
                    ("qr_solve_blocked", 160, 128, 64, 8)]
QR_CLUSTER_PAIRS = {
    "qr_solve_blocked": (tp.qr_solve_blocked_fused,
                         tp.qr_solve_blocked_plain, MID_RTOL),
    "qr_solve_tiled": (tp.qr_solve_tiled_fused, tp.qr_solve_tiled_plain,
                       2e-3)}


def _qr_cluster_lanes(dev, m, n, b, seed):
    """b lanes at m x n, one rhs: lane 1 has a column (3n/4) copying
    column 3 (a rank-deficient later panel), lane 2 an exact zero column
    (n/2), lane 3 a NaN; the others Gaussian (numpy seed)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, m, n)).astype(np.float32)
    a[1, :, 3 * n // 4] = a[1, :, 3]
    a[2, :, n // 2] = 0.0
    a[3, n // 3, n // 5] = np.nan
    rhs = rng.standard_normal((b, m, 1)).astype(np.float32)
    return torch.from_numpy(a).to(dev), torch.from_numpy(rhs).to(dev)


@pytest.mark.parametrize("kernel,m,n,bs,b", QR_CLUSTER_CASES)
def test_qr_cluster_forms_equal_bit_for_bit(hopper, kernel, m, n, bs, b):
    """K11 / K13 under every plan of qr_cluster_forms (each cluster size,
    the panel's bands in shared memory where they fit and in the work
    buffer at every size) give one answer bit for bit, each one launch;
    it is within the spec's rtol of
    the plain version and the oracle on the clean lanes, the zero
    column's component is zeroed, the deficient lane finite, and the
    lanes beside the NaN lane equal their clean batch's."""
    fused, plain, rtol = QR_CLUSTER_PAIRS[kernel]
    a, rhs = _qr_cluster_lanes(hopper, m, n, b, seed=m + bs)
    forms = tp.qr_cluster_forms(m, n, 1, bs)
    assert ({p.clusters for p in forms if not p.panel_shared}
            == {1, 2, 4, 8})
    assert any(p.panel_shared for p in forms) == (m < 2052)
    outs = []
    for plan in forms:
        before = _launches(kernel)
        outs.append(fused(a, rhs, bs=bs, plan=plan))
        torch.cuda.synchronize()
        assert _launches(kernel) == before + 1
    for plan, out in zip(forms, outs):
        assert torch.equal(_bits(out), _bits(outs[0])), str(plan)
    got = outs[0]
    keep = [i for i in range(b) if i != 3]
    clean = [i for i in keep if i not in (1, 2)]
    want = plain(a, rhs, bs=bs)
    assert_close(got[clean].cpu().numpy(), want[clean].cpu().numpy(),
                 rtol=rtol, name=f"{kernel} {m}x{n} bs={bs}")
    from repro_torch.kernels import ref
    assert_close(got[clean].cpu().numpy(),
                 ref.qr_solve(a[clean], rhs[clean]).cpu().numpy(),
                 rtol=rtol, name=f"{kernel} {m}x{n} oracle")
    assert bool(torch.isfinite(got[keep]).all())
    assert torch.equal(got[2, n // 2], torch.zeros_like(got[2, n // 2]))
    a_clean = a.clone()
    a_clean[3] = a[0]
    again = fused(a_clean, rhs, bs=bs, plan=forms[0])
    assert torch.equal(_bits(got[keep]), _bits(again[keep]))


def test_qr_cluster_plan_refused_off_its_forms(hopper):
    """A plan that is not one of the shape's forms raises before any
    launch; the C entry refuses bytes off its formula."""
    a, rhs = _card_case(hopper, "qr_solve", 2, 128, seed=3)
    plan = tp.qr_cluster_plan(2, 132, 128, 1, 64)
    with pytest.raises(ValueError, match="not a form"):
        tp.qr_solve_blocked_fused(a, rhs, plan=plan._replace(clusters=16))
    Qm = importlib.import_module("repro_torch.pipelines.qr_solve")
    k = next(k for k in KERNELS if k.name == "qr_solve_blocked")
    x = torch.empty((2, 128, 1), device=hopper)
    with pytest.raises(RuntimeError, match="launch failed"):
        k.launch(hopper, (plan.smem_bytes,), a.data_ptr(), rhs.data_ptr(),
                 x.data_ptr(), None, 2, 132, 128, 1, 64, Qm.DEFAULT_TINY,
                 plan.clusters, int(plan.panel_shared), plan.smem_bytes + 4)


@pytest.mark.parametrize("kernel,m,n,b", [("qr_solve_blocked", 260, 256, 32),
                                          ("qr_solve_tiled", 516, 512, 32)])
def test_qr_phase_stamps_are_ordered_and_cover_the_kernel(hopper, kernel,
                                                          m, n, b):
    """The phase-stamped instance gives the served answer bit for bit;
    each lane's stamps are ordered and its phases add up to its time."""
    Qm = importlib.import_module("repro_torch.pipelines.qr_solve")
    a, rhs = _card_case(hopper, "qr_solve", b, n, m=m, seed=5)
    before = _launches(kernel)
    x, stamps = Qm.qr_solve_phases(kernel, a, rhs)
    torch.cuda.synchronize()
    assert _launches(kernel) == before
    assert torch.equal(x, QR_CLUSTER_PAIRS[kernel][0](a, rhs))
    st = stamps.cpu()
    assert st.shape == (b, 2 + len(Qm.QR_PHASES))
    assert bool((st[:, 1] > st[:, 0]).all() and (st[:, 2:] >= 0).all())
    assert torch.equal(st[:, 2:].sum(dim=1), st[:, 1] - st[:, 0])


@pytest.mark.parametrize("name", sorted(TILED))
def test_coalesced_corner_bit_identical_in_tiled_bucket(hopper, name):
    """A 512 job embedded in a 1024 tiled bucket's lane solves to exactly
    its solo tiled answer on the card (both at slab width 128)."""
    spec = TK.get(name)
    v = next(v for v in spec.variants if v.name == "tiled")
    rng = np.random.default_rng(5)
    small = [a[0].numpy() for a in v.make_case(rng, 512)]
    big = [a[0].numpy() for a in v.make_case(rng, 1024)]
    assert spec.dispatch_key(tuple(a.shape for a in big),
                             ("float32",) * 2).name == "tiled"
    embedded = spec.coalesce.embed(small, tuple(a.shape for a in big))
    fused = TILED[name][1]
    solo = fused(*(torch.from_numpy(a[None]).to(hopper)
                   for a in small))[0].cpu().numpy()
    out = fused(*(torch.from_numpy(np.stack([e, b])).to(hopper)
                  for e, b in zip(embedded, big)))[0].cpu().numpy()
    got = spec.coalesce.extract(out, tuple(a.shape for a in small))
    np.testing.assert_array_equal(got, solo)


def test_mux_serves_hbm_mix_on_card(hopper):
    """The n = 512 slot mix served on the card runs K12, K13, K14 and the
    global form of K3 (the split-complex jobs' 2n = 1024 system)."""
    from repro_torch.launch.serve_solvers import build_slot_jobs
    for k in KERNELS:
        k.launches = k.launches_global = 0
    mux = SolverMux(lanes=4, clock=ManualClock())
    rng = np.random.default_rng(0)
    jobs = []
    for slot in range(4):
        for pipeline, arrays, priority in build_slot_jobs(rng, slot, [512]):
            jobs.append(mux.submit(pipeline, *arrays, priority=priority))
    mux.run()
    assert all(j.state == "done" for j in jobs)
    for name in ("cholesky_solve_tiled", "qr_solve_tiled",
                 "mmse_equalize_tiled", "mmse_equalize_split"):
        assert _launches(name) > 0, name
    assert next(k for k in KERNELS
                if k.name == "mmse_equalize_split").launches_global > 0
    for job in jobs:
        want = TK.get(job.pipeline).run_oracle_lane(*job.args)
        assert_close(job.out, want, rtol=2e-3, name=job.pipeline)


@pytest.mark.parametrize("name", ["cholesky_solve", "qr_solve"])
def test_tiled_1024_bucket_demotes_past_blocked_rung_to_base(hopper, name):
    """K10/K11 keep a whole panel in shared memory: at n = 512 they fit,
    at n = 1024 their launch is refused, and ``Variant.fits`` says so
    from the same query.  A 1024 tiled bucket that fails twice therefore
    demotes straight to the base (K1/K4 in their global form), which
    serves the jobs."""
    from repro_torch.launch import serve_solvers as TS
    from repro_torch.serve import FaultInjector
    fits = getattr(tp, f"{name}_blocked_fits")
    blocked = getattr(tp, f"{name}_blocked_fused")
    m, k = (1024, 2) if name == "cholesky_solve" else (1028, 1)
    if name == "cholesky_solve":
        assert fits(512, 2) and not fits(1024, 2)
    else:
        assert fits(516, 512, 1) and not fits(1028, 1024, 1)
    a = torch.eye(m, 1024, device=hopper)[None].contiguous()
    with pytest.raises(ValueError, match="shared memory"):
        blocked(a, torch.zeros((1, m, k), device=hopper))

    base = next(kk for kk in KERNELS if kk.name == name)
    before = base.launches_global
    trace = {"target": [{"pipeline": name, "variant": "tiled",
                         "kind": "raise", "count": 2}]}
    mux = SolverMux(lanes=2, clock=ManualClock(),
                    injector=FaultInjector(trace, seed=0))
    jobs = [mux.submit(name, *TS.job_args(name, 1024, 2, seed))
            for seed in range(2)]
    mux.poll()
    assert all(j.state == "done" for j in jobs)
    assert [(e["from_variant"], e["to_variant"]) for e in mux.events
            if e["event"] == "demote"] == [("tiled", "base")]
    assert [e["variant"] for e in mux.events if e["event"] == "flush"] \
        == ["base"]
    assert base.launches_global > before
    for job in jobs:
        want = TK.get(name).run_oracle_lane(*job.args)
        assert_close(job.out, np.asarray(want), rtol=2e-3,
                     name=f"demoted-{name}")


# ---------------- the primitive kernels (K15-K17, K19) ----------------

PRIM_PAIRS = {"cholesky": (tchol.cholesky_fused, tchol.cholesky_plain),
              "trisolve": (ttri.trisolve_fused, ttri.trisolve_plain),
              "qr": (tqr.qr_fused, tqr.qr_plain),
              "fir": (tfir.fir_fused, tfir.fir_plain)}


def _pieces(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("kernel", sorted(PRIM_PAIRS))
def test_primitive_kernel_matches_plain_version(hopper, kernel):
    """K15-K17 and K19 at every registry size (K16 also backward, on the
    transposed triangle) against their plain versions on the same card
    inputs, one launch each."""
    fused, plain = PRIM_PAIRS[kernel]
    spec = TK.get(kernel)
    for n in spec.sizes:
        args = [a.to(hopper) for a in spec.make_case(
            np.random.default_rng(n), n)]
        calls = [((), {})]
        if kernel == "trisolve":
            calls.append(((args[0].mT.contiguous(), args[1]),
                          {"lower": False}))
        for override, kw in calls:
            call_args = override or args
            before = _launches(kernel)
            got = fused(*call_args, **kw)
            torch.cuda.synchronize()
            assert _launches(kernel) == before + 1
            for g, w in zip(_pieces(got), _pieces(plain(*call_args, **kw))):
                assert_close(g.cpu().numpy(), w.cpu().numpy(),
                             rtol=spec.rtol, name=f"{kernel} n={n} {kw}")


def _primitive_case(dev, kernel, b, n, seed=0):
    """K15 on SPD systems (sample_spd), K16 on their factors with two
    right-hand sides, K17 on Gaussian (n + 4) x n matrices."""
    rng = np.random.default_rng(seed)
    from repro_torch.kernels.common import sample_spd
    if kernel == "qr":
        return (torch.from_numpy(rng.standard_normal(
            (b, n + 4, n)).astype(np.float32)).to(dev),)
    a = torch.from_numpy(sample_spd(rng, b, n)).to(dev)
    if kernel == "cholesky":
        return (a,)
    rhs = torch.from_numpy(rng.standard_normal((b, n, 2)).astype(
        np.float32)).to(dev)
    return tchol.cholesky_plain(a), rhs


@pytest.mark.parametrize("kernel,lower", [("cholesky", None),
                                          ("trisolve", True),
                                          ("trisolve", False),
                                          ("qr", None)])
def test_primitive_past_shared_memory_runs_global_form(hopper, kernel,
                                                       lower):
    """A lane at n = 256 (m = 260 for QR) is more than a CTA's shared
    memory: the kernel works in its output in device memory (the global
    form, counted in ``launches_global``) and agrees with its plain
    version."""
    fused, plain = PRIM_PAIRS[kernel]
    args = _primitive_case(hopper, kernel, 4, 256, seed=256)
    kw = {}
    if lower is not None:
        kw = {"lower": lower}
        if not lower:
            args = (args[0].mT.contiguous(), args[1])
    k = next(k for k in KERNELS if k.name == kernel)
    assert not k.fits_shared(*((256, 2) if kernel == "trisolve" else
                               (260, 256) if kernel == "qr" else (256,)))
    before = k.launches_global
    got = fused(*args, **kw)
    torch.cuda.synchronize()
    assert k.launches_global == before + 1
    for g, w in zip(_pieces(got), _pieces(plain(*args, **kw))):
        assert_close(g.cpu().numpy(), w.cpu().numpy(),
                     rtol=TK.get(kernel).rtol, name=f"{kernel} n=256")


@pytest.mark.parametrize("kernel,lower", [("cholesky", None),
                                          ("trisolve", True),
                                          ("trisolve", False),
                                          ("qr", None)])
def test_primitive_global_form_equals_shared_form_bit_for_bit(
        hopper, monkeypatch, kernel, lower):
    """At n = 32 both forms fit: the global form (forced by a shared-
    memory limit of 0) gives the shared form's answer bit for bit."""
    fused, _ = PRIM_PAIRS[kernel]
    args = _primitive_case(hopper, kernel, 64, 32, seed=32)
    kw = {} if lower is None else {"lower": lower}
    k = next(k for k in KERNELS if k.name == kernel)
    before = k.launches_global
    shared = _pieces(fused(*args, **kw))
    assert k.launches_global == before
    monkeypatch.setattr(common, "MAX_SMEM_BYTES", 0)
    glob = _pieces(fused(*args, **kw))
    torch.cuda.synchronize()
    assert k.launches_global == before + 1
    assert all(torch.equal(s, g) for s, g in zip(shared, glob))


@pytest.mark.parametrize("lower", [True, False])
def test_trisolve_warp_form_equals_cta_form_bit_for_bit(hopper, monkeypatch,
                                                        lower):
    """K16 a warp a lane (n <= 32, m <= 8) against a block a lane (forced
    by WARP_MAX_N = 0) at n in {1, 7, 8, 16, 31, 32} and m in {1, 2, 3,
    8}, bit for bit, with NaN in the triangle neither reads; each call is
    one launch of the form it names."""
    k = next(k for k in KERNELS if k.name == "trisolve")
    for n in (1, 7, 8, 16, 31, 32):
        for m in (1, 2, 3, 8):
            l, _ = _primitive_case(hopper, "trisolve", 300, n, seed=n)
            if not lower:
                l = l.mT.contiguous()
            rhs = torch.from_numpy(np.random.default_rng(m).standard_normal(
                (300, n, m)).astype(np.float32)).to(hopper)
            idx = torch.triu_indices(n, n, offset=1)
            if not lower:
                idx = idx.flip(0)
            l[:, idx[0], idx[1]] = float("nan")
            assert ttri.trisolve_form(n, m) == "warp"
            before = (k.launches, k.launches_warp)
            warp = ttri.trisolve_fused(l, rhs, lower=lower)
            assert (k.launches, k.launches_warp) == (before[0] + 1,
                                                     before[1] + 1)
            with monkeypatch.context() as mp:
                mp.setattr(ttri, "WARP_MAX_N", 0)
                cta = ttri.trisolve_fused(l, rhs, lower=lower)
            torch.cuda.synchronize()
            assert k.launches_warp == before[1] + 1
            assert torch.equal(warp, cta), (n, m)
            assert bool(torch.isfinite(warp).all()), (n, m)


def test_trisolve_warp_form_refuses_past_its_limits(hopper, monkeypatch):
    """The C entry takes the warp form only up to 32 rows and 8
    right-hand sides."""
    l, rhs = _primitive_case(hopper, "trisolve", 2, 40, seed=40)
    monkeypatch.setattr(ttri, "WARP_MAX_N", 64)
    with pytest.raises(RuntimeError, match="launch failed"):
        ttri.trisolve_fused(l, rhs)


@pytest.mark.parametrize("samples,taps", [(61470, 31), (61504, 65),
                                          (1000, 30), (300, 1)])
def test_fir_kernel_equals_plain_bit_for_bit(hopper, samples, taps):
    """K19 rounds each sum and product separately, in the plain version's
    order: the two agree bit for bit, also on a ragged last tile."""
    rng = np.random.default_rng(taps)
    x = torch.from_numpy(rng.standard_normal(samples).astype(
        np.float32)).to(hopper)
    h = rng.standard_normal(taps).astype(np.float32)
    h = torch.from_numpy((h + h[::-1]) / 2).to(hopper)
    got = tfir.fir_fused(x, h)
    torch.cuda.synchronize()
    assert torch.equal(got, tfir.fir_plain(x, h))


def _reset_launches():
    for k in KERNELS:
        k.launches = k.launches_global = 0


@pytest.mark.parametrize("name,expect", [
    ("cholesky_solve", {"cholesky": 1, "trisolve": 2}),
    ("qr_solve", {"qr": 1, "trisolve": 1}),
    ("mmse_equalize", {"cholesky": 1, "trisolve": 2})])
def test_unfused_baseline_launch_counts(hopper, name, expect):
    """Each unfused baseline runs as its chain of primitive kernels and
    nothing else, and agrees with its fused kernel at the reference's
    tolerance (1e-4; 1e-3 for QR)."""
    unfused = {"cholesky_solve": tp.cholesky_solve_unfused,
               "qr_solve": tp.qr_solve_unfused,
               "mmse_equalize": tp.mmse_equalize_composed}[name]
    fused = PAIRS[name][0]
    args = _card_case(hopper, name, 64, 16, seed=16)
    _reset_launches()
    got = unfused(*args)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in KERNELS if k.launches}
    assert counts == expect
    assert_close(got.cpu().numpy(), fused(*args).cpu().numpy(),
                 rtol=1e-3 if name == "qr_solve" else 1e-4, name=name)


def test_dsp_pipeline_launches_its_five_kernels(hopper, capsys):
    """The DSP chain at the reference's defaults: K15 once, K16 twice,
    K7, K19 and K8 once each, nothing else, and finite errors."""
    from repro_torch.launch import dsp_pipeline
    _reset_launches()
    errors = dsp_pipeline.main([])
    counts = {k.name: k.launches for k in KERNELS if k.launches}
    assert counts == {"cholesky": 1, "trisolve": 2, "fft": 1, "fir": 1,
                      "svd": 1}
    assert capsys.readouterr().out.rstrip().endswith("pipeline OK.")
    assert errors["nmse"] < 1.0 and errors["fir_err"] < 1e-4


# ---------------- the repairs (wide QR, bf16 K1) ----------------

def test_qr_kernel_takes_a_wide_matrix(hopper):
    """K17 on M < N (2, 4, 6): min(N, M - 1) reflectors, Q (2, 4, 4), R
    (2, 4, 6) zero below its diagonal, equal to the plain version."""
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 4, 6)).astype(np.float32)).to(hopper)
    before = _launches("qr")
    q, r = tqr.qr_fused(a)
    torch.cuda.synchronize()
    assert _launches("qr") == before + 1
    assert q.shape == (2, 4, 4) and r.shape == (2, 4, 6)
    wq, wr = tqr.qr_plain(a)
    assert_close(q.cpu().numpy(), wq.cpu().numpy(), rtol=1e-4, name="Q")
    assert_close(r.cpu().numpy(), wr.cpu().numpy(), rtol=1e-4, name="R")
    assert torch.all(torch.tril(r, -1) == 0)
    assert_close((q @ r).cpu().numpy(), a.cpu().numpy(), rtol=1e-4,
                 name="QR")


def test_cholesky_solve_kernel_takes_bf16(hopper):
    """K1 on the reference's bf16 case: computed in float32 (one launch),
    returned in bf16, within the reference's rtol of 8e-2."""
    from repro_torch.kernels.common import sample_spd
    rng = np.random.default_rng(0)
    a = sample_spd(rng, 2, 16)
    b = rng.standard_normal((2, 16, 2)).astype(np.float32)
    before = _launches("cholesky_solve")
    got = tp.cholesky_solve_fused(
        torch.from_numpy(a).to(hopper, torch.bfloat16),
        torch.from_numpy(b).to(hopper, torch.bfloat16))
    torch.cuda.synchronize()
    assert _launches("cholesky_solve") == before + 1
    assert got.dtype == torch.bfloat16
    want = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    assert_close(got.float().cpu().numpy(), want, rtol=8e-2,
                 name="chol_solve-bf16")


# ---------------- the LM kernels (K18, K20) and the LM path ----------------

tgemm = importlib.import_module("repro_torch.kernels.gemm")
tattn = importlib.import_module("repro_torch.kernels.attention")

# bf16 answers round once to bf16 (2^-8 relative) on both faces; the
# sums before that rounding differ in order only
BF16_RTOL = 1e-2
# K18 in bf16 element by element: |got - plain| <= GEMM_BF16_STEP |plain|
# + GEMM_BF16_SUM (|x| |y|): one bf16 step of the answer (each face rounds
# its float32 sum once, and two roundings of nearly equal sums may land a
# step apart) plus a float32 sum-order term on the sum of |products|.  A
# stale or skipped pipeline stage moves whole products, which this sees.
GEMM_BF16_STEP = 2.0 ** -7
GEMM_BF16_SUM = 2.0 ** -16


def _gemm_forms():
    kern = next(k for k in KERNELS if k.name == "gemm")
    return kern.launches, kern.launches_tc


@pytest.mark.parametrize("m,k,n,dtype", [
    (64, 64, 64, "float32"), (128, 128, 128, "float32"),
    (1000, 300, 700, "float32"), (129, 257, 65, "float32"),
    (1000, 300, 700, "bfloat16"), (1, 1, 1, "float32"),
    (64, 64, 60, "float32"), (1, 4096, 256, "float32"),
    (129, 257, 65, "bfloat16"), (1, 1, 1, "bfloat16"),
    (100, 13, 50, "bfloat16"), (64, 64, 60, "bfloat16"),
    (1, 4096, 256, "bfloat16"), (4096, 64, 4096, "bfloat16"),
    (2048, 2048, 2048, "bfloat16")])
def test_gemm_kernel_matches_plain_version(hopper, m, k, n, dtype):
    """K18 at the registry's squares (64, 128), at shapes that are not
    multiples of its tiles (K % 8 and N % 8 != 0 in bf16: the padded
    route), a long k axis (1 x 4096 x 256: the bf16 ring wraps 16 times),
    many waves of tiles (4096 x 64 x 4096, 2048^3), against its plain
    version on the same card inputs.  float32 runs the SIMT form on IEEE
    products (no TF32), held to the spec's rtol of 1e-4; bf16 runs the
    tensor-core form, held to BF16_RTOL and element by element."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(
        np.float32)).to(hopper, dt)
    y = torch.from_numpy(rng.standard_normal((k, n)).astype(
        np.float32)).to(hopper, dt)
    before = _gemm_forms()
    got = tgemm.gemm_fused(x, y)
    torch.cuda.synchronize()
    tc = int(dtype == "bfloat16")
    assert _gemm_forms() == (before[0] + 1, before[1] + tc)
    assert got.dtype == dt and got.shape == (m, n)
    want = tgemm.gemm_plain(x, y)
    rtol = 1e-4 if dtype == "float32" else BF16_RTOL
    assert_close(got.float().cpu().numpy(), want.float().cpu().numpy(),
                 rtol=rtol, name=f"gemm {m}x{k}x{n} {dtype}")
    if tc:
        err = (got.double() - want.double()).abs()
        tol = GEMM_BF16_STEP * want.double().abs() + GEMM_BF16_SUM * (
            x.float().abs() @ y.float().abs()).double()
        worst = float((err / tol.clamp_min(1e-300)).max())
        assert worst <= 1.0, (f"gemm {m}x{k}x{n} bf16: |diff| reaches "
                              f"{worst:.3g} of its limit")


def test_gemm_registry_cases_and_guard_on_card(hopper):
    from repro_torch.kernels import ref as tref
    spec = TK.get("gemm")
    for n in spec.sizes:
        x, y = (a.to(hopper) for a in spec.make_case(
            np.random.default_rng(n), n))
        got = TK.gemm(x, y, device=hopper)
        assert_close(got.cpu().numpy(), tref.gemm(x, y).cpu().numpy(),
                     rtol=spec.rtol, name=f"gemm n={n}")
    with pytest.raises(ValueError):
        tgemm.gemm_fused(torch.ones((4, 5), device=hopper),
                         torch.ones((6, 3), device=hopper))


# K20 element by element, |got - want| <= rtol (softmax(q k^T) |v| +
# |want|): rounding p to bf16 moves each term of P V by at most 2^-8 of
# itself and the answer rounds to 2^-8 of itself, 5e-3 covering both;
# float32 differs by summation order and exp's last bits only
ATTN_RTOLS = {"float32": 1e-4, "bfloat16": 5e-3}


def _peaked_qkv(hopper, b, h, hkv, s, d, dt, seed):
    """Peaked scores: q and k at sigma 1.5 (so each row's max moves from
    kv tile to kv tile) and a score of ~18 planted in the last kv tile
    (q with a common component 3 / sqrt(D), the key at s - 1 - s // 16
    all 6), where the running max jumps and all before must be
    rescaled."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)) * 1.5 + 3.0 / np.sqrt(d)
    k = rng.standard_normal((b, hkv, s, d)) * 1.5
    k[:, :, s - 1 - s // 16] = 6.0
    v = rng.standard_normal((b, hkv, s, d))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(hopper, dt)
                 for a in (q, k, v))


def _flash_worst(got, q, k, v, causal, dtype):
    """The largest |got - plain| over its limit ATTN_RTOLS[dtype] *
    (softmax(q k^T) |v| + |plain|), element by element."""
    want = tattn.flash_attention_plain(q, k, v, causal=causal).double()
    scale = tattn.flash_attention_plain(q.float(), k.float(),
                                        v.float().abs(), causal=causal)
    err = (got.double() - want).abs()
    tol = ATTN_RTOLS[dtype] * (scale.double() + want.abs())
    return float((err / tol).max())


def _forms():
    kern = next(k for k in KERNELS if k.name == "flash_attention")
    return kern.launches, kern.launches_tc


@pytest.mark.parametrize("d", [4, 8, 12, 64, 80, 128])
@pytest.mark.parametrize("s", [5, 96, 100, 128, 512])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_version(hopper, d, s, causal, dtype):
    """K20 at phi4-mini's head width (128), zamba2's (80), the registry's
    (64), the smoke configs' (8) and widths that are not multiples of 8
    (4, 12: the 8-byte copies), at S = 5, 96, 100 (ragged q and kv
    tiles), 128 and 512, causal and not, GQA 4/2, against its plain
    version on the same card inputs, on peaked scores.  bf16 runs the
    tensor-core form, float32 the SIMT form."""
    dt = getattr(torch, dtype)
    q, k, v = _peaked_qkv(hopper, 1, 4, 2, s, d, dt, d + s)
    before = _forms()
    got = tattn.flash_attention_fused(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tc = int(dtype == "bfloat16")
    assert _forms() == (before[0] + 1, before[1] + tc)
    worst = _flash_worst(got, q, k, v, causal, dtype)
    assert worst <= 1.0, (f"flash d={d} s={s} {dtype}: |diff| reaches "
                          f"{worst:.3g} of its limit")


@pytest.mark.parametrize("b,h,hkv,s,d", [(4, 24, 8, 512, 128),
                                         (4, 32, 32, 512, 80)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_at_full_width_prefill_shapes(hopper, b, h, hkv, s, d,
                                                   dtype):
    """K20 at the shapes the LM prefills launch it at: phi4-mini's (4,
    24, 512, 128) with GQA 24/8 and zamba2's (4, 32, 512, 80), causal, on
    peaked scores, against its plain version element by element."""
    dt = getattr(torch, dtype)
    q, k, v = _peaked_qkv(hopper, b, h, hkv, s, d, dt, d)
    before = _forms()
    got = tattn.flash_attention_fused(q, k, v)
    torch.cuda.synchronize()
    assert _forms() == (before[0] + 1,
                        before[1] + int(dtype == "bfloat16"))
    worst = _flash_worst(got, q, k, v, True, dtype)
    assert worst <= 1.0, (f"flash ({b},{h},{s},{d}) {dtype}: |diff| "
                          f"reaches {worst:.3g} of its limit")


@pytest.mark.parametrize("d,s,causal", [(128, 512, True), (80, 100, True),
                                        (12, 96, False), (4, 5, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_strided_route_equals_contiguous_one(hopper, d, s, causal,
                                                   dtype):
    """ops.flash_attention on the models' (B, S, H, D) tensors handed
    over as transposed views: the kernel reads them through their
    strides, answers in their layout (the transpose back is contiguous)
    and equals its answer on contiguous (B, H, S, D) copies bit for
    bit, in both forms."""
    dt = getattr(torch, dtype)
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _peaked_qkv(hopper, 2, 4, 2, s, d, dt, s))
    assert not q.is_contiguous()
    got = TK.flash_attention(q, k, v, causal=causal, device=hopper)
    want = TK.flash_attention(*(t.contiguous() for t in (q, k, v)),
                              causal=causal, device=hopper)
    torch.cuda.synchronize()
    assert got.transpose(1, 2).is_contiguous()
    assert torch.equal(got, want)


def test_flash_registry_case_and_guards_on_card(hopper):
    from repro_torch.kernels import ref as tref
    spec = TK.get("flash_attention")
    q, k, v = (a.to(hopper) for a in spec.make_case(
        np.random.default_rng(0), 128))
    assert_close(TK.flash_attention(q, k, v, device=hopper).cpu().numpy(),
                 tref.mha(q, k, v).cpu().numpy(), rtol=spec.rtol,
                 name="flash registry case")
    bad = torch.ones((1, 2, 200, 64), device=hopper)
    with pytest.raises(ValueError):                 # 200 % 128 != 0
        tattn.flash_attention_fused(bad, bad, bad)


def test_prefill_on_flash_kernel_matches_xla_impl(hopper):
    """The smoke model's prefill with attn_impl="flash" launches K20 once
    a layer and gives the logits of attn_impl="xla" (f32 compute), at
    S = 256: two kv tiles, so the online softmax rescales."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tT
    cfg = dataclasses.replace(get_smoke("phi4-mini-3.8b"),
                              compute_dtype="float32", attn_impl="flash")
    gen = torch.Generator(device=hopper)
    gen.manual_seed(0)
    p = tT.init_params(gen, cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 256))).to(hopper)      # two kv tiles of 128
    before = _launches("flash_attention")
    got = tT.prefill(p, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    assert _launches("flash_attention") == before + cfg.n_layers
    want = tT.prefill(p, dataclasses.replace(cfg, attn_impl="xla"),
                      {"tokens": toks})
    assert_close(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-3,
                 name="flash-vs-xla prefill")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prefill_runs_every_k20_launch_in_its_dtype_form(hopper, dtype):
    """The smoke phi4-mini's prefill with attn_impl="flash": in bf16
    compute every K20 launch runs the tensor-core form, in float32 none
    does; one launch a layer either way, and finite logits."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tT
    cfg = dataclasses.replace(get_smoke("phi4-mini-3.8b"),
                              compute_dtype=dtype, attn_impl="flash")
    gen = torch.Generator(device=hopper)
    gen.manual_seed(0)
    p = tT.cast_params(tT.init_params(gen, cfg), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 256))).to(hopper)
    before = _forms()
    got = tT.prefill(p, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    tc = cfg.n_layers if dtype == "bfloat16" else 0
    assert _forms() == (before[0] + cfg.n_layers, before[1] + tc)
    assert bool(torch.isfinite(got).all())


def test_decode_golden_replay_on_card(hopper):
    """The committed mixed solver+decode trace through the port's mux on
    the card, event for event equal to the golden file."""
    from repro_torch.launch.serve_solvers import replay_decode
    data = pathlib.Path(__file__).parent / "data"
    trace = json.loads((data / "decode_trace.json").read_text())
    mux, _, requests, jobs = replay_decode(trace, device=hopper)
    assert all(r.done for r in requests)
    assert all(j.state == "done" for j in jobs)
    got = json.dumps(mux.drain_events(), indent=1) + "\n"
    assert got == (data / "decode_golden.json").read_text()


# ---------------- K21, the chunked SSD scan ----------------

tscan = importlib.import_module("repro_torch.kernels.ssm_scan")
# K21 against its plain version on the same card inputs: float32 sums in
# another order only (1e-4 of the largest answer, as the solver specs);
# bfloat16 rounds each answer once from float32 in both, so two answers may
# sit one bf16 step (2^-8 of themselves) apart: 8e-3.  Against the float32
# sequential oracle: the spec's 1e-3, and 8e-3 in bf16.
SSM_RTOLS = {"float32": (1e-4, 1e-3), "bfloat16": (8e-3, 8e-3)}
# (label, b, h, s, p, n, per_head, chunk, decays): the registry's shapes,
# zamba2-2.7b's prefill (N = 64 shared, chunk 128), xlstm-125m's (P = 385
# with the normaliser channel, N = 192 per head, chunk 64), S < chunk, an
# odd P, the decay limits 1 and 0 (the 1e-20 clamp), more chunks (16)
# than a cluster's ranks, and both prefill shapes at S = 128 (zamba2's a
# lane of one chunk, xlstm's two)
SSM_CASES = [("registry", 1, 2, 64, 4, 8, False, 16, (0.8, 0.999)),
             ("zamba2", 4, 32, 512, 160, 64, False, 128, (0.8, 0.999)),
             ("xlstm", 4, 4, 512, 385, 192, True, 64, (0.8, 0.999)),
             ("S<chunk", 2, 3, 48, 9, 16, True, 128, (0.8, 0.999)),
             ("decay 1", 1, 2, 256, 33, 8, False, 64, (1.0, 1.0)),
             ("decay 0", 1, 2, 256, 33, 8, False, 64, (0.0, 0.0)),
             ("16 chunks", 1, 2, 2048, 33, 8, False, 128, (0.8, 0.999)),
             ("zamba2 S=128", 4, 32, 128, 160, 64, False, 128, (0.8, 0.999)),
             ("xlstm S=128", 4, 4, 128, 385, 192, True, 64, (0.8, 0.999))]


def _ssm_case(dev, b, h, s, p, n, per_head, decays, seed=0):
    """Kernel-layout inputs on ``dev``: x standard normal, decays uniform
    over ``decays``, b/c normal of variance 1 / N."""
    rng = np.random.default_rng(seed)
    bc = (b, h, s, n) if per_head else (b, s, n)
    arrays = (rng.standard_normal((b, h, s, p)),
              rng.uniform(*decays, (b, h, s)),
              rng.standard_normal(bc) / np.sqrt(n),
              rng.standard_normal(bc) / np.sqrt(n))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label,b,h,s,p,n,per_head,chunk,decays", SSM_CASES,
                         ids=[c[0] for c in SSM_CASES])
def test_ssm_kernel_matches_plain_version_and_oracle(
        hopper, label, b, h, s, p, n, per_head, chunk, decays, dtype):
    from repro_torch.kernels import ref as tref
    args = [t.to(getattr(torch, dtype))
            for t in _ssm_case(hopper, b, h, s, p, n, per_head, decays)]
    before = _launches("ssm_scan")
    got = tscan.ssm_scan_fused(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert _launches("ssm_scan") == before + 1
    rtol, rtol_o = SSM_RTOLS[dtype]
    want = tscan.ssm_scan_plain(*args, chunk=chunk)
    for g, w, name in zip(got, want, ("y", "h")):
        assert g.dtype == args[0].dtype
        assert_close(g.float().cpu().numpy(), w.float().cpu().numpy(),
                     rtol=rtol, name=f"{label} {name} vs plain")
    x, a, bb, cc = (t.float() for t in args)
    mv = lambda t: t.transpose(1, 2) if t.dim() == 4 else t
    oy, oh = tref.ssm_scan(mv(x), a.transpose(1, 2), mv(bb), mv(cc))
    assert_close(got[0].float().transpose(1, 2).cpu().numpy(),
                 oy.cpu().numpy(), rtol=rtol_o, name=f"{label} y vs oracle")
    assert_close(got[1].float().cpu().numpy(), oh.cpu().numpy(),
                 rtol=rtol_o, name=f"{label} h vs oracle")


@pytest.mark.parametrize("dtype,b,h,s,p,n,per_head,chunk", [
    ("float32", 2, 4, 128, 40, 16, False, 64),
    ("bfloat16", 4, 32, 512, 160, 64, False, 128),      # zamba2-2.7b's
    ("bfloat16", 4, 4, 512, 385, 192, True, 64)],       # xlstm-125m's
    ids=["small", "zamba2", "xlstm"])
def test_ssm_kernel_reads_views_and_ops_layout(hopper, dtype, b, h, s, p, n,
                                               per_head, chunk):
    """ops.ssm_scan's (B, S, H, P) inputs reach the kernel as strided
    views, shared B/C with a head stride of 0: the answers equal the
    kernel's on contiguous (B, H, S, P) copies bit for bit."""
    x, a, bb, cc = (t.to(getattr(torch, dtype)) for t in _ssm_case(
        hopper, b, h, s, p, n, per_head, (0.8, 0.99)))
    mv = lambda t: t.transpose(1, 2).contiguous()
    y, hf = TK.ssm_scan(mv(x), mv(a), *((mv(bb), mv(cc)) if per_head
                                        else (bb, cc)),
                        chunk=chunk, device=hopper)
    want_y, want_h = tscan.ssm_scan_fused(x, a, bb, cc, chunk=chunk)
    assert torch.equal(y.transpose(1, 2), want_y)
    assert torch.equal(hf, want_h)


def test_ssm_registry_case_and_guards_on_card(hopper):
    spec = TK.get("ssm_scan")
    args = [t.to(hopper) for t in spec.make_case(np.random.default_rng(0),
                                                 spec.sizes[0])]
    for g, w in zip(spec.run_kernel(*args), spec.run_oracle(*args)):
        assert_close(g.cpu().numpy(), w.cpu().numpy(), rtol=spec.rtol,
                     name="ssm registry case")
    x, a, bb, cc = _ssm_case(hopper, 1, 2, 100, 4, 8, False, (0.8, 0.99))
    with pytest.raises(ValueError):              # 100 % 64 != 0
        tscan.ssm_scan_fused(x, a, bb, cc, chunk=64)
    x, a, bb, cc = _ssm_case(hopper, 1, 2, 512, 4, 8, False, (0.8, 0.99))
    with pytest.raises(ValueError):              # chunk 256 > 128
        tscan.ssm_scan_fused(x, a, bb, cc, chunk=256)
    # shared memory of a CTA's narrowest form (one tile, one slot): 57472
    # floats at chunk 128, N = 128 fit 227 KB, N = 129 does not (a CTA
    # holds M^T, C^T, B w, the x tile and a slot of N x 32); at chunk 64
    # every N up to 256 fits (64-column tiles); every shape the one-CTA
    # kernel took still fits
    assert tscan.kernel_fits(128, 128) and not tscan.kernel_fits(128, 129)
    assert tscan.kernel_fits(64, 256) and not tscan.kernel_fits(64, 257)
    assert tscan.ssm_smem(128, 128, 1) <= common.MAX_SMEM_BYTES \
        < tscan.ssm_smem(128, 129, 1)
    for cs, n in ((128, 128), (64, 256), (96, 201), (80, 252), (48, 256)):
        assert tscan.kernel_fits(cs, n)
    x, a, bb, cc = _ssm_case(hopper, 1, 2, 128, 4, 160, False, (0.8, 0.99))
    with pytest.raises(ValueError):              # N 160 past shared memory
        tscan.ssm_scan_fused(x, a, bb, cc, chunk=128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label,b,h,s,p,n,per_head,chunk,decays", SSM_CASES,
                         ids=[c[0] for c in SSM_CASES])
def test_ssm_every_cluster_form_gives_the_plans_bits(
        hopper, label, b, h, s, p, n, per_head, chunk, decays, dtype):
    """Every form ssm_check_forms holds (each cluster size the plan can
    pick, and the narrowest lane) gives the plan's answer bit for bit; a
    plan off the forms raises ValueError."""
    args = [t.to(getattr(torch, dtype))
            for t in _ssm_case(hopper, b, h, s, p, n, per_head, decays)]
    cs = min(chunk, s)
    forms = tscan.ssm_check_forms(b, h, s, p, n, cs)
    want = tscan.ssm_scan_fused(*args, chunk=chunk)
    for form in forms:
        got = tscan.ssm_scan_fused(*args, chunk=chunk, plan=form)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), form
    with pytest.raises(ValueError):
        tscan.ssm_scan_fused(*args, chunk=chunk,
                             plan=forms[0]._replace(clusters=3))


@pytest.mark.parametrize("b,h,s,p,n,per_head,chunk", [
    (4, 32, 512, 160, 64, False, 128), (4, 4, 512, 385, 192, True, 64),
    (1, 2, 2048, 33, 8, False, 128)], ids=["zamba2", "xlstm", "16chunks"])
def test_ssm_phase_stamps_are_ordered_and_cover_the_cta(hopper, b, h, s, p,
                                                        n, per_head, chunk):
    """K21's phase-stamped instance: its answer equals the served
    kernel's bit for bit at every check form; each scan CTA's stamps are
    ordered and its phases add up to its time; each gram CTA's clock
    runs forward."""
    args = _ssm_case(hopper, b, h, s, p, n, per_head, (0.8, 0.999))
    before = _launches("ssm_scan")
    for form in tscan.ssm_check_forms(b, h, s, p, n, chunk):
        (y, hf), stamps, gram, plan = tscan.ssm_phases(*args, chunk=chunk,
                                                       plan=form)
        want = tscan.ssm_scan_fused(*args, chunk=chunk, plan=form)
        torch.cuda.synchronize()
        assert plan == form
        assert torch.equal(y, want[0]) and torch.equal(hf, want[1])
        st = stamps.cpu()
        total = st[:, 1] - st[:, 0]
        assert stamps.shape == (
            b * h * tscan.ssm_groups(p, chunk, form.tiles) * form.clusters,
            2 + len(tscan.SSM_PHASES))
        assert (total > 0).all() and (st[:, 2:] >= 0).all()
        assert torch.equal(st[:, 2:].sum(dim=1), total)
        g = gram.cpu()
        assert (g[:, 1] > g[:, 0]).all()
    # the stamped instance is not the counted entry
    assert _launches("ssm_scan") == before + len(
        tscan.ssm_check_forms(b, h, s, p, n, chunk))


def _to_device(tree, dev):
    """A parameter tree's tensors copied to ``dev``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("arch,k21,k20", [("zamba2-2.7b", 4, 2),
                                          ("xlstm-125m", 3, 0)])
def test_hybrid_and_xlstm_prefill_launch_counts(hopper, arch, k21, k20):
    """The smoke models' prefill on the card (f32 compute, attention by
    K20): K21 once a Mamba2 or mLSTM layer, K20 once an application of
    the shared block, and the logits of the plain versions on the CPU on
    the same weights (1e-3: the two scans and attentions sum in other
    orders)."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tT
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32",
                              attn_impl="flash")
    gen = torch.Generator()
    gen.manual_seed(0)
    p = tT.init_params(gen, cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 128)))
    before = (_launches("ssm_scan"), _launches("flash_attention"))
    got = tT.prefill(_to_device(p, hopper), cfg,
                     {"tokens": toks.to(hopper)})
    torch.cuda.synchronize()
    assert (_launches("ssm_scan") - before[0],
            _launches("flash_attention") - before[1]) == (k21, k20)
    want = tT.prefill(p, cfg, {"tokens": toks})
    assert_close(got.cpu().numpy(), want.numpy(), rtol=1e-3,
                 name=f"{arch} prefill card vs cpu")


# ---------------- K3's and K6's warp forms (a lane on a warp) ----------

tmmse = importlib.import_module("repro_torch.pipelines.mmse")
tpusch = importlib.import_module("repro_torch.pipelines.pusch")
LANE_PHASES = importlib.import_module(
    "repro_torch.pipelines.warp_chain").LANE_PHASES
WARP_SIZES = [8, 12, 16, 24, 32]           # the slot mixes' and DAGs' n
WARP_BATCHES = [1, 4, 32, 3276]


def _split_lanes(dev, b, n, k=2, seed=0):
    """K3 lanes at m = n + 4 with, where the batch has them, a rank-
    deficient lane (1: Hr's and Hi's column 1 a copy of column 0), a zero
    channel (2, the guard of chip_smoke.py) and a NaN lane (3)."""
    rng = np.random.default_rng(seed)
    m = n + 4
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    hr, hi, yr, yi = f(b, m, n), f(b, m, n), f(b, m, k), f(b, m, k)
    if b > 3 and n > 1:
        hr[1, :, 1], hi[1, :, 1] = hr[1, :, 0], hi[1, :, 0]
        hr[2], hi[2] = 0.0, 0.0
        hr[3, 0, 0] = np.nan
    return tuple(torch.from_numpy(a).to(dev) for a in (hr, hi, yr, yi))


def _chain_lanes(dev, b, n, k=2, seed=0):
    """K6 lanes at p = 2n, m = n + 4 with, where the batch has them, a
    deficient pilot block (lane 1: pilot row 1 a copy of row 0), zero
    observations (2) and a NaN lane (3)."""
    rng = np.random.default_rng(seed)
    m, p = n + 4, 2 * n
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    xp, yp, y = f(b, n, p), f(b, m, p), f(b, m, k)
    if b > 3 and n > 1:
        xp[1, 1] = xp[1, 0]
        yp[2] = 0.0
        xp[3, 0, 0] = np.nan
    return tuple(torch.from_numpy(a).to(dev) for a in (xp, yp, y))


def _warp_form_agrees(kernel, fused, args):
    """The served (warp) form's answer bit for bit the CTA form's (the
    kernel of earlier slices); the served launch counted as one warp
    launch."""
    k = next(k for k in KERNELS if k.name == kernel)
    cta = fused(*args, form="cta")
    before = (k.launches, k.launches_warp)
    got = fused(*args)
    torch.cuda.synchronize()
    assert (k.launches - before[0], k.launches_warp - before[1]) == (1, 1)
    assert torch.equal(_bits(got), _bits(cta))
    return got


@pytest.mark.parametrize("b", WARP_BATCHES)
@pytest.mark.parametrize("n", WARP_SIZES)
def test_split_warp_form_equals_cta_form_bit_for_bit(hopper, n, b):
    """K3 a warp a lane against a CTA a lane at every slot-mix size and batch, deficient, zero and NaN lanes among
    them bit for bit; the well-posed lanes within rtol of the plain
    version (a deficient lane's answer hangs on rounding: it is held to
    the CTA form's bits alone)."""
    args = _split_lanes(hopper, b, n, seed=n * 10 + b)
    m = n + 4
    assert tmmse.mmse_split_plan(m, n, 2) == "warp"
    got = _warp_form_agrees("mmse_equalize_split",
                            tmmse.mmse_equalize_split_fused, args)
    keep = [i for i in range(b) if i not in (1, 3) or b <= 3]
    assert_close(got[keep].cpu().numpy(), tmmse.mmse_equalize_split_plain(
        *args)[keep].cpu().numpy(), rtol=1e-4, name=f"K3 warp n={n}")
    if b > 3:
        assert bool(torch.isfinite(got[:3]).all())
        assert bool((got[2].abs() < 1e-5).all())


@pytest.mark.parametrize("n,k", [(1, 1), (3, 2), (13, 3), (17, 2),
                                 (29, 8), (31, 4), (32, 1), (32, 8)])
def test_split_warp_form_at_odd_sizes_and_right_hand_sides(hopper, n, k):
    """K3's warp form at n off the tiles' multiple of 4, at 2n just past
    32 rows and at every instance of its right-hand sides (1, 2, 4, 8):
    the CTA form's bits."""
    args = _split_lanes(hopper, 300, n, k=k, seed=n + 100 * k)
    _warp_form_agrees("mmse_equalize_split",
                      tmmse.mmse_equalize_split_fused, args)


@pytest.mark.parametrize("b", WARP_BATCHES)
@pytest.mark.parametrize("n", WARP_SIZES)
def test_pusch_warp_form_equals_cta_form_bit_for_bit(hopper, n, b):
    """K6 a warp a lane against a CTA a lane at every DAG size and batch,
    deficient, zero and NaN lanes among them bit for bit; the well-posed
    lanes within rtol of the plain version (a deficient lane's answer
    hangs on rounding: it is held to the CTA form's bits alone)."""
    args = _chain_lanes(hopper, b, n, seed=n * 10 + b)
    m, p = n + 4, 2 * n
    assert tpusch.pusch_chain_plan(n, p, m, 2) == "warp"
    got = _warp_form_agrees("pusch_chain", tpusch.pusch_chain_fused, args)
    keep = [i for i in range(b) if i not in (1, 3) or b <= 3]
    assert_close(got[keep].cpu().numpy(), tpusch.pusch_chain_plain(
        *args)[keep].cpu().numpy(), rtol=1e-4, name=f"K6 warp n={n}")


@pytest.mark.parametrize("n,k", [(1, 1), (5, 2), (13, 3), (20, 8),
                                 (31, 4), (32, 1)])
def test_pusch_warp_form_at_odd_sizes_and_right_hand_sides(hopper, n, k):
    args = _chain_lanes(hopper, 300, n, k=k, seed=n + 100 * k)
    _warp_form_agrees("pusch_chain", tpusch.pusch_chain_fused, args)


def test_split_global_form_equals_the_warp_form_at_n_32(hopper,
                                                        monkeypatch):
    """Where the warp form runs, the global form (forced by a
    shared-memory limit of 0) still gives its bits."""
    args = _split_lanes(hopper, 64, 32, seed=3)
    k = next(k for k in KERNELS if k.name == "mmse_equalize_split")
    warp = tmmse.mmse_equalize_split_fused(*args)
    before = (k.launches_global, k.launches_warp)
    monkeypatch.setattr(common, "MAX_SMEM_BYTES", 0)
    glob = tmmse.mmse_equalize_split_fused(*args)
    torch.cuda.synchronize()
    assert (k.launches_global, k.launches_warp) == (before[0] + 1,
                                                    before[1])
    assert torch.equal(_bits(glob), _bits(warp))


def test_channel_estimate_is_untouched_by_the_warp_forms(hopper):
    """K5 at a carrier's width, in its warp form: its lanes match the
    plain version and each lane's answer is its own alone, the CTA
    form's bits."""
    xp, yp, _ = _chain_lanes(hopper, 3276, 32, seed=9)
    got = tp.channel_estimate_fused(xp, yp)
    alone = tp.channel_estimate_fused(xp[5:6].contiguous(),
                                      yp[5:6].contiguous(), form="cta")
    torch.cuda.synchronize()
    assert torch.equal(_bits(got[5:6]), _bits(alone))
    keep = [i for i in range(3276) if i not in (1, 3)]
    assert_close(got[keep].cpu().numpy(), tp.channel_estimate_plain(
        xp, yp)[keep].cpu().numpy(), rtol=1e-4, name="K5 n=32")


def test_warp_form_refused_off_its_plan_by_the_c_entry(hopper):
    """The C entries refuse a warp launch past n = 32 or k = 8 (K6: also
    past the stage-1 tiles four slots a thread hold)."""
    args = _split_lanes(hopper, 4, 8)
    x = torch.empty((4, 16, 2), device=hopper)
    ptrs = [t.data_ptr() for t in args] + [x.data_ptr(), None]
    for n, k in ((33, 2), (8, 9)):
        with pytest.raises(RuntimeError, match="launch failed"):
            tmmse._SPLIT_KERNEL.launch(hopper, (12, 8, 2), *ptrs, 4, 12, n,
                                       k, 0.1, 1e-5, 1, 0, 0, 0)
    xp, yp, y = _chain_lanes(hopper, 4, 8)
    out = torch.empty((4, 8, 2), device=hopper)
    for n, m, k in ((33, 12, 2), (8, 12, 9), (32, 48, 2)):
        with pytest.raises(RuntimeError, match="launch failed"):
            tpusch._CHAIN.launch(hopper, (8, 16, 12, 2), xp.data_ptr(),
                                 yp.data_ptr(), y.data_ptr(), out.data_ptr(),
                                 4, n, 16, m, k, 1e-3, 0.1, 1e-5, 1)


def test_warp_lane_bytes_match_the_c_entries(hopper):
    """The plans' lane bytes (mmse_split_warp_smem, pusch_warp_smem) are
    the kernels' own (the C entries' *_warp_smem) at every n <= 32."""
    lib = common.load_library()
    for fn in (lib.mmse_equalize_split_warp_smem, lib.pusch_chain_warp_smem):
        fn.restype = ctypes.c_size_t
    for n in range(1, 33):
        for m, k in ((n, 1), (n + 4, 2), (2 * n + 3, 8)):
            assert lib.mmse_equalize_split_warp_smem(m, n, k) == \
                tmmse.mmse_split_warp_smem(m, n, k)
            for p in (n, 2 * n, 70):
                assert lib.pusch_chain_warp_smem(n, p, m, k) == \
                    tpusch.pusch_warp_smem(n, p, m, k)


@pytest.mark.parametrize("kernel,n,b", [("mmse_equalize_split", 32, 300),
                                        ("mmse_equalize_split", 8, 32),
                                        ("pusch_chain", 32, 300),
                                        ("pusch_chain", 24, 32),
                                        ("mmse_equalize", 32, 300),
                                        ("mmse_equalize", 8, 4),
                                        ("mmse_equalize", 128, 32),
                                        ("mmse_equalize", 64, 300),
                                        ("channel_estimate", 32, 300),
                                        ("channel_estimate", 8, 4)])
def test_lane_phase_stamps_are_ordered_and_cover_the_kernel(hopper, kernel,
                                                            n, b):
    """The warp forms' (and K2's wide form's) phase-stamped instances give
    the served bits; each lane's stamps are ordered and its phases add up
    to its time; K2, K3 and K5 leave K6's second chain's phases at 0."""
    if kernel == "mmse_equalize_split":
        args = _split_lanes(hopper, b, n, seed=4)
        fused, stamped = (tmmse.mmse_equalize_split_fused,
                          tmmse.mmse_equalize_split_phases)
    elif kernel == "pusch_chain":
        args = _chain_lanes(hopper, b, n, seed=4)
        fused, stamped = tpusch.pusch_chain_fused, tpusch.pusch_chain_phases
    elif kernel == "mmse_equalize":
        args = _mmse_lanes(hopper, b, n, seed=4)
        fused, stamped = (tmmse.mmse_equalize_fused,
                          tmmse.mmse_equalize_phases)
    else:
        args = _chain_lanes(hopper, b, n, seed=4)[:2]
        fused, stamped = (tpusch.channel_estimate_fused,
                          tpusch.channel_estimate_phases)
    before = _launches(kernel)
    x, stamps = stamped(*args)
    torch.cuda.synchronize()
    assert _launches(kernel) == before
    assert torch.equal(_bits(x), _bits(fused(*args)))
    st = stamps.cpu()
    assert st.shape == (b, 2 + len(LANE_PHASES))
    assert bool((st[:, 1] > st[:, 0]).all() and (st[:, 2:] >= 0).all())
    assert torch.equal(st[:, 2:].sum(dim=1), st[:, 1] - st[:, 0])
    if kernel != "pusch_chain":
        assert not bool(st[:, 2 + 4:2 + 7].any())


# ---------------- K2's and K5's warp forms, K2's wide form ----------

def _mmse_lanes(dev, b, n, k=2, seed=0):
    """K2 lanes at m = n + 4 with, where the batch has them, a rank-
    deficient channel (lane 1: column 1 a copy of column 0), a zero
    channel (2, the guard of chip_smoke.py) and a NaN lane (3)."""
    rng = np.random.default_rng(seed)
    m = n + 4
    h = rng.standard_normal((b, m, n)).astype(np.float32)
    y = rng.standard_normal((b, m, k)).astype(np.float32)
    if b > 3 and n > 1:
        h[1, :, 1] = h[1, :, 0]
        h[2] = 0.0
        h[3, 0, 0] = np.nan
    return torch.from_numpy(h).to(dev), torch.from_numpy(y).to(dev)


def _mmse_form_agrees(args, form=None):
    """K2 in ``form`` (default its plan's) bit for bit its CTA form, the
    launch counted once, in that form's count."""
    k = next(k for k in KERNELS if k.name == "mmse_equalize")
    _, m, n = args[0].shape
    want = form or tmmse.mmse_form(m, n, args[1].shape[-1])
    cta = tmmse.mmse_equalize_fused(*args, form="cta")
    before = (k.launches, k.launches_warp, k.launches_wide)
    got = tmmse.mmse_equalize_fused(*args, form=form)
    torch.cuda.synchronize()
    assert (k.launches - before[0], k.launches_warp - before[1],
            k.launches_wide - before[2]) == (1, int(want == "warp"),
                                             int(want == "wide"))
    assert torch.equal(_bits(got), _bits(cta))
    return got


def _well_posed(b):
    return [i for i in range(b) if i not in (1, 3) or b <= 3]


@pytest.mark.parametrize("b", [1, 37, 300])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 12, 13, 16, 17, 24, 29, 31,
                               32])
def test_mmse_warp_form_equals_cta_form_bit_for_bit(hopper, n, k, b):
    """K2 a warp a lane against a CTA a lane at every edge of the warp (n
    = 1-32, every right-hand-side instance 1, 2, 4, 8), deficient, zero
    and NaN lanes among them bit for bit; the well-posed lanes within
    1e-4 of the plain version."""
    args = _mmse_lanes(hopper, b, n, k=k, seed=n * 100 + k * 10 + b)
    assert tmmse.mmse_form(n + 4, n, k) == "warp"
    got = _mmse_form_agrees(args)
    keep = _well_posed(b)
    assert_close(got[keep].cpu().numpy(), tmmse.mmse_equalize_plain(
        *args)[keep].cpu().numpy(), rtol=1e-4, name=f"K2 warp n={n} k={k}")
    if b > 3:
        assert bool(torch.isfinite(got[:3]).all())


@pytest.mark.parametrize("n", [33, 64, 97, 128, 168])
def test_mmse_wide_form_equals_cta_form_bit_for_bit(hopper, n):
    """K2 on a CTA of its plan's W warps against a CTA a lane (37 lanes
    with deficient, zero and NaN ones, then 32 and 300 lanes), bit for
    bit; the well-posed lanes within 1e-4 of the plain version."""
    m = n + 4
    assert tmmse.mmse_form(m, n, 2) == "wide"
    assert tmmse.mmse_wide_plan(m, n, 2)
    args = _mmse_lanes(hopper, 37, n, seed=n)
    got = _mmse_form_agrees(args, "wide")
    keep = _well_posed(37)
    assert_close(got[keep].cpu().numpy(), tmmse.mmse_equalize_plain(
        *args)[keep].cpu().numpy(), rtol=1e-4, name=f"K2 wide n={n}")
    assert bool(torch.isfinite(got[:3]).all())
    assert bool((got[2].abs() < 1e-5).all())
    for b in (32, 300):
        _mmse_form_agrees(_mmse_lanes(hopper, b, n, seed=n + b))


@pytest.mark.parametrize("n,k", [(33, 1), (40, 3), (64, 8), (97, 5),
                                 (128, 1), (128, 9)])
def test_mmse_wide_form_at_odd_right_hand_sides(hopper, n, k):
    """The wide form's tiles of y (k off a multiple of 4; k = 9, three
    tiles a row): the CTA form's bits."""
    args = _mmse_lanes(hopper, 37, n, k=k, seed=n + 100 * k)
    _mmse_form_agrees(args, "wide")


@pytest.mark.parametrize("b", [1, 37, 300])
@pytest.mark.parametrize("n,p", [(1, 2), (3, 6), (5, 7), (8, 16), (13, 26),
                                 (16, 33), (17, 40), (24, 48), (31, 62),
                                 (32, 64), (32, 65), (32, 100)])
def test_chanest_warp_form_equals_cta_form_bit_for_bit(hopper, n, p, b):
    """K5 a warp a lane against a CTA a lane at every edge of the warp and
    at pilot counts across the 32-pilot chunks, deficient, zero and NaN
    lanes among them bit for bit, each default call one warp launch; the
    well-posed lanes within 1e-4 of the plain version."""
    rng = np.random.default_rng(n * 1000 + p * 10 + b)
    m = n + 4
    xp = rng.standard_normal((b, n, p)).astype(np.float32)
    yp = rng.standard_normal((b, m, p)).astype(np.float32)
    if b > 3 and n > 1:
        xp[1, 1] = xp[1, 0]
        yp[2] = 0.0
        xp[3, 0, 0] = np.nan
    xp, yp = torch.from_numpy(xp).to(hopper), torch.from_numpy(yp).to(hopper)
    assert tpusch.channel_estimate_plan(n, p, m) == "warp"
    k = next(k for k in KERNELS if k.name == "channel_estimate")
    cta = tpusch.channel_estimate_fused(xp, yp, form="cta")
    before = (k.launches, k.launches_warp)
    got = tpusch.channel_estimate_fused(xp, yp)
    torch.cuda.synchronize()
    assert (k.launches - before[0], k.launches_warp - before[1]) == (1, 1)
    assert torch.equal(_bits(got), _bits(cta))
    keep = _well_posed(b)
    assert_close(got[keep].cpu().numpy(), tpusch.channel_estimate_plain(
        xp, yp)[keep].cpu().numpy(), rtol=1e-4, name=f"K5 warp n={n}")


def test_mmse_and_chanest_forms_refused_off_their_plans_by_the_c_entry(
        hopper):
    """The C entries refuse K2's warp form past n = 32 or k = 8, its wide
    form on a thread count off a warp multiple, under its tiles one a
    thread or past 1024, a form number they do not know, and K5's warp
    form past n = 32 or its tiles four a thread."""
    h, y = _mmse_lanes(hopper, 4, 64)
    x = torch.empty((4, 64, 2), device=hopper)
    ptrs = [h.data_ptr(), y.data_ptr(), x.data_ptr(), None]
    for n, k, form, threads in ((33, 2, 1, 0), (8, 9, 1, 0), (64, 2, 2, 48),
                                (128, 2, 2, 64), (64, 2, 2, 2048),
                                (64, 2, 3, 0)):
        with pytest.raises(RuntimeError, match="launch failed"):
            tmmse._KERNEL.launch(hopper, (68, 64, 2), *ptrs, 4, n + 4, n, k,
                                 0.1, 1e-5, threads, 0, 0, form)
    xp, yp, _ = _chain_lanes(hopper, 4, 8)
    out = torch.empty((4, 12, 8), device=hopper)
    for n, m in ((33, 12), (32, 48)):
        with pytest.raises(RuntimeError, match="launch failed"):
            tpusch._CHANEST.launch(hopper, (8, 16, 12), xp.data_ptr(),
                                   yp.data_ptr(), out.data_ptr(), 4, n, 16,
                                   m, 1e-3, 1e-5, 1)


def test_mmse_and_chanest_lane_bytes_match_the_c_entries(hopper):
    """The plans' lane bytes (mmse_cta_smem, mmse_warp_smem,
    mmse_wide_smem, K5's pusch_warp_smem at k = 0) are the kernels' own
    (the C entries' *_smem)."""
    lib = common.load_library()
    for fn in (lib.mmse_equalize_smem, lib.mmse_equalize_warp_smem,
               lib.mmse_equalize_wide_smem, lib.channel_estimate_warp_smem):
        fn.restype = ctypes.c_size_t
    for n in (1, 7, 8, 31, 32, 33, 64, 97, 128, 168):
        for m, k in ((n, 1), (n + 4, 2), (2 * n + 3, 8)):
            assert lib.mmse_equalize_smem(m, n, k) == \
                tmmse.mmse_cta_smem(m, n, k)
            if n <= 32:
                assert lib.mmse_equalize_warp_smem(m, n, k) == \
                    tmmse.mmse_warp_smem(m, n, k)
                for p in (n, 2 * n, 70):
                    assert lib.channel_estimate_warp_smem(n, p, m) == \
                        tpusch.pusch_warp_smem(n, p, m, 0)
            for w in (2, 8, 32):
                assert lib.mmse_equalize_wide_smem(m, n, k, w) == \
                    tmmse.mmse_wide_smem(m, n, k, w)
