#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (compute capability 9.0) and the CUDA
toolkit's ``nvcc``; exits non-zero without a result line otherwise.
Phases, each fatal on failure:

  1. device  — the card's name and power limit (nvidia-smi), TF32 off;
  2. build   — every kernel in src/repro_torch/csrc built from source;
  3. kernels — K1-K9 held against their plain PyTorch versions and the
               oracles at the registry sizes, at a slot's real width
               (B = 3276 lanes: one 100 MHz carrier at 30 kHz SCS, 273
               PRBs x 12 subcarriers, 3GPP TS 38.101-1 Table 5.3.2-1;
               the FFT over 3276 (n + 4) antenna rows of 64 points and
               3276 rows of 1024) and on the guard cases (poisoned upper
               triangle, singular and rank-deficient lanes, filler lanes,
               a unit impulse).  The SVD is held by sorted spectrum and
               reconstruction, its factors being sign/order ambiguous;
  4. serve   — the main paths, each with every kernel's launch count
               reset before and read after: the TTI slot mix
               (``repro_torch.launch.serve_solvers.main`` on two mixes and
               the committed overload trace replayed to its golden file)
               and the served DAGs (``main --pusch`` staged with the
               committed fault trace and chained, at n = 8 and at n = 24
               with 32 lanes over 8 ticks, and the committed PUSCH trace
               replayed to its golden file);
  5. times   — each kernel at B = 3276 timed with CUDA events (cold L2)
               beside its bound, its plain version and, where one PyTorch
               call computes the same function, that call.

The second-to-last lines are the ``{"kernels": [...]}`` JSON line and the
card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

LANES = 3276                 # one 100 MHz carrier at 30 kHz SCS
SLOT_SIZES = (8, 16, 32)
NFFT = 64                    # the PUSCH DAG's OFDM size
NFFT_MAX = 1024              # the largest registered FFT size
SWEEPS = 14                  # Jacobi sweeps of the served svd_factor stage
PEAK_F32_FLOPS = 67e12       # H100 SXM, float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12     # H100 SXM HBM3
RTOL = 1e-4                  # the solver specs' rtol
SVD_RTOL = 4.0 * (2.0 ** -23) ** 0.5   # 4 sqrt(eps_f32), the SVD specs'
RTOLS = {"fft": 1e-3, "pusch_fft": 1e-3, "svd": SVD_RTOL,
         "svd_factor": SVD_RTOL}
# check key -> the kernel it runs (stage adapters run a kernel of their own)
KERNEL_OF = {"pusch_fft": "fft", "svd_factor": "svd"}
# registry spec -> check key
KEY_OF_SPEC = {"pusch_chanest": "channel_estimate"}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def close(got, want, rtol=RTOL):
    """assert_close semantics of the test suite: |got - want| <=
    rtol * max|want| + rtol * |want| elementwise, over each tensor of a
    tuple.  Returns (ok, max |diff|)."""
    import torch
    if isinstance(got, tuple):
        res = [close(g, w, rtol) for g, w in zip(got, want)]
        return all(ok for ok, _ in res), max(err for _, err in res)
    got = got.double()
    want = want.double()
    err = (got - want).abs()
    tol = rtol * want.abs().max() + 1e-12 + rtol * want.abs()
    ok = bool(torch.all(err <= tol)) and bool(torch.isfinite(got).all())
    return ok, float(err.max()) if err.numel() else 0.0


def main():
    import numpy as np
    import torch

    # ---------------- 1. device ----------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if torch.cuda.get_device_capability(0) != (9, 0):
        fail(f"{torch.cuda.get_device_name(0)} is not a Hopper card "
             f"(capability {torch.cuda.get_device_capability(0)})")
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from repro_torch import kernels as K
    from repro_torch import pipelines as pp
    from repro_torch.kernels import common, ref
    from repro_torch.kernels import fft as F
    from repro_torch.kernels import svd as S
    from repro_torch.kernels.common import sample_spd
    from repro_torch.kernels.svd import spectrum_recon

    # ---------------- 2. build ----------------
    t0 = time.perf_counter()
    common.load_library()
    print(f"build: {common.build_info['seconds']:.1f}s nvcc, "
          f"{time.perf_counter() - t0:.1f}s to load "
          f"({common.build_info['path']})", flush=True)
    for line in common.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    kern = {k.name: k for k in common.KERNELS}
    fused = {"cholesky_solve": pp.cholesky_solve_fused,
             "mmse_equalize": pp.mmse_equalize_fused,
             "mmse_equalize_split": pp.mmse_equalize_split_fused,
             "qr_solve": pp.qr_solve_fused,
             "channel_estimate": pp.channel_estimate_fused,
             "pusch_chain": pp.pusch_chain_fused,
             "fft": lambda xr, xi: torch.stack(F.fft_fused(xr, xi)),
             "pusch_fft": pp.pusch_fft_fused,
             "svd": lambda a: spectrum_recon(*S.svd_fused(a, SWEEPS)),
             "svd_factor": lambda a: spectrum_recon(*pp.unpack_factors(
                 pp.svd_factor_fused(a))),
             "svd_apply": pp.svd_apply_fused}
    plain = {"cholesky_solve": pp.cholesky_solve_plain,
             "mmse_equalize": pp.mmse_equalize_plain,
             "mmse_equalize_split": pp.mmse_equalize_split_plain,
             "qr_solve": pp.qr_solve_plain,
             "channel_estimate": pp.channel_estimate_plain,
             "pusch_chain": pp.pusch_chain_plain,
             "fft": lambda xr, xi: torch.stack(F.fft_plain(xr, xi)),
             "pusch_fft": pp.pusch_fft_plain,
             "svd": lambda a: spectrum_recon(*S.svd_plain(a, SWEEPS)),
             "svd_factor": lambda a: spectrum_recon(*pp.unpack_factors(
                 pp.svd_factor_plain(a))),
             "svd_apply": pp.svd_apply_plain}
    oracle = {"cholesky_solve": ref.cholesky_solve,
              "mmse_equalize": ref.mmse_equalize,
              "mmse_equalize_split": ref.mmse_equalize_split,
              "qr_solve": ref.qr_solve,
              "channel_estimate": ref.channel_estimate,
              "pusch_chain": ref.pusch_chain,
              "fft": lambda xr, xi: torch.stack(ref.fft(xr, xi)),
              "pusch_fft": ref.pusch_fft,
              "svd": lambda a: (ref.svd_vals(a), a),
              "svd_factor": lambda a: (ref.svd_vals(a), a),
              "svd_apply": ref.svd_apply}
    if set(kern) != {KERNEL_OF.get(key, key) for key in fused}:
        fail(f"kernel set {sorted(kern)} != {sorted(fused)}")
    max_err = {name: 0.0 for name in kern}
    failures = []

    def check(key, args, label, oracle_args=None):
        """Kernel vs plain version (same card inputs) vs oracle (on
        ``oracle_args``, default the same inputs)."""
        rtol = RTOLS.get(key, RTOL)
        got = fused[key](*args)
        torch.cuda.synchronize()
        want = plain[key](*args)
        ok, err = close(got, want, rtol)
        name = KERNEL_OF.get(key, key)
        max_err[name] = max(max_err[name], err)
        ok_o, err_o = close(got, oracle[key](*(oracle_args or args)), rtol)
        status = "ok" if ok and ok_o else "MISMATCH"
        print(f"  {key:<20} {label:<28} |kernel-plain| {err:.3e}  "
              f"|kernel-oracle| {err_o:.3e}  (rtol {rtol:.3g}) {status}",
              flush=True)
        if not (ok and ok_o):
            failures.append(f"{key} {label}")
        return got

    def rand(rng, *shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    def slot_case(key, rng, b, n):
        """The main paths' own per-lane shapes: the slot mix's
        (build_slot_jobs) and the PUSCH DAG's (m = n + 4 antennas,
        p = 2n pilots, k = 2 data symbols, 64-point FFT)."""
        m, p = n + 4, 2 * n
        f = lambda *s: rand(rng, *s)
        if key == "cholesky_solve":
            return (torch.from_numpy(sample_spd(rng, b, n)).to(dev),
                    f(b, n, 2))
        if key == "mmse_equalize":
            return f(b, m, n), f(b, m, 2)
        if key == "mmse_equalize_split":
            return f(b, m, n), f(b, m, n), f(b, m, 2), f(b, m, 2)
        if key == "qr_solve":
            return f(b, m, n), f(b, m, 1)
        if key == "channel_estimate":
            return f(b, n, p), f(b, m, p)
        if key == "pusch_chain":
            return f(b, n, p), f(b, m, p), f(b, m, 2)
        if key == "pusch_fft":
            return f(b, m, NFFT), f(b, m, NFFT)
        if key in ("svd", "svd_factor"):
            return (f(b, m, n),)
        if key == "svd_apply":          # factors of a real channel
            return pp.svd_factor_fused(f(b, m, n)), f(b, m, 2)
        raise KeyError(key)

    # ---------------- 3. kernels against plain versions ----------------
    print("kernels vs plain versions and oracles:", flush=True)
    rng = np.random.default_rng(0)
    for spec in K.specs():
        variants = [(KEY_OF_SPEC.get(spec.name, spec.name), spec.base)] + [
            ("mmse_equalize_split", v) for v in spec.variants
            if v.name == "split_complex"]
        for key, variant in variants:
            for n in variant.sizes:
                args = tuple(a.to(dev) for a in variant.make_case(rng, n))
                check(key, args, f"registry n={n}")
    for key in fused:
        if key == "fft":
            check(key, (rand(rng, LANES, NFFT_MAX),
                        rand(rng, LANES, NFFT_MAX)),
                  f"{LANES} rows of {NFFT_MAX}")
            continue
        for n in SLOT_SIZES:
            check(key, slot_case(key, rng, LANES, n), f"B={LANES} n={n}")

    # guard cases
    a = torch.from_numpy(sample_spd(rng, 2, 16)).to(dev)
    rhs = rand(rng, 2, 16, 2)
    clean = pp.cholesky_solve_fused(a, rhs)
    poisoned = a.clone()
    iu = torch.triu_indices(16, 16, offset=1)
    poisoned[:, iu[0], iu[1]] = float("nan")
    got = check("cholesky_solve", (poisoned, rhs), "poisoned upper",
                oracle_args=(a, rhs))
    if not torch.equal(got, clean):
        failures.append("cholesky_solve: upper-triangle NaN leaked")
    v = rand(rng, 2, 16, 2)
    x = pp.cholesky_solve_fused((v @ v.transpose(-1, -2)).contiguous(),
                                rhs)
    guards = [("cholesky_solve rank 2 of 16", x)]
    zero_h = torch.zeros((1, 16, 12), device=dev)
    y1 = rand(rng, 1, 16, 1)
    xz = pp.mmse_equalize_fused(zero_h, y1)
    guards.append(("mmse_equalize zero channel", xz))
    if not torch.all(xz.abs() < 1e-5):
        failures.append("mmse_equalize: zero channel not ~0")
    xs = pp.mmse_equalize_split_fused(zero_h, zero_h, y1, y1)
    guards.append(("mmse_equalize_split zero channel", xs))
    if not torch.all(xs.abs() < 1e-5):
        failures.append("mmse_equalize_split: zero channel not ~0")
    col = rand(rng, 2, 16, 1)
    qb = rand(rng, 2, 16, 2)
    guards.append(("qr_solve duplicate columns", pp.qr_solve_fused(
        col.repeat(1, 1, 8).contiguous(), qb)))
    guards.append(("qr_solve exact zero pivot", pp.qr_solve_fused(
        torch.tensor([[[0.0, 1.0], [0.0, 0.0], [0.0, 0.0]]], device=dev),
        torch.ones((1, 3, 1), device=dev))))
    xq = pp.qr_solve_fused(torch.zeros((1, 12, 8), device=dev),
                           y1[:, :12].contiguous())
    guards.append(("qr_solve zero matrix", xq))
    if not torch.all(xq == 0):
        failures.append("qr_solve: zero matrix not solved to 0")
    for spec_name, key in (("pusch_chanest", "channel_estimate"),
                           ("pusch_chain", "pusch_chain"),
                           ("svd_apply", "svd_apply")):
        spec = K.get(spec_name)
        for n in SLOT_SIZES:
            case = slot_case(key, rng, 1, n)
            lane = spec.filler(tuple(tuple(t.shape[1:]) for t in case),
                               (np.dtype("float32"),) * len(case))
            out = fused[key](*(torch.from_numpy(t)[None].to(dev)
                               for t in lane))
            guards.append((f"{key} filler lane n={n}", out))
            if not torch.equal(out, torch.zeros_like(out)):
                failures.append(f"{key}: filler lane n={n} not exactly 0")
    for n in SLOT_SIZES:
        low = rand(rng, 1, n + 4, 2) @ rand(rng, 1, 2, n)
        deficient = torch.cat([low, torch.zeros_like(low)]).contiguous()
        u, s, v = S.svd_fused(deficient, SWEEPS)
        guards.append((f"svd rank 2 and rank 0, n={n}", torch.cat(
            [u.flatten(), s.flatten(), v.flatten()])))
        if not torch.equal(s[1], torch.zeros_like(s[1])):
            failures.append(f"svd: zero matrix n={n} has nonzero s")
    for nf in (NFFT, NFFT_MAX):
        impulse = torch.zeros((3, nf), device=dev)
        impulse[:, 0] = 1.0
        re, im = F.fft_fused(impulse, torch.zeros_like(impulse))
        guards.append((f"fft unit impulse nf={nf}", re))
        if not (torch.equal(re, torch.ones_like(re))
                and torch.equal(im, torch.zeros_like(im))):
            failures.append(f"fft: unit impulse nf={nf} not all ones")
    for label, out in guards:
        finite = bool(torch.isfinite(out).all())
        print(f"  guard {label:<34} finite={finite}")
        if not finite:
            failures.append(f"guard {label}: non-finite output")
    if failures:
        fail("kernel checks: " + "; ".join(failures))

    # ---------------- 4. serve: the main paths ----------------
    from repro_torch.launch import serve_solvers as S_
    from repro_torch.serve import CostModel, OverloadPolicy
    launches = {name: 0 for name in kern}

    def read_launches(path: str, expect: tuple):
        counts = {k.name: k.launches for k in common.KERNELS}
        print(f"main-path launches ({path}): {json.dumps(counts)}",
              flush=True)
        if not all(counts[name] for name in expect):
            fail(f"a kernel of the {path} path never launched: {counts}")
        for name, c in counts.items():
            launches[name] += c

    for k in common.KERNELS:
        k.launches = 0
    for argv in (["--slots", "8", "--lanes", "8", "--sizes", "8,12",
                  "--policy"],
                 ["--slots", "8", "--lanes", "32", "--sizes", "16,32",
                  "--policy"]):
        print(f"serve_solvers {' '.join(argv)}", flush=True)
        summary = S_.main(argv)
        print(f"  summary {json.dumps(summary)}")
        if summary is None or summary["hard_dropped"] != 0 \
                or not summary["oracle_rel_err"] < 1e-3 \
                or summary["done"] != summary["jobs"]:
            fail(f"serve {argv}: {summary}")
    trace = S_.load_trace(ROOT / "tests" / "data" / "overload_trace.json")
    mux = S_.replay_trace(trace, lanes=2, policy=OverloadPolicy(
        budget=6.5e-5, cost_model=CostModel()), pressure=4)
    want = json.loads((ROOT / "tests" / "data"
                       / "overload_golden.json").read_text())
    got = json.loads(json.dumps(mux.events))
    print(f"golden replay: {len(got)} events, equal={got == want}")
    if got != want:
        fail("overload trace replay differs from overload_golden.json")
    read_launches("TTI slot mix", ("cholesky_solve", "mmse_equalize",
                                   "mmse_equalize_split", "qr_solve"))

    for k in common.KERNELS:
        k.launches = 0
    fault_trace = str(ROOT / "tests" / "data" / "pusch_fault_trace.json")
    for argv in (["--pusch", "--fault-trace", fault_trace],
                 ["--pusch", "--sizes", "24", "--lanes", "32",
                  "--ticks", "8"]):
        print(f"serve_solvers {' '.join(argv)}", flush=True)
        out = S_.main(argv)
        for mode, s in out.items():
            if s["done"] != s["dags"] or s["hard_lost"] != 0 \
                    or not s["max_rel_err"] < 2e-3 or s["pending"]:
                fail(f"pusch {argv} {mode}: {s}")
        if "--fault-trace" in argv and not out["staged"]["retries"] >= 1:
            fail(f"pusch fault trace did not fire: {out['staged']}")
    trace = json.loads((ROOT / "tests" / "data"
                        / "pusch_trace.json").read_text())
    mux, dags = S_.replay_pusch(trace)
    got = json.dumps(mux.drain_events(), indent=1) + "\n"
    want = (ROOT / "tests" / "data" / "pusch_golden.json").read_text()
    print(f"pusch golden replay: equal={got == want}", flush=True)
    if got != want:
        fail("pusch trace replay differs from pusch_golden.json")
    for d in dags:
        ok, err = close(torch.from_numpy(d.out),
                        torch.from_numpy(d.spec.oracle(*d.args)),
                        d.spec.rtol)
        if d.state != "done" or not ok:
            fail(f"pusch golden dag {d.dag} {d.seq}: {d.state}, "
                 f"|out - oracle| {err:.3e}")
    read_launches("served DAGs", ("mmse_equalize", "channel_estimate",
                                  "pusch_chain", "fft", "svd",
                                  "svd_apply"))

    # ---------------- 5. times ----------------
    flush = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=dev)

    def time_ms(fn, reps):
        """Median device time of fn() per call, L2 flushed before each.
        The card first spins for ~0.5 ms so that the host has enqueued
        the call before the start event fires: the host's launch path
        (argument checks, ctypes) is not counted as device time.  Returns
        (median, slowest): one slow call moves a mean by its whole excess
        over the number of calls, the median not at all."""
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            torch.cuda._sleep(1_000_000)
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times), max(times)

    def work(key, shapes):
        """(bytes, FLOPs) one call must move and do at these per-lane
        shapes (per row for the FFT): each input read once, each output
        written once; the least float32 work, an FMA counted as two, a
        symmetric Gram matrix counted by one triangle (the registry's
        flops models count it whole, because they price work for the
        cost model, not bound it)."""
        if key in ("fft", "pusch_fft"):
            nf = shapes[0][-1]
            rows = shapes[0][0] if key == "pusch_fft" else 1
            return 16 * nf * rows, 5 * nf * math.log2(nf) * rows
        if key in ("svd", "svd_factor"):
            m, n = shapes[0]
            return (4 * (2 * m * n + n * n + n),
                    SWEEPS * n * (n - 1) / 2 * (6 * m + 6 * (m + n)))
        if key == "svd_apply":
            (mn1, n), (m, k) = shapes
            return (4 * (mn1 * n + m * k + n * k),
                    2 * m * n * k + 2 * n * n * k + 3 * n * k)
        if key in ("channel_estimate", "pusch_chain"):
            n, p = shapes[0]
            m = shapes[1][0]
            est = n * (n + 1) * p + 2 * n * p * m + n ** 3 / 3 \
                + 2 * n * n * m
            if key == "channel_estimate":
                return 4 * (n * p + m * p + m * n), est
            k = shapes[2][1]
            return (4 * (n * p + m * p + m * k + n * k),
                    est + m * n * (n + 1) + 2 * m * n * k + n ** 3 / 3
                    + 2 * n * n * k)
        m = shapes[0][0]
        n = shapes[0][1]
        k = shapes[-1][1]
        chain = n ** 3 / 3 + 2 * n * n * k     # factor + two substitutions
        if key == "cholesky_solve":            # reads the lower triangle
            return 4 * (n * (n + 1) // 2 + n * k + n * k), chain
        if key == "mmse_equalize":             # G = H^T H, H^T y, chain
            return (4 * (m * n + m * k + n * k),
                    m * n * (n + 1) + 2 * m * n * k + chain)
        if key == "mmse_equalize_split":       # Gr over [Hr; Hi], C =
            n2 = 2 * n                         # Hr^T Hi, two stacked matched
            return (4 * (2 * m * n + 2 * m * k + 2 * n * k),   # filters,
                    2 * m * n * (n + 1) + 2 * m * n * n        # chain
                    + 8 * m * n * k + n2 ** 3 / 3 + 2 * n2 * n2 * k)
        # Householder QR of A, Q^T b, back substitution
        return (4 * (m * n + m * k + n * k),
                2 * m * n * n - 2 * n ** 3 / 3 + 4 * m * n * k
                - 2 * n * n * k + n * n * k)

    def syncs(fn):
        """Whether fn() makes the host wait for the card, as torch's sync
        debug mode reports it."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return any("synchroniz" in str(w.message).lower() for w in caught)

    def library(key, args):
        """One PyTorch call computing the same function, where there is
        one (its inputs prepared outside the timed call), else None."""
        if key == "cholesky_solve":
            return lambda: torch.linalg.solve_ex(
                *args, check_errors=False).result
        if key == "qr_solve":
            return lambda: torch.linalg.lstsq(*args).solution
        if key in ("fft", "pusch_fft"):
            z = torch.complex(*args)
            return lambda: torch.fft.fft(z)
        if key == "svd_factor":
            return lambda: torch.linalg.svd(args[0], full_matrices=False)
        return None

    # the timed call of each kernel: its main-path entry point, returning
    # what the main path gets (not the spectrum/reconstruction view)
    timed = {"fft": "pusch_fft", "svd": "svd_factor"}
    calls = {"pusch_fft": (pp.pusch_fft_fused, pp.pusch_fft_plain),
             "svd_factor": (pp.svd_factor_fused, pp.svd_factor_plain),
             "fft": (F.fft_fused, F.fft_plain)}
    rows = []
    for name, k in kern.items():
        key = timed.get(name, name)
        kfn, pfn = calls.get(key, (fused[key], plain[key]))
        cases = [(f"n={n}", n, slot_case(key, rng, LANES, n))
                 for n in SLOT_SIZES]
        if name == "fft":
            cases.append((f"nf={NFFT_MAX}", None,
                          (rand(rng, LANES, NFFT_MAX),
                           rand(rng, LANES, NFFT_MAX))))
        sweep = []
        for label, n, args in cases:
            tkey = key if n is not None else "fft"
            tk, tp_ = calls.get(tkey, (kfn, pfn))
            shapes = tuple(tuple(a.shape[1:]) for a in args)
            lane_bytes, lane_flops = work(tkey, shapes)
            nbytes, flops = LANES * lane_bytes, LANES * lane_flops
            t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
            t_ops = flops / PEAK_F32_FLOPS * 1e3
            ms, ms_max = time_ms(lambda: tk(*args), 30)
            plain_ms = time_ms(lambda: tp_(*args), 3 if name != "svd"
                               else 1)[0]
            lib = library(tkey, args)
            lib_ms = time_ms(lib, 10)[0] if lib else None
            sweep.append({
                "case": label, "n": n,
                "shapes": [list(s) for s in shapes],
                "ms": ms, "ms_max": ms_max, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops, "library_ms": lib_ms,
                "library_syncs": syncs(lib) if lib else None})
            print(f"  time {name:<20} {label:<7} kernel {ms:.4f} ms (slowest "
                  f"{ms_max:.4f})  plain "
                  f"{plain_ms:.3f} ms  bound {max(t_bytes, t_ops):.5f} ms"
                  + (f"  library {lib_ms:.4f} ms" if lib_ms else "")
                  + ("  (library syncs the host)"
                     if sweep[-1]["library_syncs"] else ""),
                  flush=True)
        head = next(r for r in sweep if r["n"] == SLOT_SIZES[-1])
        rows.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[name],
            "max_abs_err": max_err[name],
            "rtol": RTOLS.get(name, RTOL),
            "lanes": LANES, "shapes": head["shapes"],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library_syncs": head["library_syncs"], "sweep": sweep})
    for r in rows:
        if not all(math.isfinite(r[key]) for key in
                   ("ms", "plain_ms", "bound_ms", "max_abs_err")):
            fail(f"non-finite measurement for {r['name']}")

    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
