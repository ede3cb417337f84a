#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (compute capability 9.0) and the CUDA
toolkit's ``nvcc``; exits non-zero without a result line otherwise.
Phases, each fatal on failure:

  1. device  — the card's name and power limit (nvidia-smi), TF32 off;
  2. build   — every kernel in src/repro_torch/csrc built from source;
  3. kernels — K1-K4 held against their plain PyTorch versions and the
               oracles at the registry sizes, at a slot's real width
               (B = 3276 lanes: one 100 MHz carrier at 30 kHz SCS, 273
               PRBs x 12 subcarriers, 3GPP TS 38.101-1 Table 5.3.2-1) and
               on the guard cases (poisoned upper triangle, singular and
               rank-deficient lanes);
  4. serve   — the main path: ``repro_torch.launch.serve_solvers.main``
               on two slot mixes and the committed overload trace replayed
               through the port's SolverMux, with every kernel's launch
               count reset before and read after;
  5. times   — each kernel at B = 3276 timed with CUDA events (cold L2)
               beside its bound, its plain version and, where one PyTorch
               call computes the same function, that call.

The second-to-last lines are the ``{"kernels": [...]}`` JSON line and the
card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

LANES = 3276                 # one 100 MHz carrier at 30 kHz SCS
SLOT_SIZES = (8, 16, 32)
PEAK_F32_FLOPS = 67e12       # H100 SXM, float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12     # H100 SXM HBM3
RTOL = 1e-4                  # the registry specs' rtol


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
    rtol * max|want| + rtol * |want| elementwise.  Returns max |diff|."""
    import torch
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
    from repro_torch.kernels.common import sample_spd

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
             "qr_solve": pp.qr_solve_fused}
    plain = {"cholesky_solve": pp.cholesky_solve_plain,
             "mmse_equalize": pp.mmse_equalize_plain,
             "mmse_equalize_split": pp.mmse_equalize_split_plain,
             "qr_solve": pp.qr_solve_plain}
    oracle = {"cholesky_solve": ref.cholesky_solve,
              "mmse_equalize": ref.mmse_equalize,
              "mmse_equalize_split": ref.mmse_equalize_split,
              "qr_solve": ref.qr_solve}
    if set(kern) != set(fused):
        fail(f"kernel set {sorted(kern)} != {sorted(fused)}")
    max_err = {name: 0.0 for name in fused}
    failures = []

    def check(name, args, label, oracle_args=None):
        """Kernel vs plain version (same card inputs) vs oracle (on
        ``oracle_args``, default the same inputs)."""
        got = fused[name](*args)
        torch.cuda.synchronize()
        want = plain[name](*args)
        ok, err = close(got, want)
        max_err[name] = max(max_err[name], err)
        ok_o, err_o = close(got, oracle[name](*(oracle_args or args)))
        status = "ok" if ok and ok_o else "MISMATCH"
        print(f"  {name:<20} {label:<28} |kernel-plain| {err:.3e}  "
              f"|kernel-oracle| {err_o:.3e}  (rtol {RTOL:g}) {status}",
              flush=True)
        if not (ok and ok_o):
            failures.append(f"{name} {label}")
        return got

    def slot_case(name, rng, b, n):
        """The slot mix's own per-lane shapes (build_slot_jobs)."""
        m = n + 4
        f = lambda *s: torch.from_numpy(
            rng.standard_normal(s).astype(np.float32)).to(dev)
        if name == "cholesky_solve":
            return (torch.from_numpy(sample_spd(rng, b, n)).to(dev),
                    f(b, n, 2))
        if name == "mmse_equalize":
            return f(b, m, n), f(b, m, 2)
        if name == "mmse_equalize_split":
            return f(b, m, n), f(b, m, n), f(b, m, 2), f(b, m, 2)
        return f(b, m, n), f(b, m, 1)

    # ---------------- 3. kernels against plain versions ----------------
    print("kernels vs plain versions and oracles:", flush=True)
    rng = np.random.default_rng(0)
    for spec in K.specs():
        variants = [(spec.name, spec.base)] + [
            ("mmse_equalize_split", v) for v in spec.variants
            if v.name == "split_complex"]
        for name, variant in variants:
            for n in variant.sizes:
                args = tuple(a.to(dev) for a in variant.make_case(rng, n))
                check(name, args, f"registry n={n}")
    for name in fused:
        for n in SLOT_SIZES:
            check(name, slot_case(name, rng, LANES, n), f"B={LANES} n={n}")

    # guard cases
    a = torch.from_numpy(sample_spd(rng, 2, 16)).to(dev)
    rhs = torch.from_numpy(
        rng.standard_normal((2, 16, 2)).astype(np.float32)).to(dev)
    clean = pp.cholesky_solve_fused(a, rhs)
    poisoned = a.clone()
    iu = torch.triu_indices(16, 16, offset=1)
    poisoned[:, iu[0], iu[1]] = float("nan")
    got = check("cholesky_solve", (poisoned, rhs), "poisoned upper",
                oracle_args=(a, rhs))
    if not torch.equal(got, clean):
        failures.append("cholesky_solve: upper-triangle NaN leaked")
    v = torch.from_numpy(
        rng.standard_normal((2, 16, 2)).astype(np.float32)).to(dev)
    x = pp.cholesky_solve_fused((v @ v.transpose(-1, -2)).contiguous(),
                                rhs)
    guards = [("cholesky_solve rank 2 of 16", x)]
    zero_h = torch.zeros((1, 16, 12), device=dev)
    y1 = torch.from_numpy(
        rng.standard_normal((1, 16, 1)).astype(np.float32)).to(dev)
    xz = pp.mmse_equalize_fused(zero_h, y1)
    guards.append(("mmse_equalize zero channel", xz))
    if not torch.all(xz.abs() < 1e-5):
        failures.append("mmse_equalize: zero channel not ~0")
    xs = pp.mmse_equalize_split_fused(zero_h, zero_h, y1, y1)
    guards.append(("mmse_equalize_split zero channel", xs))
    if not torch.all(xs.abs() < 1e-5):
        failures.append("mmse_equalize_split: zero channel not ~0")
    col = torch.from_numpy(
        rng.standard_normal((2, 16, 1)).astype(np.float32)).to(dev)
    qb = torch.from_numpy(
        rng.standard_normal((2, 16, 2)).astype(np.float32)).to(dev)
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
    for label, out in guards:
        finite = bool(torch.isfinite(out).all())
        print(f"  guard {label:<34} finite={finite}")
        if not finite:
            failures.append(f"guard {label}: non-finite output")
    if failures:
        fail("kernel checks: " + "; ".join(failures))

    # ---------------- 4. serve: the main path ----------------
    from repro_torch.launch import serve_solvers as S
    from repro_torch.serve import CostModel, OverloadPolicy
    for k in common.KERNELS:
        k.launches = 0
    for argv in (["--slots", "8", "--lanes", "8", "--sizes", "8,12",
                  "--policy"],
                 ["--slots", "8", "--lanes", "32", "--sizes", "16,32",
                  "--policy"]):
        print(f"serve_solvers {' '.join(argv)}", flush=True)
        summary = S.main(argv)
        print(f"  summary {json.dumps(summary)}")
        if summary is None or summary["hard_dropped"] != 0 \
                or not summary["oracle_rel_err"] < 1e-3 \
                or summary["done"] != summary["jobs"]:
            fail(f"serve {argv}: {summary}")
    trace = S.load_trace(ROOT / "tests" / "data" / "overload_trace.json")
    mux = S.replay_trace(trace, lanes=2, policy=OverloadPolicy(
        budget=6.5e-5, cost_model=CostModel()), pressure=4)
    want = json.loads((ROOT / "tests" / "data"
                       / "overload_golden.json").read_text())
    got = json.loads(json.dumps(mux.events))
    print(f"golden replay: {len(got)} events, equal={got == want}")
    if got != want:
        fail("overload trace replay differs from overload_golden.json")
    launches = {k.name: k.launches for k in common.KERNELS}
    print(f"main-path launches: {json.dumps(launches)}", flush=True)
    if not all(launches.values()):
        fail(f"a kernel never launched on the main path: {launches}")

    # ---------------- 5. times ----------------
    flush = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=dev)

    def time_ms(fn, reps):
        """Mean device time of fn() per call, L2 flushed before each.
        The card first spins for ~0.5 ms so that the host has enqueued
        the call before the start event fires: the host's launch path
        (argument checks, ctypes) is not counted as device time."""
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            torch.cuda._sleep(1_000_000)
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / reps

    def lane_bytes(name, m, n, k):
        """Bytes one lane must move: each input read once, the output
        written once."""
        if name == "cholesky_solve":       # reads the lower triangle only
            return 4 * (n * (n + 1) // 2 + n * k + n * k)
        if name == "mmse_equalize":
            return 4 * (m * n + m * k + n * k)
        if name == "mmse_equalize_split":
            return 4 * (2 * m * n + 2 * m * k + 2 * n * k)
        return 4 * (m * n + m * k + n * k)

    def lane_flops(name, m, n, k):
        """The least float32 work one lane needs, an FMA counted as two.
        A symmetric Gram matrix counts one triangle: the registry's flops
        models count it whole, because they price work for the cost
        model, not bound it."""
        chain = n ** 3 / 3 + 2 * n * n * k     # factor + two substitutions
        if name == "cholesky_solve":
            return chain
        if name == "mmse_equalize":            # G = H^T H, H^T y, chain
            return m * n * (n + 1) + 2 * m * n * k + chain
        if name == "mmse_equalize_split":      # Gr over [Hr; Hi], C =
            n2 = 2 * n                         # Hr^T Hi, two stacked matched
            return (2 * m * n * (n + 1) + 2 * m * n * n   # filters, chain
                    + 8 * m * n * k + n2 ** 3 / 3 + 2 * n2 * n2 * k)
        # Householder QR of A, Q^T b, back substitution
        return (2 * m * n * n - 2 * n ** 3 / 3 + 4 * m * n * k
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

    library = {
        "cholesky_solve": lambda a, b: torch.linalg.solve_ex(
            a, b, check_errors=False).result,
        "qr_solve": lambda a, b: torch.linalg.lstsq(a, b).solution,
    }
    rows = []
    for name, k in kern.items():
        sweep = []
        for n in SLOT_SIZES:
            args = slot_case(name, rng, LANES, n)
            shapes = tuple(tuple(a.shape[1:]) for a in args)
            dims = (shapes[0][0], n, shapes[-1][1])          # m, n, k
            flops = LANES * lane_flops(name, *dims)
            nbytes = LANES * lane_bytes(name, *dims)
            t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
            t_ops = flops / PEAK_F32_FLOPS * 1e3
            ms = time_ms(lambda: fused[name](*args), 30)
            plain_ms = time_ms(lambda: plain[name](*args), 3)
            lib = library.get(name)
            lib_ms = time_ms(lambda: lib(*args), 10) if lib else None
            sweep.append({
                "n": n, "shapes": [list(s) for s in shapes],
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops, "library_ms": lib_ms,
                "library_syncs": syncs(lambda: lib(*args)) if lib else None})
            print(f"  time {name:<20} n={n:<3} kernel {ms:.4f} ms  plain "
                  f"{plain_ms:.3f} ms  bound {max(t_bytes, t_ops):.4f} ms"
                  + (f"  library {lib_ms:.4f} ms" if lib_ms else "")
                  + ("  (library syncs the host)"
                     if sweep[-1]["library_syncs"] else ""),
                  flush=True)
        head = sweep[-1]                       # n = 32, the widest slot
        rows.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[name],
            "max_abs_err": max_err[name], "rtol": RTOL,
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
