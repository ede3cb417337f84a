#!/usr/bin/env python3
"""Time K18 (the GEMM kernel) of one or two source trees of the port on
one card, in turns, beside ``torch.matmul`` on the same inputs.

    python3 scripts/gemm_ab.py --tree new=src [--tree old=OTHER/src] \\
        [--order ABBA] [--reps 30]

A tree is a ``src`` directory that holds a ``repro_torch`` package (for
example an unpacked ``git archive`` of another commit).  Each turn of
``--order`` (A the first ``--tree``, B the second; one tree: one turn
unless ``--order`` says more) is a fresh process that imports
``repro_torch`` from its tree, builds its kernels there and, at each of
``chip_smoke.GEMM_TIMES``' shapes (float32 and bf16, inputs standard
normal from a seeded generator on the card), reads: the kernel's device
ms and ``torch.matmul``'s (TF32 off) as the median of ``--reps`` calls,
each timed alone by CUDA events with L2 flushed before it; the bound
(max of bytes over 3.35 TB/s and 2 M N K over 67 TFLOP/s in float32 or
989 TFLOP/s in bf16); the largest |kernel - plain version| over |plain|'s
largest; the forms the C entry reported; and what the card runs for one
call (each kernel's name and device us, torch.profiler), which splits the
wrapper's copies from the kernel.  The build's ``-Xptxas -v`` lines for
``gemm.cu`` are printed with the card's name and power limit.  Each turn
prints one JSON line; the last line is a JSON summary of each tree's ms
in turn order.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402  (the shapes, peaks and card line)


def one_turn(tree: Path, reps: int) -> dict:
    """The readings of one tree in this process."""
    import importlib

    import torch
    sys.path.insert(0, str(tree))
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"repro_torch imported from "
                           f"{repro_torch.__file__}, not from {tree}")
    from repro_torch.kernels import common
    KG = importlib.import_module("repro_torch.kernels.gemm")

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    common.load_library()
    log, keep = common.build_info["log"].splitlines(), False
    ptxas = []
    for line in log:
        if line.startswith("=="):
            keep = line.strip() == "== gemm.cu"
        elif keep and ("registers" in line or "spill" in line
                       or "Compiling entry" in line):
            ptxas.append(line.strip())
    kern = next(k for k in common.KERNELS if k.name == "gemm")
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)

    def timed(fn):
        torch.cuda._sleep(1_000_000)    # the host enqueues before start
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    def median_ms(fn):
        fn()
        return statistics.median(timed(fn) for _ in range(reps))

    def device_kernels(fn):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [(e.name[:60], e.time_range.elapsed_us())
                for e in prof.events() if e.device_type == DeviceType.CUDA]

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    for m, kk, n, dt in CS.GEMM_TIMES:
        dtype = getattr(torch, dt)
        x = torch.randn((m, kk), generator=gen, device=dev).to(dtype)
        y = torch.randn((kk, n), generator=gen, device=dev).to(dtype)
        before = (kern.launches, kern.launches_tc)
        got = KG.gemm_fused(x, y)
        torch.cuda.synchronize()
        forms = (kern.launches - before[0], kern.launches_tc - before[1])
        want = KG.gemm_plain(x, y).double()
        err = float((got.double() - want).abs().max() / want.abs().max())
        size = x.element_size()
        peak = CS.PEAK_BF16_FLOPS if dtype == torch.bfloat16 \
            else CS.PEAK_F32_FLOPS
        bound = 1e3 * max(size * (m * kk + kk * n + m * n)
                          / CS.PEAK_HBM_BYTES, 2 * m * n * kk / peak)
        rows.append({"shape": [m, kk, n], "dtype": dt,
                     "ms": median_ms(lambda: KG.gemm_fused(x, y)),
                     "matmul_ms": median_ms(lambda: torch.matmul(x, y)),
                     "bound_ms": bound, "rel_err": err,
                     "launches": forms[0], "launches_tc": forms[1],
                     "device_us": device_kernels(
                         lambda: KG.gemm_fused(x, y))})
        del x, y, got, want
    return {"tree": str(tree), "card": CS.card_line(),
            "clocks": CS.clocks_line(),
            "build_s": common.build_info["seconds"], "ptxas": ptxas,
            "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=PATH of a src directory (one or two)")
    ap.add_argument("--order", default=None)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree)
    if args.turn:
        print(json.dumps(one_turn(Path(trees[args.turn]).resolve(),
                                  args.reps)), flush=True)
        return
    order = args.order or ("ABBA" if len(trees) == 2 else "A")
    if not 1 <= len(trees) <= 2 or set(order) - set("AB"[:len(trees)]):
        ap.error("give one or two --tree and an --order of their letters")
    names = list(trees)
    summary = {name: [] for name in names}
    for turn in order:
        name = names["AB".index(turn)]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, __file__, "--turn", name,
             "--reps", str(args.reps)]
            + [f"--tree={t}" for t in args.tree],
            capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stdout + proc.stderr)
            sys.exit(f"gemm_ab: the turn of {name} failed")
        reading = json.loads(proc.stdout.strip().splitlines()[-1])
        reading["seconds"] = time.perf_counter() - t0
        print(json.dumps({"turn": name, **reading}), flush=True)
        summary[name].append({f"{'x'.join(map(str, r['shape']))} "
                              f"{r['dtype']}": (r["ms"], r["matmul_ms"])
                              for r in reading["rows"]})
    print(json.dumps({"ms_matmul_ms_by_turn": summary}))


if __name__ == "__main__":
    main()
