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
from pathlib import Path

import ab_turns as AB  # the turns and the timing helpers
import chip_smoke as CS  # the shapes, peaks and card line (on AB's path)


def one_turn(tree: Path, reps: int) -> dict:
    """The readings of one tree in this process."""
    import importlib

    import torch
    AB.import_tree(tree)
    from repro_torch.kernels import common
    KG = importlib.import_module("repro_torch.kernels.gemm")

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    common.load_library()
    kern = next(k for k in common.KERNELS if k.name == "gemm")
    median_ms = AB.cold_timer(dev, reps)
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
                     "device_us": AB.device_kernels(
                         lambda: KG.gemm_fused(x, y))})
        del x, y, got, want
    return {"tree": str(tree), "card": CS.card_line(),
            "clocks": CS.clocks_line(),
            "build_s": common.build_info["seconds"],
            "ptxas": CS.ptxas_lines(common.build_info["log"], "gemm.cu"),
            "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    AB.add_tree_arguments(ap)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    trees, order = AB.trees_and_order(ap, args)
    if args.turn:
        print(json.dumps(one_turn(Path(trees[args.turn]).resolve(),
                                  args.reps)), flush=True)
        return
    summary = {name: [] for name in trees}
    for name, reading in AB.run_turns(__file__, args, trees, order,
                                      ["--reps", str(args.reps)]):
        summary[name].append({f"{'x'.join(map(str, r['shape']))} "
                              f"{r['dtype']}": (r["ms"], r["matmul_ms"])
                              for r in reading["rows"]})
    print(json.dumps({"ms_matmul_ms_by_turn": summary}))


if __name__ == "__main__":
    main()
