#!/usr/bin/env python3
"""Time K7 (the FFT kernel) of one or two source trees of the port on one
card, in turns, beside ``torch.fft.fft`` on the same inputs.

    python3 scripts/fft_ab.py --tree new=src [--tree old=OTHER/src] \\
        [--order ABBA] [--reps 30]

Each turn (``ab_turns.py``) is a fresh process that imports
``repro_torch`` from its tree, builds its kernels there and, at each of
``CASES`` (inputs standard normal from a seeded generator on the card),
reads: the device ms of the main path's entry (``pusch_fft_fused`` at the
PUSCH DAG's shape, ``fft_fused`` otherwise) and of ``torch.fft.fft`` on
the same rows as complex numbers, each the median of ``--reps`` calls
timed alone by CUDA events with L2 flushed before it; the bytes bound (16
bytes a point over 3.35 TB/s) and the share of 3.35 TB/s each reading
reaches; whether the kernel equals the plain version bit for bit; its
launches; and what the card runs for one call (torch.profiler).  A case
the tree's K7 refuses (a size past its plans) is recorded as refused.  The
build's ``-Xptxas -v`` lines for ``fft.cu`` are printed with the card's
name and power limit.  Each turn prints one JSON line; the last line is a
JSON summary of each tree's (ms, torch.fft ms) in turn order.
"""
import argparse
import json
from pathlib import Path

import ab_turns as AB  # the turns and the timing helpers
import chip_smoke as CS  # the sizes, peaks and card line (on AB's path)

# (label, batch shape, points): the PUSCH DAG's rows in its stacked
# layout, a carrier's rows of the largest registered size and of its OFDM
# size, and the registry's cases (2 rows, launch-bound)
CASES = (("pusch", (CS.LANES, 36), CS.NFFT),
         ("1024", (CS.LANES,), CS.NFFT_MAX),
         ("4096", (CS.LANES,), CS.NFFT_CARRIER),
         ("registry 64", (2,), 64), ("registry 128", (2,), 128),
         ("registry 256", (2,), 256), ("registry 1024", (2,), 1024))


def one_turn(tree: Path, reps: int) -> dict:
    """The readings of one tree in this process."""
    import importlib

    import torch
    AB.import_tree(tree)
    from repro_torch import pipelines as pp
    from repro_torch.kernels import common
    F = importlib.import_module("repro_torch.kernels.fft")

    dev = torch.device("cuda")
    common.load_library()
    kern = next(k for k in common.KERNELS if k.name == "fft")
    median_ms = AB.cold_timer(dev, reps)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    for label, batch, n in CASES:
        xr = torch.randn((*batch, n), generator=gen, device=dev)
        xi = torch.randn((*batch, n), generator=gen, device=dev)
        if len(batch) == 2:
            call = lambda: pp.pusch_fft_fused(xr, xi)        # noqa: E731
            plain = lambda: (pp.pusch_fft_plain(xr, xi),)    # noqa: E731
        else:
            call = lambda: F.fft_fused(xr, xi)               # noqa: E731
            plain = lambda: F.fft_plain(xr, xi)              # noqa: E731
        before = kern.launches
        try:
            got = call()
        except ValueError as e:                # a size past its plans
            rows.append({"case": label, "shape": [*batch, n],
                         "refused": str(e)})
            continue
        torch.cuda.synchronize()
        launches = kern.launches - before
        equal = all(bool(torch.equal(g, w)) for g, w in zip(
            got if isinstance(got, tuple) else (got,), plain()))
        z = torch.complex(xr, xi)
        nbytes = 16 * xr.numel()             # re, im read and written
        ms = median_ms(call)
        fft_ms = median_ms(lambda: torch.fft.fft(z))
        rows.append({
            "case": label, "shape": [*batch, n], "ms": ms,
            "fft_ms": fft_ms, "bound_ms": 1e3 * nbytes / CS.PEAK_HBM_BYTES,
            "hbm_share": nbytes / (ms * 1e-3) / CS.PEAK_HBM_BYTES,
            "fft_hbm_share": nbytes / (fft_ms * 1e-3) / CS.PEAK_HBM_BYTES,
            "equal_plain": equal, "launches": launches,
            "device_us": AB.device_kernels(call)})
        del xr, xi, z, got
    return {"tree": str(tree), "card": CS.card_line(),
            "clocks": CS.clocks_line(),
            "build_s": common.build_info["seconds"],
            "ptxas": CS.ptxas_lines(common.build_info["log"], "fft.cu"),
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
        summary[name].append({r["case"]: (r["ms"], r["fft_ms"])
                              for r in reading["rows"] if "ms" in r})
    print(json.dumps({"ms_fft_ms_by_turn": summary}))


if __name__ == "__main__":
    main()
