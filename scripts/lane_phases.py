#!/usr/bin/env python3
"""Split the lanes of K3's and K6's warp forms into phases on the card.

    python3 scripts/lane_phases.py [--tree src] [--reps 10]

For each of ``CASES`` (``pusch_ab.py``'s K3 and K6 cases: a carrier's
3276 lanes, the slot mixes' 32 served lanes and the PUSCH DAG's widths;
standard normal inputs from a seeded generator on the card) this runs the
kernel's phase-stamped instance (``clock64()`` on thread 0 of each lane's
warp at the edges of ``LANE_PHASES``), checks that its answer equals the
served kernel's bit for bit, that each lane's stamps are ordered and that
its phases add up to its time, and prints each phase's share of a lane
(the mean over lanes), the lane's mean cycles and the served call's
device ms (CUDA events, L2 flushed, median of ``--reps``).  Each
instance's registers and spills (``-Xptxas -v``) are printed after the
build.  One JSON line a case; the card's name and power limit first.
(``lane_parent_phases.py`` splits the one-CTA kernels of an earlier
tree.)
"""
import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import ab_turns as AB  # noqa: E402  the tree import and the timer
import pusch_ab as PA  # noqa: E402  the cases

CASES = tuple(c for c in PA.CASES if c[0] != "channel_estimate")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    AB.import_tree(Path(args.tree).resolve())
    import chip_smoke as CS
    import torch
    from repro_torch.kernels import common
    WC = importlib.import_module("repro_torch.pipelines.warp_chain")
    mods = {"mmse_equalize_split":
            importlib.import_module("repro_torch.pipelines.mmse"),
            "pusch_chain": importlib.import_module(
                "repro_torch.pipelines.pusch")}

    if not torch.cuda.is_available():
        sys.exit("lane_phases: no CUDA device")
    print(CS.card_line(), flush=True)
    dev = torch.device("cuda")
    common.load_library()
    for source in ("mmse_equalize_split.cu", "pusch_chain.cu"):
        ptxas = CS.ptxas_lines(common.build_info["log"], source)
        for i, line in enumerate(ptxas):       # each instance's registers
            if "Compiling entry" in line:
                print(json.dumps({"instance": line.split("'")[1],
                                  "ptxas": ptxas[i + 1:i + 3]}), flush=True)
    median_ms = AB.cold_timer(dev, args.reps)
    failed = []
    for kernel, n, lanes in CASES:
        mod = mods[kernel]
        inputs = PA.make_case(torch, dev, kernel, n, lanes)
        fused = getattr(mod, f"{kernel}_fused")
        x, stamps = getattr(mod, f"{kernel}_phases")(*inputs)
        served = fused(*inputs)
        torch.cuda.synchronize()
        st = stamps.cpu().double()
        total = st[:, 1] - st[:, 0]
        parts = st[:, 2:]
        ordered = bool((total > 0).all() and (parts >= 0).all())
        covered = bool((parts.sum(dim=1) == total).all())
        same = torch.equal(x, served)
        share = (parts / total[:, None]).mean(dim=0)
        print(json.dumps({
            "kernel": kernel, "n": n, "m": n + 4, "lanes": lanes,
            "ms": median_ms(lambda: fused(*inputs)),
            "lane_cycles": float(total.mean()),
            "share": dict(zip(WC.LANE_PHASES, map(float, share))),
            "ordered": ordered, "covered": covered,
            "stamped_equals_served": same}), flush=True)
        if not (ordered and covered and same):
            failed.append(f"{kernel} n={n} B={lanes}: ordered {ordered}, "
                          f"covered {covered}, equal {same}")
        del inputs, x, stamps, served
    if failed:
        sys.exit("lane_phases: " + "; ".join(failed))

if __name__ == "__main__":
    main()
