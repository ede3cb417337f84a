#!/usr/bin/env python3
"""Split the lanes of the warp forms of K2, K3, K5 and K6 and of K2's wide
form into phases on the card.

    python3 scripts/lane_phases.py [--tree src] [--reps 10] [--forms]

For each of ``CASES`` (``pusch_ab.py``'s cases: a carrier's 3276 lanes,
the slot mixes' and the decode trace's served widths, the mid-range mix's
n = 128 on 32 lanes and the PUSCH DAG's widths; standard normal inputs
from a seeded generator on the card) this runs the kernel's
phase-stamped instance (``clock64()`` on thread 0 of each lane's CTA at
the edges of ``LANE_PHASES``), checks that its answer equals the served
kernel's bit for bit, that each lane's stamps are ordered and that its
phases add up to its time, and prints each phase's share of a lane (the
mean over lanes), the lane's mean cycles and the served call's device ms
(CUDA events, L2 flushed, median of ``--reps``).  With ``--forms`` each
case of K2's wide form is also run at every W of ``WIDE_WARPS`` that
holds its tiles one a thread, through the C entries with the threads
given directly (its ms, lane cycles and whether it gives the plan's
bits): the sweep that reads whether a W past ``mmse_wide_plan``'s
fewest would pay.  Each instance's registers and spills
(``-Xptxas -v``) are printed after the build.  One JSON line a case (and
a W); the card's name and power limit first.  (``lane_parent_phases.py``
splits the one-CTA kernels of an earlier tree.)
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

CASES = PA.CASES
# K2's wide form at more widths and batches for --forms: (n, lanes), m =
# n + 4, k = 2
WIDE_SWEEP = ((40, 32), (40, 3276), (64, 32), (64, 3276), (97, 32),
              (97, 3276), (128, 132), (128, 264), (168, 32), (168, 3276))


def sweep_wide(MM, WC, inputs, served, median_ms, torch) -> list:
    """K2's wide form at every W of ``WIDE_WARPS`` holding the tiles of
    ``inputs`` one a thread, launched through the C entries
    (``mmse_equalize_f32``, and ``mmse_equalize_phases_f32`` for a lane's
    cycles) with 32 W threads: one JSON line a W (its ms, a lane's mean
    cycles, whether it is the plan's W and gives the served bits);
    returns the failures."""
    h, y = inputs
    lanes, m, n = h.shape
    k = y.shape[-1]
    plan = MM.mmse_wide_plan(m, n, k)
    x = torch.empty_like(served)
    stamps = torch.zeros((lanes, 2 + len(WC.LANE_PHASES)),
                         dtype=torch.int64, device=h.device)
    failed = []
    for w in (w for w in MM.WIDE_WARPS if w >= plan):
        def wide(w=w):
            MM._KERNEL.launch(h.device, (m, n, k), h.data_ptr(),
                              y.data_ptr(), x.data_ptr(), None, lanes, m, n,
                              k, 0.1, MM.DEFAULT_EPS, 32 * w, 0, 0, 2)
        WC.launch_phases("mmse_equalize_phases_f32", h.device,
                         [h, y, x, stamps], [lanes, m, n, k, 2, 32 * w],
                         [0.1, MM.DEFAULT_EPS])
        cycles = float((stamps[:, 1] - stamps[:, 0]).double().mean())
        wide()
        same = torch.equal(x, served)
        print(json.dumps({
            "kernel": "mmse_equalize", "n": n, "lanes": lanes, "warps": w,
            "plan": w == plan, "ms": median_ms(wide),
            "lane_cycles": cycles, "equals_plan": same}), flush=True)
        if not same:
            failed.append(f"mmse_equalize n={n} B={lanes} W={w}: bits")
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--forms", action="store_true",
                    help="time K2's wide form at every W too")
    args = ap.parse_args(argv)
    AB.import_tree(Path(args.tree).resolve())
    import chip_smoke as CS
    import torch
    from repro_torch.kernels import common
    WC = importlib.import_module("repro_torch.pipelines.warp_chain")
    MM = importlib.import_module("repro_torch.pipelines.mmse")
    PU = importlib.import_module("repro_torch.pipelines.pusch")
    mods = {"mmse_equalize": MM, "mmse_equalize_split": MM,
            "channel_estimate": PU, "pusch_chain": PU}

    if not torch.cuda.is_available():
        sys.exit("lane_phases: no CUDA device")
    print(CS.card_line(), flush=True)
    dev = torch.device("cuda")
    common.load_library()
    for source in ("mmse_equalize.cu", "mmse_equalize_split.cu",
                   "pusch_chain.cu"):
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
        form = PA.form_of(mod, kernel, inputs)
        st = stamps.cpu().double()
        total = st[:, 1] - st[:, 0]
        parts = st[:, 2:]
        ordered = bool((total > 0).all() and (parts >= 0).all())
        covered = bool((parts.sum(dim=1) == total).all())
        same = torch.equal(x, served)
        share = (parts / total[:, None]).mean(dim=0)
        warps = MM.mmse_wide_plan(n + 4, n, 2) if form == "wide" else None
        print(json.dumps({
            "kernel": kernel, "n": n, "m": n + 4, "lanes": lanes,
            "form": form, "warps": warps,
            "ms": median_ms(lambda: fused(*inputs)),
            "lane_cycles": float(total.mean()),
            "share": dict(zip(WC.LANE_PHASES, map(float, share))),
            "ordered": ordered, "covered": covered,
            "stamped_equals_served": same}), flush=True)
        if not (ordered and covered and same):
            failed.append(f"{kernel} n={n} B={lanes}: ordered {ordered}, "
                          f"covered {covered}, equal {same}")
        if args.forms and form == "wide":
            failed += sweep_wide(MM, WC, inputs, served, median_ms, torch)
        del inputs, x, stamps, served
    if args.forms:
        for n, lanes in WIDE_SWEEP:
            inputs = PA.make_case(torch, dev, "mmse_equalize", n, lanes)
            served = MM.mmse_equalize_fused(*inputs)
            failed += sweep_wide(MM, WC, inputs, served, median_ms, torch)
            del inputs, served
    if failed:
        sys.exit("lane_phases: " + "; ".join(failed))

if __name__ == "__main__":
    main()
