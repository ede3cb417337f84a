#!/usr/bin/env python3
"""Time K12 and K14 of one or two source trees of the port on one card, in
turns, at a carrier's width and at the 32 lanes the slot mixes serve, and
hold their answers to each other bit for bit.

    python3 scripts/chol_tiled_ab.py --tree new=src [--tree old=OTHER/src] \\
        [--order ABBA] [--reps 5] [--mixes]

Each turn (``ab_turns.py``) is a fresh process that imports
``repro_torch`` from its tree and builds its kernels there.  At each of
``CASES`` (inputs made on the card from a seeded generator as
``chol_tiled_phases.py`` makes them, two right-hand sides, the default
panel width) it reads the fused entry's device ms (CUDA events, L2
flushed, median of ``--reps``) and keeps the whole answer; with
``--mixes`` it then serves the HBM-scale mix (``serve_solvers --sizes
512 --slots 4 --lanes 32``) once warm and once under ``torch.profiler``,
and reads the card's busy time a slot (every kernel's device time over
the slots) and K12's and K14's share of it.  A tree with
``chol_tiled_plan`` records each case's plan.  Each turn prints one JSON
line and writes its answers to ``build/chol_tiled_ab/<tree>.pt``; the
last line is a JSON summary of each tree's ms in turn order and, with two
trees, whether their answers are equal bit for bit at each case (every
element's operations are the same in both, so they must be), with the
largest relative difference beside it.
"""
import argparse
import json
from pathlib import Path

import ab_turns as AB  # the turns and the timing helpers
import chip_smoke as CS  # the card line and clocks (on AB's path)
import chol_tiled_phases as PH  # the cases and their inputs

CASES = PH.CASES[:6]
MIX = ["--sizes", "512", "--slots", "4", "--lanes", "32"]
MIX_SLOTS = 4
OUT = AB.ROOT / "build" / "chol_tiled_ab"
# K12's and K14's kernels as the profiler names them
TILED_KERNEL_NAMES = ("cholesky_solve_tiled", "mmse_equalize_tiled")


def one_turn(name: str, tree: Path, reps: int, mixes: bool) -> dict:
    """The readings of one tree in this process."""
    import importlib

    import torch
    AB.import_tree(tree)
    from repro_torch.kernels import common
    CH = importlib.import_module("repro_torch.pipelines.cholesky_solve")
    MM = importlib.import_module("repro_torch.pipelines.mmse")
    plan_of = getattr(CH, "chol_tiled_plan", None)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    common.load_library()
    median_ms = AB.cold_timer(dev, reps)
    fused = {"cholesky_solve_tiled": CH.cholesky_solve_tiled_fused,
             "mmse_equalize_tiled": MM.mmse_equalize_tiled_fused}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows, answers = [], {}
    for kernel, n, m, lanes in CASES:
        a, b = PH.make_case(torch, kernel, n, m, lanes, gen, dev)
        case = f"{kernel} {m}x{n} B={lanes}"
        call = lambda: fused[kernel](a, b)  # noqa: E731
        answers[case] = call().cpu()
        row = {"case": case, "ms": median_ms(call)}
        if plan_of:
            mm = m if kernel == "mmse_equalize_tiled" else None
            row["plan"] = list(plan_of(lanes, n, 2, CH.tiled_block_size(n),
                                       kernel, m=mm))
        rows.append(row)
        del a, b
    out = {"tree": str(tree), "card": CS.card_line(),
           "clocks": CS.clocks_line(),
           "build_s": common.build_info["seconds"], "rows": rows}
    if mixes:
        from repro_torch.launch import serve_solvers
        kernels = AB.device_kernels(lambda: serve_solvers.main(MIX))
        busy = sum(us for _, us in kernels) / 1e3
        tiled = sum(us for kname, us in kernels
                    if any(k in kname for k in TILED_KERNEL_NAMES))
        out["mix"] = {"busy_ms_a_slot": busy / MIX_SLOTS,
                      "k12_k14_ms_a_slot": tiled / 1e3 / MIX_SLOTS,
                      "kernels": len(kernels)}
    OUT.mkdir(parents=True, exist_ok=True)
    torch.save(answers, OUT / f"{name}.pt")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    AB.add_tree_arguments(ap)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--mixes", action="store_true",
                    help="also read the HBM-scale mix's busy ms a slot")
    args = ap.parse_args(argv)
    trees, order = AB.trees_and_order(ap, args)
    if args.turn:
        print(json.dumps(one_turn(args.turn,
                                  Path(trees[args.turn]).resolve(),
                                  args.reps, args.mixes)), flush=True)
        return
    forward = ["--reps", str(args.reps)] + (["--mixes"] if args.mixes
                                            else [])
    summary = {name: [] for name in trees}
    for name, reading in AB.run_turns(__file__, args, trees, order,
                                      forward):
        summary[name].append({
            **{r["case"]: r["ms"] for r in reading["rows"]},
            **({"HBM mix busy ms a slot": reading["mix"]["busy_ms_a_slot"],
                "HBM mix K12 + K14 ms a slot":
                    reading["mix"]["k12_k14_ms_a_slot"]}
               if "mix" in reading else {})})
    out = {"ms_by_turn": summary}
    if len(trees) == 2:
        import torch
        first, second = (torch.load(OUT / f"{n}.pt") for n in trees)
        out["answers"] = {}
        for kernel, n, m, lanes in CASES:
            case = f"{kernel} {m}x{n} B={lanes}"
            x, y = first[case], second[case]
            rel = float((x - y).abs().max() / x.abs().max())
            out["answers"][case] = {
                "bit_for_bit": bool(torch.equal(x.view(torch.int32),
                                                y.view(torch.int32))),
                "max_rel_diff": rel}
    print(json.dumps(out))
    if len(trees) == 2 and not all(v["bit_for_bit"]
                                   for v in out["answers"].values()):
        raise SystemExit("chol_tiled_ab: the trees' answers differ")


if __name__ == "__main__":
    main()
