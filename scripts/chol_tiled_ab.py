#!/usr/bin/env python3
"""Time K12, K14 and K10 of one or two source trees of the port on one
card, in turns, at a carrier's width and at the 32 lanes the slot mixes
serve, and hold their answers to each other bit for bit.

    python3 scripts/chol_tiled_ab.py --tree new=src [--tree old=OTHER/src] \\
        [--order ABBA] [--reps 5] [--mixes] [--kernels NAME,...]

Each turn (``ab_turns.py``) is a fresh process that imports
``repro_torch`` from its tree and builds its kernels there.  At each of
``CASES`` (inputs made on the card from a seeded generator as
``chol_tiled_phases.py`` makes them, two right-hand sides, the default
panel width or K10's odd one; ``--kernels`` keeps the cases of the
kernels it names) it reads the fused entry's device ms (CUDA events, L2
flushed, median of ``--reps``) and keeps the whole answer; with
``--mixes`` it then serves the HBM-scale mix (``serve_solvers --sizes
512 --slots 4 --lanes 32``, where K12 and K14 run) and, where K10's
cases are kept, the mid-range mix (``--sizes 128,256 --slots 4 --lanes
32``, where K10 runs) once warm and once under ``torch.profiler``, and
reads the card's busy time a slot (every kernel's device time over the
slots) and the share of it of the mix's kernels.  A tree whose
``chol_tiled_plan`` plans a case records the plan.  Each turn prints one
JSON line and writes its answers to ``build/chol_tiled_ab/<tree>.pt``; the
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

CASES = PH.CASES[:6] + tuple(c for c in PH.CASES if c[0] == PH.BLOCKED)
MIX_SLOTS = 4
# (label, serve_solvers arguments, the kernels read, as the profiler names
# them, and the kernel whose cases select the mix)
MIXES = (("HBM mix", ["--sizes", "512", "--slots", "4", "--lanes", "32"],
          ("cholesky_solve_tiled", "mmse_equalize_tiled"),
          "cholesky_solve_tiled"),
         ("mid mix", ["--sizes", "128,256", "--slots", "4", "--lanes", "32"],
          (PH.BLOCKED,), PH.BLOCKED))
OUT = AB.ROOT / "build" / "chol_tiled_ab"


def label(kernel, n, m, lanes) -> str:
    """A case's name: K10's with its panel width where it is not 64."""
    if kernel == PH.BLOCKED:
        return (f"{kernel} n={n}" + (f" bs={m}" if m != n else "")
                + f" B={lanes}")
    return f"{kernel} {m}x{n} B={lanes}"


def one_turn(name: str, tree: Path, reps: int, mixes: bool,
             cases) -> dict:
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
             "mmse_equalize_tiled": MM.mmse_equalize_tiled_fused,
             PH.BLOCKED: CH.cholesky_solve_blocked_fused}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows, answers = [], {}
    for kernel, n, m, lanes in cases:
        a, b = PH.make_case(torch, kernel, n, m, lanes, gen, dev)
        case = label(kernel, n, m, lanes)
        bs = PH.case_bs(CH, kernel, n, m)
        call = lambda: fused[kernel](a, b, bs=bs)  # noqa: E731
        answers[case] = call().cpu()
        row = {"case": case, "ms": median_ms(call)}
        if plan_of:
            mm = m if kernel == "mmse_equalize_tiled" else None
            try:
                row["plan"] = list(plan_of(lanes, n, 2, bs, kernel, m=mm))
            except ValueError:      # a tree whose plan has no such kernel
                pass
        rows.append(row)
        del a, b
    out = {"tree": str(tree), "card": CS.card_line(),
           "clocks": CS.clocks_line(),
           "build_s": common.build_info["seconds"], "rows": rows}
    if mixes:
        from repro_torch.launch import serve_solvers
        out["mixes"] = {}
        for mix, argv, names, of in MIXES:
            if not any(c[0] == of for c in cases):
                continue
            kernels = AB.device_kernels(lambda: serve_solvers.main(argv))
            busy = sum(us for _, us in kernels) / 1e3
            mine = sum(us for kname, us in kernels
                       if any(k in kname for k in names))
            out["mixes"][mix] = {"busy_ms_a_slot": busy / MIX_SLOTS,
                                 "kernels_ms_a_slot": mine / 1e3 / MIX_SLOTS,
                                 "read": list(names),
                                 "kernels": len(kernels)}
    OUT.mkdir(parents=True, exist_ok=True)
    torch.save(answers, OUT / f"{name}.pt")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    AB.add_tree_arguments(ap)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--mixes", action="store_true",
                    help="also read the mixes' busy ms a slot")
    ap.add_argument("--kernels", default=None,
                    help="comma-separated kernels whose cases to run")
    args = ap.parse_args(argv)
    cases = [c for c in CASES
             if args.kernels is None or c[0] in args.kernels.split(",")]
    trees, order = AB.trees_and_order(ap, args)
    if args.turn:
        print(json.dumps(one_turn(args.turn,
                                  Path(trees[args.turn]).resolve(),
                                  args.reps, args.mixes, cases)), flush=True)
        return
    forward = (["--reps", str(args.reps)]
               + (["--mixes"] if args.mixes else [])
               + ([f"--kernels={args.kernels}"] if args.kernels else []))
    summary = {name: [] for name in trees}
    for name, reading in AB.run_turns(__file__, args, trees, order,
                                      forward):
        summary[name].append({
            **{r["case"]: r["ms"] for r in reading["rows"]},
            **{f"{mix} {key} ms a slot": v[f"{key}_ms_a_slot"]
               for mix, v in reading.get("mixes", {}).items()
               for key in ("busy", "kernels")}})
    out = {"ms_by_turn": summary}
    if len(trees) == 2:
        import torch
        first, second = (torch.load(OUT / f"{n}.pt") for n in trees)
        out["answers"] = {}
        for kernel, n, m, lanes in cases:
            case = label(kernel, n, m, lanes)
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
