#!/usr/bin/env python3
"""Time the global forms of K1, K2 and K3 (the Cholesky chain on a lane in
device memory), and their shared forms at n = 32, of one or two source
trees of the port on one card, in turns, beside ``torch.linalg.solve_ex``
for K1.

    python3 scripts/chol_ab.py --tree new=src [--tree old=OTHER/src] \\
        [--order ABBA] [--reps 5] [--widths 8,16,32,64]

Each turn (``ab_turns.py``) is a fresh process that imports
``repro_torch`` from its tree, builds its kernels there and, at each of
``CASES`` (the mid-range and HBM-scale mixes' per-lane shapes and the
slot mix's n = 32, standard normal inputs from a seeded generator on the
card; K1's systems X X^T + n I), reads the device ms of the fused entry
(which must run the case's form) and, for K1, of
``torch.linalg.solve_ex`` on the same systems, each the median of
``--reps`` calls timed alone by CUDA events with L2 flushed before it.
A tree with ``chol_panel_plan`` also records each global case's plan;
with ``--widths`` it times each again with its plans' widest panel set
to each width (the plan still halves a width that does not fit), and
checks that every width gives the default plan's answer bit for bit.
The build's ``-Xptxas -v`` lines for the three sources are printed with
the card's name and power limit.  Each turn prints one JSON line; the
last line is a JSON summary of each tree's ms in turn order.
"""
import argparse
import json
from pathlib import Path

import ab_turns as AB  # the turns and the timing helpers
import chip_smoke as CS  # the sizes, peaks and card line (on AB's path)

# (kernel, n, lanes, form): K1 at the mid-range mix's ragged n and the
# 1024 demotion rung; K2 and K3 as the mid-range mix sends them; K3's
# split-complex jobs of the HBM-scale mix (a 2n = 1024 system); and the
# shared forms at the slot mix's n = 32, which share the global forms'
# sources and must not move
CASES = (("cholesky_solve", 250, CS.LANES, "global"),
         ("cholesky_solve", 1024, 264, "global"),
         ("mmse_equalize", 256, CS.LANES, "global"),
         ("mmse_equalize_split", 128, CS.LANES, "global"),
         ("mmse_equalize_split", 256, CS.LANES, "global"),
         ("mmse_equalize_split", 512, 264, "global"),
         ("cholesky_solve", 32, CS.LANES, "shared"),
         ("mmse_equalize", 32, CS.LANES, "shared"),
         ("mmse_equalize_split", 32, CS.LANES, "shared"))
SOURCES = ("cholesky_solve.cu", "mmse_equalize.cu", "mmse_equalize_split.cu")


def make_case(torch, gen, dev, key: str, n: int, b: int) -> tuple:
    """The per-lane shapes of the mixes (m = n + 4, k = 2)."""
    g = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    m = n + 4
    if key == "cholesky_solve":
        x = g(b, n, n)
        a = torch.baddbmm(n * torch.eye(n, device=dev), x,
                          x.transpose(-1, -2))
        return a, g(b, n, 2)
    if key == "mmse_equalize":
        return g(b, m, n), g(b, m, 2)
    return g(b, m, n), g(b, m, n), g(b, m, 2), g(b, m, 2)


def one_turn(tree: Path, reps: int, widths: list) -> dict:
    """The readings of one tree in this process."""
    import importlib

    import torch
    AB.import_tree(tree)
    from repro_torch import pipelines as pp
    from repro_torch.kernels import common
    C = importlib.import_module("repro_torch.pipelines.cholesky_solve")
    plan_of = getattr(C, "chol_panel_plan", None)

    dev = torch.device("cuda")
    common.load_library()
    kern = {k.name: k for k in common.KERNELS}
    median_ms = AB.cold_timer(dev, reps)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    fused = {"cholesky_solve": pp.cholesky_solve_fused,
             "mmse_equalize": pp.mmse_equalize_fused,
             "mmse_equalize_split": pp.mmse_equalize_split_fused}
    rows = []
    for key, n, b, form in CASES:
        args = make_case(torch, gen, dev, key, n, b)
        call = lambda: fused[key](*args)                     # noqa: E731
        before = kern[key].launches_global
        want = call()
        torch.cuda.synchronize()
        if (kern[key].launches_global == before + 1) != (form == "global"):
            raise RuntimeError(f"{key} n={n}: the {form} form did not run")
        row = {"case": f"{key} n={n} B={b}", "form": form,
               "ms": median_ms(call)}
        if key == "cholesky_solve":
            row["solve_ex_ms"] = median_ms(
                lambda: torch.linalg.solve_ex(args[0], args[1]))
        if plan_of and form == "global":
            nn, k = (2 * n, 2) if key == "mmse_equalize_split" else (n, 2)
            row["plan"] = list(plan_of(nn, k))
            row["widths"] = {}
            default = C.PANEL_WIDTH
            try:
                for w in widths:
                    C.PANEL_WIDTH = w
                    got = call()
                    row["widths"][w] = {
                        "plan": list(plan_of(nn, k)), "ms": median_ms(call),
                        "equal": bool(torch.equal(got, want))}
            finally:
                C.PANEL_WIDTH = default
        rows.append(row)
        del args, want
    return {"tree": str(tree), "card": CS.card_line(),
            "clocks": CS.clocks_line(),
            "build_s": common.build_info["seconds"],
            "ptxas": {s: CS.ptxas_lines(common.build_info["log"], s)
                      for s in SOURCES},
            "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    AB.add_tree_arguments(ap)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--widths", default="",
                    help="comma-separated widest panels to time as well")
    args = ap.parse_args(argv)
    trees, order = AB.trees_and_order(ap, args)
    widths = [int(w) for w in args.widths.split(",") if w]
    if args.turn:
        print(json.dumps(one_turn(Path(trees[args.turn]).resolve(),
                                  args.reps, widths)), flush=True)
        return
    summary = {name: [] for name in trees}
    for name, reading in AB.run_turns(
            __file__, args, trees, order,
            ["--reps", str(args.reps), "--widths", args.widths]):
        summary[name].append({r["case"]: r["ms"] for r in reading["rows"]})
    print(json.dumps({"ms_by_turn": summary}))


if __name__ == "__main__":
    main()
