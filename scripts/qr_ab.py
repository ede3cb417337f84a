#!/usr/bin/env python3
"""Time K4's global form (the Householder chain on a lane in device memory)
and its shared form at n = 32, and K16 at n = 8 and 32, of one or two
source trees of the port on one card, in turns, beside
``torch.linalg.lstsq`` for K4 and ``torch.linalg.solve_triangular`` for
K16.

    python3 scripts/qr_ab.py --tree new=src [--tree old=OTHER/src] \\
        [--order ABBA] [--reps 5] [--widths 8,16,32] [--tiles 32,128]

Each turn (``ab_turns.py``) is a fresh process that imports
``repro_torch`` from its tree, builds its kernels there and, at each of
``CASES`` (K4 at the global case of ``chip_smoke.py`` and the demoted 1024
bucket's rung, and the slot mix's n = 32; K16 forward at the slot mix's n
= 8 and 32 on Cholesky factors with two right-hand sides; standard normal
inputs from a seeded generator on the card), reads the device ms of the
fused entry (K4 must run the case's form) and of the library call on the
same inputs, each the median of ``--reps`` calls timed alone by CUDA
events with L2 flushed before it.  A tree with ``qr_panel_plan`` also
records each global case's plan; with ``--widths`` or ``--tiles`` it times
each again with its plan's widest panel or tile set to each value (the
plan still halves what does not fit) and checks that each gives the
default plan's answer bit for bit.  A tree with ``trisolve_form`` records
K16's form.  The build's ``-Xptxas -v`` lines for the two sources are
printed with the card's name and power limit.  Each turn prints one JSON
line; the last line is a JSON summary of each tree's ms in turn order.
"""
import argparse
import json
from pathlib import Path

import ab_turns as AB  # the turns and the timing helpers
import chip_smoke as CS  # the sizes, peaks and card line (on AB's path)

# (kernel, n, m, lanes, form): K4 at 254 x 250 (chip_smoke.py's global
# case) and 1028 x 1024 (the demoted 1024 QR bucket's rung), and its
# shared form at the slot mix's 36 x 32, which shares the source and must
# not move; K16 at the slot mix's n = 8 and 32 (m: right-hand sides)
CASES = (("qr_solve", 250, 254, CS.LANES, "global"),
         ("qr_solve", 1024, 1028, 264, "global"),
         ("qr_solve", 32, 36, CS.LANES, "shared"),
         ("trisolve", 8, 2, CS.LANES, None),
         ("trisolve", 32, 2, CS.LANES, None))
SOURCES = ("qr_solve.cu", "trisolve.cu")
KNOBS = {"widths": "QR_PANEL_WIDTH", "tiles": "QR_TILE_WIDTH"}


def make_case(torch, gen, dev, key: str, n: int, m: int, b: int) -> tuple:
    """K4: A (b, m, n), B (b, m, 1); K16: L, a Cholesky factor of X X^T
    + n I, and B (b, n, m)."""
    g = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    if key == "qr_solve":
        return g(b, m, n), g(b, m, 1)
    x = g(b, n, n)
    spd = torch.baddbmm(n * torch.eye(n, device=dev), x, x.transpose(-1, -2))
    return torch.linalg.cholesky(spd).contiguous(), g(b, n, m)


def one_turn(tree: Path, reps: int, knobs: dict) -> dict:
    """The readings of one tree in this process."""
    import importlib

    import torch
    AB.import_tree(tree)
    from repro_torch import pipelines as pp
    from repro_torch.kernels import common
    Q = importlib.import_module("repro_torch.pipelines.qr_solve")
    T = importlib.import_module("repro_torch.kernels.trisolve")
    plan_of = getattr(Q, "qr_panel_plan", None)
    form_of = getattr(T, "trisolve_form", None)

    dev = torch.device("cuda")
    common.load_library()
    kern = {k.name: k for k in common.KERNELS}
    median_ms = AB.cold_timer(dev, reps)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    for key, n, m, b, form in CASES:
        args = make_case(torch, gen, dev, key, n, m, b)
        if key == "qr_solve":
            call = lambda: pp.qr_solve_fused(*args)            # noqa: E731
            lib = lambda: torch.linalg.lstsq(*args).solution  # noqa: E731
        else:
            call = lambda: T.trisolve_fused(*args)             # noqa: E731
            lib = lambda: torch.linalg.solve_triangular(       # noqa: E731
                *args, upper=False)
        before = kern[key].launches_global
        want = call()
        torch.cuda.synchronize()
        if form and (kern[key].launches_global == before + 1) != (
                form == "global"):
            raise RuntimeError(f"{key} n={n}: the {form} form did not run")
        row = {"case": f"{key} n={n} m={m} B={b}", "form": form,
               "ms": median_ms(call), "library_ms": median_ms(lib)}
        if key == "trisolve" and form_of:
            row["form"] = form_of(n, m)
        if plan_of and form == "global":
            row["plan"] = list(plan_of(m, n, 1))
            for knob, values in knobs.items():
                attr = KNOBS[knob]
                row[knob] = {}
                default = getattr(Q, attr)
                try:
                    for w in values:
                        setattr(Q, attr, w)
                        got = call()
                        row[knob][w] = {
                            "plan": list(plan_of(m, n, 1)),
                            "ms": median_ms(call),
                            "equal": bool(torch.equal(got, want))}
                finally:
                    setattr(Q, attr, default)
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
    ap.add_argument("--tiles", default="",
                    help="comma-separated widest tiles to time as well")
    args = ap.parse_args(argv)
    trees, order = AB.trees_and_order(ap, args)
    knobs = {knob: [int(w) for w in getattr(args, knob).split(",") if w]
             for knob in KNOBS if getattr(args, knob)}
    if args.turn:
        print(json.dumps(one_turn(Path(trees[args.turn]).resolve(),
                                  args.reps, knobs)), flush=True)
        return
    summary = {name: [] for name in trees}
    for name, reading in AB.run_turns(
            __file__, args, trees, order,
            ["--reps", str(args.reps), "--widths", args.widths,
             "--tiles", args.tiles]):
        summary[name].append({r["case"]: r["ms"] for r in reading["rows"]})
    print(json.dumps({"ms_by_turn": summary}))


if __name__ == "__main__":
    main()
