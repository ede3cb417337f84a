#!/usr/bin/env python3
"""Time the MMSE solves of the slot mixes and the PUSCH DAG -- K2 (the
MMSE equalizer), K3 (the split equalizer), K5 (the channel estimate) and
K6 (the fused PUSCH chain) -- of one or two source trees of the port on
one card, in turns, and hold their answers to each other bit for bit.

    python3 scripts/pusch_ab.py --tree new=src [--tree old=OTHER/src] \\
        [--order BAAB] [--reps 10]

Each turn (``ab_turns.py``) is a fresh process that imports
``repro_torch`` from its tree and builds its kernels there.  At each of
``CASES`` (K2 at a carrier's 3276 lanes at n = 32 and 128, at the slot
mixes' and the decode trace's served widths and at the mid-range mix's
n = 128 on 32 lanes; K3 at 3276 lanes and at the slot mixes' 32 served
lanes, n = 8, 16, 32; K5 and K6 at 3276 lanes and n = 32, and at the
DAG's n = 8 on 4 lanes and n = 24 on 32; m = n + 4 antennas, p = 2n
pilots, k = 2 symbols), with inputs made on the card from a seeded
generator (the same in every turn), it reads the kernel's device ms
(CUDA events, L2 flushed, median of ``--reps``) and keeps its answer
(``build/pusch_ab/<tree>.pt``).  A tree whose kernel takes a ``form``
also runs the CTA form at each case, records whether it gives the served
form's answer (``torch.equal``) and times it (``cta_ms``).  Each turn
prints one JSON line; the last line is a JSON summary: each tree's ms in
turn order and, with two trees, whether every turn's answers are
``torch.equal`` to the other tree's at every case.  It exits 1 if any
answer or form differs.
"""
import argparse
import json
import sys
from pathlib import Path

import ab_turns as AB  # the turns and the timing helpers
import chip_smoke as CS  # the card line and clocks

# (kernel, n, lanes): m = n + 4, p = 2n, k = 2
CASES = (("mmse_equalize", 32, 3276), ("mmse_equalize", 8, 8),
         ("mmse_equalize", 12, 8), ("mmse_equalize", 16, 32),
         ("mmse_equalize", 32, 32), ("mmse_equalize", 8, 4),
         ("mmse_equalize", 24, 32), ("mmse_equalize", 128, 32),
         ("mmse_equalize", 128, 3276),
         ("mmse_equalize_split", 8, 3276), ("mmse_equalize_split", 16, 3276),
         ("mmse_equalize_split", 32, 3276), ("mmse_equalize_split", 8, 32),
         ("mmse_equalize_split", 16, 32), ("mmse_equalize_split", 32, 32),
         ("pusch_chain", 32, 3276), ("pusch_chain", 8, 4),
         ("pusch_chain", 24, 32), ("channel_estimate", 32, 3276),
         ("channel_estimate", 8, 4), ("channel_estimate", 24, 32))
OUT = AB.ROOT / "build" / "pusch_ab"


def make_case(torch, dev, kernel: str, n: int, lanes: int, seed: int = 0):
    """The inputs of one case, standard normal, made on the card from a
    generator seeded with ``seed``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    m, p = n + 4, 2 * n
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    if kernel == "mmse_equalize_split":
        return r(lanes, m, n), r(lanes, m, n), r(lanes, m, 2), r(lanes, m, 2)
    if kernel == "mmse_equalize":
        return r(lanes, m, n), r(lanes, m, 2)
    if kernel == "pusch_chain":
        return r(lanes, n, p), r(lanes, m, p), r(lanes, m, 2)
    return r(lanes, n, p), r(lanes, m, p)


def form_of(mod, kernel: str, args):
    """The form a tree picks for ``kernel`` at ``args`` (None for a tree
    without forms of it)."""
    if kernel == "mmse_equalize" and hasattr(mod, "mmse_form"):
        _, m, n = args[0].shape
        return mod.mmse_form(m, n, args[1].shape[-1])
    if kernel == "channel_estimate" and hasattr(mod,
                                                "channel_estimate_plan"):
        _, n, p = args[0].shape
        return mod.channel_estimate_plan(n, p, args[1].shape[1])
    if kernel == "mmse_equalize_split" and hasattr(mod, "mmse_split_plan"):
        _, m, n = args[0].shape
        return mod.mmse_split_plan(m, n, args[2].shape[-1])
    if kernel == "pusch_chain" and hasattr(mod, "pusch_chain_plan"):
        _, n, p = args[0].shape
        return mod.pusch_chain_plan(n, p, args[1].shape[1],
                                    args[2].shape[-1])
    return None


def one_turn(name: str, tree: Path, reps: int) -> dict:
    """The readings of one tree in this process."""
    import importlib

    import torch
    AB.import_tree(tree)
    from repro_torch.kernels import common
    pp = {k: importlib.import_module(f"repro_torch.pipelines.{mod}")
          for k, mod in (("mmse_equalize", "mmse"),
                         ("mmse_equalize_split", "mmse"),
                         ("pusch_chain", "pusch"),
                         ("channel_estimate", "pusch"))}
    dev = torch.device("cuda")
    common.load_library()
    median_ms = AB.cold_timer(dev, reps)
    rows, answers = [], {}
    for kernel, n, lanes in CASES:
        args = make_case(torch, dev, kernel, n, lanes)
        fused = getattr(pp[kernel], f"{kernel}_fused")
        want = fused(*args)
        case = f"{kernel} n={n} B={lanes}"
        row = {"case": case, "ms": median_ms(lambda: fused(*args))}
        form = form_of(pp[kernel], kernel, args)
        if form:
            row["form"] = form
            row["forms_equal"] = torch.equal(fused(*args, form="cta"), want)
            row["cta_ms"] = median_ms(lambda: fused(*args, form="cta"))
        answers[case] = want.cpu()
        rows.append(row)
        del args, want
    OUT.mkdir(parents=True, exist_ok=True)
    torch.save(answers, OUT / f"{name}.pt")
    return {"tree": str(tree), "card": CS.card_line(),
            "clocks": CS.clocks_line(),
            "build_s": common.build_info["seconds"], "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    AB.add_tree_arguments(ap)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    trees, order = AB.trees_and_order(ap, args)
    if args.turn:
        tree = Path(trees[args.turn]).resolve()
        print(json.dumps(one_turn(args.turn, tree, args.reps)), flush=True)
        return
    import torch
    summary = {name: [] for name in trees}
    forms_ok, equal, first = True, [], {}
    for name, reading in AB.run_turns(__file__, args, trees, order,
                                      ["--reps", str(args.reps)]):
        summary[name].append({r["case"]: r["ms"] for r in reading["rows"]})
        forms_ok &= all(r.get("forms_equal", True) for r in reading["rows"])
        got = torch.load(OUT / f"{name}.pt")
        first.setdefault(name, got)
        for other, ref in first.items():      # every turn against the
            equal.append(all(torch.equal(got[k], ref[k])   # first of each
                             for k in ref))                 # tree
    out = {"ms_by_turn": summary, "forms_equal": forms_ok,
           "all_equal": all(equal)}
    print(json.dumps(out))
    if not (forms_ok and out["all_equal"]):
        sys.exit("pusch_ab: answers differ")


if __name__ == "__main__":
    main()
