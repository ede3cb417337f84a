#!/usr/bin/env python3
"""Time K21, the chunked SSD scan, of one or two source trees of the port
on one card, in turns, and hold their answers to each other bit for bit.

    python3 scripts/ssm_ab.py --tree new=src [--tree old=OTHER/src] \\
        [--order BAAB] [--reps 10]

Each turn (``ab_turns.py``) is a fresh process that imports
``repro_torch`` from its tree and builds its kernels there.  At each of
``CASES`` (``chip_smoke.py``'s ``SSM_CASES`` and ``SSM_TIMES``: the
registry case, zamba2-2.7b's and xlstm-125m's prefill shapes at S = 512
and 128, S < chunk, the decay limits and 16 chunks at chunk 128), in
float32 and in bfloat16, with inputs made on the card from a seeded
generator (the same in every turn), it reads ``ssm_scan_fused``'s device
ms (CUDA events, L2 flushed, median of ``--reps``) and keeps y and h
(``build/ssm_ab/<tree>.pt``); a tree with ``ssm_check_forms`` also runs
every one of those forms and records whether each gives the plan's y and
h (``torch.equal``).  Each turn prints one JSON line; the last line is a
JSON summary: each tree's ms in turn order, and with two trees whether
their y and h are ``torch.equal`` at every case and dtype.  It exits 1 if
any pair of answers or any form differs.
"""
import argparse
import json
import math
import sys
from pathlib import Path

import ab_turns as AB  # the turns and the timing helpers
import chip_smoke as CS  # the cases, the card line and clocks

# (label, B, H, S, P, N, B/C per head, chunk, decay range), each shape once
CASES = tuple({c[1:8]: c for c in CS.SSM_CASES + tuple(
    t + ((0.8, 0.999),) for t in CS.SSM_TIMES)}.values())
DTYPES = ("float32", "bfloat16")
OUT = AB.ROOT / "build" / "ssm_ab"


def one_turn(name: str, tree: Path, reps: int) -> dict:
    """The readings of one tree in this process."""
    import importlib

    import torch
    AB.import_tree(tree)
    from repro_torch.kernels import common
    KS = importlib.import_module("repro_torch.kernels.ssm_scan")
    dev = torch.device("cuda")
    common.load_library()
    median_ms = AB.cold_timer(dev, reps)
    check_forms = getattr(KS, "ssm_check_forms", None)
    rows, answers = [], {}
    for label, b, h, s, p, n, per_head, cs, decays in CASES:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        bc = (b, h, s, n) if per_head else (b, s, n)
        x = torch.randn((b, h, s, p), generator=gen, device=dev)
        a = decays[0] + (decays[1] - decays[0]) * torch.rand(
            (b, h, s), generator=gen, device=dev)
        bb = torch.randn(bc, generator=gen, device=dev) / math.sqrt(n)
        cc = torch.randn(bc, generator=gen, device=dev) / math.sqrt(n)
        for dt in DTYPES:
            args = tuple(t.to(getattr(torch, dt)) for t in (x, a, bb, cc))
            call = lambda kw={}: KS.ssm_scan_fused(  # noqa: E731
                *args, chunk=cs, **kw)
            want = call()
            case = f"{label} ({b},{h},{s},{p}) N={n} chunk={cs}"
            row = {"case": case, "dtype": dt, "ms": median_ms(call)}
            if check_forms:
                forms = check_forms(b, h, s, p, n, min(cs, s))
                row["plan"] = list(forms[0])
                row["forms"] = [list(f) for f in forms]
                row["forms_equal"] = all(
                    all(torch.equal(g, w) for g, w in zip(
                        call({"plan": f}), want)) for f in forms)
            answers[f"{case} {dt}"] = tuple(t.cpu() for t in want)
            rows.append(row)
            del args, want
        del x, a, bb, cc
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
    summary = {name: [] for name in trees}
    forms_ok = True
    for name, reading in AB.run_turns(__file__, args, trees, order,
                                      ["--reps", str(args.reps)]):
        summary[name].append({f"{r['case']} {r['dtype']}": r["ms"]
                              for r in reading["rows"]})
        forms_ok &= all(r.get("forms_equal", True) for r in reading["rows"])
    out = {"ms_by_turn": summary, "forms_equal": forms_ok}
    if len(trees) == 2:
        import torch
        first, second = (torch.load(OUT / f"{n}.pt") for n in trees)
        out["equal"] = {k: k in second and all(
            torch.equal(g, w) for g, w in zip(first[k], second[k]))
            for k in first}
        out["all_equal"] = all(out["equal"].values())
    print(json.dumps(out))
    if not (forms_ok and out.get("all_equal", True)):
        sys.exit("ssm_ab: answers differ")


if __name__ == "__main__":
    main()
