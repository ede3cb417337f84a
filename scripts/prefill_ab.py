#!/usr/bin/env python3
"""Time the LM prefill of two source trees of the port on one card, in
turns, so that the two are compared within one session of one card.

    python3 scripts/prefill_ab.py --tree new=src --tree old=OTHER/src \\
        [--arch phi4-mini-3.8b ...] [--order ABBA]

A tree is a ``src`` directory that holds a ``repro_torch`` package (for
example an unpacked ``git archive`` of another commit).  Each turn of
``--order`` (A the first ``--tree``, B the second) is a fresh process that
imports ``repro_torch`` from its tree and builds its kernels there, makes
each model's full-width weights from seed 0 as ``chip_smoke.py`` does
(the float32 draw, then the bf16 copy the path runs on) and 4 prompts of
each length, then reads, for each length: the wall ms of a call as the
median of ``--windows`` windows of ``--reps`` back-to-back calls (the card
synchronized at each end of a window only), and the card's busy ms in one
call from torch.profiler.  The models default to the three LM families
(xLSTM runs no K20, so it shows what the host alone moves between
turns).  Each turn prints one JSON line; the last line is a JSON summary
with each tree's readings in turn order.
"""
import argparse
import json
import statistics
from pathlib import Path

import ab_turns as AB  # the turns
import chip_smoke as CS  # the timing helpers and batch size (on AB's path)


def one_turn(tree: Path, archs, seqs, reps: int, windows: int) -> dict:
    """The readings of one tree in this process."""
    import dataclasses

    import torch
    AB.import_tree(tree)
    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.models import transformer as MT

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    common.load_library()
    out = {"tree": str(tree), "card": CS.card_line(),
           "clocks_before": CS.clocks_line(), "archs": {}}
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = MT.cast_params(MT.init_params(gen, cfg), cfg)
        tokens = {s: torch.randint(0, cfg.vocab, (CS.LM_BATCH, s),
                                   generator=gen, device=dev) for s in seqs}
        rows = {}
        for s in seqs:
            call = lambda s=s: MT.prefill(params, cfg, {"tokens": tokens[s]})
            call()                                  # warm-up
            walls = [CS.wall_ms(call, reps) for _ in range(windows)]
            ops = CS.device_ops(call)
            rows[f"s{s}"] = {
                "wall_ms": statistics.median(walls), "wall_ms_windows": walls,
                "kernels": None if ops is None else ops[0],
                "busy_ms": None if ops is None else ops[2]}
        out["archs"][arch] = rows
        del params, tokens
        torch.cuda.empty_cache()
    out["clocks_after"] = CS.clocks_line()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    AB.add_tree_arguments(ap, order_default="ABBA")
    ap.add_argument("--arch", action="append")
    ap.add_argument("--seqs", default="512,128")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--windows", type=int, default=3)
    args = ap.parse_args(argv)
    archs = args.arch or ["phi4-mini-3.8b", "zamba2-2.7b", "xlstm-125m"]
    seqs = [int(s) for s in args.seqs.split(",")]
    trees, order = AB.trees_and_order(ap, args, pairs_only=True)
    if args.turn:
        print(json.dumps(one_turn(Path(trees[args.turn]).resolve(), archs,
                                  seqs, args.reps, args.windows)),
              flush=True)
        return
    summary = {name: [] for name in trees}
    forward = ["--seqs", args.seqs, "--reps", str(args.reps),
               "--windows", str(args.windows)] \
        + [f"--arch={a}" for a in archs]
    for name, reading in AB.run_turns(__file__, args, trees, order,
                                      forward):
        summary[name].append({
            arch: {s: (r["wall_ms"], r["busy_ms"]) for s, r in rows.items()}
            for arch, rows in reading["archs"].items()})
    print(json.dumps({"wall_ms_busy_ms_by_turn": summary}))


if __name__ == "__main__":
    main()
