#!/usr/bin/env python3
"""Time K11 and K13 of one or two source trees of the port on one card, in
turns, at a carrier's width and at the 32 lanes the slot mixes serve, and
the slot mixes' device time a slot.

    python3 scripts/qr_cluster_ab.py --tree new=src [--tree old=OTHER/src] \\
        [--order ABBA] [--reps 5]

Each turn (``ab_turns.py``) is a fresh process that imports
``repro_torch`` from its tree and builds its kernels there.  At each of
``CASES`` (standard normal inputs from a seeded generator on the card,
one right-hand side, the default panel width) it reads the fused entry's
device ms (CUDA events, L2 flushed, median of ``--reps``) and keeps the
answer; then it serves the HBM-scale mix (``serve_solvers --sizes 512
--slots 4 --lanes 32``) and the mid-range mix (``--sizes 128,256 --slots
8 --lanes 32``) once warm and once under ``torch.profiler``, and reads
the card's busy time a slot (every kernel's device time over the slots)
and K11's and K13's share of it.  A tree with ``qr_cluster_plan``
records each case's plan.  Each turn prints one JSON line and writes its
answers to ``build/qr_cluster_ab/<tree>.pt``; the last line is a
JSON summary of each tree's ms in turn order and, with two trees, the
largest relative difference of their answers at each case beside the
spec's rtol (the panel sums regroup, so the bits may differ).
"""
import argparse
import json
from pathlib import Path

import ab_turns as AB  # the turns and the timing helpers
import chip_smoke as CS  # the card line and clocks (on AB's path)

# (kernel, n, m, lanes): a carrier's width (B = 264 at n = 1024, as
# chip_smoke.py's TILED_CASES) and the slot mixes' 32 served lanes
CASES = (("qr_solve_blocked", 128, 132, CS.LANES),
         ("qr_solve_blocked", 128, 132, 32),
         ("qr_solve_blocked", 256, 260, CS.LANES),
         ("qr_solve_blocked", 256, 260, 32),
         ("qr_solve_tiled", 512, 516, CS.LANES),
         ("qr_solve_tiled", 512, 516, 32),
         ("qr_solve_tiled", 1024, 1028, 264),
         ("qr_solve_tiled", 1024, 1028, 32))
RTOL = {"qr_solve_blocked": 1e-3, "qr_solve_tiled": 2e-3}
MIXES = (("hbm", ["--sizes", "512", "--slots", "4", "--lanes", "32"], 4),
         ("mid", ["--sizes", "128,256", "--slots", "8", "--lanes", "32"], 8))
OUT = AB.ROOT / "build" / "qr_cluster_ab"
# K11's and K13's kernels as the profiler names them: the one-CTA kernels
# and the cluster kernel both variants instantiate
QR_KERNEL_NAMES = ("qr_solve_blocked", "qr_solve_tiled", "qr_cluster_kernel")


def one_turn(name: str, tree: Path, reps: int) -> dict:
    """The readings of one tree in this process."""
    import importlib

    import torch
    AB.import_tree(tree)
    from repro_torch.kernels import common
    from repro_torch.launch import serve_solvers
    Q = importlib.import_module("repro_torch.pipelines.qr_solve")
    CH = importlib.import_module("repro_torch.pipelines.cholesky_solve")
    plan_of = getattr(Q, "qr_cluster_plan", None)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    common.load_library()
    median_ms = AB.cold_timer(dev, reps)
    fused = {"qr_solve_blocked": Q.qr_solve_blocked_fused,
             "qr_solve_tiled": Q.qr_solve_tiled_fused}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows, answers = [], {}
    for kernel, n, m, lanes in CASES:
        a = torch.randn((lanes, m, n), generator=gen, device=dev)
        b = torch.randn((lanes, m, 1), generator=gen, device=dev)
        case = f"{kernel} {m}x{n} B={lanes}"
        call = lambda: fused[kernel](a, b)  # noqa: E731
        answers[case] = call()[:64].cpu()
        row = {"case": case, "ms": median_ms(call)}
        if plan_of:
            bs = (CH.block_size(n) if kernel == "qr_solve_blocked"
                  else CH.tiled_block_size(n))
            row["plan"] = list(plan_of(lanes, m, n, 1, bs, kernel))
        rows.append(row)
        del a, b
    mixes = {}
    for label, argv, slots in MIXES:
        kernels = AB.device_kernels(lambda: serve_solvers.main(argv))
        busy = sum(us for _, us in kernels) / 1e3
        qr = sum(us for kname, us in kernels
                 if any(name in kname for name in QR_KERNEL_NAMES))
        mixes[label] = {"busy_ms_a_slot": busy / slots,
                        "k11_k13_ms_a_slot": qr / 1e3 / slots,
                        "kernels": len(kernels)}
    OUT.mkdir(parents=True, exist_ok=True)
    torch.save(answers, OUT / f"{name}.pt")
    return {"tree": str(tree), "card": CS.card_line(),
            "clocks": CS.clocks_line(),
            "build_s": common.build_info["seconds"], "rows": rows,
            "mixes": mixes}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    AB.add_tree_arguments(ap)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    trees, order = AB.trees_and_order(ap, args)
    if args.turn:
        print(json.dumps(one_turn(args.turn,
                                  Path(trees[args.turn]).resolve(),
                                  args.reps)), flush=True)
        return
    summary = {name: [] for name in trees}
    for name, reading in AB.run_turns(__file__, args, trees, order,
                                      ["--reps", str(args.reps)]):
        summary[name].append({
            **{r["case"]: r["ms"] for r in reading["rows"]},
            **{f"{label} mix busy ms a slot": m["busy_ms_a_slot"]
               for label, m in reading["mixes"].items()}})
    out = {"ms_by_turn": summary}
    if len(trees) == 2:
        import torch
        first, second = (torch.load(OUT / f"{n}.pt") for n in trees)
        out["answers"] = {}
        for kernel, n, m, lanes in CASES:
            case = f"{kernel} {m}x{n} B={lanes}"
            x, y = first[case], second[case]
            rel = float((x - y).abs().max() / x.abs().max())
            out["answers"][case] = {"max_rel_diff": rel,
                                    "rtol": RTOL[kernel],
                                    "within": rel <= RTOL[kernel],
                                    "bit_for_bit": bool(torch.equal(x, y))}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
