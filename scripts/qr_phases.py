#!/usr/bin/env python3
"""Split K11's and K13's lanes into phases on the card.

    python3 scripts/qr_phases.py [--tree src] [--reps 5] [--forms]

For each of ``CASES`` (K11 at the mid-range mix's 132 x 128 and 260 x 256,
K13 at the HBM-scale mix's 516 x 512, at 1028 x 1024 and at a tall 2052
x 512, each at a carrier's width and at the 32 lanes the slot mixes
serve; standard normal inputs from a seeded generator on the card) this
runs the kernel's phase-stamped instance (``qr_solve_phases``:
``clock64()`` on thread 0 of each lane's first CTA at the edges of
``QR_PHASES``), checks that its answer equals the served kernel's bit
for bit, that each lane's stamps are ordered and that its phases add up
to its time, and prints each phase's share of a lane (the mean over
lanes), the lane's mean cycles and the served kernel's device ms (CUDA
events, L2 flushed, median of ``--reps``).  A tree with
``qr_cluster_plan`` also prints the plan of each case and the clusters
of it the card holds at once (``cudaOccupancyMaxActiveClusters``), and
the waves the batch takes.  With ``--forms`` it does so for every form
of ``qr_cluster_forms`` at each case (the plan's marked), and checks
that every form gives the plan's answer bit for bit.  One JSON line a
case and form; the card's name and power limit first.
"""
import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import ab_turns as AB  # noqa: E402  the tree import and the timer

# (kernel, n, m, lanes): K11 at the mid-range sizes, K13 at the HBM-scale
# ones; a carrier's width (B = 264 at n = 1024, as chip_smoke.py's
# TILED_CASES) and the slot mixes' 32 served lanes
CASES = (("qr_solve_blocked", 128, 132, 3276),
         ("qr_solve_blocked", 128, 132, 32),
         ("qr_solve_blocked", 256, 260, 3276),
         ("qr_solve_blocked", 256, 260, 32),
         ("qr_solve_tiled", 512, 516, 3276),
         ("qr_solve_tiled", 512, 516, 32),
         ("qr_solve_tiled", 1024, 1028, 264),
         ("qr_solve_tiled", 1024, 1028, 32),
         ("qr_solve_tiled", 512, 2052, 264),
         ("qr_solve_tiled", 512, 2052, 32))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--forms", action="store_true",
                    help="time every form of qr_cluster_forms at each case")
    args = ap.parse_args(argv)
    AB.import_tree(Path(args.tree).resolve())
    import chip_smoke as CS
    import torch
    Q = importlib.import_module("repro_torch.pipelines.qr_solve")
    CH = importlib.import_module("repro_torch.pipelines.cholesky_solve")
    from repro_torch.kernels import common

    if not torch.cuda.is_available():
        sys.exit("qr_phases: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(CS.card_line(), flush=True)
    dev = torch.device("cuda")
    common.load_library()
    median_ms = AB.cold_timer(dev, args.reps)
    fused = {"qr_solve_blocked": Q.qr_solve_blocked_fused,
             "qr_solve_tiled": Q.qr_solve_tiled_fused}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    plan_of = getattr(Q, "qr_cluster_plan", None)
    for name, n, m, lanes in CASES:
        a = torch.randn((lanes, m, n), generator=gen, device=dev)
        b = torch.randn((lanes, m, 1), generator=gen, device=dev)
        bs = (CH.block_size(n) if name == "qr_solve_blocked"
              else CH.tiled_block_size(n))
        plan = plan_of(lanes, m, n, 1, bs, name) if plan_of else None
        forms = (Q.qr_cluster_forms(m, n, 1, bs) if args.forms
                 else [plan])
        want = fused[name](a, b)
        for form in forms:
            kw = {} if form is None else {"plan": form}
            x, stamps = Q.qr_solve_phases(name, a, b, **kw)
            served = fused[name](a, b, **kw)
            torch.cuda.synchronize()
            st = stamps.cpu().double()
            total = st[:, 1] - st[:, 0]
            parts = st[:, 2:]
            ordered = bool((total > 0).all() and (parts >= 0).all())
            covered = bool((parts.sum(dim=1) == total).all())
            same = bool(torch.equal(x, served) and torch.equal(served, want))
            share = (parts / total[:, None]).mean(dim=0)
            row = {"kernel": name, "m": m, "n": n, "lanes": lanes,
                   "ms": median_ms(lambda: fused[name](a, b, **kw)),
                   "lane_cycles": float(total.mean()),
                   "share": dict(zip(Q.QR_PHASES, map(float, share))),
                   "ordered": ordered, "covered": covered,
                   "stamped_equals_served": same}
            if form is not None:
                at_once = Q.qr_cluster_occupancy(name, form)
                row.update(plan=list(form), is_plan=form == plan,
                           clusters_at_once=at_once,
                           waves=-(-lanes // at_once))
            print(json.dumps(row), flush=True)
            if not (ordered and covered and same):
                sys.exit(f"qr_phases: {name} {m}x{n} B={lanes} {form}: "
                         f"ordered {ordered}, covered {covered}, equal "
                         f"{same}")
            del x, stamps, served
        del a, b, want

if __name__ == "__main__":
    main()
