#!/usr/bin/env python3
"""Split K8's lanes into phases on the card.

    python3 scripts/svd_phases.py [--tree src] [--reps 5] [--forms] [--fit]

For each of ``CASES`` (the svd_solve DAG's two served shapes, n = 24 on
32 lanes and n = 8 on 4 lanes, and n = 32, 16 and 8 at a carrier's 3276
lanes; m = n + 4, the DAG's 14 sweeps, standard normal inputs from a
seeded generator on the card) this runs K8's phase-stamped instance
(``svd_phases``: ``clock64()`` on thread 0 of each lane at the edges of
``SVD_PHASES``), checks that its U, S and V equal the served kernel's bit
for bit, that each lane's stamps are ordered and that its phases add up
to its time, and prints each phase's share of a lane (the mean over
lanes), the lane's mean cycles and its cycles a step (a rotation of one
pair on a tree that runs the pairs in turn, a round of disjoint pairs on
one that runs them at once), the DAG stage's device ms (``svd_factor``;
CUDA events, L2 flushed, median of ``--reps``) and ``torch.linalg.svd``'s
on the same lanes.  A tree with ``svd_plan`` also prints the plan of
each case; with ``--forms`` it does so for every form of ``svd_forms``
at each case (the plan's marked) and checks that every form gives the
plan's bits.  Each instance's registers and spills (``-Xptxas -v``)
are printed after the build.  With ``--forms --fit`` the last line is
the plan's model (``SVD_ROUND_NS``) fitted to the sweep's served times
(the stamps slow an instance down by up to a fifth, unevenly across
forms) and the form the refitted model picks at each case beside the
fastest one measured.  One JSON line a case and form; the card's name
and power limit first.
"""
import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import ab_turns as AB  # noqa: E402  the tree import and the timer

# (n, m, lanes): the svd_solve DAG at n = 24 on 32 lanes (serve_solvers
# --pusch --sizes 24 --lanes 32) and at n = 8 on the mux's 4 lanes, and a
# carrier's width at the slot mixes' sizes (the last two price the plan's
# issue model apart from the first)
CASES = ((24, 28, 32), (8, 12, 4), (32, 36, 3276), (16, 20, 3276),
         (8, 12, 3276))


def bits(*tensors):
    """The tensors' bits, flat, as one int32 tensor (NaN compares)."""
    import torch
    return torch.cat([t.reshape(-1).view(torch.int32) for t in tensors])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--forms", action="store_true",
                    help="time every form of svd_forms at each case")
    ap.add_argument("--fit", action="store_true",
                    help="fit the plan's model to the --forms sweep")
    args = ap.parse_args(argv)
    AB.import_tree(Path(args.tree).resolve())
    import chip_smoke as CS
    import torch
    S = importlib.import_module("repro_torch.kernels.svd")
    P = importlib.import_module("repro_torch.pipelines.pusch")
    from repro_torch.kernels import common

    if not torch.cuda.is_available():
        sys.exit("svd_phases: no CUDA device")
    print(CS.card_line(), flush=True)
    dev = torch.device("cuda")
    common.load_library()
    ptxas = CS.ptxas_lines(common.build_info["log"], "svd.cu")
    for i, line in enumerate(ptxas):       # each instance's registers
        if "svd_kernel" in line:
            print(json.dumps({"instance": line.split("'")[1],
                              "ptxas": ptxas[i + 1:i + 3]}), flush=True)
    median_ms = AB.cold_timer(dev, args.reps)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sweeps = P.DAG_SWEEPS
    plan_of = getattr(S, "svd_plan", None)
    sweep, failed = [], []
    for n, m, lanes in CASES:
        a = torch.randn((lanes, m, n), generator=gen, device=dev)
        plan = plan_of(lanes, m, n) if plan_of else None
        forms = S.svd_forms(m, n) if args.forms and plan_of else [plan]
        rounds = (len(S.jacobi_rounds(n)) if hasattr(S, "jacobi_rounds")
                  else n * (n - 1) // 2)
        want = bits(*S.svd_fused(a, sweeps))
        lib_ms = median_ms(lambda: torch.linalg.svd(a, full_matrices=False))
        for form in forms:
            kw = {} if form is None else {"plan": form}
            factors, stamps = S.svd_phases(a, sweeps, **kw)
            served = bits(*S.svd_fused(a, sweeps, **kw))
            torch.cuda.synchronize()
            st = stamps.cpu().double()
            total = st[:, 1] - st[:, 0]
            parts = st[:, 2:]
            ordered = bool((total > 0).all() and (parts >= 0).all())
            covered = bool((parts.sum(dim=1) == total).all())
            same = bool(torch.equal(bits(*factors), served)
                        and torch.equal(served, want))
            share = (parts / total[:, None]).mean(dim=0)
            steps = sweeps * rounds
            row = {"n": n, "m": m, "lanes": lanes, "sweeps": sweeps,
                   "steps": steps,
                   "ms": median_ms(lambda: P.svd_factor_fused(a, **kw)),
                   "linalg_svd_ms": lib_ms,
                   "lane_cycles": float(total.mean()),
                   "step_cycles": float(total.mean()) / steps,
                   "share": dict(zip(S.SVD_PHASES, map(float, share))),
                   "step_cycles_by_phase": dict(zip(
                       S.SVD_PHASES,
                       map(float, parts.mean(dim=0) / steps))),
                   "ordered": ordered, "covered": covered,
                   "stamped_equals_served": same}
            if form is not None:
                row.update(plan=list(form), is_plan=form == plan)
                sweep.append((n, m, lanes, form, row))
            print(json.dumps(row), flush=True)
            if not (ordered and covered and same):
                failed.append(f"n={n} m={m} B={lanes} {form}: ordered "
                              f"{ordered}, covered {covered}, equal {same}")
            del factors, stamps
        del a
    if args.fit and sweep:
        print(json.dumps({"fit": fit(S, sweep)}), flush=True)
    if failed:
        sys.exit("svd_phases: " + "; ".join(failed))


def fit(S, sweep) -> dict:
    """SVD_ROUND_NS fitted to the sweep's served times (``S.fit_round_ns``:
    each form's ms over its sweeps' rounds) and each case's pick under it
    beside its fastest form."""
    prices = S.fit_round_ns([(n, m, lanes, form, row["ms"] * 1e6
                              / row["steps"])
                             for n, m, lanes, form, row in sweep])
    old = dict(S.SVD_ROUND_NS)
    S.SVD_ROUND_NS.update(prices)
    picks = {}
    try:
        for n, m, lanes in CASES:
            rows = [(form, row) for nn, mm, ll, form, row in sweep
                    if (nn, mm, ll) == (n, m, lanes)]
            pick = S.svd_plan(lanes, m, n)
            best = min(rows, key=lambda r: r[1]["ms"])
            picks[f"{m}x{n} B={lanes}"] = {
                "pick": list(pick),
                "pick_ms": next(r["ms"] for f, r in rows if f == pick),
                "best": list(best[0]), "best_ms": best[1]["ms"]}
    finally:
        S.SVD_ROUND_NS.clear()
        S.SVD_ROUND_NS.update(old)
    return {"SVD_ROUND_NS": {f"{g},{int(c)}": price for (g, c), price
                             in prices.items()}, "picks": picks}


if __name__ == "__main__":
    main()
