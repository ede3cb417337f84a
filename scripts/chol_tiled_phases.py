#!/usr/bin/env python3
"""Split K12's, K14's and K10's lanes into phases on the card.

    python3 scripts/chol_tiled_phases.py [--tree src] [--reps 5] [--forms]
        [--fit] [--kernels cholesky_solve_blocked,...]

For each of ``CASES`` (K14 at the HBM-scale mix's 516 x 512, at 1028 x
1024 and at a tall 2052 x 512, K12 at n = 512 and 1024, K10 at the
mid-range mix's n = 128 and 256 (panels of 64) and at the odd panel
widths (128, 16) and (192, 48); a carrier's width and the 32 lanes the
slot mixes serve; inputs made on the card from a seeded generator as
``chip_smoke.py`` makes them: X X^T + n I for K12 and K10, standard
normal H and y for K14, two right-hand sides; ``--kernels`` keeps the
cases of the kernels it names) this runs the
kernel's phase-stamped instance (``chol_tiled_phases``: ``clock64()`` on
thread 0 of each lane's first CTA at the edges of ``TILED_PHASES``),
checks that its answer equals the served kernel's bit for bit, that each
lane's stamps are ordered and that its phases add up to its time, and
prints each phase's share of a lane (the mean over lanes), the lane's
mean cycles and the served kernel's device ms (CUDA events, L2 flushed,
median of ``--reps``).  A tree with ``chol_tiled_plan`` also prints the
plan of each case, the clusters of it the card holds at once
(``cudaOccupancyMaxActiveClusters``) and the waves the batch takes.  With
``--forms`` it does so for every form of ``chol_tiled_forms`` at each
case (the plan's marked), and checks that every form gives the plan's
answer bit for bit.  One JSON line a case and form; the card's name and
power limit first.  With ``--forms --fit`` the last line is the lane
model's prices (``CHOL_LANE_CYCLES``) fitted to the sweep, a price a
phase and product tile: each phase's mean cycles a lane against its
units (``chol_lane_units``) by least squares through 0, the cluster
barrier's from what the other prices leave of each lane, and the form
the refitted model picks at each case beside the fastest one measured.
K10's cases price its chain back substitution ("chain") alone; the other
prices come from K12's and K14's cases (kept as they are where the
sweep has none).
"""
import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import ab_turns as AB  # noqa: E402  the tree import and the timer

# (kernel, n, m, lanes): the six cases of the HBM-scale path (a carrier's
# width, B = 264 at n = 1024 as chip_smoke.py's TILED_CASES, and the slot
# mixes' 32 served lanes), K14 on a tall channel, and K10 at the mid-range
# mix's sizes at both widths and at the odd panel widths (BLOCKED_BS)
CASES = (("mmse_equalize_tiled", 512, 516, 3276),
         ("mmse_equalize_tiled", 512, 516, 32),
         ("mmse_equalize_tiled", 1024, 1028, 264),
         ("cholesky_solve_tiled", 512, 512, 3276),
         ("cholesky_solve_tiled", 512, 512, 32),
         ("cholesky_solve_tiled", 1024, 1024, 264),
         ("mmse_equalize_tiled", 512, 2052, 32),
         ("cholesky_solve_blocked", 128, 128, 32),
         ("cholesky_solve_blocked", 256, 256, 32),
         ("cholesky_solve_blocked", 128, 128, 3276),
         ("cholesky_solve_blocked", 256, 256, 3276),
         ("cholesky_solve_blocked", 128, 16, 3276),
         ("cholesky_solve_blocked", 192, 48, 3276))
# K10: its cases' m column holds the panel width where it is not n
BLOCKED = "cholesky_solve_blocked"


def case_bs(CH, kernel, n, m):
    """The panel width of a case: K10 64 (``block_size``) or its odd
    width, K12 and K14 ``tiled_block_size``."""
    if kernel == BLOCKED:
        return m if m != n else CH.block_size(n)
    return CH.tiled_block_size(n)


def make_case(torch, kernel, n, m, lanes, gen, dev):
    """The case's inputs on the card: K12 and K10 X X^T + n I and two
    rhs, K14 H and y standard normal (the slot mixes' shapes, k = 2)."""
    if kernel in ("cholesky_solve_tiled", BLOCKED):
        x = torch.randn((lanes, n, n), generator=gen, device=dev)
        a = torch.baddbmm(n * torch.eye(n, device=dev), x, x.transpose(-1, -2))
        del x
        return a, torch.randn((lanes, n, 2), generator=gen, device=dev)
    return (torch.randn((lanes, m, n), generator=gen, device=dev),
            torch.randn((lanes, m, 2), generator=gen, device=dev))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--forms", action="store_true",
                    help="time every form of chol_tiled_forms at each case")
    ap.add_argument("--fit", action="store_true",
                    help="fit the lane model's prices to the --forms sweep")
    ap.add_argument("--kernels", default=None,
                    help="comma-separated kernels whose cases to run")
    args = ap.parse_args(argv)
    cases = [c for c in CASES
             if args.kernels is None or c[0] in args.kernels.split(",")]
    AB.import_tree(Path(args.tree).resolve())
    import chip_smoke as CS
    import torch
    CH = importlib.import_module("repro_torch.pipelines.cholesky_solve")
    MM = importlib.import_module("repro_torch.pipelines.mmse")
    from repro_torch.kernels import common

    if not torch.cuda.is_available():
        sys.exit("chol_tiled_phases: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(CS.card_line(), flush=True)
    dev = torch.device("cuda")
    common.load_library()
    median_ms = AB.cold_timer(dev, args.reps)
    fused = {"cholesky_solve_tiled": CH.cholesky_solve_tiled_fused,
             "mmse_equalize_tiled": MM.mmse_equalize_tiled_fused,
             BLOCKED: CH.cholesky_solve_blocked_fused}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    plan_of = getattr(CH, "chol_tiled_plan", None)
    sweep = []
    for name, n, m, lanes in cases:
        a, b = make_case(torch, name, n, m, lanes, gen, dev)
        bs = case_bs(CH, name, n, m)
        mm = m if name == "mmse_equalize_tiled" else None
        plan = plan_of(lanes, n, 2, bs, name, m=mm) if plan_of else None
        forms = (CH.chol_tiled_forms(n, 2, bs, name, m=mm) if args.forms
                 else [plan])
        want = fused[name](a, b, bs=bs)
        for form in forms:
            kw = {"bs": bs} if form is None else {"bs": bs, "plan": form}
            x, stamps = CH.chol_tiled_phases(name, a, b, **kw)
            served = fused[name](a, b, **kw)
            torch.cuda.synchronize()
            st = stamps.cpu().double()
            total = st[:, 1] - st[:, 0]
            parts = st[:, 2:]
            ordered = bool((total > 0).all() and (parts >= 0).all())
            covered = bool((parts.sum(dim=1) == total).all())
            same = bool(torch.equal(x, served) and torch.equal(served, want))
            share = (parts / total[:, None]).mean(dim=0)
            row = {"kernel": name, "m": m, "n": n, "bs": bs, "lanes": lanes,
                   "ms": median_ms(lambda: fused[name](a, b, **kw)),
                   "lane_cycles": float(total.mean()),
                   "share": dict(zip(CH.TILED_PHASES, map(float, share))),
                   "ordered": ordered, "covered": covered,
                   "stamped_equals_served": same}
            if form is not None:
                at_once = CH.chol_tiled_occupancy(name, form)
                row.update(plan=list(form), is_plan=form == plan,
                           clusters_at_once=at_once,
                           waves=-(-lanes // at_once))
            print(json.dumps(row), flush=True)
            if form is not None:
                sweep.append((name, n, m, lanes, form, row))
            if not (ordered and covered and same):
                sys.exit(f"chol_tiled_phases: {name} {m}x{n} B={lanes} "
                         f"{form}: ordered {ordered}, covered {covered}, "
                         f"equal {same}")
            del x, stamps, served
        del a, b, want
    if args.fit:
        print(json.dumps({"fit": fit(CH, sweep, cases)}), flush=True)


# the measured phases each price of the lane model covers
FIT_PHASES = {"diag": ("diag", "update"), "rows": ("walk", "rows"),
              "trail": ("trail",), "gram": ("gram",), "filter": ("filter",),
              "sums": ("sums",), "solve": ("backsub",), "load": ("load",),
              "chain": ("chain",)}


def fit(CH, sweep, cases=CASES) -> dict:
    """CHOL_LANE_CYCLES fitted to the sweep's rows (each a case, a form
    and its phase shares), a price a phase and product tile ("chain" from
    K10's rows, the rest from K12's and K14's; a price the sweep has no
    rows for kept), and each case's pick beside its best."""
    def units_of(name, n, m, form):
        return CH.chol_lane_units(n, 2, case_bs(CH, name, n, m), form, name,
                                  m if name == "mmse_equalize_tiled" else None)

    def scale(pairs):
        den = sum(u * u for u, _ in pairs)
        return sum(u * y for u, y in pairs) / den if den else 0.0

    old = CH.CHOL_LANE_CYCLES
    tiles = sorted({form.tile for *_, form, _ in sweep})
    prices = {key: dict(val) for key, val in old.items()}
    for tile in tiles:
        rows = {k10: [(units_of(name, n, m, form), row)
                      for name, n, m, _, form, row in sweep
                      if form.tile == tile and (name == BLOCKED) == k10]
                for k10 in (False, True)}
        for key, phases in FIT_PHASES.items():
            use = rows[key == "chain"]
            if use:
                prices[key][tile] = scale([
                    (units[key], sum(row["share"][p] for p in phases)
                     * row["lane_cycles"]) for units, row in use])
        if rows[False]:
            rest = [(units["sync"], row["lane_cycles"] - sum(
                u * prices[k][tile] for k, u in units.items()
                if k != "sync")) for units, row in rows[False]]
            prices["sync"][tile] = max(0.0, scale(rest))
    CH.CHOL_LANE_CYCLES = prices
    CH.chol_tiled_clusters_at_once.cache_clear()
    picks = {}
    try:
        for name, n, m, lanes in cases:
            rows = [(form, row) for nm, nn, mm, ll, form, row in sweep
                    if (nm, nn, mm, ll) == (name, n, m, lanes)]
            if not rows:
                continue
            pick = CH.chol_tiled_plan(lanes, n, 2, case_bs(CH, name, n, m),
                                      name,
                                      m if name == "mmse_equalize_tiled"
                                      else None)
            best = min(rows, key=lambda r: r[1]["ms"])
            picks[f"{name} {m}x{n} B={lanes}"] = {
                "pick": [pick.clusters, pick.tile],
                "pick_ms": next(r["ms"] for f, r in rows if f == pick),
                "best": [best[0].clusters, best[0].tile],
                "best_ms": best[1]["ms"]}
    finally:
        CH.CHOL_LANE_CYCLES = old
        CH.chol_tiled_clusters_at_once.cache_clear()
    return {"CHOL_LANE_CYCLES": prices, "picks": picks}


if __name__ == "__main__":
    main()
