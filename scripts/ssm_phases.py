#!/usr/bin/env python3
"""Split K21, the chunked SSD scan, into phases on the card.

    python3 scripts/ssm_phases.py [--tree src] [--reps 5] [--forms [--fit]]

At each of ``CASES`` (zamba2-2.7b's and xlstm-125m's prefill shapes at S
= 512 and 128, one chunk of 48 rows and 16 chunks on two lanes, inputs
made on the card from a seeded generator as ``chip_smoke.py`` makes them,
in float32: the stamped instances are float32 ones) this runs the tree's
phase-stamped instance (``ssm_phases``: ``clock64()`` on thread 0 of each
CTA at the edges of ``SSM_PHASES``) on the case's plan, and with
``--forms`` on every form of ``ssm_forms``.  It prints one JSON line a
case and form: each phase's share of a CTA (the mean over CTAs), a CTA's
mean cycles, the gram pass's mean cycles a CTA, the served kernel's device
ms (CUDA events, L2 flushed, median of ``--reps``) and the waves of
clusters the card holds at once.  It checks that the stamped answer
equals the served kernel's bit for bit, and the plan's, that each CTA's
stamps are ordered and that its phases add up to its time.  The card's
name and power limit come first, each instance's registers and spills
(``-Xptxas -v``) after the build.  With ``--forms --fit`` the last line is
the lane model's prices (``SSM_LANE_CYCLES``) fitted to the sweep, and the
form the refitted model picks at each case beside the fastest one
measured.
"""
import argparse
import importlib
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import ab_turns as AB  # noqa: E402  the tree import and the timer

# (label, B, H, S, P, N, B/C per head, chunk): the main path's K21 shapes,
# the smallest of chip_smoke.py's cases (one chunk of 48 rows) and its
# case of more chunks than a cluster's ranks
CASES = (("zamba2", 4, 32, 512, 160, 64, False, 128),
         ("zamba2 S=128", 4, 32, 128, 160, 64, False, 128),
         ("xlstm", 4, 4, 512, 385, 192, True, 64),
         ("xlstm S=128", 4, 4, 128, 385, 192, True, 64),
         ("S<chunk", 2, 3, 48, 9, 16, True, 48),
         ("16 chunks", 1, 2, 2048, 33, 8, False, 128))
# the measured phases each price of the lane model (SSM_LANE_CYCLES) covers
FIT_PHASES = {"stage": ("load", "scan"), "exp": ("M",),
              "fma": ("Mx", "state", "Ch", "x"), "hop": ("wait", "chain")}


def make_case(torch, gen, dev, b, h, s, p, n, per_head):
    """Kernel-layout float32 inputs made on the card (chip_smoke.py's)."""
    bc = (b, h, s, n) if per_head else (b, s, n)
    x = torch.randn((b, h, s, p), generator=gen, device=dev)
    a = 0.8 + 0.199 * torch.rand((b, h, s), generator=gen, device=dev)
    return (x, a, torch.randn(bc, generator=gen, device=dev) / math.sqrt(n),
            torch.randn(bc, generator=gen, device=dev) / math.sqrt(n))


def split(torch, stamps):
    """(ordered, covered, shares, mean cycles) of (CTAs, 2 + phases)."""
    st = stamps.cpu().double()
    total = st[:, 1] - st[:, 0]
    parts = st[:, 2:]
    ordered = bool((total > 0).all() and (parts >= 0).all())
    covered = bool((parts.sum(dim=1) == total).all())
    return ordered, covered, (parts / total[:, None]).mean(dim=0), \
        float(total.mean())


def bits(torch, *ts):
    return torch.cat([t.reshape(-1).view(torch.int32) for t in ts])


def run(args, torch, KS, dev, median_ms, gen) -> tuple:
    """Every case's split on its plan (every form with ``--forms``):
    (failures, sweep rows (case, form, row))."""
    import chip_smoke as CS
    from repro_torch.kernels import common
    ptxas = CS.ptxas_lines(common.build_info["log"], "ssm_scan.cu")
    for i, line in enumerate(ptxas):       # each instance's registers
        if "Compiling entry" in line:
            print(json.dumps({"instance": line.split("'")[1],
                              "ptxas": ptxas[i + 1:i + 3]}), flush=True)
    failed, sweep = [], []
    for case in CASES:
        label, b, h, s, p, n, per_head, cs = case
        x, a, bb, cc = make_case(torch, gen, dev, b, h, s, p, n, per_head)
        plan = KS.ssm_plan(b, h, s, p, n, cs)
        forms = KS.ssm_forms(s, p, n, cs) if args.forms else [plan]
        want = bits(torch, *KS.ssm_scan_fused(x, a, bb, cc, chunk=cs))
        for form in forms:
            (y, hf), stamps, gram, _ = KS.ssm_phases(x, a, bb, cc, chunk=cs,
                                                     plan=form)
            served = bits(torch, *KS.ssm_scan_fused(x, a, bb, cc, chunk=cs,
                                                    plan=form))
            torch.cuda.synchronize()
            ordered, covered, share, cycles = split(torch, stamps)
            g = gram.cpu().double()
            gram_ok = bool((g[:, 1] > g[:, 0]).all())
            same = bool(torch.equal(bits(torch, y, hf), served)
                        and torch.equal(served, want))
            at_once = KS.ssm_clusters_at_once(cs, form)
            row = {
                "kernel": "ssm_scan (a lane on a cluster)", "case": label,
                "shape": [b, h, s, p], "n": n, "chunk": cs,
                "plan": list(form), "is_plan": form == plan,
                "ctas": stamps.shape[0], "clusters_at_once": at_once,
                "waves": -(-b * h * KS.ssm_groups(p, cs, form.tiles)
                           // at_once),
                "ms": median_ms(lambda: KS.ssm_scan_fused(
                    x, a, bb, cc, chunk=cs, plan=form)),
                "cta_cycles": cycles,
                "gram_cta_cycles": float((g[:, 1] - g[:, 0]).mean()),
                "gram_ctas": g.shape[0],
                "share": dict(zip(KS.SSM_PHASES, map(float, share))),
                "ordered": ordered and gram_ok, "covered": covered,
                "stamped_equals_served": same}
            print(json.dumps(row), flush=True)
            sweep.append((case, form, row))
            if not (ordered and gram_ok and covered and same):
                failed.append(f"{label} {tuple(form)}: ordered {ordered}, "
                              f"gram {gram_ok}, covered {covered}, equal "
                              f"{same}")
    return failed, sweep


def fit(KS, sweep) -> dict:
    """SSM_LANE_CYCLES fitted to the sweep's rows, each price the least
    squares scale from its units (``ssm_lane_units``) to its phases'
    cycles (FIT_PHASES; a price no row has units of kept), and each case's
    pick under the fitted prices beside its fastest form."""
    def scale(pairs):
        den = sum(u * u for u, _ in pairs)
        return sum(u * y for u, y in pairs) / den if den else None

    units = [(KS.ssm_lane_units(c[3], c[4], c[5], c[7], form), row)
             for c, form, row in sweep]
    old = KS.SSM_LANE_CYCLES
    prices = dict(old)
    for key, phases in FIT_PHASES.items():
        got = scale([(u[key], sum(row["share"][ph] for ph in phases)
                      * row["cta_cycles"]) for u, row in units])
        if got is not None:
            prices[key] = got
    KS.SSM_LANE_CYCLES = prices
    KS._plan.cache_clear()
    picks = {}
    try:
        for case in CASES:
            label, b, h, s, p, n, _, cs = case
            rows = [(form, row) for c, form, row in sweep if c == case]
            pick = KS.ssm_plan(b, h, s, p, n, cs)
            best = min(rows, key=lambda r: r[1]["ms"])
            picks[label] = {
                "pick": list(pick)[:3],
                "pick_ms": next(r["ms"] for f, r in rows if f == pick),
                "best": list(best[0])[:3], "best_ms": best[1]["ms"]}
    finally:
        KS.SSM_LANE_CYCLES = old
        KS._plan.cache_clear()
    return {"SSM_LANE_CYCLES": prices, "picks": picks}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--forms", action="store_true",
                    help="every form of ssm_forms at each case")
    ap.add_argument("--fit", action="store_true",
                    help="fit the lane model's prices to the --forms sweep")
    args = ap.parse_args(argv)
    if args.fit and not args.forms:
        ap.error("--fit needs --forms")
    AB.import_tree(Path(args.tree).resolve())
    import chip_smoke as CS
    import torch
    KS = importlib.import_module("repro_torch.kernels.ssm_scan")
    from repro_torch.kernels import common
    if not torch.cuda.is_available():
        sys.exit("ssm_phases: no CUDA device")
    print(CS.card_line(), flush=True)
    dev = torch.device("cuda")
    common.load_library()
    median_ms = AB.cold_timer(dev, args.reps)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    failed, sweep = run(args, torch, KS, dev, median_ms, gen)
    if failed:
        sys.exit("ssm_phases: " + "; ".join(failed))
    if args.fit:
        print(json.dumps({"fit": fit(KS, sweep)}), flush=True)


if __name__ == "__main__":
    main()
