#!/usr/bin/env python3
"""Time K8 of one or two source trees of the port on one card, in turns,
beside ``torch.linalg.svd``, and hold their answers to each other by
spectrum and reconstruction.

    python3 scripts/svd_ab.py --tree new=src [--tree old=OTHER/src] \\
        [--order ABBA] [--reps 5] [--ticks 4]

Each turn (``ab_turns.py``) is a fresh process that imports
``repro_torch`` from its tree and builds its kernels there.  At each of
``svd_phases.py``'s cases (the svd_solve DAG's served shapes, n = 24 on
32 lanes and n = 8 on 4, and a carrier's 3276 lanes at n = 32, 16 and 8;
m = n + 4, inputs made on the card from a seeded generator) it reads the
DAG stage's device ms (``svd_factor``, 14 sweeps; CUDA events, L2
flushed, median of ``--reps``) and ``torch.linalg.svd``'s on the same
lanes, and keeps the sorted spectrum and the reconstruction U diag(S)
V^T.  Then it serves the svd_solve DAG at n = 24 on 32 lanes
(``serve_solvers --pusch --sizes 24 --lanes 32 --ticks T``, staged and
chained, 2 T ticks) once warm and once under ``torch.profiler``, and
reads K8's device ms a tick and a launch.  A tree with ``svd_plan``
records each case's plan.  Each turn prints one JSON line and writes its
answers to ``build/svd_ab/<tree>.pt``; the last line is a JSON summary
of each tree's ms in turn order and, with two trees, the largest
relative gap between their spectra and their reconstructions at each
case (the two trees may rotate the pairs in different orders, so their
bits may differ; each is within the spec's 4 sqrt(eps) of the other).
"""
import argparse
import json
from pathlib import Path

import ab_turns as AB  # the turns and the timing helpers
import chip_smoke as CS  # the card line and clocks (on AB's path)
import svd_phases as PH  # the cases

OUT = AB.ROOT / "build" / "svd_ab"
SWEEPS = 14                 # the DAG stage's (pipelines/pusch.py)


def one_turn(name: str, tree: Path, reps: int, ticks: int) -> dict:
    """The readings of one tree in this process."""
    import importlib

    import torch
    AB.import_tree(tree)
    from repro_torch.kernels import common
    S = importlib.import_module("repro_torch.kernels.svd")
    P = importlib.import_module("repro_torch.pipelines.pusch")

    dev = torch.device("cuda")
    common.load_library()
    median_ms = AB.cold_timer(dev, reps)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    plan_of = getattr(S, "svd_plan", None)
    rows, answers = [], {}
    for n, m, lanes in PH.CASES:
        a = torch.randn((lanes, m, n), generator=gen, device=dev)
        case = f"{m}x{n} B={lanes}"
        call = lambda: P.svd_factor_fused(a, sweeps=SWEEPS)  # noqa: E731
        answers[case] = [t.cpu() for t in S.spectrum_recon(
            *P.unpack_factors(call()))]
        row = {"case": case, "ms": median_ms(call),
               "linalg_svd_ms": median_ms(
                   lambda: torch.linalg.svd(a, full_matrices=False))}
        if plan_of:
            row["plan"] = list(plan_of(lanes, m, n))
        rows.append(row)
        del a
    from repro_torch.launch import serve_solvers
    k8 = next(k for k in common.KERNELS if k.name == "svd")
    argv = ["--pusch", "--sizes", "24", "--lanes", "32", "--ticks",
            str(ticks)]
    before = k8.launches
    kernels = AB.device_kernels(lambda: serve_solvers.main(argv))
    launches = (k8.launches - before) // 2     # a warm run, then the traced
    k8_ms = sum(us for kname, us in kernels if "svd_kernel" in kname) / 1e3
    out = {"tree": str(tree), "card": CS.card_line(),
           "clocks": CS.clocks_line(),
           "build_s": common.build_info["seconds"], "rows": rows,
           "dag": {"k8_ms_a_tick": k8_ms / (2 * ticks),
                   "k8_ms_a_launch": k8_ms / launches if launches else None,
                   "k8_launches": launches,
                   "busy_ms_a_tick": sum(us for _, us in kernels) / 1e3
                   / (2 * ticks)}}
    OUT.mkdir(parents=True, exist_ok=True)
    torch.save(answers, OUT / f"{name}.pt")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    AB.add_tree_arguments(ap)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--ticks", type=int, default=4)
    args = ap.parse_args(argv)
    trees, order = AB.trees_and_order(ap, args)
    if args.turn:
        print(json.dumps(one_turn(args.turn,
                                  Path(trees[args.turn]).resolve(),
                                  args.reps, args.ticks)), flush=True)
        return
    forward = ["--reps", str(args.reps), "--ticks", str(args.ticks)]
    summary = {name: [] for name in trees}
    for name, reading in AB.run_turns(__file__, args, trees, order,
                                      forward):
        summary[name].append({
            **{r["case"]: {"ms": r["ms"],
                           "linalg_svd_ms": r["linalg_svd_ms"]}
               for r in reading["rows"]},
            "svd_solve DAG n=24 on 32 lanes, K8 ms a tick":
                reading["dag"]["k8_ms_a_tick"]})
    out = {"ms_by_turn": summary}
    if len(trees) == 2:
        import torch
        first, second = (torch.load(OUT / f"{n}.pt") for n in trees)
        out["gaps"] = {}
        for case in first:
            out["gaps"][case] = {
                part: float((x - y).abs().max() / x.abs().max())
                for part, x, y in zip(("spectrum", "recon"), first[case],
                                      second[case])}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
