"""Turns of one or two source trees of the port on one card, and the
timing helpers the turn scripts share (``gemm_ab.py``, ``fft_ab.py``,
``prefill_ab.py``).

A tree is a ``src`` directory that holds a ``repro_torch`` package (for
example an unpacked ``git archive`` of another commit).  Each turn of an
order such as ``ABBA`` (A the first tree, B the second) is a fresh
process running ``<script> --turn NAME``, which imports ``repro_torch``
from its tree, builds its kernels there and prints one JSON line of
readings; :func:`run_turns` runs the turns in order and yields each
reading.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def add_tree_arguments(ap, order_default=None) -> None:
    """``--tree NAME=PATH`` (one or two), ``--order`` and the hidden
    ``--turn`` of a turn script."""
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=PATH of a src directory (one or two)")
    ap.add_argument("--order", default=order_default)
    ap.add_argument("--turn", help=argparse.SUPPRESS)


def trees_and_order(ap, args, pairs_only=False):
    """The ``{name: path}`` of ``--tree`` and the order of turns: ABBA
    for two trees, one turn for one, unless ``--order`` says more."""
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order or ("ABBA" if len(trees) == 2 else "A")
    if (not (len(trees) == 2 if pairs_only else 1 <= len(trees) <= 2)
            or set(order) - set("AB"[:len(trees)])):
        ap.error("give " + ("two --tree" if pairs_only else
                            "one or two --tree")
                 + " and an --order of their letters")
    return trees, order


def run_turns(script: str, args, trees: dict, order: str, forward: list):
    """Run each turn of ``order`` as a fresh process of ``script`` with
    ``forward`` arguments; yield (tree name, its JSON reading, with the
    turn's wall seconds).  A failed turn ends the run."""
    names = list(trees)
    for turn in order:
        name = names["AB".index(turn)]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, script, "--turn", name, *forward]
            + [f"--tree={t}" for t in args.tree],
            capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stdout + proc.stderr)
            sys.exit(f"{Path(script).stem}: the turn of {name} failed")
        reading = json.loads(proc.stdout.strip().splitlines()[-1])
        reading["seconds"] = time.perf_counter() - t0
        print(json.dumps({"turn": name, **reading}), flush=True)
        yield name, reading


def import_tree(tree: Path):
    """Import ``repro_torch`` from ``tree`` and check that it came from
    there."""
    sys.path.insert(0, str(tree))
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"repro_torch imported from "
                           f"{repro_torch.__file__}, not from {tree}")
    return repro_torch


def cold_timer(device, reps: int):
    """``median_ms(fn)``: the median device ms of ``reps`` calls of fn(),
    each timed alone by CUDA events with L2 flushed before it (after one
    warm call).  The card spins ~0.5 ms before each start event so that
    the host has enqueued the call: its launch path is not counted."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.float32, device=device)

    def timed(fn):
        torch.cuda._sleep(1_000_000)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    def median_ms(fn):
        fn()
        return statistics.median(timed(fn) for _ in range(reps))

    return median_ms


def device_kernels(fn) -> list:
    """What the card runs for one fn() (after one warm call): each
    kernel's name (its return type and anonymous namespaces dropped, so a
    template kernel's name keeps its own, cut to 60 characters) and
    device us, torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name.removeprefix("void ")
             .replace("(anonymous namespace)::", "")[:60],
             e.time_range.elapsed_us())
            for e in prof.events() if e.device_type == DeviceType.CUDA]
