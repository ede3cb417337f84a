#!/usr/bin/env python3
"""Split the one-CTA K10 of an earlier tree into phases on the card.

    python3 scripts/k10_parent_phases.py --tree OTHER/src [--reps 5]

K10 ran a lane on one CTA of 256 threads until it moved onto the tiled
Cholesky core (``csrc/tiled_chol.cuh``), and that kernel had no phase
stamps.  This script is the source of PERF.md's split of that kernel; it
runs only on a tree that still holds it, at commit e871bbb or before
(a ``git archive`` of it unpacked under ``build/``), since it patches the
kernel's text by anchors.  It takes that tree's
``csrc/cholesky_solve_blocked.cu``, adds ``phase_clock.cuh``'s stamps at
the barriers that end its four phases -- the load (A's lower triangle into
the work buffer, B into shared memory, the threshold), the panel factor
(the panel's staging and its bs columns, two barriers a column), the SYRK
(the panel's columns back to the work buffer and the rank-bs update) and
the back substitution (two barriers a row) -- builds that one file with
``nvcc`` into ``build/k10_parent_phases/`` and runs it at ``CASES``
(inputs made on the card as ``chol_tiled_phases.py`` makes K12's: X X^T +
n I and two right-hand sides).  It checks that the stamped answer equals
the tree's served kernel bit for bit, that each lane's stamps are ordered
and that its phases add up to its time, and prints one JSON line a case:
each phase's share of a lane (the mean over lanes), the lane's mean
cycles and the served kernel's device ms (CUDA events, L2 flushed, median
of ``--reps``).  The card's name and power limit come first.
"""
import argparse
import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import ab_turns as AB  # noqa: E402  the tree import and the timer

# (n, lanes) at k = 2 and bs = 64: the mid-range registry sizes on the 32
# lanes the mid-range mix serves and at a carrier's width
CASES = ((128, 32), (256, 32), (128, 3276), (256, 3276))
PHASES = ("load", "panel", "syrk", "backsub")
OUT = ROOT / "build" / "k10_parent_phases"

# (anchor, text put after it): each anchor must occur exactly once
PATCHES = (
    ('#include "tile_loops.cuh"\n', '#include "phase_clock.cuh"\n'),
    ("constexpr int kBlockedThreads = 256;\n",
     "__device__ unsigned long long* g_k10_stamps;\n"
     "enum { kPLoad, kPPanel, kPSyrk, kPBack, kPPhases };\n"),
    ("  const size_t lane = blockIdx.x;\n",
     "  PhaseClock<true, kPPhases> clk(true);\n"),
    ("  const float thresh = *thresh_s;\n", "  clk.mark(kPLoad);\n"),
    ("      c[r * pc + jj] = r >= o + jj ? a[r * n + o + jj] : 0.0f;\n"
     "    }\n    __syncthreads();\n", "    clk.mark(kPPanel);\n"),
    ("      for (int q = tid; q < m; q += nt) yk[q] = y[g * m + q] * inv;\n"
     "      __syncthreads();\n", "      clk.mark(kPPanel);\n"),
    ("        for (int q = 0; q < m; ++q) y[r * m + q] -= lr * yk[q];\n"
     "      }\n      __syncthreads();\n", "      clk.mark(kPPanel);\n"),
    ("            a[(i0 + r) * n + j0 + q] -= s[r][q];\n"
     "    }\n    __syncthreads();\n", "    clk.mark(kPSyrk);\n"),
    ("    for (int q = tid; q < m; q += nt) yk[q] = y[k * m + q] / lkk;\n"
     "    __syncthreads();\n", "    clk.mark(kPBack);\n"),
    ("        y[e] -= a[k * n + i] * yk[q];\n    }\n    __syncthreads();\n",
     "    clk.mark(kPBack);\n"),
)
# before the final store of x: the stamps out
STORE = "  float* xl = X + lane * n * m;\n"
SETTER = """
extern "C" int k10_parent_set_stamps(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(repro_torch::g_k10_stamps, &p,
                                             sizeof(p)));
}
"""


def patched_source(text: str) -> str:
    """The one-CTA K10 source with its phase stamps."""
    for anchor, add in PATCHES + ((STORE, None),):
        if text.count(anchor) != 1:
            raise SystemExit(f"k10_parent_phases: anchor found "
                             f"{text.count(anchor)} times: {anchor!r}")
        text = (text.replace(anchor, anchor + add) if add else
                text.replace(anchor, "  clk.write(g_k10_stamps + lane * "
                             "(2 + kPPhases));\n" + anchor))
    return text + SETTER


def build(tree: Path) -> ctypes.CDLL:
    """Compile the patched source alone into a shared library."""
    csrc = tree / "repro_torch" / "csrc"
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "k10_parent.cu"
    src.write_text(patched_source(
        (csrc / "cholesky_solve_blocked.cu").read_text()))
    from repro_torch.kernels import common
    lib = OUT / "libk10_parent.so"
    proc = subprocess.run(
        [common._nvcc(), *common.NVCC_FLAGS, "-shared", "-I", str(csrc),
         str(src), "-o", str(lib)], capture_output=True, text=True)
    print(json.dumps({"nvcc": (proc.stdout + proc.stderr).strip()[-600:]}),
          flush=True)
    if proc.returncode:
        raise SystemExit("k10_parent_phases: nvcc failed")
    dll = ctypes.CDLL(str(lib))
    dll.cholesky_solve_blocked_f32.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p])
    dll.k10_parent_set_stamps.argtypes = [ctypes.c_void_p]
    return dll


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True,
                    help="a src directory whose K10 runs a lane on one CTA")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    AB.import_tree(tree)
    import chip_smoke as CS
    import chol_tiled_phases as PH
    import torch
    CH = importlib.import_module("repro_torch.pipelines.cholesky_solve")
    if not torch.cuda.is_available():
        sys.exit("k10_parent_phases: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(CS.card_line(), flush=True)
    dev = torch.device("cuda")
    dll = build(tree)
    median_ms = AB.cold_timer(dev, args.reps)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for n, lanes in CASES:
        a, b = PH.make_case(torch, "cholesky_solve_tiled", n, n, lanes, gen,
                            dev)
        bs = 64
        served = CH.cholesky_solve_blocked_fused(a, b, bs=bs)
        x = torch.empty_like(b)
        work = torch.empty((lanes, n, n), device=dev)
        stamps = torch.zeros((lanes, 2 + len(PHASES)), dtype=torch.int64,
                             device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = dll.k10_parent_set_stamps(stamps.data_ptr()) or \
            dll.cholesky_solve_blocked_f32(
                a.data_ptr(), b.data_ptr(), x.data_ptr(), work.data_ptr(),
                lanes, n, 2, bs, CH.DEFAULT_EPS, stream)
        torch.cuda.synchronize()
        if err:
            raise SystemExit(f"k10_parent_phases: launch failed ({err})")
        st = stamps.cpu().double()
        total = st[:, 1] - st[:, 0]
        parts = st[:, 2:]
        ordered = bool((total > 0).all() and (parts >= 0).all())
        covered = bool((parts.sum(dim=1) == total).all())
        same = torch.equal(x.view(torch.int32), served.view(torch.int32))
        share = (parts / total[:, None]).mean(dim=0)
        print(json.dumps({
            "kernel": "cholesky_solve_blocked (one CTA a lane)", "n": n,
            "k": 2, "bs": bs, "lanes": lanes,
            "ms": median_ms(lambda: CH.cholesky_solve_blocked_fused(
                a, b, bs=bs)),
            "lane_cycles": float(total.mean()),
            "share": dict(zip(PHASES, map(float, share))),
            "ordered": ordered, "covered": covered,
            "stamped_equals_served": same}), flush=True)
        if not (ordered and covered and same):
            raise SystemExit(f"k10_parent_phases: n = {n} B = {lanes}: "
                             f"ordered {ordered}, covered {covered}, "
                             f"equal {same}")
        del a, b, served, x, work


if __name__ == "__main__":
    main()
