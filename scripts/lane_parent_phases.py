#!/usr/bin/env python3
"""Split f8f18d0's one-CTA K2 and K5 into phases on the card.

    python3 scripts/lane_parent_phases.py --tree OTHER/src

K2 (the MMSE equalizer) and K5 (the channel estimate) ran a lane on one
128-thread CTA until they took their warp forms (``csrc/warp_chain.cuh``),
and those CTA kernels had no phase stamps.  This script is the source of
PERF.md's split of them.  It patches their text by anchors, so it runs
only on the tree its anchors were written for: f8f18d0, a ``git
archive`` of it unpacked under ``build/``.  It copies that tree's
``csrc/`` into ``build/lane_parent_phases/<kernel>/``, adds
``phase_clock.cuh``'s stamps at the barriers that end the phases of
``LANE_PHASES`` -- the load, the Gram and matched filter (K5: the pilot
Gram and cross product), the factor with its forward substitution (the
edge inside ``chol_chain``, after its last factor step's barrier), the
back substitution, the store -- builds each kernel's file alone with
``nvcc`` (both at once) and runs it at ``lane_phases.py``'s cases of that
kernel (the same inputs).  It checks that each stamped answer equals
this tree's served kernel in its CTA form bit for bit (``pusch_ab.py``
holds the served kernel to that tree's bits), that each lane's stamps
are ordered and that its phases add up to its time, and prints one JSON
line a case: each phase's share of a lane (the mean over lanes) and the
lane's mean cycles.  The card's name and power limit come first.
"""
import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import ab_turns as AB  # noqa: E402  the tree import
import lane_phases as LP  # noqa: E402  the cases
import pusch_ab as PA  # noqa: E402  the inputs

OUT = ROOT / "build" / "lane_parent_phases"
POINTER = "__device__ unsigned long long* g_lane_stamps;\n"
WRITE = ("clk.mark(kLpStore);\n"
         "  clk.write(g_lane_stamps + lane * (2 + kLanePhases));\n")
SETTER = """
extern "C" int lane_parent_set_stamps(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(repro_torch::g_lane_stamps, &p,
                                             sizeof(p)));
}
"""
OPEN = "namespace repro_torch {\nnamespace {\n"
CLOCK_INCLUDE = ('#include "lane_common.cuh"\n',
                 '#include "lane_common.cuh"\n#include "phase_clock.cuh"\n', 1)
# chol_chain cut at its factor's end: chol_chain_edge calls edge() there
LANE_COMMON = (
    ("__device__ inline void chol_chain(float* a, float* y, int n, "
     "int m,\n                                  float eps, float* col, "
     "float* yk,\n                                  float* thresh_s) {\n",
     "template <class Edge>\n__device__ inline void chol_chain_edge("
     "float* a, float* y, int n, int m, float eps,\n    float* col, "
     "float* yk, float* thresh_s, Edge edge) {\n", 1),
    ("  // back substitution on U = L^T: x[k] = y[k] / l[k][k];\n",
     "  edge();\n  // back substitution on U = L^T: x[k] = y[k] / "
     "l[k][k];\n", 1),
    ("\n}  // namespace repro_torch\n",
     "\n__device__ inline void chol_chain(float* a, float* y, int n, "
     "int m, float eps,\n    float* col, float* yk, float* thresh_s) {\n"
     "  chol_chain_edge(a, y, n, m, eps, col, yk, thresh_s, [] {});\n}\n"
     "\n}  // namespace repro_torch\n", 1))
# estimate_h with a clock: the Gram's end, the factor's and the back's
ESTIMATE_H = (
    ("__device__ void estimate_h(",
     "template <class Clock>\n__device__ void estimate_h(", 1),
    ("float* yk, float* thresh) {\n  const int lx",
     "float* yk, float* thresh,\n                           Clock& clk) "
     "{\n  const int lx", 1),
    ("  __syncthreads();\n  chol_chain(g, z, n, m, eps, col, yk, "
     "thresh);\n",
     "  __syncthreads();\n  clk.mark(kLpGram);\n"
     "  chol_chain_edge(g, z, n, m, eps, col, yk, thresh,\n"
     "                  [&] { clk.mark(kLpFactor); });\n"
     "  clk.mark(kLpBack);\n", 1))
# kernel -> {file: (anchor, replacement, times the anchor occurs)}, the
# anchors f8f18d0's text
PATCHES = {
    "mmse_equalize": {
        "lane_common.cuh": LANE_COMMON,
        "mmse_equalize.cu": (
            CLOCK_INCLUDE,
            (OPEN, OPEN + POINTER, 1),
            ("  const size_t lane = blockIdx.x;\n",
             "  const size_t lane = blockIdx.x;\n"
             "  PhaseClock<!kGlobal, kLanePhases> clk(true);\n", 1),
            ("    col = rhs + n * k;\n    __syncthreads();\n",
             "    col = rhs + n * k;\n    __syncthreads();\n"
             "    clk.mark(kLpLoad);\n", 1),
            ("    rhs[e] = s;\n  }\n  __syncthreads();\n",
             "    rhs[e] = s;\n  }\n  __syncthreads();\n"
             "  clk.mark(kLpGram);\n", 1),
            ("    chol_chain(g, rhs, n, k, eps, col, yk, thresh);\n",
             "    chol_chain_edge(g, rhs, n, k, eps, col, yk, thresh,\n"
             "                    [&] { clk.mark(kLpFactor); });\n"
             "    clk.mark(kLpBack);\n", 1),
            ("e < n * k; e += blockDim.x) xl[e] = rhs[e];\n",
             "e < n * k; e += blockDim.x) xl[e] = rhs[e];\n    " + WRITE,
             1))},
    "channel_estimate": {
        "lane_common.cuh": LANE_COMMON,
        "pusch_chain.cu": (
            (OPEN, OPEN + POINTER, 1),
            *ESTIMATE_H,
            ("  const size_t lane = blockIdx.x;\n  load_pilots(XP + lane * "
             "n * p, YP + lane * m * p, xt, yt, n, p, m);\n  __syncthreads()"
             ";\n  estimate_h(xt, yt, g, z, n, p, m, ridge, eps, col, yk, "
             "thresh);\n",
             "  const size_t lane = blockIdx.x;\n"
             "  PhaseClock<true, kLanePhases> clk(true);\n  load_pilots(XP "
             "+ lane * n * p, YP + lane * m * p, xt, yt, n, p, m);\n  "
             "__syncthreads();\n  clk.mark(kLpLoad);\n  estimate_h(xt, yt, "
             "g, z, n, p, m, ridge, eps, col, yk, thresh, clk);\n", 1),
            ("  estimate_h(xt, yt, g, z, n, p, m, ridge, eps, col, yk, "
             "thresh);\n",
             "  PhaseClock<false, kLanePhases> off(false);\n  estimate_h(xt,"
             " yt, g, z, n, p, m, ridge, eps, col, yk, thresh, off);\n", 1),
            ("    hl[e] = z[(e % n) * m + e / n];\n}\n",
             "    hl[e] = z[(e % n) * m + e / n];\n  __syncthreads();\n  "
             + WRITE + "}\n", 1))},
}
SOURCES = {"mmse_equalize": "mmse_equalize.cu",
           "channel_estimate": "pusch_chain.cu"}
# the entries' ctypes signatures at f8f18d0
ENTRIES = {
    "mmse_equalize": ("mmse_equalize_f32",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                      + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                      + [ctypes.c_void_p]),
    "channel_estimate": ("channel_estimate_f32",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                         + [ctypes.c_float] * 2 + [ctypes.c_void_p]),
}


def patched(kernel: str, name: str, text: str) -> str:
    """``text`` of csrc file ``name`` with ``kernel``'s stamps."""
    for anchor, new, times in PATCHES[kernel][name]:
        if text.count(anchor) != times:
            raise SystemExit(f"lane_parent_phases: {kernel}: {name}: anchor "
                             f"found {text.count(anchor)} times, not {times}"
                             f" (its anchors are f8f18d0's): {anchor!r}")
        text = text.replace(anchor, new)
    return text + (SETTER if name.endswith(".cu") else "")


def build(tree: Path) -> dict:
    """Patch a copy of the tree's csrc for each kernel and build its file
    alone into a shared library; returns each kernel's library."""
    from repro_torch.kernels import common
    shutil.rmtree(OUT, ignore_errors=True)

    def nvcc(kernel):
        csrc = OUT / kernel / "csrc"
        shutil.copytree(tree / "repro_torch" / "csrc", csrc)
        for name in PATCHES[kernel]:
            (csrc / name).write_text(
                patched(kernel, name, (csrc / name).read_text()))
        lib = OUT / kernel / f"lib{kernel}_parent.so"
        proc = subprocess.run(
            [common._nvcc(), *common.NVCC_FLAGS, "-shared", "-I", str(csrc),
             str(csrc / SOURCES[kernel]), "-o", str(lib)],
            capture_output=True, text=True)
        return kernel, lib, proc

    libs = {}
    with ThreadPoolExecutor(len(PATCHES)) as pool:
        for kernel, lib, proc in pool.map(nvcc, PATCHES):
            print(json.dumps({"nvcc": kernel, "rc": proc.returncode,
                              "log": (proc.stdout + proc.stderr).strip()
                              [-600:]}), flush=True)
            if proc.returncode:
                raise SystemExit(f"lane_parent_phases: nvcc failed on "
                                 f"{kernel}")
            dll = ctypes.CDLL(str(lib))
            symbol, argtypes = ENTRIES[kernel]
            getattr(dll, symbol).argtypes = argtypes
            dll.lane_parent_set_stamps.argtypes = [ctypes.c_void_p]
            libs[kernel] = dll
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True,
                    help="f8f18d0's src directory")
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    AB.import_tree(ROOT / "src")
    import chip_smoke as CS
    import torch
    from repro_torch.pipelines import mmse, pusch
    from repro_torch.pipelines.cholesky_solve import DEFAULT_EPS
    from repro_torch.pipelines.warp_chain import LANE_PHASES
    if not torch.cuda.is_available():
        sys.exit("lane_parent_phases: no CUDA device")
    print(CS.card_line(), flush=True)
    dev = torch.device("cuda")
    libs = build(tree)
    failed = []
    for kernel, n, lanes in LP.CASES:
        if kernel not in PATCHES:
            continue
        inputs = PA.make_case(torch, dev, kernel, n, lanes)
        dll = libs[kernel]
        stream = torch.cuda.current_stream(dev).cuda_stream
        stamps = torch.zeros((lanes, 2 + len(LANE_PHASES)),
                             dtype=torch.int64, device=dev)
        ptrs = [t.data_ptr() for t in inputs]
        m, p = n + 4, 2 * n
        if kernel == "mmse_equalize":
            served = mmse.mmse_equalize_fused(*inputs, form="cta")
            x = torch.empty_like(served)
            call = lambda: dll.mmse_equalize_f32(  # noqa: E731
                *ptrs, x.data_ptr(), None, lanes, m, n, 2, 0.1,
                DEFAULT_EPS, 0, 0, 0, stream)
        else:
            served = pusch.channel_estimate_fused(*inputs, form="cta")
            x = torch.empty_like(served)
            call = lambda: dll.channel_estimate_f32(  # noqa: E731
                *ptrs, x.data_ptr(), lanes, n, p, m, pusch.DEFAULT_RIDGE,
                DEFAULT_EPS, stream)
        err = dll.lane_parent_set_stamps(stamps.data_ptr()) or call()
        torch.cuda.synchronize()
        if err:
            raise SystemExit(f"lane_parent_phases: {kernel} launch failed "
                             f"({err})")
        st = stamps.cpu().double()
        total = st[:, 1] - st[:, 0]
        parts = st[:, 2:]
        ordered = bool((total > 0).all() and (parts >= 0).all())
        covered = bool((parts.sum(dim=1) == total).all())
        same = torch.equal(x.view(torch.int32), served.view(torch.int32))
        share = (parts / total[:, None]).mean(dim=0)
        print(json.dumps({
            "kernel": f"{kernel} (a CTA a lane, {tree.parent.name})",
            "n": n, "m": m, "lanes": lanes,
            "lane_cycles": float(total.mean()),
            "share": dict(zip(LANE_PHASES, map(float, share))),
            "ordered": ordered, "covered": covered,
            "stamped_equals_served": same}), flush=True)
        if not (ordered and covered and same):
            failed.append(f"{kernel} n={n} B={lanes}: ordered {ordered}, "
                          f"covered {covered}, equal {same}")
        del inputs, served, x, stamps
    if failed:
        sys.exit("lane_parent_phases: " + "; ".join(failed))


if __name__ == "__main__":
    main()
