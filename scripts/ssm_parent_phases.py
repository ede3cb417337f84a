#!/usr/bin/env python3
"""Split the one-CTA K21 of an earlier tree into phases on the card.

    python3 scripts/ssm_parent_phases.py --tree OTHER/src [--reps 5]

K21 ran a (batch, head, 32 columns of P) on one CTA, its chunks a loop
inside it, until it moved onto thread-block clusters, and that kernel had
no phase stamps.  This script is the source of PERF.md's split of that
kernel; it runs only on a tree that still holds it, at commit 9aebec0 or
before (a ``git archive`` of it unpacked under ``build/``), since it
patches the kernel's text by anchors.  It takes that tree's
``csrc/ssm_scan.cu``, adds ``phase_clock.cuh``'s stamps at the edges of
its phases -- the chunk's staging, the scan, the gram (thread 0's own
loop), M (to the barrier), M x (thread 0's), C h with y stored, and the
state (B scaled, the barrier, the update) -- builds that one file with
``nvcc`` into ``build/ssm_parent_phases/`` and runs it at
``ssm_phases.py``'s ``CASES`` (inputs made on the card as that script
makes them, float32).  It checks that the stamped answer equals the
tree's served kernel bit for bit, that each CTA's stamps are ordered and
that its phases add up to its time, and prints one JSON line a case: each
phase's share of a CTA (the mean over CTAs), a CTA's mean cycles and the
served kernel's device ms (CUDA events, L2 flushed, median of
``--reps``).  The card's name and power limit come first.
"""
import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import ab_turns as AB  # noqa: E402  the tree import and the timer
import ssm_phases as PH  # noqa: E402  the cases and the split

OUT = ROOT / "build" / "ssm_parent_phases"
PARENT_PHASES = ("load", "scan", "gram", "M", "Mx", "state", "wait",
                 "chain", "Ch", "x")
# (anchor, its replacement): each anchor must occur exactly once in the
# parent's csrc/ssm_scan.cu; the marks use PARENT_PHASES' indices
MARK = "clk.mark({});\n"
PATCHES = (
    ('#include "lane_common.cuh"\n',
     '#include "lane_common.cuh"\n#include "phase_clock.cuh"\n'),
    ("constexpr int kStage = 8;", "__device__ unsigned long long* "
     "g_ssm_stamps;\nconstexpr int kStage = 8;"),
    ("  const int tid = threadIdx.x;\n",
     "  const int tid = threadIdx.x;\n  PhaseClock<true, 10> clk(true);\n"),
    ("    __syncthreads();\n\n    // the non-critical region",
     "    __syncthreads();\n    " + MARK.format(0)
     + "\n    // the non-critical region"),
    ("    __syncthreads();\n\n    // critical region 1",
     "    __syncthreads();\n    " + MARK.format(1)
     + "\n    // critical region 1"),
    ("            acc[u][v] = fmaf(cr[u], br[v], acc[u][v]);\n      }\n",
     "            acc[u][v] = fmaf(cr[u], br[v], acc[u][v]);\n      }\n"
     "      " + MARK.format(2)),
    ("    __syncthreads();\n\n    // critical region 2",
     "    __syncthreads();\n    " + MARK.format(3)
     + "\n    // critical region 2"),
    ("#pragma unroll 4\n      for (int r = 0; r < n; ++r) {\n",
     "      " + MARK.format(4)
     + "#pragma unroll 4\n      for (int r = 0; r < n; ++r) {\n"),
    ("      for (int e = tid; e < n * cs16; e += kScanThreads) {\n",
     "      " + MARK.format(8)
     + "      for (int e = tid; e < n * cs16; e += kScanThreads) {\n"),
    ("    __syncthreads();\n\n    // the ordered dependence",
     "    __syncthreads();\n    " + MARK.format(5)
     + "\n    // the ordered dependence"),
    ("              make_float4(hreg[k][0], hreg[k][1], hreg[k][2], "
     "hreg[k][3]);\n        }\n      }\n    }\n",
     "              make_float4(hreg[k][0], hreg[k][1], hreg[k][2], "
     "hreg[k][3]);\n        }\n      }\n    }\n    " + MARK.format(5)),
    # after the final store of h: the stamps out
    ("        store(&hg[static_cast<size_t>(r) * p + tc + q], hreg[k][q]);"
     "\n  }\n",
     "        store(&hg[static_cast<size_t>(r) * p + tc + q], hreg[k][q]);"
     "\n  }\n  " + MARK.format(5) + "  clk.write(g_ssm_stamps + "
     "((static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * "
     "gridDim.x + blockIdx.x) * 12);\n"),
)
SETTER = """
extern "C" int ssm_parent_set_stamps(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(repro_torch::g_ssm_stamps, &p,
                                             sizeof(p)));
}
"""


def patched_source(text: str) -> str:
    """The one-CTA K21 source with its phase stamps."""
    for anchor, new in PATCHES:
        if text.count(anchor) != 1:
            raise SystemExit(f"ssm_parent_phases: anchor found "
                             f"{text.count(anchor)} times: {anchor!r}")
        text = text.replace(anchor, new)
    return text + SETTER


def build_parent(tree: Path):
    """Compile the patched parent source alone into a shared library."""
    import ctypes
    csrc = tree / "repro_torch" / "csrc"
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "ssm_parent.cu"
    src.write_text(patched_source((csrc / "ssm_scan.cu").read_text()))
    from repro_torch.kernels import common
    lib = OUT / "libssm_parent.so"
    proc = subprocess.run(
        [common._nvcc(), *common.NVCC_FLAGS, "-shared", "-I", str(csrc),
         str(src), "-o", str(lib)], capture_output=True, text=True)
    print(json.dumps({"nvcc": (proc.stdout + proc.stderr).strip()[-1500:]}),
          flush=True)
    if proc.returncode:
        raise SystemExit("ssm_parent_phases: nvcc failed")
    dll = ctypes.CDLL(str(lib))
    dll.ssm_scan_run.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                                 + [ctypes.c_longlong] * 15
                                 + [ctypes.c_int, ctypes.c_void_p])
    dll.ssm_parent_set_stamps.argtypes = [ctypes.c_void_p]
    return dll


def run(args, torch, KS, dev, median_ms, gen) -> list:
    dll = build_parent(Path(args.tree).resolve())
    failed = []
    for label, b, h, s, p, n, per_head, cs in PH.CASES:
        x, a, bb, cc = PH.make_case(torch, gen, dev, b, h, s, p, n,
                                    per_head)
        served = KS.ssm_scan_fused(x, a, bb, cc, chunk=cs)
        y = torch.empty_like(x)
        hf = torch.empty((b, h, n, p), device=dev)
        ctas = -(-p // 32) * h * b
        stamps = torch.zeros((ctas, 2 + len(PARENT_PHASES)),
                             dtype=torch.int64, device=dev)
        bcs = ((bb.stride(0), 0, bb.stride(1)) if bb.dim() == 3
               else bb.stride()[:3])
        err = dll.ssm_parent_set_stamps(stamps.data_ptr()) or \
            dll.ssm_scan_run(
                x.data_ptr(), a.data_ptr(), bb.data_ptr(), cc.data_ptr(),
                y.data_ptr(), hf.data_ptr(), b, h, s, p, n, cs,
                *x.stride()[:3], *a.stride(), *bcs, *bcs, *y.stride()[:3], 0,
                torch.cuda.current_stream(dev).cuda_stream)
        torch.cuda.synchronize()
        if err:
            raise SystemExit(f"ssm_parent_phases: parent launch failed "
                             f"({err})")
        ordered, covered, share, cycles = PH.split(torch, stamps)
        same = torch.equal(PH.bits(torch, y, hf), PH.bits(torch, *served))
        print(json.dumps({
            "kernel": "ssm_scan (one CTA a (batch, head, 32 columns))",
            "case": label, "shape": [b, h, s, p], "n": n, "chunk": cs,
            "ctas": ctas,
            "ms": median_ms(lambda: KS.ssm_scan_fused(x, a, bb, cc,
                                                      chunk=cs)),
            "cta_cycles": cycles,
            "share": dict(zip(PARENT_PHASES, map(float, share))),
            "ordered": ordered, "covered": covered,
            "stamped_equals_served": same}), flush=True)
        if not (ordered and covered and same):
            failed.append(f"{label}: ordered {ordered}, covered {covered}, "
                          f"equal {same}")
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True,
                    help="a src directory whose K21 runs a (batch, head, 32 "
                    "columns) on one CTA")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    AB.import_tree(Path(args.tree).resolve())
    import chip_smoke as CS
    import torch
    KS = importlib.import_module("repro_torch.kernels.ssm_scan")
    from repro_torch.kernels import common
    if not torch.cuda.is_available():
        sys.exit("ssm_parent_phases: no CUDA device")
    print(CS.card_line(), flush=True)
    dev = torch.device("cuda")
    common.load_library()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    failed = run(args, torch, KS, dev, AB.cold_timer(dev, args.reps), gen)
    if failed:
        sys.exit("ssm_parent_phases: " + "; ".join(failed))


if __name__ == "__main__":
    main()
