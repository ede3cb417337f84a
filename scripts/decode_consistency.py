#!/usr/bin/env python3
"""Hold the LM path's token-by-token decode to its prefill at several
prompt lengths, for one or more source trees of the port, on one card.

    python3 scripts/decode_consistency.py --tree new=src \\
        [--tree old=OTHER/src ...] [--arch zamba2-2.7b ...] \\
        [--lens 128,120,112,104,96,88,80,72]

``chip_smoke.py`` holds the bf16 decode of 128 tokens to the bf16 flash
prefill of the same 128 tokens on 4 rows.  This script reads the same
comparison at every length n of ``--lens``: the decode's logits after
its n-th token against the prefill of the first n tokens, so the
agreement is read on 4 rows a length instead of 4 in all.  A tree is a
``src`` directory that holds a ``repro_torch`` package (for example an
unpacked ``git archive`` of another commit); each runs in a fresh
process, on the weights and tokens ``chip_smoke.py`` makes (seed 0, the
float32 draw then its bf16 copy; 4 prompts of 512 tokens, then the 4 of
128 that are used here).  Each tree prints one JSON line: for each
length, ``rel`` max|decode - prefill| / max|prefill| in bf16, ``agree``
the rows whose argmax agree, and the bf16 prefill's and the bf16
decode's relative error to the float32 prefill; and ``decode_step_ms``,
the wall of the second pass of the decode over the card synchronized at
its ends only, over its steps (the first pass warms up).  Name a tree
twice (``--tree a=X --tree b=Y --tree a2=X --tree b2=Y``) to read the
step in turns.
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402  (the card line and the batch)


def one_tree(tree: Path, archs, lens) -> dict:
    """The readings of one tree in this process."""
    import torch
    sys.path.insert(0, str(tree))
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"repro_torch imported from "
                           f"{repro_torch.__file__}, not from {tree}")
    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.models import decode as MD
    from repro_torch.models import transformer as MT

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    common.load_library()
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    out = {"tree": str(tree), "card": CS.card_line(), "archs": {}}
    s = max(lens)
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params32 = MT.init_params(gen, cfg)
        params = MT.cast_params(params32, cfg)
        tokens = {n: torch.randint(0, cfg.vocab, (CS.LM_BATCH, n),
                                   generator=gen, device=dev)
                  for n in CS.LM_SEQS}[s]
        pos = [torch.full((CS.LM_BATCH,), j, device=dev) for j in range(s)]

        def decode(cache):
            steps = []
            for j in range(s):
                last, cache = MD.decode_step(params, cfg, cache,
                                             tokens[:, j:j + 1], pos[j])
                steps.append(last)
            return steps

        decode(MD.init_cache(cfg, CS.LM_BATCH, s, device=dev))
        cache = MD.init_cache(cfg, CS.LM_BATCH, s, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = decode(cache)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / s
        rows = {}
        for n in lens:
            want = MT.prefill(params, cfg, {"tokens": tokens[:, :n]})
            truth = MT.prefill(params32, cfg32, {"tokens": tokens[:, :n]})
            got = steps[n - 1]
            rows[n] = {"rel": rel(got, want),
                       "agree": int((got.argmax(-1)
                                     == want.argmax(-1)).sum()),
                       "prefill_to_f32": rel(want, truth),
                       "decode_to_f32": rel(got, truth)}
        out["archs"][arch] = {
            "lengths": rows,
            "decode_step_ms": step_ms,
            "agree": sum(r["agree"] for r in rows.values()),
            "of": CS.LM_BATCH * len(lens)}
        del params32, params, cache, steps
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=PATH of a src directory")
    ap.add_argument("--arch", action="append")
    ap.add_argument("--lens", default="128,120,112,104,96,88,80,72")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    archs = args.arch or ["zamba2-2.7b"]
    lens = [int(n) for n in args.lens.split(",")]
    if max(lens) > max(CS.LM_SEQS):
        ap.error(f"lengths go up to {max(CS.LM_SEQS)}")
    trees = dict(t.split("=", 1) for t in args.tree)
    if args.one:
        print(json.dumps(one_tree(Path(trees[args.one]).resolve(), archs,
                                  lens)), flush=True)
        return
    for name in trees:
        proc = subprocess.run(
            [sys.executable, __file__, "--one", name, "--lens", args.lens]
            + [f"--tree={t}" for t in args.tree]
            + [f"--arch={a}" for a in archs],
            capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stdout + proc.stderr)
            sys.exit(f"decode_consistency: the tree {name} failed")
        reading = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"name": name, **reading}), flush=True)


if __name__ == "__main__":
    main()
