"""LM serving launcher: a DecodeEngine (continuous batching) behind a
SolverMux, serving a batch of greedy requests on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --pool 4 --max-len 256 --requests 8 --max-new 16

The model is ``--arch``'s smoke config (default) or, with ``--full``, its
full published width — a dense model (phi4-mini-3.8b, the default), the
hybrid zamba2-2.7b or xlstm-125m — with random weights from a generator
seeded 0 on ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch paths).
Prompts are ``--requests`` seed-keyed token lists whose lengths spread
evenly over 3..40 tokens (chat-length prompts).  The run prints
requests, tokens, tokens/s and the step time (the serving window over
its steps, and the median step); ``main`` returns them with the prompts
served and each request's output.  ``--mesh`` other than ``1x1`` is refused: sharded serving is a later
slice of the port.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.kernels.common import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve import SolverMux
from repro_torch.serve.decode import DecodeEngine, Request

PROMPT_LENS = (3, 40)      # shortest and longest prompt, in tokens


def prompts(n: int, lo: int, hi: int, vocab: int, seed: int) -> list:
    """``n`` prompts of lengths spread evenly over lo..hi, tokens drawn
    from a generator seeded ``seed`` (ids 2..vocab-1)."""
    rng = np.random.default_rng(seed)
    lens = [lo + (hi - lo) * i // max(n - 1, 1) for i in range(n)]
    return [[int(t) for t in rng.integers(2, vocab, size=k)] for k in lens]


def serve(engine: DecodeEngine, batch: list, max_new: int) -> list:
    """Serve ``batch`` (prompts) through a mux with ``engine`` attached;
    returns the finished requests in submission order."""
    mux = SolverMux(lanes=1, device=engine.device)
    mux.attach_decode(engine)
    reqs = [mux.submit_decode(Request(prompt=list(p), max_new=max_new),
                              priority="hard") for p in batch]
    mux.run()
    if not all(r.done for r in reqs) or mux.pending():
        raise RuntimeError("the mux left decode requests unfinished")
    return reqs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="phi4-mini-3.8b")
    ap.add_argument("--full", action="store_true",
                    help="the arch's full published width instead of its "
                         "smoke config")
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--pool", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        ap.error(f"--mesh {args.mesh}: sharded serving is a later slice of "
                 f"the port")
    if args.max_len <= PROMPT_LENS[1]:
        ap.error(f"--max-len must exceed the longest prompt, "
                 f"{PROMPT_LENS[1]} tokens")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = T.init_params(gen, cfg)
    engine = DecodeEngine(cfg, params, batch=args.pool,
                          max_len=args.max_len, eos_id=-1)
    del params                       # the engine keeps its cast copy
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup = time.perf_counter() - t0

    batch = prompts(args.requests, *PROMPT_LENS, cfg.vocab, seed=0)
    t0 = time.perf_counter()
    reqs = serve(engine, batch, args.max_new)
    wall = time.perf_counter() - t0
    steps = [rec.measured for rec in engine.metrics().launches
             if rec.pipeline == "decode"]
    tokens = sum(len(r.out) for r in reqs)
    summary = {
        "arch": cfg.name, "device": str(dev), "pool": args.pool,
        "requests": len(reqs), "done": sum(r.done for r in reqs),
        "tokens": tokens, "steps": len(steps), "seconds": wall,
        "tokens_per_s": tokens / wall,
        "step_ms": 1e3 * wall / len(steps),
        "step_ms_p50": 1e3 * statistics.median(steps),
        "setup_seconds": setup,
        "prompts": batch,
        "outputs": [r.out for r in reqs]}
    print(f"{cfg.name} on {dev}: {summary['requests']} requests, "
          f"{tokens} tokens in {wall:.2f}s ({summary['tokens_per_s']:.1f} "
          f"tok/s), {len(steps)} steps, {summary['step_ms']:.3f} ms a step "
          f"(median {summary['step_ms_p50']:.3f} ms; model set-up "
          f"{setup:.1f}s)")
    return summary


if __name__ == "__main__":
    main()
