"""Feed-forward blocks: dense SwiGLU / squared-ReLU / GELU.

Mixture-of-experts (``moe``, ``moe_a2a``) belongs to the MoE slice of the
port and raises here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

MOE_SLICE = ("mixture-of-experts (moe, moe_a2a) is a later slice of the "
             "port (MoE)")


def init_mlp(gen: torch.Generator, d: int, f: int, act: str,
             device=None) -> dict:
    if act == "swiglu":
        return {"wi": dense_init(gen, (d, f), device=device),
                "wg": dense_init(gen, (d, f), device=device),
                "wo": dense_init(gen, (f, d), device=device)}
    return {"wi": dense_init(gen, (d, f), device=device),
            "wo": dense_init(gen, (f, d), device=device)}


def mlp(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """x (..., D) -> (..., D) in x's dtype; each weight cast to it."""
    dt = x.dtype
    if act == "swiglu":
        hi = x @ p["wi"].to(dt)
        hg = x @ p["wg"].to(dt)
        h = F.silu(hg) * hi
    elif act == "sq_relu":
        h = torch.square(F.relu(x @ p["wi"].to(dt)))
    else:  # gelu, tanh-approximated as jax.nn.gelu's default
        h = F.gelu(x @ p["wi"].to(dt), approximate="tanh")
    return h @ p["wo"].to(dt)


def init_moe(*args, **kwargs):
    raise NotImplementedError(MOE_SLICE)


def moe(*args, **kwargs):
    raise NotImplementedError(MOE_SLICE)


def moe_a2a(*args, **kwargs):
    raise NotImplementedError(MOE_SLICE)
