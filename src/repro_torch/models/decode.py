"""Single-token decode (the serve step) for the dense family.

The step consumes a pre-allocated per-layer KV cache (L, B, Smax, KV, Dh);
each row's live length is pos + 1 (implicit masking over the rectangular
cache).  The reference's ``lax.scan`` over layers is a Python loop, and
its ``dynamic_update_slice`` at each row's position an indexed write per
row into the cache, in place.  The other families' decode state (Mamba,
xLSTM, the audio encoder memory) comes with their slices.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpm
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import (_out_head, check_family,
                                            embed_tokens)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Zeroed K and V caches, (n_layers, batch, max_len, n_kv, d_head)
    each.  At phi4-mini-3.8b's width a token takes 128 KB in bfloat16."""
    check_family(cfg)
    return attn.init_kv_cache(cfg, batch, max_len, cfg.n_layers,
                              dtype=dtype, device=device)


@torch.no_grad()
def decode_step(p: dict, cfg: ArchConfig, cache: dict, tokens, pos):
    """tokens: (B, 1) int; pos: (B,) per-row positions.  Returns (logits
    (B, V) float32, cache), the cache updated in place."""
    check_family(cfg)
    x = embed_tokens(p, cfg, tokens)
    pos = pos.long()
    for i, lp in enumerate(p["layers"]):
        h, _, _ = attn.attention_decode(
            lp["attn"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps),
            cache["k"][i], cache["v"][i], pos)
        x = x + h
        xn = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlpm.mlp(lp["mlp"], xn, cfg.act)
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    w = _out_head(p, cfg)
    return (x[:, 0] @ w.to(x.dtype)).float(), cache
