"""Single-token decode (the serve step) for the dense, hybrid and xLSTM
families.

The step consumes a pre-allocated cache, updated in place:
  dense   per-layer KV cache (L, B, Smax, KV, Dh); each row's live length
          is pos + 1 (implicit masking over the rectangular cache)
  hybrid  Mamba2 ``state`` (L, B, H, N, P) and ``conv`` (L, B, K - 1, C),
          float32, plus K/V caches for the L / shared_every applications
          of the shared block
  ssm     mLSTM matrix memories ``m`` (Lm, B, H, N, P + 1) and sLSTM
          cells ``s`` {h, c, n, m} (Ls, B, D), float32
The reference's ``lax.scan`` over layers is a Python loop, and its
``dynamic_update_slice`` at each row's position an indexed write per row
into the cache.  A recurrent state has no position to mask by, so a slot
handed to a new request is first given a fresh slot's state
(:func:`reset_slots`).  The audio encoder memory comes with its slice.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpm
from repro_torch.models import ssm as ssmm
from repro_torch.models import xlstm as xlm
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import (_out_head, check_family,
                                            embed_tokens, xlstm_counts,
                                            xlstm_groups)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """A fresh cache: zeroed K and V (n, batch, max_len, n_kv, d_head) in
    ``dtype`` for the attention blocks, float32 recurrent states.  At
    phi4-mini-3.8b's width a token takes 128 KB of K/V in bfloat16."""
    check_family(cfg)
    if cfg.family == "hybrid":
        cache = ssmm.init_mamba_cache(cfg, batch, cfg.n_layers,
                                      device=device)
        cache.update(attn.init_kv_cache(
            cfg, batch, max_len, cfg.n_layers // cfg.shared_every,
            dtype=dtype, device=device))
        return cache
    if cfg.family == "ssm":
        nm, ns = xlstm_counts(cfg)
        m = xlm.init_mlstm_state(cfg, cfg.d_model, batch, cfg.n_heads,
                                 device=device)
        s = xlm.init_slstm_state(cfg.d_model, batch, device=device)
        return {"m": m.expand((nm,) + m.shape).clone(),
                "s": {k: v.expand((ns,) + v.shape).clone()
                      for k, v in s.items()}}
    return attn.init_kv_cache(cfg, batch, max_len, cfg.n_layers,
                              dtype=dtype, device=device)


def reset_slots(cfg: ArchConfig, cache: dict, slots) -> dict:
    """Give the batch rows ``slots`` the recurrent state :func:`init_cache`
    gives a fresh slot, in place: zero Mamba2 / mLSTM state and conv
    buffer, sLSTM h, c, n zero and m at -1e30.  K/V caches are left as
    they are (a row's attention is masked to its live length), so for the
    dense family this does nothing."""
    check_family(cfg)
    slots = list(slots)
    if not slots:
        return cache
    if cfg.family == "hybrid":
        cache["state"][:, slots] = 0.0
        cache["conv"][:, slots] = 0.0
    elif cfg.family == "ssm":
        cache["m"][:, slots] = 0.0
        for k, v in cache["s"].items():
            v[:, slots] = xlm.SLSTM_M0 if k == "m" else 0.0
    return cache


def _attn_block(p: dict, cfg: ArchConfig, x, cache_k, cache_v, pos):
    """One dense block's decode step: attention over the KV cache, then
    the MLP, each with its residual."""
    h, _, _ = attn.attention_decode(
        p["attn"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps), cache_k,
        cache_v, pos)
    x = x + h
    xn = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlpm.mlp(p["mlp"], xn, cfg.act)


@torch.no_grad()
def decode_step(p: dict, cfg: ArchConfig, cache: dict, tokens, pos):
    """tokens: (B, 1) int; pos: (B,) per-row positions.  Returns (logits
    (B, V) float32, cache), the cache updated in place."""
    check_family(cfg)
    x = embed_tokens(p, cfg, tokens)
    pos = pos.long()
    if cfg.family == "hybrid":
        se = cfg.shared_every
        for g in range(cfg.n_layers // se):
            for i in range(g * se, (g + 1) * se):
                h, st, cv = ssmm.mamba_decode(p["layers"][i], cfg, x,
                                              cache["state"][i],
                                              cache["conv"][i])
                cache["state"][i] = st
                cache["conv"][i] = cv
                x = x + h
            x = _attn_block(p["shared"], cfg, x, cache["k"][g],
                            cache["v"][g], pos)
    elif cfg.family == "ssm":
        for ms, ss in xlstm_groups(cfg):
            for j in ms:
                h, st = xlm.mlstm_decode(p["layers"]["m"][j], cfg, x,
                                         cache["m"][j], cfg.n_heads)
                cache["m"][j] = st
                x = x + h
            for j in ss:
                h, st = xlm.slstm_decode(
                    p["layers"]["s"][j], cfg, x,
                    {k: v[j] for k, v in cache["s"].items()})
                for k, v in st.items():
                    cache["s"][k][j] = v
                x = x + h
    else:
        for i, lp in enumerate(p["layers"]):
            x = _attn_block(lp, cfg, x, cache["k"][i], cache["v"][i], pos)
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    w = _out_head(p, cfg)
    return (x[:, 0] @ w.to(x.dtype)).float(), cache
