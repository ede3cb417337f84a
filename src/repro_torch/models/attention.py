"""GQA attention: init, train paths (incl. FGOP-inductive banding), decode.

Train-path implementations (``cfg.attn_impl``):
  'xla'     — one dense product + mask (small S only)
  'chunked' — a loop over q blocks, full-width kv with causal mask
              (rectangular tiling: the no-FGOP baseline at scale)
  'banded'  — q-band b attends kv[0 : band_end(b)] with static inductive
              lengths: the paper's RI-stream tiling at coarse grain
  'flash'   — the hand-written kernel K20 (``ops.flash_attention``)
'auto' picks 'xla' up to S = max(attn_chunk, 1024), else 'chunked', as
the reference does; so the flash kernel runs only where a config asks for
it by name.  Decode: single-token attention over a pre-allocated KV cache,
masked to each row's live length.

The reference's ``constrain`` calls are sharding hints that do nothing on
one device, so they have no counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, rms_norm

NEG = -1e30


def init_attention(gen: torch.Generator, cfg, d_model=None,
                   device=None) -> dict:
    d = d_model or cfg.d_model
    h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    p = {
        "wq": dense_init(gen, (d, h * dh), device=device),
        "wk": dense_init(gen, (d, kv * dh), device=device),
        "wv": dense_init(gen, (d, kv * dh), device=device),
        "wo": dense_init(gen, (h * dh, d), device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), device=device)
        p["k_norm"] = torch.ones((dh,), device=device)
    return p


def _qkv(p, cfg, x, positions, rope: bool = True):
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, h, dh)
    k = (x @ p["wk"].to(x.dtype)).reshape(b, s, kv, dh)
    v = (x @ p["wv"].to(x.dtype)).reshape(b, s, kv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_logits(q, k, scale):
    """q: (B,Sq,H,Dh), k: (B,Skv,KV,Dh) -> (B,H,Sq,Skv) f32, grouped."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, dh)
    lg = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale
    return lg.reshape(b, h, sq, k.shape[1])


def _gqa_out(w, v):
    """w: (B,H,Sq,Skv) f32, v: (B,Skv,KV,Dh) -> (B,Sq,H,Dh)."""
    b, h, sq, skv = w.shape
    kvh = v.shape[2]
    wg = w.reshape(b, kvh, h // kvh, sq, skv)
    o = torch.einsum("bkgqs,bskd->bqkgd", wg.to(v.dtype), v)
    return o.reshape(b, sq, h, v.shape[-1])


def _attend_dense(q, k, v, scale, causal, q_off=0):
    logits = _gqa_logits(q, k, scale)
    if causal:
        qi = q_off + torch.arange(q.shape[1], device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        logits = torch.where((ki <= qi)[None, None], logits, NEG)
    w = torch.softmax(logits, dim=-1)
    return _gqa_out(w, v)


def _largest_divisor(s: int, cap: int) -> int:
    """The largest divisor of s that is <= cap (a VLM prefix can make s a
    non-power-of-two)."""
    c = min(cap, s)
    while s % c != 0:
        c -= 1
    return c


def _attend_chunks(q, k, v, scale, c, q_off=0):
    """Causal attention of q's rows in chunks of c against all of k/v."""
    s = q.shape[1]
    return torch.cat([_attend_dense(q[:, i:i + c], k, v, scale, True,
                                    q_off=q_off + i)
                      for i in range(0, s, c)], dim=1)


def attend_train(q, k, v, cfg, causal: bool = True):
    """q,k,v: (B,S,H/KV,Dh) -> (B,S,H,Dh)."""
    s, dh = q.shape[1], q.shape[3]
    scale = 1.0 / np.sqrt(dh)
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "xla" if s <= max(cfg.attn_chunk, 1024) else "chunked"

    if impl == "flash":
        # K20 reads the (B, H, S, D) views through their strides and
        # answers in q's layout: the transposes copy nothing
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                device=q.device)
        return o.transpose(1, 2)

    if impl == "xla" or not causal:
        return _attend_dense(q, k, v, scale, causal)

    if impl == "chunked":
        return _attend_chunks(q, k, v, scale,
                              _largest_divisor(s, cfg.attn_chunk))

    if impl == "banded":
        # FGOP: inductive trip count at band granularity — band i reads
        # kv[0 : (i+1)*band] only; within a band the q rows go in
        # attn_chunk tiles, so one (B,H,chunk,band_kv) logits tile is live
        nb = min(cfg.attn_bands, s)
        if s % nb:
            raise ValueError(f"banded attention: S = {s} does not divide "
                             f"into {nb} bands")
        band = s // nb
        c = _largest_divisor(band, cfg.attn_chunk)
        outs = []
        for i in range(nb):
            qb = q[:, i * band:(i + 1) * band]
            kc = k[:, :(i + 1) * band]
            vc = v[:, :(i + 1) * band]
            outs.append(_attend_chunks(qb, kc, vc, scale, c,
                                       q_off=i * band))
        return torch.cat(outs, dim=1)

    raise ValueError(f"unknown attn_impl {impl!r}")


def attention_train(p, cfg, x, positions, *, causal=True, kv_x=None,
                    rope=True):
    """Full attention block (no residual). Cross-attention (``kv_x``)
    belongs to the audio slice and raises here."""
    if kv_x is not None:
        raise NotImplementedError("cross-attention is a later slice of "
                                  "the port (audio)")
    q, k, v = _qkv(p, cfg, x, positions, rope=rope)
    o = attend_train(q, k, v, cfg, causal=causal)
    b, s, h, dh = o.shape
    return o.reshape(b, s, h * dh) @ p["wo"].to(x.dtype)


# ---------------- decode ----------------

def init_kv_cache(cfg, batch: int, max_len: int, n_layers: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    kv, dh = cfg.n_kv, cfg.d_head
    shape = (n_layers, batch, max_len, kv, dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(p, cfg, x, cache_k, cache_v, pos, *, rope=True):
    """One-token decode. x: (B,1,D); cache_k/v: (B,Smax,KV,Dh); pos: (B,)
    PER-ROW positions — each row (slot) carries its own position, so a
    continuous-batching pool can mix rows mid-prefill with rows deep into
    generation.  Returns (out (B,1,D), cache_k, cache_v).

    Each row's new k/v is written at that row's own position IN PLACE
    (the reference returns updated copies; writing in place keeps one
    cache in device memory).  Each row's cache tail beyond its ``pos`` is
    masked — the live length is pos + 1 — which is also what makes slot
    reuse safe: resetting a row's position to 0 orphans its stale pages
    without zeroing them."""
    b = x.shape[0]
    h, dh = cfg.n_heads, cfg.d_head
    q, k, v = _qkv(p, cfg, x, pos[:, None], rope=rope)
    rows = torch.arange(b, device=x.device)
    cache_k[rows, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, pos] = v[:, 0].to(cache_v.dtype)
    smax = cache_k.shape[1]
    scale = 1.0 / np.sqrt(dh)
    logits = _gqa_logits(q, cache_k.to(q.dtype), scale)     # (B,H,1,Smax)
    live = torch.arange(smax, device=x.device)[None, None, None, :] \
        <= pos[:, None, None, None]
    logits = torch.where(live, logits, NEG)
    w = torch.softmax(logits, dim=-1)
    o = _gqa_out(w, cache_v.to(q.dtype))
    out = o.reshape(b, 1, h * dh) @ p["wo"].to(x.dtype)
    return out, cache_k, cache_v
