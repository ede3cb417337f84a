"""Model assembly for the dense family: init, embedding, the layer stack,
the output head and ``prefill`` (the serve-time forward).

Parameters are a plain dict under the reference's names — ``embed``,
``ln_f``, ``lm_head`` (untied), ``layers`` — where ``layers`` is a list
with one dict per layer (``ln1``, ``attn`` {``wq``, ``wk``, ``wv``,
``wo``, [``q_norm``, ``k_norm``]}, ``ln2``, ``mlp`` {``wi``, [``wg``],
``wo``}) instead of the reference's stacked ``(L, ...)`` arrays: the
reference's ``lax.scan`` over layers is a Python loop here.

The reference casts each weight to the compute dtype at every use
(``x @ w.astype(bf16)``); :func:`cast_params` makes that copy once, which
gives the same values (one float32 -> bfloat16 rounding either way) and
saves re-reading the float32 weights at every call, for the memory of
one bfloat16 copy.  Norm scales stay float32, as ``rms_norm`` reads them.

The hybrid (zamba2) and xLSTM families come with the K21 slice, MoE,
audio and VLM with theirs; ``lm_loss`` and ``chunked_ce`` with training.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpm
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import embed_init, rms_norm

LATER_SLICES = {
    "hybrid": "the hybrid family (zamba2, Mamba2 + K21) is a later slice "
              "of the port",
    "ssm": "the xLSTM family (K21) is a later slice of the port",
    "moe": "the MoE family is a later slice of the port",
    "audio": "the audio family (encoder-decoder, cross-attention) is a "
             "later slice of the port",
    "vlm": "the VLM family (prefix embeddings) is a later slice of the "
           "port",
}


def check_family(cfg: ArchConfig) -> None:
    """Raise for a family this slice does not carry."""
    if cfg.family != "dense":
        raise NotImplementedError(LATER_SLICES.get(
            cfg.family, f"unknown family {cfg.family!r}"))


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------- init ----------------

def _init_block(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    """One dense transformer block (attention + MLP)."""
    return {
        "ln1": torch.ones((cfg.d_model,), device=device),
        "attn": attn.init_attention(gen, cfg, device=device),
        "ln2": torch.ones((cfg.d_model,), device=device),
        "mlp": mlpm.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act,
                             device=device),
    }


def init_params(gen: torch.Generator, cfg: ArchConfig,
                device=None) -> dict:
    """Random parameters drawn from ``gen`` on ``device`` (default: the
    generator's device), in ``cfg.param_dtype``.  At phi4-mini-3.8b's full
    width that is 4.45e9 float32 values, 17.8 GB."""
    check_family(cfg)
    device = gen.device if device is None else torch.device(device)
    p: dict = {"embed": embed_init(gen, (cfg.vocab, cfg.d_model),
                                   device=device),
               "ln_f": torch.ones((cfg.d_model,), device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab),
                                  device=device)
    p["layers"] = [_init_block(gen, cfg, device)
                   for _ in range(cfg.n_layers)]
    return _to_param_dtype(p, cfg)


def _map_weights(p: dict, fn) -> dict:
    """The tree with ``fn`` applied to every matrix weight (embedding,
    head, projections); norm scales are passed through untouched."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return fn(node) if node.dim() >= 2 else node
    return walk(p)


def _to_param_dtype(p: dict, cfg: ArchConfig) -> dict:
    dt = _dtype(cfg.param_dtype)
    return _map_weights(p, lambda w: w.to(dt))


def cast_params(p: dict, cfg: ArchConfig) -> dict:
    """The parameters with every matrix weight cast once to
    ``cfg.compute_dtype``, the value each use would cast it to; norm
    scales stay as they are.  The serving path runs on this copy."""
    dt = _dtype(cfg.compute_dtype)
    return _map_weights(p, lambda w: w.to(dt))


def params_from_numpy(tree: dict, cfg: ArchConfig, device=None) -> dict:
    """The reference's parameter tree (numpy arrays, the layer arrays
    stacked ``(L, ...)``) as the port's parameters on ``device`` (default
    ``cuda``), so both packages compute the same function."""
    from repro_torch.kernels.common import resolve_device
    check_family(cfg)
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    def layer(node, i):
        if isinstance(node, dict):
            return {k: layer(v, i) for k, v in node.items()}
        return t(node[i])

    p = {k: t(v) for k, v in tree.items() if k != "layers"}
    p["layers"] = [layer(tree["layers"], i) for i in range(cfg.n_layers)]
    return p


# ---------------- forward ----------------

def _dense_block(p: dict, cfg: ArchConfig, x, positions, *, causal=True):
    h = attn.attention_train(p["attn"], cfg,
                             rms_norm(x, p["ln1"], cfg.norm_eps),
                             positions, causal=causal)
    x = x + h
    xn = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlpm.mlp(p["mlp"], xn, cfg.act)


def embed_tokens(p: dict, cfg: ArchConfig, tokens,
                 extra_embeds=None) -> torch.Tensor:
    """Token embeddings in the compute dtype.  Rows are gathered before
    the cast, which gives the values the reference's cast-then-gather
    gives without casting the whole table."""
    if extra_embeds is not None:
        raise NotImplementedError(LATER_SLICES["vlm"])
    return p["embed"][tokens].to(_dtype(cfg.compute_dtype))


def backbone(p: dict, cfg: ArchConfig, x, positions):
    """The layer stack; returns (x, aux) with aux = 0 (no MoE here)."""
    check_family(cfg)
    for lp in p["layers"]:
        x = _dense_block(lp, cfg, x, positions)
    return x, torch.zeros((), device=x.device)


def _out_head(p: dict, cfg: ArchConfig) -> torch.Tensor:
    return p["embed"].T if cfg.tie_embeddings else p["lm_head"]


@torch.no_grad()
def prefill(p: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Forward without loss: batch ``tokens`` (B, S) -> last-position
    logits (B, V) float32.  With ``cfg.attn_impl == "flash"`` every layer
    runs K20 once."""
    tokens = batch["tokens"]
    x = embed_tokens(p, cfg, tokens, batch.get("vision_embeds"))
    pos = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    x, _ = backbone(p, cfg, x, pos)
    x = rms_norm(x[:, -1:], p["ln_f"], cfg.norm_eps)
    w = _out_head(p, cfg)
    return (x[:, 0] @ w.to(x.dtype)).float()
