"""Model assembly for the dense, hybrid (zamba2) and xLSTM families: init,
embedding, the layer stack, the output head and ``prefill`` (the
serve-time forward).

Parameters are a plain dict under the reference's names — ``embed``,
``ln_f``, ``lm_head`` (untied), ``layers`` — where ``layers`` holds one
dict per layer instead of the reference's stacked ``(L, ...)`` arrays: the
reference's ``lax.scan`` over layers is a Python loop here.

  dense   ``layers`` a list of blocks (``ln1``, ``attn`` {``wq``, ``wk``,
          ``wv``, ``wo``, [``q_norm``, ``k_norm``]}, ``ln2``, ``mlp``
          {``wi``, [``wg``], ``wo``});
  hybrid  ``layers`` a list of Mamba2 layers (``models/ssm.py``) and
          ``shared`` one dense block, applied after each group of
          ``shared_every`` layers;
  ssm     ``layers`` = {``m``: mLSTM layers, ``s``: sLSTM layers}
          (``models/xlstm.py``), run as groups of m_per_group mLSTM then
          s_per_group sLSTM layers.

The reference casts each weight to the compute dtype at every use
(``x @ w.astype(bf16)``); :func:`cast_params` makes that copy once, which
gives the same values (one float32 -> bfloat16 rounding either way) and
saves re-reading the float32 weights at every call, for the memory of
one bfloat16 copy.  Vectors (norm scales, Mamba2's ``a_log``,
``dt_bias`` and ``d_skip``) stay float32, as the reference reads them.

MoE, audio and VLM come with their slices; ``lm_loss`` and ``chunked_ce``
with training.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpm
from repro_torch.models import ssm as ssmm
from repro_torch.models import xlstm as xlm
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import embed_init, rms_norm

FAMILIES = ("dense", "hybrid", "ssm")
LATER_SLICES = {
    "moe": "the MoE family is a later slice of the port",
    "audio": "the audio family (encoder-decoder, cross-attention) is a "
             "later slice of the port",
    "vlm": "the VLM family (prefix embeddings) is a later slice of the "
           "port",
}


def check_family(cfg: ArchConfig) -> None:
    """Raise for a family the port does not carry yet."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(LATER_SLICES.get(
            cfg.family, f"unknown family {cfg.family!r}"))


def xlstm_groups(cfg: ArchConfig) -> list[tuple[range, range]]:
    """The layer groups of an xLSTM config, in order: n_layers //
    (m_per_group + s_per_group) groups, each (its mLSTM layers, its sLSTM
    layers) as indices into the stacked ``m`` and ``s`` layer lists."""
    mg, sg = cfg.xlstm.m_per_group, cfg.xlstm.s_per_group
    return [(range(g * mg, (g + 1) * mg), range(g * sg, (g + 1) * sg))
            for g in range(cfg.n_layers // (mg + sg))]


def xlstm_counts(cfg: ArchConfig) -> tuple[int, int]:
    """(mLSTM layers, sLSTM layers) of an xLSTM config."""
    n = len(xlstm_groups(cfg))
    return n * cfg.xlstm.m_per_group, n * cfg.xlstm.s_per_group


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
    width that is 4.45e9 float32 values, 17.8 GB; at zamba2-2.7b's
    2.4e9."""
    check_family(cfg)
    device = gen.device if device is None else torch.device(device)
    p: dict = {"embed": embed_init(gen, (cfg.vocab, cfg.d_model),
                                   device=device),
               "ln_f": torch.ones((cfg.d_model,), device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab),
                                  device=device)
    d = cfg.d_model
    if cfg.family == "hybrid":
        p["layers"] = [ssmm.init_mamba(gen, d, cfg.ssm, device=device)
                       for _ in range(cfg.n_layers)]
        p["shared"] = _init_block(gen, cfg, device)
    elif cfg.family == "ssm":
        nm, ns = xlstm_counts(cfg)
        p["layers"] = {
            "m": [xlm.init_mlstm(gen, d, cfg.xlstm, device=device)
                  for _ in range(nm)],
            "s": [xlm.init_slstm(gen, d, cfg.xlstm, device=device)
                  for _ in range(ns)]}
    else:
        p["layers"] = [_init_block(gen, cfg, device)
                       for _ in range(cfg.n_layers)]
    return _to_param_dtype(p, cfg)


def _map_weights(p: dict, fn) -> dict:
    """The tree with ``fn`` applied to every matrix weight (embedding,
    head, projections, Mamba2's conv taps); vectors (norm scales, the
    Mamba2 decay and skip parameters) are passed through untouched."""
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
    stacked ``(L, ...)``: the hybrid's ``shared`` block unstacked, the
    xLSTM's ``layers`` a dict of two stacks, ``m`` and ``s``) as the
    port's parameters on ``device`` (default ``cuda``), so both packages
    compute the same function."""
    from repro_torch.kernels.common import resolve_device
    check_family(cfg)
    dev = resolve_device(device)

    def whole(node):
        if isinstance(node, dict):
            return {k: whole(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node)).to(dev)

    def layer(node, i):
        if isinstance(node, dict):
            return {k: layer(v, i) for k, v in node.items()}
        return whole(node[i])

    def unstack(stacked, n):
        return [layer(stacked, i) for i in range(n)]

    p = {k: whole(v) for k, v in tree.items() if k != "layers"}
    if cfg.family == "ssm":
        nm, ns = xlstm_counts(cfg)
        p["layers"] = {"m": unstack(tree["layers"]["m"], nm),
                       "s": unstack(tree["layers"]["s"], ns)}
    else:
        p["layers"] = unstack(tree["layers"], cfg.n_layers)
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


def _hybrid_stack(p: dict, cfg: ArchConfig, x, positions):
    """zamba2: groups of ``shared_every`` Mamba2 layers, each group
    followed by the one shared attention + MLP block."""
    se = cfg.shared_every
    for g in range(cfg.n_layers // se):
        for lp in p["layers"][g * se:(g + 1) * se]:
            x = x + ssmm.mamba_train(lp, cfg, x)
        x = _dense_block(p["shared"], cfg, x, positions)
    return x


def _xlstm_stack(p: dict, cfg: ArchConfig, x):
    """Groups of m_per_group mLSTM then s_per_group sLSTM layers."""
    for ms, ss in xlstm_groups(cfg):
        for j in ms:
            x = x + xlm.mlstm_train(p["layers"]["m"][j], cfg, x, cfg.n_heads)
        for j in ss:
            x = x + xlm.slstm_train(p["layers"]["s"][j], cfg, x)
    return x


def backbone(p: dict, cfg: ArchConfig, x, positions):
    """The layer stack; returns (x, aux) with aux = 0 (no MoE here)."""
    check_family(cfg)
    if cfg.family == "hybrid":
        x = _hybrid_stack(p, cfg, x, positions)
    elif cfg.family == "ssm":
        x = _xlstm_stack(p, cfg, x)
    else:
        for lp in p["layers"]:
            x = _dense_block(lp, cfg, x, positions)
    return x, torch.zeros((), device=x.device)


def _out_head(p: dict, cfg: ArchConfig) -> torch.Tensor:
    return p["embed"].T if cfg.tie_embeddings else p["lm_head"]


@torch.no_grad()
def prefill(p: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Forward without loss: batch ``tokens`` (B, S) -> last-position
    logits (B, V) float32.  With ``cfg.attn_impl == "flash"`` every
    attention block runs K20 once (each dense layer; each application of
    the hybrid's shared block); every Mamba2 and mLSTM layer runs K21
    once.  The hybrid needs S divisible by min(ssm.chunk, S), the xLSTM by
    min(64, S)."""
    tokens = batch["tokens"]
    x = embed_tokens(p, cfg, tokens, batch.get("vision_embeds"))
    pos = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    x, _ = backbone(p, cfg, x, pos)
    x = rms_norm(x[:, -1:], p["ln_f"], cfg.norm_eps)
    w = _out_head(p, cfg)
    return (x[:, 0] @ w.to(x.dtype)).float()
