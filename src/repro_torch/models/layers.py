"""Shared layer primitives: inits, norms, RoPE, cross-entropy (plain
tensors and dicts, no modules).

The inits draw from an explicit ``torch.Generator`` on an explicit
device; they give other numbers than the reference's ``jax.random`` keys,
so a test that holds the two packages against each other carries the
reference's weights across (``transformer.params_from_numpy``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Normal weights scaled by 1 / sqrt(fan_in)."""
    std = 1.0 / np.sqrt(shape[in_axis])
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Normal embeddings of standard deviation 0.02."""
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm over the last axis, computed in float32 and cast back."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def rope_freqs(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float32)
                            / d_head))


@functools.lru_cache(maxsize=None)
def _inv_freqs(d_head: int, theta: float, device) -> torch.Tensor:
    """The RoPE frequencies on ``device``, copied there once: a copy from
    the host at every call would make the host wait for the card."""
    return torch.from_numpy(rope_freqs(d_head, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e6) -> torch.Tensor:
    """x: (..., S, H, Dh) or (..., S, Dh); positions: (..., S)."""
    dh = x.shape[-1]
    inv = _inv_freqs(dh, float(theta), x.device)
    ang = positions[..., None].float() * inv            # (..., S, Dh/2)
    if x.dim() == ang.dim() + 1:                        # head dim present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-level cross-entropy. logits (..., V); labels (...,) int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if mask is not None:
        loss = loss * mask
        return torch.sum(loss) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(loss)
