"""Mamba2 block on the chunked scan K21 (ordered dependence).

The serve-time forward (``mamba_train``) runs ``ops.ssm_scan``, the
kernel on a CUDA tensor; the decode step is the O(1) recurrent update in
plain tensor ops, its state and short-conv buffer carried in the decode
cache.  The reference's models call ``ops.ssm_scan(backend="xla")``,
whose bfloat16 path takes the log and cumsum of a bfloat16 decay and
mixes bfloat16 into its carry; K21 follows the reference's kernel
instead (every input upcast to float32 inside), so the two agree to
rounding in float32 and within the reference's bf16 model rule in
bfloat16.

The decode step runs the prefill's arithmetic: its conv taps are summed
one by one in the compute dtype, as ``_causal_conv`` sums them, and the
decay and x * dt are rounded to it before the float32 state update, where
``mamba_train`` rounds them for the scan.  The reference's decode sums
the taps at once and keeps both in float32, so in bfloat16 its decode and
its prefill run two recurrences (a decay within 2^-9 of 1 rounds to 1 in
one and not in the other), and a deep stack widens that gap past the
argmax agreement of greedy decoding.  In float32 the two forms are the
same but for summation order.

``softplus`` is ``jax.nn.softplus``'s ``logaddexp(x, 0)``
(``torch.logaddexp``), not ``F.softplus``, which turns linear above 20.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rms_norm


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_mamba(gen: torch.Generator, d: int, cfg_ssm, device=None) -> dict:
    di = cfg_ssm.expand * d
    n = cfg_ssm.state
    h = cfg_ssm.heads
    kc = cfg_ssm.conv_kernel
    return {
        # fused input projection: [z(di), x(di), B(n), C(n), dt(h)]
        "w_in": dense_init(gen, (d, 2 * di + 2 * n + h), device=device),
        "w_out": dense_init(gen, (di, d), device=device),
        "conv_w": dense_init(gen, (kc, di + 2 * n), device=device),
        "a_log": torch.zeros((h,), device=device),      # A = -exp(a_log)
        "dt_bias": torch.zeros((h,), device=device),
        "d_skip": torch.ones((h,), device=device),
        "norm": torch.ones((di,), device=device),
    }


def _split_proj(p, cfg_ssm, d, proj):
    di = cfg_ssm.expand * d
    n = cfg_ssm.state
    z = proj[..., :di]
    xc = proj[..., di:2 * di]
    bmat = proj[..., 2 * di:2 * di + n]
    cmat = proj[..., 2 * di + n:2 * di + 2 * n]
    dt = proj[..., 2 * di + 2 * n:]
    return z, xc, bmat, cmat, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C), w: (K, C) depthwise causal conv, tap by tap in x's
    dtype as the reference sums it."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1]] * w[i][None, None, :]
    return out


def mamba_train(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D); S must divide by min(ssm.chunk, S)."""
    ssm = cfg.ssm
    b, s, d = x.shape
    di = ssm.expand * d
    hh = ssm.heads
    pp = di // hh
    proj = x @ p["w_in"].to(x.dtype)
    z, xc, bmat, cmat, dt = _split_proj(p, ssm, d, proj)
    # causal short conv over [x, B, C] (mamba2 convention)
    conv_in = torch.cat([xc, bmat, cmat], dim=-1)
    conv = F.silu(_causal_conv(conv_in, p["conv_w"].to(x.dtype)))
    xc = conv[..., :di]
    bmat = conv[..., di:di + ssm.state]
    cmat = conv[..., di + ssm.state:]
    dt = softplus(dt.float() + p["dt_bias"][None, None, :])     # (B,S,H)
    a = torch.exp(-torch.exp(p["a_log"])[None, None, :] * dt)   # (0, 1)
    xh = xc.reshape(b, s, hh, pp)
    xin = (xh.float() * dt[..., None]).to(x.dtype)
    y, _ = ops.ssm_scan(xin, a.to(x.dtype), bmat, cmat, chunk=ssm.chunk,
                        device=x.device)
    y = y + xh * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, s, di)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["w_out"].to(x.dtype)


# ---------------- decode ----------------

def init_mamba_cache(cfg, batch: int, n_layers: int, dtype=torch.float32,
                     device=None) -> dict:
    """Zero state (L, B, H, N, P) and conv buffer (L, B, K - 1, C)."""
    ssm = cfg.ssm
    di = ssm.expand * cfg.d_model
    return {
        "state": torch.zeros((n_layers, batch, ssm.heads, ssm.state,
                              di // ssm.heads), dtype=dtype, device=device),
        "conv": torch.zeros((n_layers, batch, ssm.conv_kernel - 1,
                             di + 2 * ssm.state), dtype=dtype,
                            device=device),
    }


def mamba_decode(p: dict, cfg, x: torch.Tensor, state: torch.Tensor,
                 conv_buf: torch.Tensor):
    """x: (B, 1, D); state: (B, H, N, P); conv_buf: (B, K - 1, C).
    Returns (out (B, 1, D), new state, new conv buffer)."""
    ssm = cfg.ssm
    b, _, d = x.shape
    di = ssm.expand * d
    hh = ssm.heads
    pp = di // hh
    proj = x[:, 0] @ p["w_in"].to(x.dtype)                     # (B, ...)
    z, xc, bmat, cmat, dt = _split_proj(p, ssm, d, proj)
    conv_in = torch.cat([xc, bmat, cmat], dim=-1)               # (B, C)
    window = torch.cat([conv_buf.to(x.dtype), conv_in[:, None]], dim=1)
    # _causal_conv's sum at the window's last position, tap by tap
    w = p["conv_w"].to(x.dtype)
    conv = window[:, 0] * w[0]
    for i in range(1, w.shape[0]):
        conv = conv + window[:, i] * w[i]
    conv = F.silu(conv)
    new_buf = window[:, 1:].to(conv_buf.dtype)
    xc = conv[:, :di]
    bmat = conv[:, di:di + ssm.state]
    cmat = conv[:, di + ssm.state:]
    dt = softplus(dt.float() + p["dt_bias"][None, :])
    # decay and x * dt rounded as the prefill rounds them for the scan
    a = torch.exp(-torch.exp(p["a_log"])[None, :] * dt).to(x.dtype)
    xh = (xc.reshape(b, hh, pp).float() * dt[..., None]).to(x.dtype)
    state = a[..., None, None] * state + torch.einsum(
        "bn,bhp->bhnp", bmat.float(), xh.float())
    y = torch.einsum("bn,bhnp->bhp", cmat.float(), state)
    y = y.to(x.dtype) + xc.reshape(b, hh, pp) \
        * p["d_skip"].to(x.dtype)[None, :, None]
    y = y.reshape(b, di)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = (y @ p["w_out"].to(x.dtype))[:, None]
    return out, state, new_buf
