"""xLSTM blocks: mLSTM (matrix memory, chunkable) + sLSTM (strictly
sequential scalar memory).

mLSTM's recurrence  C_t = f_t C_{t-1} + i_t k_t v_t^T,  n_t = f_t n + i_t k
is the same ordered-dependence shape as Mamba2's SSD, so it runs on
``ops.ssm_scan`` (K21) with per-head B/C streams and an augmented value
channel (v ++ 1) that carries the normalizer in the same scan — one
kernel instead of two.  sLSTM is *not* chunkable (its nonlinearity sits
inside the recurrence): it is the paper's strictly ordered, non-tileable
case and runs as a :func:`repro_torch.core.dependence.fuse_scan` loop over
time in plain tensor ops, as the reference runs it as a ``lax.scan`` (no
TPU kernel).  GELU is tanh-approximated, as ``jax.nn.gelu``'s default.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.dependence import fuse_scan
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rms_norm

MLSTM_CHUNK = 64     # the reference's chunk where cfg.ssm is None
SLSTM_M0 = -1e30     # a fresh sLSTM cell's stabilizer m


# ---------------- mLSTM ----------------

def _mlstm_dims(cfg, d: int, n_heads: int):
    """(di, dqk, pv, pk): inner width, q/k width and their head widths."""
    di = cfg.xlstm.expand_m * d
    dqk = int(di * cfg.xlstm.qk_frac)
    return di, dqk, di // n_heads, dqk // n_heads


def init_mlstm(gen: torch.Generator, d: int, cfg_x, device=None) -> dict:
    di = cfg_x.expand_m * d
    dqk = int(di * cfg_x.qk_frac)
    return {
        "wq": dense_init(gen, (d, dqk), device=device),
        "wk": dense_init(gen, (d, dqk), device=device),
        "wv": dense_init(gen, (d, di), device=device),
        "wz": dense_init(gen, (d, di), device=device),
        "wf": dense_init(gen, (d, 1), device=device),   # scalar gates
        "wi": dense_init(gen, (d, 1), device=device),
        "wo": dense_init(gen, (di, d), device=device),
        "norm": torch.ones((di,), device=device),
    }


def mlstm_train(p: dict, cfg, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D); S must divide by min(64, S)."""
    b, s, d = x.shape
    di, _, pv, pk = _mlstm_dims(cfg, d, n_heads)
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(b, s, n_heads, pk)
    k = (x @ p["wk"].to(dt)).reshape(b, s, n_heads, pk) / (pk ** 0.5)
    v = (x @ p["wv"].to(dt)).reshape(b, s, n_heads, pv)
    z = x @ p["wz"].to(dt)
    f = torch.sigmoid((x @ p["wf"].to(dt)).float())          # (B, S, 1)
    i = torch.sigmoid((x @ p["wi"].to(dt)).float())
    a = f.expand(b, s, n_heads)                               # (B, S, H)
    # augmented value channel carries the normalizer in the same scan
    ones = torch.ones((b, s, n_heads, 1), dtype=dt, device=x.device)
    v_aug = torch.cat([v, ones], dim=-1)                      # (B,S,H,P+1)
    bik = k * i[..., None].to(dt)                             # (B,S,H,N)
    y_aug, _ = ops.ssm_scan(v_aug, a.to(dt), bik, q,
                            chunk=cfg.ssm.chunk if cfg.ssm else MLSTM_CHUNK,
                            device=x.device)
    y = y_aug[..., :pv]
    n = y_aug[..., pv:]
    y = y / torch.clamp_min(n.abs(), 1.0)
    y = y.reshape(b, s, di)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["wo"].to(dt)


def init_mlstm_state(cfg, d: int, batch: int, n_heads: int,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """Zero matrix memory with its normalizer column: (B, H, N, P + 1)."""
    _, _, pv, pk = _mlstm_dims(cfg, d, n_heads)
    return torch.zeros((batch, n_heads, pk, pv + 1), dtype=dtype,
                       device=device)


def mlstm_decode(p: dict, cfg, x: torch.Tensor, state: torch.Tensor,
                 n_heads: int):
    """x: (B, 1, D); state: (B, H, N, P + 1) float32.  Returns (out
    (B, 1, D), new state)."""
    b, _, d = x.shape
    di, _, pv, pk = _mlstm_dims(cfg, d, n_heads)
    dt = x.dtype
    xt = x[:, 0]
    q = (xt @ p["wq"].to(dt)).reshape(b, n_heads, pk)
    k = (xt @ p["wk"].to(dt)).reshape(b, n_heads, pk) / (pk ** 0.5)
    v = (xt @ p["wv"].to(dt)).reshape(b, n_heads, pv)
    z = xt @ p["wz"].to(dt)
    f = torch.sigmoid((xt @ p["wf"].to(dt)).float())          # (B, 1)
    i = torch.sigmoid((xt @ p["wi"].to(dt)).float())
    v_aug = torch.cat([v, torch.ones((b, n_heads, 1), dtype=dt,
                                     device=x.device)], dim=-1)
    state = f[..., None, None] * state + torch.einsum(
        "bhn,bhp->bhnp", (k * i[..., None].to(dt)).float(), v_aug.float())
    y_aug = torch.einsum("bhn,bhnp->bhp", q.float(), state)
    y = y_aug[..., :pv] / torch.clamp_min(y_aug[..., pv:].abs(), 1.0)
    y = y.reshape(b, di).to(dt)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return (y @ p["wo"].to(dt))[:, None], state


# ---------------- sLSTM ----------------

def init_slstm(gen: torch.Generator, d: int, cfg_x, device=None) -> dict:
    fd = int(d * cfg_x.expand_s_ffn)
    return {
        "w_gates": dense_init(gen, (d, 4 * d), device=device),  # z, i, f, o
        "r_gates": dense_init(gen, (d, 4 * d), device=device),  # recurrent
        "w_up": dense_init(gen, (d, fd), device=device),
        "w_down": dense_init(gen, (fd, d), device=device),
        "norm": torch.ones((d,), device=device),
    }


def _slstm_cell(p: dict, carry, wx: torch.Tensor):
    """Stabilized sLSTM cell. carry: (h, c, n, m) each (B, D); h in the
    compute dtype, c, n, m float32."""
    h, c, n, m = carry
    pre = wx + h @ p["r_gates"].to(h.dtype)
    z, i, f, o = torch.chunk(pre.float(), 4, dim=-1)
    logf = F.logsigmoid(f)
    m_new = torch.maximum(logf + m, i)
    fp = torch.exp(logf + m - m_new)
    ip = torch.exp(i - m_new)
    c = fp * c + ip * torch.tanh(z)
    n = fp * n + ip
    h_new = torch.sigmoid(o) * c / torch.clamp_min(n, 1.0)
    return (h_new.to(wx.dtype), c, n, m_new)


def _slstm_out(p: dict, cfg, h: torch.Tensor, dt) -> torch.Tensor:
    h = rms_norm(h, p["norm"], cfg.norm_eps)
    ff = F.gelu(h @ p["w_up"].to(dt), approximate="tanh")
    return ff @ p["w_down"].to(dt)


def slstm_train(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """Strictly ordered loop over time (the non-tileable FGOP case)."""
    b, s, d = x.shape
    wx = x @ p["w_gates"].to(x.dtype)                          # (B,S,4D)
    carry = (torch.zeros((b, d), dtype=x.dtype, device=x.device),
             *(torch.zeros((b, d), device=x.device) for _ in range(2)),
             torch.full((b, d), SLSTM_M0, device=x.device))

    def step(carry, wxt):
        carry = _slstm_cell(p, carry, wxt)
        return carry, carry[0]

    _, hs = fuse_scan(step, carry, wx.transpose(0, 1))
    return _slstm_out(p, cfg, hs.transpose(0, 1), x.dtype)      # (B,S,D)


def init_slstm_state(d: int, batch: int, device=None) -> dict:
    """A fresh cell: h, c, n zero and the stabilizer m at -1e30."""
    z = lambda: torch.zeros((batch, d), device=device)
    return {"h": z(), "c": z(), "n": z(),
            "m": torch.full((batch, d), SLSTM_M0, device=device)}


def slstm_decode(p: dict, cfg, x: torch.Tensor, st: dict):
    """x: (B, 1, D); st: {h, c, n, m} float32 (B, D) each."""
    wx = x[:, 0] @ p["w_gates"].to(x.dtype)
    carry = (st["h"].to(x.dtype), st["c"], st["n"], st["m"])
    h, c, n, m = _slstm_cell(p, carry, wx)
    st = {"h": h.float(), "c": c, "n": n, "m": m}
    return _slstm_out(p, cfg, h, x.dtype)[:, None], st
