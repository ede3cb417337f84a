"""Plain-library oracles for the served pipelines and the kernels they
run — the ground truth for allclose tests and the serving stack's
per-job spot check.

These are deliberately unfused library calls (``torch.linalg``,
``torch.fft``, ``conv1d``, ``matmul`` and einsum) and, for the QR, the Householder loop in
unfused tensor ops, the counterparts of the reference's
``repro/kernels/ref.py`` oracles (and of its ``backend="xla"`` paths:
a caller that wants one calls it by name).  This module is the only place
in the package that calls them; no kernel path does.
"""
from __future__ import annotations

import torch


# ---------------- factorizations ----------------

def cholesky(a: torch.Tensor) -> torch.Tensor:
    """(B, N, N) SPD -> lower L."""
    return torch.linalg.cholesky(a)


def trisolve(l: torch.Tensor, b: torch.Tensor, *,
             lower: bool = True) -> torch.Tensor:
    """(B,N,N) triangular x (B,N,M) -> y with l @ y = b."""
    return torch.linalg.solve_triangular(l, b, upper=not lower)


def qr(a: torch.Tensor):
    """Householder QR, the same math as the kernel but unfused, every
    lane at once: a (B, M, N) -> (Q (B,M,M), triu(R) (B,M,N)).  Not
    ``torch.linalg.qr``, whose reflector signs may differ."""
    bsz, m, n = a.shape
    q = torch.eye(m, dtype=a.dtype, device=a.device).repeat(bsz, 1, 1)
    r = a
    rows = torch.arange(m, device=a.device)
    for k in range(min(n, m - 1) if m > 1 else 0):
        x = torch.where(rows >= k, r[:, :, k], 0.0)
        xk = r[:, k, k]
        norm = torch.linalg.vector_norm(x, dim=-1)
        alpha = torch.where(xk >= 0, -norm, norm)
        v = x - alpha[:, None] * (rows == k).to(r.dtype)
        vnorm2 = torch.clamp_min(torch.einsum("bm,bm->b", v, v), 1e-30)
        tau = torch.where(norm < 1e-30, 0.0, 2.0 / vnorm2)
        w = tau[:, None] * torch.einsum("bm,bmn->bn", v, r)
        r = r - v[:, :, None] * w[:, None, :]
        u = tau[:, None] * torch.einsum("bmj,bj->bm", q, v)
        q = q - u[:, :, None] * v[:, None, :]
    return q, torch.triu(r[:, :, :n])


def cholesky_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SPD solve a @ x = b, the unfused library path.
    a: (B,N,N), b: (B,N,M)."""
    return torch.linalg.solve(a, b)


def qr_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Least squares min ||a x - b||, full-rank tall a.
    a: (B,M,N), b: (B,M,K) -> (B,N,K)."""
    q, r = torch.linalg.qr(a)            # reduced
    qtb = torch.einsum("bmn,bmk->bnk", q, b)
    return torch.linalg.solve_triangular(r, qtb, upper=True)


def mmse_equalize(h: torch.Tensor, y: torch.Tensor, *,
                  sigma2: float = 0.1) -> torch.Tensor:
    """LMMSE x = (H^T H + s I)^{-1} H^T y.  h: (B,M,N), y: (B,M,K)."""
    n = h.shape[-1]
    g = torch.einsum("bmi,bmj->bij", h, h) \
        + sigma2 * torch.eye(n, dtype=h.dtype, device=h.device)
    rhs = torch.einsum("bmn,bmk->bnk", h, y)
    return torch.linalg.solve(g, rhs)


def mmse_equalize_split(hr: torch.Tensor, hi: torch.Tensor,
                        yr: torch.Tensor, yi: torch.Tensor, *,
                        sigma2: float = 0.1) -> torch.Tensor:
    """Complex-valued LMMSE oracle for the split re/im kernel.

    hr/hi: (B,M,N) channel planes, yr/yi: (B,M,K) observation planes.
    Solves x = (H^H H + s I)^{-1} H^H y in complex64 and returns the
    REAL-STACKED result (B, 2N, K) = [Re x; Im x] — the layout the real
    expansion produces, so split- and expansion-path answers to the same
    complex problem compare element-for-element.
    """
    h = torch.complex(hr, hi)
    y = torch.complex(yr, yi)
    n = h.shape[-1]
    g = torch.einsum("bmi,bmj->bij", h.conj(), h) \
        + sigma2 * torch.eye(n, dtype=h.dtype, device=h.device)
    rhs = torch.einsum("bmn,bmk->bnk", h.conj(), y)
    x = torch.linalg.solve(g, rhs)
    return torch.cat([x.real, x.imag], dim=-2).to(hr.dtype)


def svd_vals(a: torch.Tensor) -> torch.Tensor:
    """Singular values, descending. a: (B, M, N)."""
    return torch.linalg.svdvals(a)


def channel_estimate(xp: torch.Tensor, yp: torch.Tensor, *,
                     ridge: float = 1e-3) -> torch.Tensor:
    """Regularized LS channel estimate from pilots: solve
    (Xp Xp^T + ridge I) Z = Xp Yp^T, H = Z^T.
    xp: (B,N,P) known pilots, yp: (B,M,P) observations -> (B,M,N)."""
    n = xp.shape[-2]
    g = torch.einsum("bnp,bmp->bnm", xp, xp) \
        + ridge * torch.eye(n, dtype=xp.dtype, device=xp.device)
    rhs = torch.einsum("bnp,bmp->bnm", xp, yp)
    return torch.linalg.solve(g, rhs).transpose(-1, -2)


def pusch_chain(xp: torch.Tensor, yp: torch.Tensor, y: torch.Tensor, *,
                ridge: float = 1e-3, sigma2: float = 0.1) -> torch.Tensor:
    """Channel-estimate -> MMSE equalize, the unfused two-stage path.
    xp: (B,N,P), yp: (B,M,P), y: (B,M,K) -> (B,N,K)."""
    return mmse_equalize(channel_estimate(xp, yp, ridge=ridge), y,
                         sigma2=sigma2)


def svd_apply(f: torch.Tensor, b: torch.Tensor, *,
              lam: float = 1e-3) -> torch.Tensor:
    """Pseudo-inverse apply from a packed (B, M+N+1, N) factor buffer
    [U; V; s]: x = V diag(s / (s^2 + lam)) U^T b.  b: (B,M,K)."""
    n = f.shape[-1]
    m = f.shape[-2] - n - 1
    u, v, s = f[:, :m], f[:, m:m + n], f[:, m + n]
    w = torch.einsum("bmn,bmk->bnk", u, b)
    w = (s / (s * s + lam))[:, :, None] * w
    return torch.einsum("bnj,bjk->bnk", v, w)


def ridge_solve(a: torch.Tensor, b: torch.Tensor, *,
                lam: float = 1e-3) -> torch.Tensor:
    """Closed-form ridge regression x = (A^T A + lam I)^{-1} A^T b — the
    factor-free ground truth for the svd_factor -> svd_apply DAG (the
    composition is invariant to SVD sign/order ambiguity)."""
    n = a.shape[-1]
    g = torch.einsum("bmi,bmj->bij", a, a) \
        + lam * torch.eye(n, dtype=a.dtype, device=a.device)
    return torch.linalg.solve(g, torch.einsum("bmn,bmk->bnk", a, b))


def gemm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ y (K, N) accumulated in float32, in x's dtype."""
    return (x.float() @ y.float()).to(x.dtype)


def fir(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Valid-mode correlation-style FIR matching the kernel tap order:
    y[i] = sum_j h[j] * x[i + j].  On a CUDA tensor cuDNN computes it in
    TF32 unless ``torch.backends.cudnn.allow_tf32`` is False."""
    return torch.nn.functional.conv1d(x[None, None], h[None, None])[0, 0]


def fft(x_re: torch.Tensor, x_im: torch.Tensor):
    """Batched complex FFT. (B, N) each -> (re, im)."""
    z = torch.fft.fft(torch.complex(x_re, x_im))
    return z.real.to(x_re.dtype), z.imag.to(x_im.dtype)


def pusch_fft(xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """OFDM demod stage oracle: per-antenna FFT over the last axis,
    packed into stacked planes.  (B, A, NF) re/im -> (B, 2, A, NF)."""
    z = torch.fft.fft(torch.complex(xr, xi))
    return torch.stack([z.real.to(xr.dtype), z.imag.to(xi.dtype)], dim=1)


# ---------------- LM-side kernels ----------------

def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, scale: float | None = None,
        bias: torch.Tensor | None = None) -> torch.Tensor:
    """Reference attention. q: (B,H,S,D), k/v: (B,Hkv,S,D); GQA by head
    replication; float32 softmax, its weights cast to v's dtype."""
    h, s, d = q.shape[1], q.shape[2], q.shape[3]
    hkv = k.shape[1]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    if scale is None:
        scale = 1.0 / d ** 0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if bias is not None:
        logits = logits + bias
    if causal:
        qi = torch.arange(s, device=q.device)[:, None]
        ki = torch.arange(k.shape[2], device=q.device)[None, :]
        logits = torch.where(ki <= qi, logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), v)


def ssm_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, h0: torch.Tensor | None = None):
    """Naive sequential SSD/Mamba2 recurrence (the oracle).

    x: (B, S, H, P); a: (B, S, H) decays in (0, 1]; b/c: (B, S, N) shared
    across heads or (B, S, H, N) per head; h0: (B, H, N, P) initial state
    (zero by default).  Returns y (B, S, H, P) and the final state
    (B, H, N, P): h = a_t h + b_t x_t^T, y_t = c_t h, step by step."""
    bs, s, hh, p = x.shape
    n = b.shape[-1]
    per_head = b.dim() == 4
    h = torch.zeros((bs, hh, n, p), dtype=x.dtype, device=x.device) \
        if h0 is None else h0
    ys = []
    for t in range(s):
        xt, at, bt, ct = x[:, t], a[:, t], b[:, t], c[:, t]
        if per_head:
            h = at[:, :, None, None] * h \
                + torch.einsum("bhn,bhp->bhnp", bt, xt)
            ys.append(torch.einsum("bhn,bhnp->bhp", ct, h))
        else:
            h = at[:, :, None, None] * h \
                + torch.einsum("bn,bhp->bhnp", bt, xt)
            ys.append(torch.einsum("bn,bhnp->bhp", ct, h))
    return torch.stack(ys, dim=1), h
