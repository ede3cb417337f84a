"""Causal flash attention with an inductive kv trip count, K20 — the
flagship LM-side FGOP kernel.

Causal attention's iteration domain is triangular: q tile i attends to kv
tiles 0..i, the paper's RI stream (inner trip = outer iterator + 1); the
diagonal tile's partial mask is implicit vector masking.  The online
softmax's running (m, l, acc), carried across kv tiles, is the ordered
dependence between the score region and the rescale region.  GQA maps
query head h to kv head h // (H / Hkv).

The kernel (``csrc/flash_attention.cu``) runs one CUDA block per (batch,
head, 64 query rows); the reference's sequential kv grid axis is a loop
inside it that stops at the diagonal when causal, with m, l and the
accumulator in registers and each kv tile in shared memory.  It has two
forms, chosen by the dtype:

  * bfloat16: the tensor-core form — ``mma.sync`` bf16 products with
    float32 accumulators, ``ldmatrix`` fragments, kv tiles of 128 rows
    (the reference's, so p is rounded against the same running max)
    loaded by ``cp.async`` ahead of their use, P kept in registers
    between the softmax and P V (``launches_tc`` counts the launches
    that the C entry reports in this form);
  * float32: the SIMT form — IEEE float32 FMAs, kv tiles of min(128, S).

Both keep the reference's numerics: scores and the softmax in float32,
-1e30 (not -inf) on masked scores, l summed from the unrounded p, p
rounded to v's dtype before the P V product, l clamped at 1e-30.  Both
read q, k, v and write the output through element strides (the last
axis contiguous), so the models' (B, S, H, D) tensors go in as
transposed views and the output comes back in their layout, with no
copy.

:func:`flash_attention_plain` follows ``_flash_kernel`` tile by tile
(bq = bkv = min(128, S)) with the batch and heads written out; a CPU
tensor takes it, a CUDA tensor the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.common import CudaKernel, check_tensors

DTYPES = (torch.float32, torch.bfloat16)
NEG_INF = -1e30
MAX_KERNEL_D = 128


def _tiles(q, k, v, causal, bq, bkv):
    """Validate the shapes as the reference asserts them; return the
    tile sizes (bq, bkv) clamped to the sequence lengths."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: expected q (B, H, S, D) and "
                         f"k/v (B, Hkv, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    b, h, sq, d = q.shape
    b2, hkv, skv, d2 = k.shape
    if b2 != b or d2 != d or hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} do not pair (H % Hkv == 0)")
    if causal and sq != skv:
        raise ValueError("flash_attention: the causal path assumes square "
                         f"attention, got Sq = {sq}, Skv = {skv}")
    bq, bkv = min(bq, sq), min(bkv, skv)
    if sq % bq or skv % bkv:
        raise ValueError(f"flash_attention: S must divide by its tile: "
                         f"Sq = {sq} by {bq}, Skv = {skv} by {bkv}")
    return bq, bkv


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          scale: float | None = None, bq: int = 128,
                          bkv: int = 128) -> torch.Tensor:
    """Plain PyTorch version of K20: q (B, H, S, D), k/v (B, Hkv, S, D)
    -> (B, H, S, D) in q's dtype, tile by tile as ``_flash_kernel``."""
    bq, bkv = _tiles(q, k, v, causal, bq, bkv)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    grp = h // k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kr = k.repeat_interleave(grp, dim=1).float()
    vr = v.repeat_interleave(grp, dim=1)
    out = torch.empty_like(q)
    cols = torch.arange(bkv, device=q.device)
    rows = torch.arange(bq, device=q.device)
    for iq in range(sq // bq):
        qt = q[:, :, iq * bq:(iq + 1) * bq].float()
        m = torch.full((b, h, bq, 1), NEG_INF, device=q.device)
        l = torch.zeros((b, h, bq, 1), device=q.device)
        acc = torch.zeros((b, h, bq, d), device=q.device)
        last = iq if causal else skv // bkv - 1
        for ikv in range(last + 1):
            kt = kr[:, :, ikv * bkv:(ikv + 1) * bkv]
            vt = vr[:, :, ikv * bkv:(ikv + 1) * bkv]
            s = (qt @ kt.transpose(-1, -2)) * scale
            if causal:
                live = (ikv * bkv + cols)[None, :] <= (iq * bq
                                                      + rows)[:, None]
                s = torch.where(live, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            m = m_new
            acc = acc * corr + p.to(v.dtype).float() @ vt.float()
        out[:, :, iq * bq:(iq + 1) * bq] = (
            acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out


_KERNEL = CudaKernel(
    "flash_attention", "flash_attention_run",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_int] + [ctypes.c_longlong] * 12
    + [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
    "flash_attention_smem", 2,
    source="src/repro_torch/csrc/flash_attention.cu",
    replaces="src/repro/kernels/attention.py:81 flash_attention_pallas")


def _row_align(t: torch.Tensor) -> int:
    """The widest copy, 16, 8 or the element's bytes, that t's pointer,
    row length and batch, head and row strides all allow."""
    el = t.element_size()
    offsets = [t.data_ptr(), t.shape[-1] * el] + [
        st * el for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
    return next((w for w in (16, 8) if all(o % w == 0 for o in offsets)),
                el)


def _strides(t: torch.Tensor) -> tuple:
    """t's batch, head and row strides in elements (0 on an axis of
    length 1)."""
    return tuple(st if n > 1 else 0
                 for st, n in zip(t.stride()[:3], t.shape[:3]))


def flash_attention_fused(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          scale: float | None = None, bq: int = 128,
                          bkv: int = 128) -> torch.Tensor:
    """q (B, H, S, D), k/v (B, Hkv, S, D), all float32 or all bfloat16 on
    one device -> (B, H, S, D) in q's dtype and, where q is dense, q's
    layout.  ``causal`` needs Sq == Skv; each S must divide by its tile
    min(128, S).  K20 on a CUDA tensor (one launch; D <= 128 with D % 4
    == 0): the tensor-core form for bfloat16, the SIMT form for float32;
    its plain version on a CPU one.  Views are read through their
    strides; a tensor whose last axis is not contiguous (or, in bfloat16,
    whose rows are not 8-byte aligned) is copied first."""
    dev = check_tensors("flash_attention", q, k, v, dtypes=DTYPES,
                        contiguous=False)
    _, bkv = _tiles(q, k, v, causal, bq, bkv)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     bq=bq, bkv=bkv)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d > MAX_KERNEL_D or d % 4:
        raise ValueError(f"flash_attention: the kernel takes D <= "
                         f"{MAX_KERNEL_D} with D % 4 == 0, got D = {d}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    bf16 = q.dtype == torch.bfloat16
    q, k, v = (t.clone(memory_format=torch.contiguous_format)
               if t.stride(-1) != 1 or (bf16 and _row_align(t) < 8) else t
               for t in (q, k, v))
    out = torch.empty_like(q)
    if q.numel():
        vec16 = all(_row_align(t) == 16 for t in (q, k, v, out))
        tc = ctypes.c_int(-1)           # the form the C entry launched
        _KERNEL.launch(dev, (d, int(bf16)), q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), out.data_ptr(), b, h, hkv, sq, skv, d,
                       bkv, int(causal), float(scale), int(bf16),
                       *_strides(q), *_strides(k), *_strides(v),
                       *_strides(out), int(vec16), ctypes.byref(tc))
        if tc.value == 1:
            _KERNEL.launches_tc += 1
    return out
