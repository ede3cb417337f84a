"""Blocked GEMM, the paper's non-FGOP baseline workload (rectangular
streams), K18: (M, K) @ (K, N) -> (M, N) in x's dtype, accumulated in
float32 over the sequential k axis.

The kernel (``csrc/gemm.cu``) runs one CUDA block per 128 x 128 output
tile and loops over k inside it, staging 8-deep k tiles in shared memory;
float32 products are IEEE FMAs (no TF32, which would break the spec's
rtol of 1e-4), bfloat16 ones are widened to float32.  It masks every
edge, so it takes any M, N, K; :func:`repro_torch.kernels.ops.gemm` pads
as the reference's ``ops.gemm`` does all the same.

:func:`gemm_plain` follows the reference's ``_gemm_kernel``: a float32
accumulator summed over 128-deep k tiles, rounded once to x's dtype.  A
CPU tensor takes it, a CUDA tensor the kernel.  The models' own products
(``x @ w``) stay ``torch.matmul``, as the reference leaves them to XLA.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import CudaKernel, check_tensors

DTYPES = (torch.float32, torch.bfloat16)


def gemm_plain(x: torch.Tensor, y: torch.Tensor, *,
               bk: int = 128) -> torch.Tensor:
    """Plain PyTorch version of K18: x (M, K) @ y (K, N) -> (M, N) in x's
    dtype, a float32 accumulator summed over k tiles of ``bk``."""
    m, k = x.shape
    acc = torch.zeros((m, y.shape[1]), dtype=torch.float32, device=x.device)
    for k0 in range(0, k, bk):
        acc += x[:, k0:k0 + bk].float() @ y[k0:k0 + bk].float()
    return acc.to(x.dtype)


_KERNEL = CudaKernel(
    "gemm", "gemm_run",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4,
    "gemm_smem", 1,
    source="src/repro_torch/csrc/gemm.cu",
    replaces="src/repro/kernels/gemm.py:34 gemm_pallas")


def gemm_fused(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ y (K, N) -> (M, N): both float32 or both bfloat16,
    contiguous, on one device.  K18 on a CUDA tensor (one launch), its
    plain version on a CPU one."""
    dev = check_tensors("gemm", x, y, dtypes=DTYPES)
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"gemm: expected (M, K) @ (K, N), got "
                         f"{tuple(x.shape)} @ {tuple(y.shape)}")
    if dev.type == "cpu":
        return gemm_plain(x, y)
    m, k = x.shape
    n = y.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m and n:
        _KERNEL.launch(dev, (k,), x.data_ptr(), y.data_ptr(),
                       out.data_ptr(), m, n, k,
                       int(x.dtype == torch.bfloat16))
    return out
