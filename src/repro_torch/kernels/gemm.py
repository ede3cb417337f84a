"""Blocked GEMM, the paper's non-FGOP baseline workload (rectangular
streams), K18: (M, K) @ (K, N) -> (M, N) in x's dtype, accumulated in
float32 over the sequential k axis.

The kernel (``csrc/gemm.cu``) has two forms, picked by the dtype:

  * bfloat16 runs on the tensor cores: ``wgmma`` fed by TMA tile loads,
    128 x 256 output tiles (128 x 128 where those leave SMs idle:
    :func:`tc_tile`).  TMA needs K % 8 == 0, N % 8 == 0 and 16-byte
    aligned x and y; :func:`tc_operands` zero-pads copies of any other
    operands (chosen from the shapes and pointers alone), and the kernel
    writes the answer at its own width N;
  * float32 stays IEEE on the SIMT FMA pipes (no TF32, which would break
    the spec's rtol of 1e-4), at 128 x 128 or 64 x 64 output tiles
    (:func:`simt_tile`), k tiles 16 deep, every edge masked.

``CudaKernel.launches_tc`` counts the launches the C entry reports in the
tensor-core form.  :func:`repro_torch.kernels.ops.gemm` pads as the
reference's ``ops.gemm`` does all the same.

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


# SMs of an H100 SXM: the float32 form takes its larger tile only where
# that gives every SM a CTA
H100_SMS = 132
TC_ALIGN = 8        # bf16 elements in TMA's 16-byte stride and base unit


def simt_tile(m: int, n: int, sms: int = H100_SMS) -> int:
    """The float32 form's square output tile: 128 where 128 x 128 tiles
    give at least ``sms`` CTAs, else 64 (more, smaller CTAs)."""
    return 128 if -(-m // 128) * -(-n // 128) >= sms else 64


def tc_tile(m: int, n: int, sms: int = H100_SMS) -> int:
    """The bf16 form's output tile columns (its rows are 128): 256 where
    128 x 256 tiles give at least ``sms`` CTAs, else 128."""
    return 256 if -(-m // 128) * -(-n // 256) >= sms else 128


def tc_operands(x: torch.Tensor, y: torch.Tensor):
    """x (M, K) and y (K, N) as the tensor-core form takes them: K and
    y's row length multiples of :data:`TC_ALIGN` (K at least that) and
    both base pointers 16-byte aligned (TMA's rules).  An operand that
    breaks one comes back as a zero-padded copy; the product of the two
    has the answer in its first N columns.  Chosen from the shapes and
    pointers alone."""
    k, n = y.shape
    kp, np_ = (max(TC_ALIGN, -(-v // TC_ALIGN) * TC_ALIGN) for v in (k, n))
    pad = torch.nn.functional.pad       # always a new, aligned tensor
    if kp != k or x.data_ptr() % 16:
        x = pad(x, (0, kp - k))
    if (kp, np_) != (k, n) or y.data_ptr() % 16:
        y = pad(y, (0, np_ - n, 0, kp - k))
    return x, y


_KERNEL = CudaKernel(
    "gemm", "gemm_run",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
    + [ctypes.POINTER(ctypes.c_int)],
    "gemm_smem", 2,
    source="src/repro_torch/csrc/gemm.cu",
    replaces="src/repro/kernels/gemm.py:34 gemm_pallas")


def gemm_fused(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ y (K, N) -> (M, N): both float32 or both bfloat16,
    contiguous, on one device.  K18 on a CUDA tensor (one launch): the
    tensor-core form for bfloat16, the SIMT form for float32; its plain
    version on a CPU one."""
    dev = check_tensors("gemm", x, y, dtypes=DTYPES)
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"gemm: expected (M, K) @ (K, N), got "
                         f"{tuple(x.shape)} @ {tuple(y.shape)}")
    if dev.type == "cpu":
        return gemm_plain(x, y)
    m, n = x.shape[0], y.shape[1]
    if not (m and n):
        return torch.empty((m, n), dtype=x.dtype, device=dev)
    bf16 = x.dtype == torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if bf16:
        x, y = tc_operands(x, y)
        tile = tc_tile(m, n, sms)
    else:
        tile = simt_tile(m, n, sms)
    k, ldy = y.shape
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    tc = ctypes.c_int(-1)               # the form the C entry launched
    _KERNEL.launch(dev, (int(bf16), tile), x.data_ptr(), y.data_ptr(),
                   out.data_ptr(), m, n, k, ldy, int(bf16), tile,
                   ctypes.byref(tc))
    if tc.value == 1:
        _KERNEL.launches_tc += 1
    return out
