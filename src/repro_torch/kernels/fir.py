"""Centro-symmetric FIR (paper's Centro-FIR workload), K19.

Exploits h[j] == h[m-1-j]: each tap pair shares one multiply,
y[i] = sum_{j<m/2} h[j]*(x[i+j] + x[i+m-1-j]) (+ the middle tap if m is
odd), halving multiplies exactly as the paper's ASIC model assumes.
Valid mode: x (N,), h (m,) -> y (N - m + 1,), the correlation
y[i] = sum_j h[j] x[i+j] of ``ref.fir`` when h is symmetric.

The kernel (``csrc/fir.cu``) runs one CUDA block per 256-output tile,
which stages its overlapping input window in shared memory and masks the
ragged last tile itself, so no caller pads.  It keeps the reference's
tap order and rounds every sum and product separately, as
:func:`fir_plain` does; a CPU tensor takes the plain version, a CUDA
tensor the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import CudaKernel, check_f32


def fir_plain(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K19: x (N,), h (m,) -> y (N - m + 1,)."""
    m = h.shape[0]
    out = x.shape[0] - m + 1
    half = m // 2
    acc = torch.zeros(out, dtype=torch.float32, device=x.device)
    for j in range(half):
        # paired taps: one multiply for two symmetric positions
        acc = acc + h[j] * (x[j:j + out] + x[m - 1 - j:m - 1 - j + out])
    if m % 2 == 1:
        acc = acc + h[half] * x[half:half + out]
    return acc


_KERNEL = CudaKernel(
    "fir", "fir_f32",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2,
    "fir_smem", 1,
    source="src/repro_torch/csrc/fir.cu",
    replaces="src/repro/kernels/fir.py:42 fir_pallas")


def fir_fused(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Valid-mode centro-symmetric FIR: x (N,), h (m,) symmetric, float32
    and contiguous, m <= N -> y (N - m + 1,).  K19 on a CUDA tensor (one
    launch, a block per 256 outputs), its plain version on a CPU one."""
    dev = check_f32("fir", x, h)
    if x.dim() != 1 or h.dim() != 1 or not 1 <= h.shape[0] <= x.shape[0]:
        raise ValueError(f"fir: expected x (N,) and h (m,) with 1 <= m <= "
                         f"N, got {tuple(x.shape)}, {tuple(h.shape)}")
    if dev.type == "cpu":
        return fir_plain(x, h)
    n, m = x.shape[0], h.shape[0]
    y = torch.empty(n - m + 1, dtype=torch.float32, device=dev)
    _KERNEL.launch(dev, (m,), x.data_ptr(), h.data_ptr(), y.data_ptr(), n,
                   m)
    return y
