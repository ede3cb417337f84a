"""The warp forms of K2, K3, K5 and K6 (``csrc/warp_chain.cuh``): a lane
on one warp, a CTA of 32 threads, with no block barrier.

Their plan is a form: ``"warp"`` where the lane fits the warp chain (up
to 64 rows, 8 right-hand sides held in registers, a CTA's 227 KB of
shared memory), ``"cta"`` (a lane on a 128-thread CTA) past it (K2 has a
third, its wide form, ``pipelines/mmse.py`` ``mmse_form``).  Every form
gives the same bits.  A CTA holds one lane: more lanes a CTA gained
nothing on an H100 (PERF.md §6).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

WARP_MAX_ROWS = 64           # rows of a lane's system, two a thread
WARP_MAX_RHS = 8             # right-hand sides held in registers
FORMS = ("warp", "cta")
LANE_PHASES = ("load", "gram", "factor", "back", "gram2", "factor2",
               "back2", "store")
"""The phases a stamped K2, K3, K5 or K6 lane is split into (``LanePhase``
in ``csrc/phase_clock.cuh``): the load; the Gram and matched filter (K5,
K6: the pilot Gram and cross product); the factor with its forward
substitution (K2's wide form: with L and y written out); the back
substitution; K6's second chain (its Gram of H and matched filter,
factor, back substitution); the store.  K2, K3 and K5 leave the second
chain's phases at 0."""


def warp_pitch(rows: int) -> int:
    """The row pitch of a warp form's system (``warp_pitch`` in
    ``csrc/warp_chain.cuh``): a multiple of 4 past rows + 3, 4 modulo 8."""
    return -(-rows // 8) * 8 + 4


def warp_scratch_floats(rows: int, nrhs: int) -> int:
    """The warp chain's scratch (``warp_scratch_floats``): two raw columns
    of round4(rows) + 4 floats, two pivots, two solution rows."""
    return 2 * (-(-rows // 4) * 4 + 4) + 2 + 2 * nrhs


def warp_fits(lane_bytes: int) -> bool:
    """Whether a warp form's lane of ``lane_bytes`` fits a CTA's 227 KB."""
    return lane_bytes <= common.MAX_SMEM_BYTES


def warp_plan(name: str, fits: bool, form: str | None, limits: str) -> str:
    """The form of a K3, K5 or K6 lane in shared memory: ``"warp"`` where the
    warp form ``fits``, ``"cta"`` past it.  ``form`` asks for one; a form
    off :data:`FORMS`, or ``"warp"`` past the form's ``limits``, raises
    ValueError (on every device)."""
    if form not in (None,) + FORMS:
        raise ValueError(f"{name}: form {form!r}, not one of {FORMS}")
    if form == "warp" and not fits:
        raise ValueError(f"{name}: no warp form ({limits})")
    return form or ("warp" if fits else "cta")


def launch_phases(symbol: str, dev: torch.device, tensors: list, ints: list,
                  floats: list) -> None:
    """Launch a warp form's phase-stamped entry ``symbol(pointers...,
    ints..., floats..., stream)`` on ``dev``'s current stream."""
    lib = common.load_library()
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * len(tensors)
                   + [ctypes.c_int] * len(ints)
                   + [ctypes.c_float] * len(floats) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in tensors), *ints, *floats,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{symbol}: phase-stamped launch failed: {msg}")
