#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (compute capability 9.0) and the CUDA
toolkit's ``nvcc``; exits non-zero without a result line otherwise.
Phases, each fatal on failure:

  1. device  — the card's name and power limit (nvidia-smi), TF32 off;
  2. build   — every kernel in src/repro_torch/csrc built from source;
               K7's plan at each size (threads a row, points a thread,
               stages a pass, rows a CTA, staged batches a warp, shared
               memory) and its instance's -Xptxas -v registers and
               spills; the plan of each K1-K4 global row (threads,
               panel width, K4's tile width, shared memory) and the
               -Xptxas -v registers and spills of the global instances
               the plans run, and of K16's warp form; K11's and K13's
               instances' registers and the cluster plan (CTAs a lane,
               threads, shared memory, panel in shared memory) of every
               shape and batch the script launches them at, each beside
               cudaOccupancyMaxActiveClusters; the same of K10, K12 and
               K14 (CTAs a lane, threads, shared memory, product tile);
  3. kernels — K1-K21 held against their plain PyTorch versions
               and the oracles at the registry sizes, at a slot's real width
               (B = 3276 lanes: one 100 MHz carrier at 30 kHz SCS, 273
               PRBs x 12 subcarriers, 3GPP TS 38.101-1 Table 5.3.2-1;
               the FFT over 3276 (n + 4) antenna rows of 64 points and
               3276 rows of 1024) and on the guard cases (poisoned upper
               triangle, singular and rank-deficient lanes, filler lanes,
               a unit impulse); K7 equal to its plain version bit for bit
               at the PUSCH DAG's shape in the stacked layout (3276 x 36
               rows of 64), at 3276 rows of 1024, of 4096 (the carrier's
               OFDM size, K7's wide route) and of 2.  The SVD is held by
               sorted spectrum and
               reconstruction, its factors being sign/order ambiguous;
               K8 under every plan of svd_forms (each group size, rows
               held in registers or read again) bit for bit at the
               served shapes, 64 lanes of n = 32 and an odd n = 13, on
               zero, rank-2 and NaN lanes, each lane alone its bits in
               the batch and svd_factor svd's bits.
               The mid-range path: the blocked K10/K11 at n = 128 and
               256 with both panel widths at B = 3276, and K1-K4 on lanes
               past shared memory (their global form, K3 also at n =
               512 as the HBM-scale mix sends it, K1 at n = 1024 as the
               demoted 1024 bucket sends it); where both forms fit
               (K1 at n = 97, 128, 200, K2 at 100, 128, K3 at 90, 96,
               K4 at 128), the shared form against the plain version
               and the global form equal to it bit for bit, and K1's
               global form at n = 200 at panel widths 1, 8, 16, 32 and
               64 on lanes with a rank-deficient pivot inside a later
               panel and NaN in the upper triangle, each equal to the
               shared form bit for bit; K4's global form at 132 x 128
               and 204 x 200 at panel widths 1, 8, 16, 32 and its
               plan's own on lanes with a duplicated column inside a
               later panel, an exact zero column and a NaN, each equal
               to the shared form bit for bit, the lanes beside the NaN
               equal to their clean batch's; K10/K11 at panel
               widths that are not multiples of 32 (bs = 16 at n = 128,
               48 at n = 192).  K10 on the tiled core's clusters: at n =
               128 and 256 (bs = 64), 128 (bs = 32, 16) and 192 (bs =
               48) every form of its plan (each cluster size and product
               tile) gives C = 1's answer bit for bit, within rtol of the
               plain version, on a lane with a deficient pivot and a lane
               with NaN above the diagonal (its clean lane's answer), and
               one right-hand side solved alone gives its bits inside
               the pair.  K11 and K13 on thread-block clusters: at
               516 x 512, 1028 x 1024 and 2052 x 512 (K13, bs = 128) and
               132 x 128, 260 x 256 and 160 x 128 (K11, bs = 16, 32, 64)
               every form the cluster plan may take (each cluster size,
               the panel's bands in shared memory where they fit and in
               the device work buffer) gives one answer bit for bit,
               within rtol of the plain version, on lanes with a
               duplicated column, a zero column (its component zeroed)
               and a NaN (the lanes beside it their clean batch's).  The
               HBM-scale path: the tiled K12-K14 at
               n = 512 (B = 3276) and n = 1024 (B = 264, a carrier's
               width at that size would not fit the card's memory beside
               its plain version) at bs = 128, and their guard cases.
               The primitives: K15-K17 (K16 forward and backward) at the
               registry sizes, at B = 3276 (n = 8, 16, 32; m = n + 4 for
               K17, two right-hand sides for K16) and on one lane past
               shared memory (n = 256, m = 260: the global form), their
               global form equal to the shared one bit for bit at n = 32;
               K16's warp form (a warp a lane, n <= 32, m <= 8) equal to
               its CTA form bit for bit at n = 1, 7, 8, 16, 31, 32 and m
               = 1, 2, 3, 8, both directions, NaN in the unread triangle
               never leaking; K2's, K3's, K5's and K6's warp forms (a
               lane on a warp, n <= 32) equal to their CTA forms (the
               one-CTA kernels of earlier slices) bit for bit at the slot
               mixes' and DAGs' sizes at B = 3276 and at the
               served widths (K2 n = 8, 12 on 8 lanes, 16, 24, 32 on 32,
               8 on 4; K3 n = 8, 16, 32 on 32 lanes; K5 and K6 n = 8 on 4
               lanes, n = 24 on 32) with a deficient, a zero and a NaN
               lane, each call one launch of the form it names, and held
               to their plain versions and oracles at the served widths
               too (and timed there); K2's wide form (a lane on a CTA of
               its plan's W warps, 32 < n <= 168) equal to its CTA form
               bit for bit at n = 33, 64, 97, 128 (on 32 and 300 lanes),
               168, and on the mid-range mix's 32 lanes held to its plain
               version and oracle within 1e-4;
               K19 at 61,440 outputs (one 0.5 ms slot of one antenna at
               122.88 Msps) with 31 and 65 taps; guard cases (NaN in the
               unread triangle of K15 and K16, m = n + 1 and m = 1 for
               K17, even and odd taps and ragged tiles for K19); K17 on a
               wide 4 x 6 matrix and K1 on bf16 (the reference's case).
               The LM kernels: K18 (GEMM) at the registry's squares and
               through ops.gemm at 1000 x 300 @ 300 x 700, 129 x 257 @
               257 x 65, 1 x 1 and in bf16, and in bf16 at 129 x 257 x
               65, 1 x 1 x 1, 100 x 13 x 50, 64 x 64 x 60 (K or N not a
               multiple of 8: the padded route), 1 x 4096 x 256, 4096 x
               64 x 4096, 2048^3 and 4096^3 (M x K x N), element by
               element against the plain version and the float32 oracle
               within a bf16 step and a float32 sum-order term
               (GEMM_BF16_STEP, GEMM_BF16_SUM), 4096^3 twice bit for bit;
               every float32 launch in its SIMT form and every bf16 one in
               its tensor-core form, as the C entry reports (here, in the
               ops path and in the timings); K20 (flash attention) at the
               registry case and at D = 4, 8, 12, 64, 80, 128 by S = 5,
               96, 100, 128, 512 (ragged q and kv tiles), causal and not,
               float32 (the SIMT form) and bf16 (the tensor-core form),
               GQA 24/8 at D = 128, 4/2 otherwise, and at phi4-mini's
               prefill shape (4, 24, 512, 128), on peaked scores with a
               large one planted in the last kv tile (``attn_case``),
               element by element against the plain version and the
               float32 oracle within what p's rounding allows
               (``ATTN_RTOLS``), and at zamba2-2.7b's prefill shape (4,
               32, 512, 80); ``ops.flash_attention`` on the models'
               (B, S, H, D) tensors as transposed views (read through
               strides, answered in their layout) at both prefill shapes
               and a ragged one, float32 and bf16, held the same way and
               equal bit for bit to the kernel on contiguous copies; K21 (the
               chunked SSD scan) at the registry case, zamba2-2.7b's
               prefill shape (x (4, 32, 512, 160), B/C (4, 512, 64)
               shared, chunk 128), xlstm-125m's (v_aug (4, 4, 512, 385),
               B/C (4, 4, 512, 192) per head, chunk 64), S < chunk,
               decays of 1 and 0 and 16 chunks at chunk 128, float32 and
               bf16, against its plain version and the sequential oracle,
               and every cluster form ``ssm_check_forms`` holds (each
               cluster size the plan can pick, the narrowest lane) bit
               for bit the plan's (its plans and each instance's
               registers printed after the build); guards: S = 200, a
               mismatched K, S not dividing by K21's chunk and a chunk
               past 128 must raise;
  4. serve   — the main paths, each with every kernel's launch count
               reset before and read after: the TTI slot mix
               (``repro_torch.launch.serve_solvers.main`` on two mixes and
               the committed overload trace replayed to its golden file),
               the served DAGs (``main --pusch`` staged with the
               committed fault trace and chained, at n = 8 and at n = 24
               with 32 lanes over 8 ticks, and the committed PUSCH trace
               replayed to its golden file) and the mid-range slot mix
               (``main --sizes 128,256``, with and without the overload
               policy: K10, K11, K2's wide form and the global forms of
               K2 and K3) and
               the HBM-scale slot mix (``main --sizes 512 --slots 4
               --lanes 32``, with and without the policy: K12, K13, K14
               and the global form of K3); the DSP receiver chain
               (``repro_torch.launch.dsp_pipeline.main`` at its defaults
               and at ``--batch 3276 --samples 61470``: exactly K15 1,
               K16 2, K7 1, K19 1, K8 1) and the unfused baselines
               (``cholesky_solve_unfused``, ``qr_solve_unfused``,
               ``mmse_equalize_composed`` at B = 3276, n = 8, 16, 32:
               their primitive launches only, each equal to its fused
               kernel within the reference's tolerance); the primitive
               API of the LM kernels (``ops.gemm``, ``ops.flash_attention``:
               exactly K18 4, K20 1); the committed decode trace through
               the port's mux replayed to ``decode_golden.json`` and
               ``serve_solvers --decode`` (K2 serves the solver jobs);
               K2's launches on each path split by form (warp, wide, CTA,
               global), its warp form required on the TTI mix, the DAGs
               and the decode golden, its wide form on the mid-range mix,
               K5's warp form on the DAGs;
               the LM serving paths at full width (``lm_path``, run at
               the start of phase 5 so that they are timed there),
               phi4-mini-3.8b, zamba2-2.7b and xlstm-125m, each from its
               float32 weights with one bf16 copy kept: prefill with
               ``attn_impl="flash"`` on 4 prompts of 512 and of 128
               tokens (exactly K20 32 a call for phi4-mini; K21 54 and
               K20 6 for zamba2; K21 9 for xLSTM; every K20 launch of a
               bf16 prefill in the tensor-core form, none of a float32
               one), finite logits equal to
               ``attn_impl="xla"``'s where there is attention, each K20
               launch of a bf16 prefill held to its plain version on its
               inputs and the prefill with the plain version in K20's
               place (``attn_witness``), the 128 tokens decoded one by
               one against the prefill (float32 and bf16, argmax in
               both), and ``repro_torch.launch.serve --full`` (8
               requests through a mux of 4 slots, so slots are reused,
               each greedy output the same when served again alone on
               the same weights);
  5. times   — each kernel at B = 3276 timed with CUDA events (cold L2)
               beside its bound, its plain version and, where one PyTorch
               call computes the same function, that call (K7's rows
               also print the share of 3.35 TB/s each reaches); the blocked
               kernels and the global forms at n = 128 and 256, K2's
               shared (wide) form at n = 128 at B = 3276 and on the
               mid-range mix's 32 lanes, and the tiled kernels at n = 512
               (B = 3276) and 1024 (B = 264), the blocked kernels at n =
               128 and 256 and the tiled ones at n = 512 also at the 32
               lanes the slot mixes serve (K10-K14's rows with their
               cluster plans); K15-K17 at B = 3276 (K16
               forward and backward) and K19 at 61,440 outputs.  The
               median of 30 calls, or of 5 where one call passes 250 ms
               (``reps`` on the row).  The fusion block: at B = 3276 and
               n = 8, 16, 32 the wall of each unfused chain (events
               around the whole chain, its copies and library products
               included) beside its fused kernel (K1, K4, K2).  K18 at
               64^3, 128^3, 1000 x 300 x 700 (float32 and bf16) and 4096^3
               (bf16 and float32), beside torch.matmul with TF32 off;
               K20 at the registry case and phi4-mini's and zamba2's
               prefill shapes (beside scaled_dot_product_attention with
               the KV heads repeated, the SM clock printed beside each
               row);
               K21 at xlstm-125m's and zamba2-2.7b's prefill shapes at
               S = 128 and 512 in bf16 (no PyTorch call computes the
               scan), each row with its plan;
               the full-width prefill and decode step as wall time over a
               window of calls (the path is host-bound), and the kernels
               the card runs for each and its busy time by torch.profiler.

The lines before the last are the ``{"fusion": [...]}``, ``{"lm": {...}}``
and ``{"kernels": [...]}`` JSON lines and the card's name and power limit;
the last line is ``{"ok": true, "device": {...}}``.
"""
import contextlib
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

LANES = 3276                 # one 100 MHz carrier at 30 kHz SCS
# the lanes the mid-range and HBM-scale slot mixes serve (--lanes 32): the
# blocked and tiled kernels are timed there too, beside a carrier's width
SERVED_LANES = 32
SLOT_SIZES = (8, 16, 32)
MID_SIZES = (128, 256)       # the blocked registry sizes (n % 32 == 0)
# (n, lanes): the tiled registry sizes; at n = 1024 a lane is 4 MB of A
# and 4 MB of work buffer, and the plain version's temporaries several
# times that, so 264 lanes (two CTAs on each of the 132 SMs)
TILED_CASES = ((512, LANES), (1024, 264))
TILED_BS = 128
# (kernel, n, bs): K10/K11 at panel widths that are not multiples of 32
ODD_WIDTHS = ((128, 16), (192, 48))
SLOW_MS = 250.0              # past this a timing row takes 5 calls, not 30
CHECK_LANES = 512            # lanes of the past-shared-memory checks
# (kernel, n, m or None for n + 4): K1-K4 lanes past shared memory, which
# run the global form -- K2 and K3 as the mid-range mix sends them, K3 at
# n = 512 (a 2n = 1024 system) as the HBM-scale mix sends it, K1 and K4
# at sizes that are not multiples of 32 (so not blocked)
GLOBAL_CASES = (("cholesky_solve", 250, None), ("mmse_equalize", 256, None),
                ("mmse_equalize_split", 128, None),
                ("mmse_equalize_split", 256, None),
                ("mmse_equalize_split", 512, None), ("qr_solve", 250, 254))
NFFT = 64                    # the PUSCH DAG's OFDM size
NFFT_MAX = 1024              # the largest registered FFT size
NFFT_CARRIER = 4096          # 100 MHz at 30 kHz SCS: NR's OFDM size
SWEEPS = 14                  # Jacobi sweeps of the served svd_factor stage
PEAK_F32_FLOPS = 67e12       # H100 SXM, float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12     # H100 SXM HBM3
RTOL = 1e-4                  # the solver specs' rtol
SVD_RTOL = 4.0 * (2.0 ** -23) ** 0.5   # 4 sqrt(eps_f32), the SVD specs'
RTOLS = {"fft": 1e-3, "pusch_fft": 1e-3, "svd": SVD_RTOL,
         "svd_factor": SVD_RTOL, "qr_solve_blocked": 1e-3,
         "qr_solve_tiled": 2e-3, "mmse_equalize_tiled": 2e-3,
         "trisolve": 1e-3, "trisolve_upper": 1e-3,
         "flash_attention": 1e-3, "flash_attention_full": 1e-3}
# At n >= 128 the reference holds blocked Cholesky to 1e-3 against the
# oracle and blocked QR to 1e-3 (tests/test_variants.py).  The MMSE Gram
# H^T H + 0.1 I at m = n + 4 has condition ~9.4e3 at n = 256, and fp32
# solves differ from float64 by ~1.5e-4 there, so MMSE at n >= 128 is
# held to 1e-3, the serving spot check's tolerance.
MID_RTOL = 1e-3
# At n >= 512 the reference holds every tiled pipeline to 2e-3 against
# the oracle (tests/test_tiled.py::test_tiled_matches_oracle_large); the
# tiled checks also print each answer's distance to a float64 solve.
TILED_RTOL = 2e-3
ORACLE_RTOLS = {"ssm_scan": 1e-3, "ops_ssm_scan": 1e-3,
                "cholesky_solve_blocked": MID_RTOL,
                "qr_solve_blocked": MID_RTOL,
                "cholesky_solve_tiled": TILED_RTOL,
                "qr_solve_tiled": TILED_RTOL,
                "mmse_equalize_tiled": TILED_RTOL}
# check key -> the kernel it runs (stage adapters run a kernel of their own)
KERNEL_OF = {"pusch_fft": "fft", "svd_factor": "svd",
             "trisolve_upper": "trisolve", "ops_gemm": "gemm",
             "ops_ssm_scan": "ssm_scan",
             "flash_attention_full": "flash_attention",
             "ops_flash_attention": "flash_attention"}
# (check key, registry spec, variant): the registry cases each kernel is
# held to
REGISTRY_CHECKS = (
    ("cholesky", "cholesky", "base"), ("trisolve", "trisolve", "base"),
    ("qr", "qr", "base"), ("fir", "fir", "base"),
    ("svd", "svd", "base"), ("fft", "fft", "base"),
    ("gemm", "gemm", "base"), ("flash_attention", "flash_attention", "base"),
    ("cholesky_solve", "cholesky_solve", "base"),
    ("cholesky_solve_blocked", "cholesky_solve", "blocked"),
    ("qr_solve", "qr_solve", "base"),
    ("qr_solve_blocked", "qr_solve", "blocked"),
    ("cholesky_solve_tiled", "cholesky_solve", "tiled"),
    ("qr_solve_tiled", "qr_solve", "tiled"),
    ("mmse_equalize_tiled", "mmse_equalize", "tiled"),
    ("mmse_equalize", "mmse_equalize", "base"),
    ("mmse_equalize_split", "mmse_equalize", "split_complex"),
    ("pusch_fft", "pusch_fft", "base"),
    ("channel_estimate", "pusch_chanest", "base"),
    ("pusch_chain", "pusch_chain", "base"),
    ("svd_factor", "svd_factor", "base"),
    ("svd_apply", "svd_apply", "base"))
# check keys held at B = LANES lanes of each of SLOT_SIZES
SLOT_KEYS = ("cholesky_solve", "mmse_equalize", "mmse_equalize_split",
             "qr_solve", "channel_estimate", "pusch_chain", "pusch_fft",
             "svd", "svd_factor", "svd_apply", "cholesky", "trisolve",
             "trisolve_upper", "qr")
# K19 at full width: one 0.5 ms slot of one antenna at 122.88 Msps (the
# sampling rate of a 100 MHz carrier) is 61,440 outputs, at the DSP
# chain's 31 taps and at 65
FIR_OUTPUTS = 61440
FIR_TAPS = (31, 65)
# the unfused baselines, their fused kernels and the reference's
# fused-vs-unfused tolerances (tests/test_pipelines.py)
BASELINES = (("cholesky_solve", "cholesky_solve_unfused", 1e-4),
             ("qr_solve", "qr_solve_unfused", 1e-3),
             ("mmse_equalize", "mmse_equalize_composed", 1e-4))
BASELINE_LAUNCHES = {"cholesky_solve": {"cholesky": 1, "trisolve": 2},
                     "qr_solve": {"qr": 1, "trisolve": 1},
                     "mmse_equalize": {"cholesky": 1, "trisolve": 2}}
DSP_LAUNCHES = {"cholesky": 1, "trisolve": 2, "fft": 1, "fir": 1, "svd": 1}
# kernel -> its mid-range and HBM-scale timing rows: (n, m or None for
# n + 4, the form a two-form kernel must run, lanes); K2 at n = 128 is
# the shared (wide) form the mid-range mix runs on its 32 lanes beside
# its global form at n = 256; K1 at n = 1024 is the demoted 1024 bucket's rung and K3 at n = 512
# the HBM-scale mix's split-complex jobs, at B = 264 as TILED_CASES
MID_TIMES = {"cholesky_solve": ((250, None, "global", LANES),
                                (1024, None, "global", 264)),
             "cholesky_solve_blocked": ((128, None, None, SERVED_LANES),
                                        (256, None, None, SERVED_LANES),
                                        (128, None, None, LANES),
                                        (256, None, None, LANES)),
             "mmse_equalize": ((128, None, "shared", LANES),
                               (128, None, "shared", SERVED_LANES),
                               (256, None, "global", LANES)),
             "mmse_equalize_split": ((128, None, "global", LANES),
                                     (256, None, "global", LANES),
                                     (512, None, "global", 264)),
             "qr_solve": ((250, 254, "global", LANES),
                          (1024, 1028, "global", 264)),
             "qr_solve_blocked": ((128, None, None, SERVED_LANES),
                                  (256, None, None, SERVED_LANES),
                                  (128, None, None, LANES),
                                  (256, None, None, LANES))}
# The cases of K1-K3's panel chain (their global form), whose inputs come
# from a generator of their own so that every other check keeps its
# inputs: K1 past shared memory at n = 1024 (a demoted 1024 tiled
# bucket's rung); sizes where both forms fit that no panel width tiles (K1
# at 97 and 200, K2 at 100, K3 at 90: a 180 x 180 system), the global form
# bit for bit the shared one; K1's global form at n = 200 at each panel
# width (ragged last panels at 8 and 16; 1 is the per-column chain) on
# deficient and poisoned lanes
PANEL_GLOBAL_CASES = (("cholesky_solve", 1024, None),)
PANEL_BIT_SIZES = (("cholesky_solve", 97), ("cholesky_solve", 200),
                   ("mmse_equalize", 100), ("mmse_equalize_split", 90))
PANEL_WIDTHS = (1, 8, 16, 32, 64)
# K4's global form (the Householder panel chain) bit for bit its shared
# form at each panel width, at 132 x 128 (the mid-range check's size) and
# 204 x 200 (ragged last panels), its lanes from a generator of their own
QR_PANEL_SIZES = (128, 200)
QR_PANEL_WIDTHS = (1, 8, 16, 32)
# K2's, K3's, K5's and K6's warp forms: (n, lanes) of the served widths
# (the slot mixes' 8 and 32 lanes; the DAGs' n = 8 on 4 lanes and n = 24
# on 32), and the cases held bit for bit to the CTA form (a carrier's
# width at every slot-mix and DAG size, and the served widths)
WARP_SERVED = {"mmse_equalize": ((8, 8), (12, 8), (16, 32), (32, 32),
                                 (8, 4), (24, 32)),
               "mmse_equalize_split": ((8, 32), (16, 32), (32, 32)),
               "channel_estimate": ((8, 4), (24, 32)),
               "pusch_chain": ((8, 4), (24, 32))}
# K2's wide form (a lane on a CTA of its plan's W warps) against its CTA
# form bit for bit: (n, lanes), m = n + 4, deficient,
# zero and NaN lanes among them: the edges of the form (33, 168), the
# mid-range mix's n = 128 on its 32 lanes and wider, and sizes off the
# tiles' multiple of 4
WIDE_BITS = ((33, 37), (64, 37), (97, 37), (128, 32), (128, 300),
             (168, 37))
WARP_BITS = tuple((n, LANES) for n in (8, 12, 16, 24, 32))
# K16's warp form against its CTA form: (n, m) of every edge of the warp
TRI_WARP_NS = (1, 7, 8, 16, 31, 32)
TRI_WARP_MS = (1, 2, 3, 8)
# the sources of K1-K3, whose global instances (<true>) run the panel chain
GLOBAL_SOURCES = {"cholesky_solve": "cholesky_solve.cu",
                  "mmse_equalize": "mmse_equalize.cu",
                  "mmse_equalize_split": "mmse_equalize_split.cu"}
TILED_TIMES = ("cholesky_solve_tiled", "qr_solve_tiled",
               "mmse_equalize_tiled")
QR_CLUSTER_KERNELS = ("qr_solve_blocked", "qr_solve_tiled")
CHOL_TILED_KERNELS = ("cholesky_solve_tiled", "mmse_equalize_tiled")
# K12 / K14 on thread-block clusters: (kernel, m, n, bs, lanes) at which
# every plan of chol_tiled_forms (each cluster size and product tile) must
# give C = 1's bits, on a deficient lane and a poisoned one (K12: NaN in
# the upper triangle; K14: a NaN in H): the served shapes, a tall channel
# and the odd slab widths
CHOL_TILED_BITS = (("mmse_equalize_tiled", 516, 512, 128, 4),
                   ("mmse_equalize_tiled", 1028, 1024, 128, 4),
                   ("mmse_equalize_tiled", 2052, 512, 128, 4),
                   ("mmse_equalize_tiled", 516, 512, 64, 4),
                   ("mmse_equalize_tiled", 516, 512, 32, 4),
                   ("cholesky_solve_tiled", 512, 512, 128, 4),
                   ("cholesky_solve_tiled", 1024, 1024, 128, 4),
                   ("cholesky_solve_tiled", 512, 512, 64, 4),
                   ("cholesky_solve_tiled", 512, 512, 32, 4))
# K10 on the tiled core's clusters: (n, bs, lanes, k) at which every plan
# of chol_tiled_forms must give C = 1's bits, on a deficient lane and on a
# lane with NaN above the diagonal: the mid-range sizes at the default
# panel width, the panel widths 32, 16 and 48, and lanes of one panel (n =
# bs, no rows below it), the second past a CTA's room for right-hand
# sides (two column groups)
BLOCKED_BITS = ((128, 64, 4, 2), (256, 64, 4, 2), (128, 32, 4, 2),
                (128, 16, 4, 2), (192, 48, 4, 2), (128, 128, 4, 2),
                (224, 224, 4, 33))
# K8 and K9 at the shapes the served DAGs launch them: the svd_solve DAG
# at n = 8 on the mux's 4 lanes (serve_solvers --pusch) and at n = 24 on
# 32 lanes (--sizes 24 --lanes 32), (n, lanes), m = n + 4
SVD_SERVED = ((8, 4), (24, 32))
# K8 under every plan of svd_forms (each group size g threads a pair):
# (n, lanes), m = n + 4, at which every form must give the same U, S and V
# bits, on a zero lane, a rank-2 lane and a NaN lane: the served shapes,
# 64 lanes of the slot mixes' largest n and an odd n (a phantom column)
SVD_BITS = ((24, 32), (8, 4), (32, 64), (13, 8))
# K11 / K13 on thread-block clusters: (kernel, m, n, bs, lanes) at which
# every plan of qr_cluster_forms (each cluster size, the panel's bands in
# shared memory and in the device work buffer) must give the same bits,
# on lanes with a duplicated column, a zero column and a NaN
QR_CLUSTER_BITS = (("qr_solve_tiled", 516, 512, 128, 8),
                   ("qr_solve_tiled", 1028, 1024, 128, 4)) + tuple(
    ("qr_solve_blocked", m, n, bs, 8) for m, n in ((132, 128), (260, 256),
                                                    (160, 128))
    for bs in (16, 32, 64)) + (("qr_solve_tiled", 2052, 512, 128, 4),)
# the LM paths at full published width (float32 weights, bfloat16
# compute): phi4-mini-3.8b (dense: 32 layers, d_model 3072, 24 query and 8
# KV heads of 128, d_ff 8192, vocabulary 200,064), zamba2-2.7b (hybrid: 54
# Mamba2 layers of 32 heads x 160 columns, state 64, chunk 128, d_model
# 2560, and one shared attention block of 32 heads x 80 applied after every
# 9) and xlstm-125m (12 layers as 3 x (3 mLSTM + 1 sLSTM), d_model 768, 4
# heads, the scan's P = 385 and N = 192, chunk 64); prompts of B = 4 at S =
# 512 and 128 (the prefill <-> decode check feeds the 128 one by one)
LM_ARCHS = ("phi4-mini-3.8b", "zamba2-2.7b", "xlstm-125m")
LM_BATCH = 4
LM_SEQS = (512, 128)
LM_PREFILL_REPS = 5          # prefill calls in each timed window
PEAK_BF16_FLOPS = 989e12     # H100 SXM, bfloat16 tensor cores, dense
# A bfloat16 answer rounds once to 2^-8 of its size: 2e-2 holds K18 in
# bf16 to its plain version and to the float32 oracle on the same (bf16)
# inputs.  5e-2 and the argmax rule
# are the reference's for bf16 prefill against token-by-token decode
# (tests/test_models.py::test_prefill_decode_consistency).
BF16_RTOL = 2e-2
LM_RTOL = 5e-2
# K18 in bf16 element by element, against its plain version and against the
# float32 oracle on the same bf16 inputs: |got - want| <= GEMM_BF16_STEP
# |want| + GEMM_BF16_SUM (|x| |y|): one bf16 step of the answer (each side
# rounds its float32 sum once, and two roundings of nearly equal sums may
# land a step apart) plus a float32 sum-order term on the sum of
# |products|.  A stale or skipped pipeline stage moves whole products.
GEMM_BF16_STEP = 2.0 ** -7
GEMM_BF16_SUM = 2.0 ** -16
# K18's bf16 checks (M, K, N): K % 8 and N % 8 != 0 (the padded route), a
# long k axis (the ring wraps 16 times), many waves of tiles, and 4096^3,
# run twice and required bit-identical (a barrier race gives two answers)
GEMM_BF16_CASES = ((129, 257, 65), (1, 1, 1), (100, 13, 50), (64, 64, 60),
                   (1, 4096, 256), (4096, 64, 4096), (2048, 2048, 2048),
                   (4096, 4096, 4096))
# The LM paths' two comparisons, flash prefill vs xla prefill and
# token-by-token decode vs prefill, are made in float32 compute (with a
# float32 KV cache), where both sides are exact but for rounding: within
# F32_LM_RTOL (float32 sums in other orders through up to 54 layers).  In
# bf16 the answers drift from float32 with depth, because the random-weight
# stacks amplify any perturbation: rounding the weights alone (float32
# compute on the bf16 weights) moves zamba2-2.7b's logits by about half
# their size.  So each bf16 answer is held to the float32 prefill within
# a fixed cap for its family (LM_BF16_CAPS: the reference's 5e-2 for the
# dense model, which reads 2e-2; xLSTM's 12 layers read 0.18 and zamba2's
# 54 read 0.49-0.78, deterministic from the seed), the argmax rule holds
# between the two bf16 sides, and K21 is held apart from the drift
# (scan_witness).
F32_LM_RTOL = 1e-3
LM_BF16_CAPS = {"dense": LM_RTOL, "ssm": 0.25, "hybrid": 0.95}
# K20 element by element, |got - want| <= rtol (softmax(q k^T) |v| +
# |want|): rounding p to bf16 moves each term of P V by at most 2^-8 of
# itself (so the sum by 2^-8 of softmax |v|) and the answer rounds to
# 2^-8 of itself; 5e-3 covers both with room for float32 sums.  Float32
# differs by summation order and exp's last bits only.
ATTN_RTOLS = {"float32": 1e-4, "bfloat16": 5e-3}
# K20 checks: head widths D (phi4-mini's 128 with its GQA 24/8, zamba2's
# 80, the registry's 64, the smoke configs' 8, and 4 and 12, which are not
# multiples of 8, with GQA 4/2) by S (5, 96 and 100 not multiples of the
# tensor-core form's 64-row tiles: ragged q and kv tiles)
FLASH_DIMS = (4, 8, 12, 64, 80, 128)
FLASH_SEQS = (5, 96, 100, 128, 512)
# the strided route (ops.flash_attention on the models' (B, S, H, D)
# tensors as transposed views): phi4-mini's and zamba2's prefill shapes and
# a ragged one, (B, H, Hkv, S, D)
FLASH_STRIDED = ((LM_BATCH, 24, 8, 512, 128), (LM_BATCH, 32, 32, 512, 80),
                 (2, 4, 2, 100, 12))
# timing rows, the head row last: K18 at the registry's squares, a shape
# that is not a multiple of its tiles (float32, then bf16) and 4096^3
# (bf16, then float32); K20
# at the registry case and at phi4-mini's prefill shapes
GEMM_TIMES = ((64, 64, 64, "float32"), (128, 128, 128, "float32"),
              (1000, 300, 700, "float32"), (1000, 300, 700, "bfloat16"),
              (4096, 4096, 4096, "bfloat16"), (4096, 4096, 4096, "float32"))
FLASH_TIMES = ((1, 2, 2, 128, 64, "float32"),
               (LM_BATCH, 32, 32, 512, 80, "bfloat16"),
               (LM_BATCH, 24, 8, 128, 128, "bfloat16"),
               (LM_BATCH, 24, 8, 512, 128, "bfloat16"))
# K21 against its plain version: float32 sums in another order only
# (RTOL); bfloat16 rounds each answer once from float32 in both, so two
# answers may sit one bf16 step (2^-8 of themselves) apart: 8e-3.  Against
# the float32 sequential oracle: the spec's 1e-3 (the chunked form regroups
# the recurrence through exp(la_i - la_j)), 8e-3 in bf16.
SSM_BF16_RTOL = 8e-3
# K21 cases (label, B, H, S, P, N, B/C per head, chunk, decay range): the
# registry case, zamba2-2.7b's prefill at S = 512 (x (4, 32, 512, 160), B/C
# (4, 512, 64) shared, chunk 128), xlstm-125m's (v_aug (4, 4, 512, 385),
# B/C (4, 4, 512, 192) per head, chunk 64), S < chunk, the decay limits
# 1 and 0 (the 1e-20 clamp), more chunks (16) than a cluster's ranks, and
# both prefill shapes at S = 128 (zamba2's a lane of one chunk, xlstm's two)
SSM_CASES = (("registry", 1, 2, 64, 4, 8, False, 16, (0.8, 0.999)),
             ("zamba2", LM_BATCH, 32, 512, 160, 64, False, 128,
              (0.8, 0.999)),
             ("xlstm", LM_BATCH, 4, 512, 385, 192, True, 64, (0.8, 0.999)),
             ("S<chunk", 2, 3, 48, 9, 16, True, 128, (0.8, 0.999)),
             ("decay 1", 1, 2, 256, 33, 8, False, 64, (1.0, 1.0)),
             ("decay 0", 1, 2, 256, 33, 8, False, 64, (0.0, 0.0)),
             ("16 chunks", 1, 2, 2048, 33, 8, False, 128, (0.8, 0.999)),
             ("zamba2 S=128", LM_BATCH, 32, 128, 160, 64, False, 128,
              (0.8, 0.999)),
             ("xlstm S=128", LM_BATCH, 4, 128, 385, 192, True, 64,
              (0.8, 0.999)))
# K21 timing rows, the head row (zamba2 at S = 512) last: the prefill
# shapes at both LM_SEQS in the path's bf16, (label, B, H, S, P, N, per
# head, chunk)
SSM_TIMES = (("xlstm S=128", LM_BATCH, 4, 128, 385, 192, True, 64),
             ("zamba2 S=128", LM_BATCH, 32, 128, 160, 64, False, 128),
             ("xlstm", LM_BATCH, 4, 512, 385, 192, True, 64),
             ("zamba2", LM_BATCH, 32, 512, 160, 64, False, 128))


@contextlib.contextmanager
def global_form(common):
    """Run every two-form kernel (K1-K4) in its global form, also where
    the lane fits in shared memory: the form follows the shared-memory
    limit, which this lowers to 0 for the block."""
    limit = common.MAX_SMEM_BYTES
    common.MAX_SMEM_BYTES = 0
    try:
        yield
    finally:
        common.MAX_SMEM_BYTES = limit


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def ptxas_lines(log: str, source: str) -> list:
    """The ``-Xptxas -v`` lines of one source in the build log: each
    entry's name, its registers, shared memory and spills."""
    keep, out = False, []
    for line in log.splitlines():
        if line.startswith("=="):
            keep = line.strip() == f"== {source}"
        elif keep and ("registers" in line or "spill" in line
                       or "Compiling entry" in line):
            out.append(line.strip())
    return out


def clocks_line() -> str:
    """The SM clock, its maximum, the temperature and the power draw now,
    as nvidia-smi reports them (or its error: informational only).  Two
    cards of one model and power limit can run at different clocks."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
         "temperature.gpu,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return (smi.stdout.strip() or smi.stderr.strip()
            or "no output").splitlines()[0]


def close(got, want, rtol=RTOL, scale=None):
    """assert_close semantics of the test suite: |got - want| <=
    rtol * max|want| + rtol * |want| elementwise, over each tensor of a
    tuple; with ``scale`` (a tensor of want's shape) the floor is
    rtol * |scale| element by element instead of the global max.
    Returns (ok, max |diff|)."""
    import torch
    if isinstance(got, tuple):
        res = [close(g, w, rtol) for g, w in zip(got, want)]
        return all(ok for ok, _ in res), max(err for _, err in res)
    got = got.double()
    want = want.double()
    err = (got - want).abs()
    floor = (rtol * want.abs().max() if scale is None
             else rtol * scale.double().abs())
    tol = floor + 1e-12 + rtol * want.abs()
    ok = bool(torch.all(err <= tol)) and bool(torch.isfinite(got).all())
    return ok, float(err.max()) if err.numel() else 0.0


def device_ops(fn):
    """What the card runs for one ``fn()`` (after one warm call), from
    torch.profiler's CUDA activity: (kernels, copies and sets, busy ms),
    the busy time the sum of their durations (one stream, so they do not
    overlap).  None where the profiler saw no device activity or
    failed: a measurement, not a check."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    except Exception as e:           # noqa: BLE001 -- reported, not fatal
        print(f"  torch.profiler failed: {e!r}", flush=True)
        return None
    if not ops:
        return None
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in ops)
    return (len(ops) - copies, copies,
            sum(e.time_range.elapsed_us() for e in ops) / 1e3)


def wall_ms(fn, reps):
    """Wall ms a call over a window of ``reps`` back-to-back calls, the
    card synchronized at each end only."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def matrix_count(cfg) -> int:
    """Matrix parameters of ``cfg`` at the reference's ``init_params``
    shapes (embedding, head and every projection; norm scales and Mamba2's
    decay and skip vectors left out).  The config's ``param_count`` is
    exact for the dense and hybrid families; for xLSTM it is "rough" (it
    counts an sLSTM layer as 5d^2 + 2 fd d where ``init_slstm`` makes 8d^2
    + 2 fd d, and leaves out the mLSTM gates' 2d), so that family is
    summed here from ``src/repro/models/xlstm.py``'s shapes."""
    if cfg.family != "ssm":
        return cfg.param_count()
    d, cx = cfg.d_model, cfg.xlstm
    di = cx.expand_m * d
    dqk = int(di * cx.qk_frac)
    fd = int(d * cx.expand_s_ffn)
    groups = cfg.n_layers // (cx.m_per_group + cx.s_per_group)
    mlstm = 2 * d * dqk + 2 * d * di + 2 * d + di * d
    slstm = 8 * d * d + 2 * fd * d
    return cfg.vocab * d * (1 if cfg.tie_embeddings else 2) + groups * (
        cx.m_per_group * mlstm + cx.s_per_group * slstm)


def prefill_launches(cfg) -> dict:
    """The kernels one prefill launches, and how often: K20 once an
    attention block (each dense layer; each application of the hybrid's
    shared block), K21 once a Mamba2 or mLSTM layer."""
    if cfg.family == "hybrid":
        return {"ssm_scan": cfg.n_layers,
                "flash_attention": cfg.n_layers // cfg.shared_every}
    if cfg.family == "ssm":
        cx = cfg.xlstm
        return {"ssm_scan": cfg.n_layers // (cx.m_per_group + cx.s_per_group)
                * cx.m_per_group}
    return {"flash_attention": cfg.n_layers}


def tensors(tree) -> list:
    """The tensors of a parameter tree (dicts and lists)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in tensors(v)]
    return [tree]


@contextlib.contextmanager
def patched(module, name, value):
    """``module.name`` set to ``value`` for the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def scan_witness(params, params32, cfg, cfg32, tokens, truth, logits,
                 rel_of) -> dict:
    """K21 on a model's path held apart from the bf16 stack's drift, at
    S = LM_SEQS[0]: every scan of one bf16 prefill against the plain
    version on the same inputs (the models' strided route, their own
    decays), element by element within SSM_BF16_RTOL of |plain| + max
    |plain| (a ratio < 1); the prefill with the plain version in place of
    K21 against K21's, in float32 within F32_LM_RTOL and in bf16 within
    the family's cap with argmax on >= 3 of 4 rows.  And what drives the
    drift, each perturbation alone in float32 compute: the weights
    rounded to bf16, the scan's decays rounded to bf16; with the share of
    bf16 decays that round to 1.  These launches are not the main
    path's."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import transformer as MT
    KS = importlib.import_module("repro_torch.kernels.ssm_scan")
    s = LM_SEQS[0]
    batch = {"tokens": tokens[s]}
    ratios, ones = [], []

    def witnessed(x, a, b, c, *, chunk):
        got = KS.ssm_scan_fused(x, a, b, c, chunk=chunk)
        want = KS.ssm_scan_plain(x, a, b, c, chunk=chunk)
        ratios.append(max(float(((g.double() - w.double()).abs() / (
            SSM_BF16_RTOL * (w.double().abs().max() + w.double().abs())
            + 1e-12)).max()) for g, w in zip(got, want)))
        ones.append(float((a == 1).float().mean()))
        return got

    def decays_rounded(x, a, b, c, *, chunk):
        return KS.ssm_scan_fused(x, a.bfloat16().float(), b, c, chunk=chunk)

    with patched(ops, "ssm_scan_fused", witnessed):
        MT.prefill(params, cfg, batch)
    with patched(ops, "ssm_scan_fused", KS.ssm_scan_plain):
        sub = MT.prefill(params, cfg, batch)
        sub32 = MT.prefill(params32, cfg32, batch)
    with patched(ops, "ssm_scan_fused", decays_rounded):
        rel_a = rel_of(MT.prefill(params32, cfg32, batch), truth[s])
    rel_w = rel_of(MT.prefill(MT.cast_params(params, cfg32), cfg32, batch),
                   truth[s])
    worst = max(ratios)
    rel32, rel = rel_of(truth[s], sub32), rel_of(logits[s], sub)
    cap = LM_BF16_CAPS[cfg.family]
    agree = int((logits[s].argmax(-1) == sub.argmax(-1)).sum())
    print(f"  K21 witness S={s}: {len(ratios)} scans of a bf16 prefill vs "
          f"the plain version on their inputs, worst |diff| / limit "
          f"{worst:.3f} (< 1, rtol {SSM_BF16_RTOL}); prefill with the plain "
          f"scan in K21's place: float32 rel err {rel32:.3e} (< "
          f"{F32_LM_RTOL}), bf16 {rel:.3e} (< {cap}), argmax on "
          f"{agree}/{LM_BATCH} rows; drift from the float32 prefill, "
          f"float32 compute with only the weights rounded to bf16 "
          f"{rel_w:.3e}, only the scan's decays {rel_a:.3e}; bf16 decays "
          f"rounded to 1: at most {max(ones):.3%} of a layer's",
          flush=True)
    if not (worst < 1 and rel32 < F32_LM_RTOL and rel < cap
            and agree >= LM_BATCH - 1):
        fail(f"{cfg.name}: K21 on the model's path differs from its "
             f"plain version")
    return {"scan_witness_ratio": worst, "scan_sub_f32_rel_err": rel32,
            "scan_sub_rel_err": rel, "scan_sub_argmax": agree,
            "drift_weights_rel_err": rel_w, "drift_decays_rel_err": rel_a,
            "decays_at_1_share": max(ones)}


def attn_witness(params, cfg, tokens, logits, rel_of) -> dict:
    """K20 on a model's path held apart from the bf16 stack's drift, at
    each S of LM_SEQS: every K20 launch of one bf16 prefill against the
    plain version on the same inputs (the models' strided route),
    element by element within ATTN_RTOLS["bfloat16"] of softmax(q k^T)
    |v| + |plain| (a ratio < 1), and the prefill with the plain version in
    K20's place against K20's, within the family's cap with argmax on >=
    3 of 4 rows.  Returns the numbers and the plain version's prefills
    (the decode check asks them).  These launches are not the main
    path's."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import transformer as MT
    KA = importlib.import_module("repro_torch.kernels.attention")
    rtol = ATTN_RTOLS["bfloat16"]
    ratios = []

    def witnessed(q, k, v, **kw):
        got = KA.flash_attention_fused(q, k, v, **kw)
        want = KA.flash_attention_plain(q, k, v, **kw).double()
        scale = KA.flash_attention_plain(q.float(), k.float(),
                                         v.float().abs(), **kw).double()
        ratios.append(float(((got.double() - want).abs()
                             / (rtol * (scale + want.abs()))).max()))
        return got

    out, subs = {}, {}
    cap = LM_BF16_CAPS[cfg.family]
    for s in LM_SEQS:
        batch = {"tokens": tokens[s]}
        with patched(ops, "flash_attention_fused", witnessed):
            MT.prefill(params, cfg, batch)
        with patched(ops, "flash_attention_fused", KA.flash_attention_plain):
            subs[s] = MT.prefill(params, cfg, batch)
        rel = rel_of(logits[s], subs[s])
        agree = int((logits[s].argmax(-1) == subs[s].argmax(-1)).sum())
        print(f"  K20 witness S={s}: {len(ratios)} K20 launches of a bf16 "
              f"prefill vs the plain version on their inputs, worst |diff| "
              f"/ limit {max(ratios):.3f} (< 1, rtol {rtol}); prefill with "
              f"the plain version in K20's place: bf16 rel err {rel:.3e} "
              f"(< {cap}), argmax on {agree}/{LM_BATCH} rows", flush=True)
        if not (max(ratios) < 1 and rel < cap and agree >= LM_BATCH - 1):
            fail(f"{cfg.name}: K20 on the model's path differs from its "
                 f"plain version")
        out.update({f"attn_witness_ratio_s{s}": max(ratios),
                    f"attn_sub_rel_err_s{s}": rel,
                    f"attn_sub_argmax_s{s}": agree})
        ratios.clear()
    return out, subs


def lm_path(arch, dev, read_launches, reset_launches, kern) -> dict:
    """The LM serving path of ``arch`` at its full published width, on
    the card.

    Prefill (``attn_impl="flash"``) on B = 4 prompts of S = 512, then 128:
    K20 and K21 launch exactly as often as ``prefill_launches`` says, the
    logits are finite and, for a model with attention, match
    ``attn_impl="xla"`` on the same weights (bf16 tolerance, argmax on >=
    3 of 4 rows).  Then the 128 tokens fed one by one through
    ``decode_step``: the last logits match the flash prefill's (the
    reference's prefill <-> decode check).  Then the serving entry point
    (``repro_torch.launch.serve``): a DecodeEngine of 4 slots, 256 tokens
    of cache, behind a mux serving 8 greedy requests of 3-40 prompt
    tokens and 16 new ones (so slots are reused), each output the same
    when served again alone.  Returns the path's numbers: wall times
    over whole windows (the path is host-bound, so CUDA events around a
    call would time the host's enqueue), and what the card ran for one
    decode step and one prefill by torch.profiler."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as LS
    from repro_torch.models import decode as MD
    from repro_torch.models import transformer as MT
    from repro_torch.serve.decode import DecodeEngine

    cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    # float32 weights from the generator, and the bf16 copy the path runs
    # on (the values each use would cast to); the float32 ones are kept
    # for the float32 prefill <-> decode check, then freed
    params32 = MT.init_params(gen, cfg)
    params = MT.cast_params(params32, cfg)
    torch.cuda.synchronize()
    leaves = tensors(params)
    n_params = sum(t.numel() for t in leaves)
    n_matrix = sum(t.numel() for t in leaves if t.dim() >= 2)
    print(f"LM: {cfg.name} at full width, {n_params} parameters, "
          f"{n_matrix} of them in matrices (float32 made, bf16 kept), built "
          f"in {time.perf_counter() - t0:.3f}s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated",
          flush=True)
    if n_matrix != matrix_count(cfg):
        fail(f"{cfg.name}: {n_matrix} matrix parameters, the reference's "
             f"shapes give {matrix_count(cfg)}")
    tokens = {s: torch.randint(0, cfg.vocab, (LM_BATCH, s), generator=gen,
                               device=dev) for s in LM_SEQS}
    out = {"arch": cfg.name, "params": n_params, "batch": LM_BATCH}

    k20 = kern["flash_attention"]

    def prefill_counted(p, c, s):
        """One prefill whose K20 launches must all run the dtype's form:
        the tensor-core form in bf16, the SIMT form in float32."""
        before = {k: kern[k].launches for k in per_call}
        tc_before = k20.launches_tc
        out = MT.prefill(p, c, {"tokens": tokens[s]})
        torch.cuda.synchronize()
        got = {k: kern[k].launches - before[k] for k in per_call}
        if got != per_call:
            fail(f"{c.name} prefill S={s} launched {got}, not {per_call}")
        tc = k20.launches_tc - tc_before
        want_tc = per_call.get("flash_attention", 0) \
            if c.compute_dtype == "bfloat16" else 0
        if tc != want_tc:
            fail(f"{c.name} {c.compute_dtype} prefill S={s}: {tc} K20 "
                 f"launches in the tensor-core form, not {want_tc}")
        return out

    reset_launches()
    logits = {}
    per_call = prefill_launches(cfg)
    for s in LM_SEQS:
        logits[s] = prefill_counted(params, cfg, s)
        if not bool(torch.isfinite(logits[s]).all()):
            fail(f"{cfg.name} prefill S={s}: non-finite logits")
    read_launches(f"{cfg.name} prefill (flash) B={LM_BATCH} S={LM_SEQS}",
                  tuple(per_call),
                  exact={k: c * len(LM_SEQS) for k, c in per_call.items()})
    # the float32 prefill on the float32 weights: the truth every bf16
    # answer of this path is held to (LM_BF16_CAPS)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    truth = {s: prefill_counted(params32, cfg32, s) for s in LM_SEQS}
    rel_of = lambda a, b: float((a - b).abs().max() / b.abs().max())
    if "flash_attention" in per_call:
        xcfg = dataclasses.replace(cfg, attn_impl="xla")
        for s in LM_SEQS:
            want = MT.prefill(params, xcfg, {"tokens": tokens[s]})
            want32 = MT.prefill(params32, dataclasses.replace(
                cfg32, attn_impl="xla"), {"tokens": tokens[s]})
            rel32 = rel_of(truth[s], want32)
            rel = rel_of(logits[s], want)
            rel_truth = rel_of(logits[s], truth[s])
            limit = LM_BF16_CAPS[cfg.family]
            agree = int((logits[s].argmax(-1) == want.argmax(-1)).sum())
            print(f"  prefill S={s}: flash vs xla logits float32 rel err "
                  f"{rel32:.3e} (< {F32_LM_RTOL}); bf16 rel err {rel:.3e}, "
                  f"flash bf16 to float32 {rel_truth:.3e} (< {limit:.3e}), "
                  f"argmax on {agree}/{LM_BATCH} rows", flush=True)
            out[f"flash_vs_xla_f32_rel_err_s{s}"] = rel32
            out[f"flash_vs_xla_rel_err_s{s}"] = rel
            out[f"flash_vs_f32_rel_err_s{s}"] = rel_truth
            out[f"flash_vs_xla_argmax_s{s}"] = agree
            if not (rel32 < F32_LM_RTOL and rel_truth < limit
                    and agree >= LM_BATCH - 1):
                fail(f"{cfg.name} prefill S={s}: flash differs from xla")

    subs = None
    if "flash_attention" in per_call:
        witness, subs = attn_witness(params, cfg, tokens, logits, rel_of)
        out.update(witness)
    if "ssm_scan" in per_call:
        out.update(scan_witness(params, params32, cfg, cfg32, tokens, truth,
                                logits, rel_of))

    # the 128 tokens fed one by one, timed as one window: wall over the
    # steps, the card synchronized at each end only
    s = LM_SEQS[-1]
    pos = [torch.full((LM_BATCH,), j, device=dev) for j in range(s)]

    def decode_all(p, c, cache):
        for j in range(s):
            last, cache = MD.decode_step(p, c, cache, tokens[s][:, j:j + 1],
                                         pos[j])
        return last, cache

    cache = MD.init_cache(cfg, LM_BATCH, s, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = decode_all(params, cfg, cache)
    torch.cuda.synchronize()
    window = time.perf_counter() - t0
    step_ms = 1e3 * window / s
    # the same in float32 compute with a float32 cache, where the recurrence
    # is exact but for rounding
    last32, _ = decode_all(params32, cfg32, MD.init_cache(
        cfg32, LM_BATCH, s, dtype=torch.float32, device=dev))
    del params32
    torch.cuda.empty_cache()
    rel32 = rel_of(last32, truth[s])
    rel = rel_of(last, logits[s])
    rel_truth = rel_of(last, truth[s])
    limit = LM_BF16_CAPS[cfg.family]
    same = lambda a, b: float((a.argmax(-1) == b.argmax(-1)).float().mean())
    agree, agree32 = same(last, logits[s]), same(last32, truth[s])
    # the decode's agreement with the prefill that has the plain version
    # in K20's place (the reference's algorithm on the same card inputs):
    # printed beside the rule, not part of it
    agree_plain = same(last, subs[s]) if subs else None
    print(f"  decode x{s} vs prefill S={s}: float32 rel err {rel32:.3e} "
          f"(< {F32_LM_RTOL}), argmax agreement {agree32:.2f} (>= 0.5); "
          f"bf16 rel err {rel:.3e}, to the float32 prefill {rel_truth:.3e} "
          f"(< {limit:.3e}), argmax agreement {agree:.2f} (>= 0.5"
          + ("" if agree_plain is None else
             f"; with the plain K20's prefill: {agree_plain:.2f}")
          + f"); {s} bf16 steps in {window:.3f}s wall: {step_ms:.3f} ms a "
          f"step, {LM_BATCH * s / window:.1f} tokens/s", flush=True)
    out.update(decode_vs_prefill_rel_err=rel, decode_vs_prefill_argmax=agree,
               decode_vs_plain_prefill_argmax=agree_plain,
               decode_vs_prefill_f32_rel_err=rel32,
               decode_vs_prefill_f32_argmax=agree32,
               decode_vs_f32_prefill_rel_err=rel_truth,
               decode_step_ms=step_ms,
               decode_tokens_per_s=LM_BATCH * s / window)
    if not (rel32 < F32_LM_RTOL and agree32 >= 0.5 and rel_truth < limit
            and agree >= 0.5):
        fail(f"{cfg.name}: token-by-token decode diverges from the prefill")

    for s in LM_SEQS:
        ms = wall_ms(lambda s=s: MT.prefill(params, cfg,
                                            {"tokens": tokens[s]}),
                     LM_PREFILL_REPS)
        out[f"prefill_ms_s{s}"] = ms
        print(f"  prefill B={LM_BATCH} S={s}: {ms:.3f} ms wall a call "
              f"(window of {LM_PREFILL_REPS}), "
              f"{1e3 * LM_BATCH * s / ms:.0f} tokens/s", flush=True)
    tok = tokens[s][:, -1:]
    for label, fn in (
            ("decode_step", lambda: MD.decode_step(params, cfg, cache, tok,
                                                   pos[-1])),
            (f"prefill_s{s}", lambda: MT.prefill(params, cfg,
                                                 {"tokens": tokens[s]}))):
        ops = device_ops(fn)
        if ops is None:
            print(f"  {label}: device operations not measured "
                  f"(torch.profiler saw none)", flush=True)
            out[f"{label}_kernels"] = None
            continue
        kernels, copies, busy = ops
        wall = step_ms if label == "decode_step" else out[f"prefill_ms_s{s}"]
        out.update({f"{label}_kernels": kernels, f"{label}_copies": copies,
                    f"{label}_device_busy_ms": busy,
                    f"{label}_device_idle_share": 1.0 - busy / wall})
        print(f"  {label}: the card runs {kernels} kernels and {copies} "
              f"copies/sets, busy {busy:.3f} ms of {wall:.3f} ms wall "
              f"(idle {1.0 - busy / wall:.1%}; torch.profiler)", flush=True)
    del cache, logits, tokens
    torch.cuda.empty_cache()

    reset_launches()
    argv = ["--full", "--arch", arch, "--pool", "4", "--max-len", "256",
            "--requests", "8", "--max-new", "16"]
    print(f"serve {' '.join(argv)}", flush=True)
    summary = LS.main(argv)
    if summary["done"] != 8 or summary["tokens"] != 8 * 16:
        fail(f"{cfg.name} serving: {summary}")
    read_launches(f"{cfg.name} serving (decode through the mux)", (),
                  exact={})
    # greedy decoding depends on the prompt only: each request served
    # again alone, by an engine over the weights this path holds (the
    # launcher's: the same generator and seed), gives the same output
    engine = DecodeEngine(get_config(arch), params, batch=4, max_len=256,
                          eos_id=-1)
    solo = [LS.serve(engine, [p], 16)[0].out for p in summary["prompts"]]
    print(f"  greedy outputs solo == co-batched: "
          f"{solo == summary['outputs']}", flush=True)
    if solo != summary["outputs"]:
        fail(f"{cfg.name} serving: a greedy output changed with its "
             f"pool-mates")
    out.update(serve_tokens_per_s=summary["tokens_per_s"],
               serve_step_ms=summary["step_ms"],
               serve_step_ms_p50=summary["step_ms_p50"],
               serve_steps=summary["steps"], serve_tokens=summary["tokens"],
               serve_seconds=summary["seconds"])
    del engine, params
    torch.cuda.empty_cache()
    return out


def main():
    import numpy as np
    import torch

    # ---------------- 1. device ----------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if torch.cuda.get_device_capability(0) != (9, 0):
        fail(f"{torch.cuda.get_device_name(0)} is not a Hopper card "
             f"(capability {torch.cuda.get_device_capability(0)})")
    card = card_line()
    print(card, flush=True)
    print(f"clocks (sm, max sm, temperature, power draw): {clocks_line()}",
          flush=True)
    # full float32 in every library product and in cuDNN's conv1d (the
    # FIR oracle and yardstick), which would otherwise run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off "
          f"(cuda.matmul.allow_tf32 = cudnn.allow_tf32 = False)", flush=True)

    from repro_torch import kernels as K
    from repro_torch import pipelines as pp
    KC = importlib.import_module("repro_torch.kernels.cholesky")
    KCS = importlib.import_module("repro_torch.pipelines.cholesky_solve")
    QS = importlib.import_module("repro_torch.pipelines.qr_solve")
    from repro_torch.kernels import common, ref
    F = importlib.import_module("repro_torch.kernels.fft")
    KF = importlib.import_module("repro_torch.kernels.fir")
    KQ = importlib.import_module("repro_torch.kernels.qr")
    S = importlib.import_module("repro_torch.kernels.svd")
    KT = importlib.import_module("repro_torch.kernels.trisolve")
    KG = importlib.import_module("repro_torch.kernels.gemm")
    KA = importlib.import_module("repro_torch.kernels.attention")
    KS = importlib.import_module("repro_torch.kernels.ssm_scan")
    from repro_torch.kernels.common import sample_spd
    from repro_torch.kernels.svd import spectrum_recon

    # ---------------- 2. build ----------------
    t0 = time.perf_counter()
    common.load_library()
    print(f"build: {common.build_info['seconds']:.1f}s nvcc, "
          f"{time.perf_counter() - t0:.1f}s to load "
          f"({common.build_info['path']})", flush=True)
    for line in common.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    kern = {k.name: k for k in common.KERNELS}
    # K7 by size: its plan (the shared memory is dynamic, so not in
    # ptxas's lines) and the registers and spills of the instance it runs
    # (fft_kernel<log2 n, depth> on the warp route, fft_wide_kernel<log2
    # n> past it)
    ptxas = ptxas_lines(common.build_info["log"], "fft.cu")
    print("K7 plans (fft.cu, -Xptxas -v):", flush=True)
    for log_n in range(1, int(math.log2(F.MAX_POINTS)) + 1):
        plan = F.fft_plan(2 ** log_n)
        entry = (f"fft_wide_kernelILi{log_n}EE" if plan.wide else
                 f"fft_kernelILi{log_n}ELi{plan.depth}EE")
        at = next(i for i, line in enumerate(ptxas) if entry in line)
        print(f"  n={plan.n:<5} {plan.threads} threads x {plan.points} "
              f"points, stages {plan.stages}, {plan.rows} rows a CTA, "
              f"{plan.depth} staged batches a warp, shared memory "
              f"{plan.smem_bytes} bytes; {ptxas[at + 1]}; "
              f"{ptxas[at + 2].removeprefix('ptxas info    : ')}",
              flush=True)

    def global_plan(name, shapes):
        """The panel chain's plan of a K1-K4 global launch at per-lane
        ``shapes`` (K1: A, B; K2: H, y; K3: Hr, Hi, yr, yi; K4: A, B)."""
        if name == "qr_solve":
            return pp.qr_panel_plan(*shapes[0], shapes[1][-1])
        if name == "cholesky_solve":
            return pp.chol_panel_plan(shapes[0][-1], shapes[1][-1])
        n = shapes[0][-1]
        return pp.chol_panel_plan(
            2 * n if name == "mmse_equalize_split" else n, shapes[-1][-1])

    def tiled_plan(name, lanes, shapes):
        """The cluster plan of a K10 / K12 / K14 launch of ``lanes`` lanes
        at per-lane ``shapes`` (A, B or H, y) and the default panel
        width."""
        (m, n), (_, k) = shapes
        bs = (KCS.block_size(n) if name == "cholesky_solve_blocked"
              else KCS.tiled_block_size(n))
        return pp.chol_tiled_plan(lanes, n, k, bs, name,
                                  m if name == "mmse_equalize_tiled" else None)

    def lane_form(name, shapes, lanes):
        """The form of a K2 / K3 / K5 / K6 launch of ``lanes`` lanes at
        per-lane ``shapes`` (K2: H, y; K3: Hr, Hi, yr, yi; K5: Xp, Yp;
        K6: Xp, Yp, y), and K2's wide form's warps."""
        if name in ("mmse_equalize", "mmse_equalize_split"):
            (m, n), k = shapes[0], shapes[-1][-1]
            if name == "mmse_equalize_split":
                return [pp.mmse_split_plan(m, n, k)]
            form = pp.mmse_form(m, n, k)
            return [form] + ([pp.mmse_wide_plan(m, n, k)]
                             if form == "wide" else [])
        if name == "channel_estimate":
            (n, p), (m, _) = shapes
            return [pp.channel_estimate_plan(n, p, m)]
        (n, p), (m, _), (_, k) = shapes
        return [pp.pusch_chain_plan(n, p, m, k)]

    def cluster_plan(name, lanes, shapes):
        """The cluster plan of a K11 / K13 launch of ``lanes`` lanes at
        per-lane ``shapes`` (A, B) and the default panel width."""
        (m, n), (_, k) = shapes
        bs = (KCS.block_size(n) if name == "qr_solve_blocked"
              else KCS.tiled_block_size(n))
        return pp.qr_cluster_plan(lanes, m, n, k, bs, name)

    # K1-K3's global rows: the plan each runs and the registers and
    # spills of the global instance (<true>) of each source
    print("K1-K3 global plans (chol_panels.cuh, -Xptxas -v):", flush=True)
    for name, source in GLOBAL_SOURCES.items():
        ptxas = ptxas_lines(common.build_info["log"], source)
        at = next(i for i, line in enumerate(ptxas)
                  if f"{name}_kernelILb1E" in line)
        print(f"  {name}<true>: {ptxas[at + 1]}; "
              f"{ptxas[at + 2].removeprefix('ptxas info    : ')}",
              flush=True)
        rows_ = sorted({n for key, n, _ in GLOBAL_CASES + PANEL_GLOBAL_CASES
                        if key == name}
                       | {n for n, _, form, _ in MID_TIMES.get(name, ())
                          if form == "global"})
        for n in rows_:
            plan = global_plan(name, ((n + 4, n), (n + 4, 2)) if name !=
                               "cholesky_solve" else ((n, n), (n, 2)))
            print(f"    n={n:<5} {plan.threads} threads, panels of "
                  f"{plan.bs}, shared memory {plan.smem_bytes} bytes",
                  flush=True)

    # K4's global rows: the plan each runs and the panel kernel's
    # registers; K16's warp form, an instance a bound on m
    ptxas = ptxas_lines(common.build_info["log"], "qr_solve.cu")
    at = next(i for i, line in enumerate(ptxas)
              if "qr_solve_panels_kernel" in line)
    print(f"K4 global plans (qr_panels.cuh, -Xptxas -v): "
          f"qr_solve_panels_kernel: {ptxas[at + 1]}; "
          f"{ptxas[at + 2].removeprefix('ptxas info    : ')}", flush=True)
    for n, m in sorted({(n, m) for key, n, m in GLOBAL_CASES
                        if key == "qr_solve"}
                       | {(n, m) for n, m, form, _ in MID_TIMES["qr_solve"]
                          if form == "global"}):
        plan = global_plan("qr_solve", ((m, n), (m, 1)))
        print(f"    {m} x {n}: {plan.threads} threads, panels of "
              f"{plan.bs}, tiles of {plan.tile}, shared memory "
              f"{plan.smem_bytes} bytes", flush=True)
    ptxas = ptxas_lines(common.build_info["log"], "trisolve.cu")
    for i, line in enumerate(ptxas):
        if "trisolve_warp_kernel" in line:
            print(f"  K16 warp form {line.split(chr(39))[1]}: "
                  f"{ptxas[i + 1]}; "
                  f"{ptxas[i + 2].removeprefix('ptxas info    : ')}",
                  flush=True)

    # K11 / K13: each instance's registers, and the cluster plan of each
    # shape and batch the script launches beside the clusters the card
    # holds at once at that plan (cudaOccupancyMaxActiveClusters)
    print("K11 / K13 cluster plans (qr_cluster.cuh, -Xptxas -v):",
          flush=True)
    for name in QR_CLUSTER_KERNELS:
        ptxas = ptxas_lines(common.build_info["log"], f"{name}.cu")
        for i, line in enumerate(ptxas):
            if "qr_cluster_kernel" in line:
                print(f"  {name}.cu {line.split(chr(39))[1]}: {ptxas[i + 1]}; "
                      f"{ptxas[i + 2].removeprefix('ptxas info    : ')}",
                      flush=True)
    launched = {(name, n + 4, n, KCS.block_size(n) if name ==
                 "qr_solve_blocked" else KCS.tiled_block_size(n), lanes)
                for name in QR_CLUSTER_KERNELS
                for n, _, _, lanes in MID_TIMES.get(name, ())}
    launched |= {("qr_solve_blocked", n + 4, n, bs, LANES)
                 for n in MID_SIZES for bs in (32, 64)}
    launched |= {("qr_solve_blocked", n + 4, n, bs, LANES)
                 for n, bs in ODD_WIDTHS}
    launched |= {("qr_solve_tiled", n + 4, n, TILED_BS, lanes)
                 for n, lanes in TILED_CASES + ((512, SERVED_LANES),)}
    for name, m, n, bs, lanes in sorted(launched):
        plan = pp.qr_cluster_plan(lanes, m, n, 1, bs, name)
        at_once = QS.qr_cluster_occupancy(name, plan)
        print(f"    {name} {m} x {n} bs={bs} B={lanes}: {tuple(plan)}, "
              f"{at_once} clusters at once, {-(-lanes // at_once)} waves",
              flush=True)
    for name, m, n, bs, _ in QR_CLUSTER_BITS:
        for plan in pp.qr_cluster_forms(m, n, 1, bs):
            print(f"    {name} {m} x {n} bs={bs} form {tuple(plan)}: "
                  f"{QS.qr_cluster_occupancy(name, plan)} clusters at once",
                  flush=True)

    # K12 / K14: each instance's registers, and the cluster plan of each
    # shape and batch the script launches beside the clusters the card
    # holds at once at that plan (cudaOccupancyMaxActiveClusters)
    print("K10 / K12 / K14 cluster plans (tiled_chol.cuh, -Xptxas -v):",
          flush=True)
    for name in CHOL_TILED_KERNELS + ("cholesky_solve_blocked",):
        ptxas = ptxas_lines(common.build_info["log"], f"{name}.cu")
        for i, line in enumerate(ptxas):
            if f"{name}_kernel" in line:
                print(f"  {name}.cu {line.split(chr(39))[1][-40:]}: "
                      f"{ptxas[i + 1]}; "
                      f"{ptxas[i + 2].removeprefix('ptxas info    : ')}",
                      flush=True)
    for name in CHOL_TILED_KERNELS:
        for n, lanes in TILED_CASES + ((512, SERVED_LANES),):
            m = n + 4 if name == "mmse_equalize_tiled" else n
            plan = tiled_plan(name, lanes, ((m, n), (m, 2)))
            at_once = KCS.chol_tiled_occupancy(name, plan)
            print(f"    {name} {m} x {n} B={lanes}: {tuple(plan)}, "
                  f"{at_once} clusters at once, {-(-lanes // at_once)} "
                  f"waves", flush=True)
    for name, m, n, bs, _ in CHOL_TILED_BITS:
        mm = m if name == "mmse_equalize_tiled" else None
        print(f"    {name} {m} x {n} bs={bs} forms: " + ", ".join(
            f"{tuple(p)} {KCS.chol_tiled_occupancy(name, p)} at once"
            for p in pp.chol_tiled_forms(n, 2, bs, name, mm)), flush=True)
    k10 = "cholesky_solve_blocked"
    for n, bs, lanes in sorted(
            {(n, KCS.block_size(n), b) for n, _, _, b in MID_TIMES[k10]}
            | {(n, bs, LANES) for n, bs in ODD_WIDTHS}):
        plan = pp.chol_tiled_plan(lanes, n, 2, bs, k10)
        at_once = KCS.chol_tiled_occupancy(k10, plan)
        print(f"    {k10} n={n} bs={bs} B={lanes}: {tuple(plan)}, "
              f"{at_once} clusters at once, {-(-lanes // at_once)} waves",
              flush=True)
    for n, bs, *_ in BLOCKED_BITS:
        print(f"    {k10} n={n} bs={bs} forms: " + ", ".join(
            f"{tuple(p)} {KCS.chol_tiled_occupancy(k10, p)} at once"
            for p in pp.chol_tiled_forms(n, 2, bs, k10)), flush=True)

    # K8: each instance's registers (svd_kernel<g, rows held, stamps>),
    # and the plan of each shape and batch the script launches it at
    print("K8 plans (svd.cu, -Xptxas -v; plan (group, threads, held)):",
          flush=True)
    ptxas = ptxas_lines(common.build_info["log"], "svd.cu")
    for i, line in enumerate(ptxas):
        if "svd_kernel" in line:
            print(f"  {line.split(chr(39))[1]}: {ptxas[i + 1]}; "
                  f"{ptxas[i + 2].removeprefix('ptxas info    : ')}",
                  flush=True)
    for n, lanes in sorted(set(SVD_SERVED) | set(SVD_BITS)
                           | {(n, LANES) for n in SLOT_SIZES}):
        print(f"    {n + 4} x {n} B={lanes}: "
              f"{tuple(S.svd_plan(lanes, n + 4, n))}", flush=True)

    # K21: each instance's registers (ssm_scan_kernel<T, cs16, qt, tiles of
    # state, stamps>, ssm_gram_kernel), and the plan of each case
    print("K21 plans (ssm_scan.cu, -Xptxas -v; plan (clusters, tiles, "
          "slots, smem); clusters at once):", flush=True)
    ptxas = ptxas_lines(common.build_info["log"], "ssm_scan.cu")
    for i, line in enumerate(ptxas):
        if "Compiling entry" in line:
            print(f"  {line.split(chr(39))[1]}: "
                  + "; ".join(x.removeprefix("ptxas info    : ")
                              for x in ptxas[i + 1:i + 3]), flush=True)
    for label, b, h, s, p, n, _, chunk, *_ in SSM_CASES + SSM_TIMES:
        cs = min(chunk, s)
        plan = KS.ssm_plan(b, h, s, p, n, cs)
        forms = [tuple(f)[:3] for f in KS.ssm_check_forms(b, h, s, p, n, cs)]
        print(f"    {label} ({b},{h},{s},{p}) N={n} chunk={cs}: "
              f"{tuple(plan)} {KS.ssm_clusters_at_once(cs, plan)} at "
              f"once; forms held {forms}", flush=True)

    fused = {"cholesky_solve": pp.cholesky_solve_fused,
             "cholesky_solve_blocked": pp.cholesky_solve_blocked_fused,
             "qr_solve_blocked": pp.qr_solve_blocked_fused,
             "cholesky_solve_tiled": pp.cholesky_solve_tiled_fused,
             "qr_solve_tiled": pp.qr_solve_tiled_fused,
             "mmse_equalize_tiled": pp.mmse_equalize_tiled_fused,
             "mmse_equalize": pp.mmse_equalize_fused,
             "mmse_equalize_split": pp.mmse_equalize_split_fused,
             "qr_solve": pp.qr_solve_fused,
             "channel_estimate": pp.channel_estimate_fused,
             "pusch_chain": pp.pusch_chain_fused,
             "fft": lambda xr, xi: torch.stack(F.fft_fused(xr, xi)),
             "pusch_fft": pp.pusch_fft_fused,
             "svd": lambda a: spectrum_recon(*S.svd_fused(a, SWEEPS)),
             "svd_factor": lambda a: spectrum_recon(*pp.unpack_factors(
                 pp.svd_factor_fused(a))),
             "svd_apply": pp.svd_apply_fused,
             "cholesky": KC.cholesky_fused, "trisolve": KT.trisolve_fused,
             "trisolve_upper": lambda l, b: KT.trisolve_fused(l, b,
                                                              lower=False),
             "qr": KQ.qr_fused, "fir": KF.fir_fused,
             "gemm": KG.gemm_fused,
             "ops_gemm": lambda x, y: K.gemm(x, y, device=x.device),
             "flash_attention": KA.flash_attention_fused,
             "flash_attention_full": lambda q, k, v:
                 KA.flash_attention_fused(q, k, v, causal=False),
             "ops_flash_attention": lambda q, k, v: K.flash_attention(
                 q, k, v, device=q.device),
             "ssm_scan": KS.ssm_scan_fused,
             "ops_ssm_scan": lambda x, a, b, c, chunk: K.ssm_scan(
                 x, a, b, c, chunk=chunk, device=x.device)}
    plain = {"cholesky_solve": pp.cholesky_solve_plain,
             "cholesky_solve_blocked": pp.cholesky_solve_blocked_plain,
             "qr_solve_blocked": pp.qr_solve_blocked_plain,
             "cholesky_solve_tiled": pp.cholesky_solve_tiled_plain,
             "qr_solve_tiled": pp.qr_solve_tiled_plain,
             "mmse_equalize_tiled": pp.mmse_equalize_tiled_plain,
             "mmse_equalize": pp.mmse_equalize_plain,
             "mmse_equalize_split": pp.mmse_equalize_split_plain,
             "qr_solve": pp.qr_solve_plain,
             "channel_estimate": pp.channel_estimate_plain,
             "pusch_chain": pp.pusch_chain_plain,
             "fft": lambda xr, xi: torch.stack(F.fft_plain(xr, xi)),
             "pusch_fft": pp.pusch_fft_plain,
             "svd": lambda a: spectrum_recon(*S.svd_plain(a, SWEEPS)),
             "svd_factor": lambda a: spectrum_recon(*pp.unpack_factors(
                 pp.svd_factor_plain(a))),
             "svd_apply": pp.svd_apply_plain,
             "cholesky": KC.cholesky_plain, "trisolve": KT.trisolve_plain,
             "trisolve_upper": lambda l, b: KT.trisolve_plain(l, b,
                                                              lower=False),
             "qr": KQ.qr_plain, "fir": KF.fir_plain,
             "gemm": KG.gemm_plain, "ops_gemm": KG.gemm_plain,
             "flash_attention": KA.flash_attention_plain,
             "flash_attention_full": lambda q, k, v:
                 KA.flash_attention_plain(q, k, v, causal=False),
             "ops_flash_attention": KA.flash_attention_plain,
             "ssm_scan": KS.ssm_scan_plain,
             # on ops' (B, S, H, ...) layout, moved to the kernel's and back
             "ops_ssm_scan": lambda x, a, b, c, chunk: (lambda y, h: (
                 y.transpose(1, 2), h))(*KS.ssm_scan_plain(
                     x.transpose(1, 2), a.transpose(1, 2),
                     b.transpose(1, 2) if b.dim() == 4 else b,
                     c.transpose(1, 2) if c.dim() == 4 else c,
                     chunk=chunk))}
    oracle = {"cholesky_solve": ref.cholesky_solve,
              "cholesky_solve_blocked": ref.cholesky_solve,
              "qr_solve_blocked": ref.qr_solve,
              "cholesky_solve_tiled": ref.cholesky_solve,
              "qr_solve_tiled": ref.qr_solve,
              "mmse_equalize_tiled": ref.mmse_equalize,
              "mmse_equalize": ref.mmse_equalize,
              "mmse_equalize_split": ref.mmse_equalize_split,
              "qr_solve": ref.qr_solve,
              "channel_estimate": ref.channel_estimate,
              "pusch_chain": ref.pusch_chain,
              "fft": lambda xr, xi: torch.stack(ref.fft(xr, xi)),
              "pusch_fft": ref.pusch_fft,
              "svd": lambda a: (ref.svd_vals(a), a),
              "svd_factor": lambda a: (ref.svd_vals(a), a),
              "svd_apply": ref.svd_apply,
              "cholesky": ref.cholesky, "trisolve": ref.trisolve,
              "trisolve_upper": lambda l, b: ref.trisolve(l, b, lower=False),
              "qr": ref.qr, "fir": ref.fir,
              "gemm": ref.gemm, "ops_gemm": ref.gemm,
              "flash_attention": ref.mha,
              "flash_attention_full": lambda q, k, v:
                  ref.mha(q, k, v, causal=False),
              "ops_flash_attention": ref.mha,
              # the sequential oracle in the (B, S, H, ...) layout, its
              # answers moved back to the kernel's
              "ssm_scan": lambda x, a, b, c: (lambda y, h: (
                  y.transpose(1, 2), h))(*ref.ssm_scan(
                      x.transpose(1, 2), a.transpose(1, 2),
                      b.transpose(1, 2) if b.dim() == 4 else b,
                      c.transpose(1, 2) if c.dim() == 4 else c)),
              "ops_ssm_scan": ref.ssm_scan}
    if set(kern) != {KERNEL_OF.get(key, key) for key in fused}:
        fail(f"kernel set {sorted(kern)} != {sorted(fused)}")
    max_err = {name: 0.0 for name in kern}
    failures = []

    def check(key, args, label, oracle_args=None, rtol=None, scale=None,
              **kw):
        """Kernel vs plain version (same card inputs, both given ``kw``)
        vs oracle (on ``oracle_args``, default the same inputs), each
        within ``close``'s limit (``scale`` its elementwise floor).
        Returns the kernel's and the plain version's answers."""
        rtol = rtol or RTOLS.get(key, RTOL)
        rtol_o = max(rtol, ORACLE_RTOLS.get(key, rtol))
        k18 = kern["gemm"]
        forms = (k18.launches, k18.launches_tc)
        got = fused[key](*args, **kw)
        torch.cuda.synchronize()
        if KERNEL_OF.get(key, key) == "gemm":     # bf16: the tensor cores
            ran = k18.launches - forms[0]
            tc = ran if args[0].dtype == torch.bfloat16 else 0
            if k18.launches_tc - forms[1] != tc:
                failures.append(f"{key} {label}: {ran} launches, "
                                f"{k18.launches_tc - forms[1]} in the "
                                f"tensor-core form, not {tc}")
        want = plain[key](*args, **kw)
        ok, err = close(got, want, rtol, scale)
        name = KERNEL_OF.get(key, key)
        max_err[name] = max(max_err[name], err)
        ok_o, err_o = close(got, oracle[key](*(oracle_args or args)),
                            rtol_o, scale)
        status = "ok" if ok and ok_o else "MISMATCH"
        print(f"  {key:<22} {label:<28} |kernel-plain| {err:.3e}  "
              f"|kernel-oracle| {err_o:.3e}  (rtol {rtol:.3g}/"
              f"{rtol_o:.3g}) {status}", flush=True)
        if not (ok and ok_o):
            failures.append(f"{key} {label}")
        return got, want

    def rand(rng, *shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    pgen = torch.Generator(device=dev)     # the panel chain's cases
    pgen.manual_seed(1)

    def grand(*shape, g=None):
        """Standard normal float32 made on the card from a seeded
        generator (``gen`` unless ``g``): the mid-range cases are too
        large to make on the host in time."""
        return torch.randn(shape, generator=g or gen, device=dev)

    def mid_case(key, b, n, m=None, g=None):
        """Per-lane shapes of the mid-range and HBM-scale slot mixes
        (build_slot_jobs at n >= 128: m = n + 4, k = 2, k = 1 for QR),
        made on the card from ``grand``'s generator ``g``;
        Cholesky systems are X X^T + n I as sample_spd makes them."""
        m = n + 4 if m is None else m
        r = lambda *s: grand(*s, g=g)     # noqa: E731
        if key.startswith("cholesky_solve"):
            x = r(b, n, n)
            a = torch.baddbmm(n * torch.eye(n, device=dev), x,
                              x.transpose(-1, -2))
            return a, r(b, n, 2)
        if key.startswith("qr_solve"):
            return r(b, m, n), r(b, m, 1)
        if key == "mmse_equalize_split":
            return r(b, m, n), r(b, m, n), r(b, m, 2), r(b, m, 2)
        if key.startswith("mmse_equalize"):
            return r(b, m, n), r(b, m, 2)
        raise KeyError(key)

    def slot_case(key, rng, b, n):
        """The main paths' own per-lane shapes: the slot mix's
        (build_slot_jobs) and the PUSCH DAG's (m = n + 4 antennas,
        p = 2n pilots, k = 2 data symbols, 64-point FFT)."""
        m, p = n + 4, 2 * n
        f = lambda *s: rand(rng, *s)
        if key in ("cholesky_solve", "cholesky_solve_blocked"):
            return (torch.from_numpy(sample_spd(rng, b, n)).to(dev),
                    f(b, n, 2))
        if key == "mmse_equalize":
            return f(b, m, n), f(b, m, 2)
        if key == "mmse_equalize_split":
            return f(b, m, n), f(b, m, n), f(b, m, 2), f(b, m, 2)
        if key in ("qr_solve", "qr_solve_blocked"):
            return f(b, m, n), f(b, m, 1)
        if key == "channel_estimate":
            return f(b, n, p), f(b, m, p)
        if key == "pusch_chain":
            return f(b, n, p), f(b, m, p), f(b, m, 2)
        if key == "pusch_fft":
            return f(b, m, NFFT), f(b, m, NFFT)
        if key in ("svd", "svd_factor"):
            return (f(b, m, n),)
        if key == "svd_apply":          # factors of a real channel
            return pp.svd_factor_fused(f(b, m, n)), f(b, m, 2)
        # the primitives: SPD systems, their factors with K1's two
        # right-hand sides (L^T for the backward solve), (n + 4) x n QR
        if key == "cholesky":
            return (torch.from_numpy(sample_spd(rng, b, n)).to(dev),)
        if key in ("trisolve", "trisolve_upper"):
            l = torch.linalg.cholesky(torch.from_numpy(
                sample_spd(rng, b, n)).to(dev))
            return (l.mT if key == "trisolve_upper" else l).contiguous(), \
                f(b, n, 2)
        if key == "qr":
            return (f(b, m, n),)
        raise KeyError(key)

    def fir_case(rng, outputs, taps):
        """A signal giving ``outputs`` valid outputs and symmetric taps."""
        h = rng.standard_normal(taps).astype(np.float32)
        return (rand(rng, outputs + taps - 1),
                torch.from_numpy((h + h[::-1]) / 2).to(dev))

    # ---------------- 3. kernels against plain versions ----------------
    print("kernels vs plain versions and oracles:", flush=True)
    rng = np.random.default_rng(0)
    for key, spec_name, variant_name in REGISTRY_CHECKS:
        spec = K.get(spec_name)
        variant = spec.base if variant_name == "base" else next(
            v for v in spec.variants if v.name == variant_name)
        make = variant.make_case or spec.make_case
        for n in variant.sizes:
            args = tuple(a.to(dev) for a in make(rng, n))
            check(key, args, f"registry n={n}")
    check("fft", (rand(rng, LANES, NFFT_MAX), rand(rng, LANES, NFFT_MAX)),
          f"{LANES} rows of {NFFT_MAX}")
    for key in SLOT_KEYS:
        for n in SLOT_SIZES:
            check(key, slot_case(key, rng, LANES, n), f"B={LANES} n={n}")

    # guard cases
    a = torch.from_numpy(sample_spd(rng, 2, 16)).to(dev)
    rhs = rand(rng, 2, 16, 2)
    clean = pp.cholesky_solve_fused(a, rhs)
    poisoned = a.clone()
    iu = torch.triu_indices(16, 16, offset=1)
    poisoned[:, iu[0], iu[1]] = float("nan")
    got, _ = check("cholesky_solve", (poisoned, rhs), "poisoned upper",
                   oracle_args=(a, rhs))
    if not torch.equal(got, clean):
        failures.append("cholesky_solve: upper-triangle NaN leaked")
    v = rand(rng, 2, 16, 2)
    x = pp.cholesky_solve_fused((v @ v.transpose(-1, -2)).contiguous(),
                                rhs)
    guards = [("cholesky_solve rank 2 of 16", x)]
    zero_h = torch.zeros((1, 16, 12), device=dev)
    y1 = rand(rng, 1, 16, 1)
    xz = pp.mmse_equalize_fused(zero_h, y1)
    guards.append(("mmse_equalize zero channel", xz))
    if not torch.all(xz.abs() < 1e-5):
        failures.append("mmse_equalize: zero channel not ~0")
    xs = pp.mmse_equalize_split_fused(zero_h, zero_h, y1, y1)
    guards.append(("mmse_equalize_split zero channel", xs))
    if not torch.all(xs.abs() < 1e-5):
        failures.append("mmse_equalize_split: zero channel not ~0")
    col = rand(rng, 2, 16, 1)
    qb = rand(rng, 2, 16, 2)
    guards.append(("qr_solve duplicate columns", pp.qr_solve_fused(
        col.repeat(1, 1, 8).contiguous(), qb)))
    guards.append(("qr_solve exact zero pivot", pp.qr_solve_fused(
        torch.tensor([[[0.0, 1.0], [0.0, 0.0], [0.0, 0.0]]], device=dev),
        torch.ones((1, 3, 1), device=dev))))
    xq = pp.qr_solve_fused(torch.zeros((1, 12, 8), device=dev),
                           y1[:, :12].contiguous())
    guards.append(("qr_solve zero matrix", xq))
    if not torch.all(xq == 0):
        failures.append("qr_solve: zero matrix not solved to 0")
    for spec_name, key in (("pusch_chanest", "channel_estimate"),
                           ("pusch_chain", "pusch_chain"),
                           ("svd_apply", "svd_apply")):
        spec = K.get(spec_name)
        for n in SLOT_SIZES:
            case = slot_case(key, rng, 1, n)
            lane = spec.filler(tuple(tuple(t.shape[1:]) for t in case),
                               (np.dtype("float32"),) * len(case))
            out = fused[key](*(torch.from_numpy(t)[None].to(dev)
                               for t in lane))
            guards.append((f"{key} filler lane n={n}", out))
            if not torch.equal(out, torch.zeros_like(out)):
                failures.append(f"{key}: filler lane n={n} not exactly 0")
    for n in SLOT_SIZES:
        low = rand(rng, 1, n + 4, 2) @ rand(rng, 1, 2, n)
        deficient = torch.cat([low, torch.zeros_like(low)]).contiguous()
        u, s, v = S.svd_fused(deficient, SWEEPS)
        guards.append((f"svd rank 2 and rank 0, n={n}", torch.cat(
            [u.flatten(), s.flatten(), v.flatten()])))
        if not torch.equal(s[1], torch.zeros_like(s[1])):
            failures.append(f"svd: zero matrix n={n} has nonzero s")
    for nf in (NFFT, NFFT_MAX):
        impulse = torch.zeros((3, nf), device=dev)
        impulse[:, 0] = 1.0
        re, im = F.fft_fused(impulse, torch.zeros_like(impulse))
        guards.append((f"fft unit impulse nf={nf}", re))
        if not (torch.equal(re, torch.ones_like(re))
                and torch.equal(im, torch.zeros_like(im))):
            failures.append(f"fft: unit impulse nf={nf} not all ones")
    # K7 bit for bit: its stages round every product and sum as the plain
    # version does (the PUSCH DAG's stacked layout, a carrier's rows of the
    # largest registered size and of its OFDM size, the smallest size)
    for key, label, args in (
            ("pusch_fft", f"{LANES} x {SLOT_SIZES[-1] + 4} rows of {NFFT}",
             slot_case("pusch_fft", rng, LANES, SLOT_SIZES[-1])),
            ("fft", f"{LANES} rows of {NFFT_MAX}",
             (rand(rng, LANES, NFFT_MAX), rand(rng, LANES, NFFT_MAX))),
            ("fft", f"{LANES} rows of {NFFT_CARRIER}",
             (rand(rng, LANES, NFFT_CARRIER),
              rand(rng, LANES, NFFT_CARRIER))),
            ("fft", f"{LANES} rows of 2",
             (rand(rng, LANES, 2), rand(rng, LANES, 2)))):
        equal = torch.equal(fused[key](*args), plain[key](*args))
        print(f"  {key:<22} {label:<28} bit for bit: {equal}", flush=True)
        if not equal:
            failures.append(f"{key} {label}: not bit for bit")

    # ---- the mid-range path: K10/K11, and K1-K4 past shared memory ----
    print("mid-range path (n = 128-511):", flush=True)
    for key in ("cholesky_solve_blocked", "qr_solve_blocked"):
        for n in MID_SIZES:
            args = mid_case(key, LANES, n)
            for bs in (32, 64):
                check(key, args, f"B={LANES} n={n} bs={bs}", bs=bs)
            del args
    for key, n, m, g in ([(*c, gen) for c in GLOBAL_CASES]
                         + [(*c, pgen) for c in PANEL_GLOBAL_CASES]):
        k = kern[key]
        before = k.launches_global
        check(key, mid_case(key, CHECK_LANES, n, m, g=g),
              f"global B={CHECK_LANES} n={n}",
              rtol=None if key == "cholesky_solve"
              else MID_RTOL if n < 512 else TILED_RTOL)
        if k.launches_global != before + 1:
            failures.append(f"{key} n={n}: the global form did not run")
    # sizes where both forms fit: the shared form against the plain
    # version (K2 at n = 128 is the mid-range mix's own shape), then the
    # global form against the shared one, bit for bit
    for (key, n), g in ([(c, gen) for c in (
            ("cholesky_solve", 128), ("mmse_equalize", 128),
            ("mmse_equalize_split", 96), ("qr_solve", 128))]
            + [(c, pgen) for c in PANEL_BIT_SIZES]):
        args = mid_case(key, CHECK_LANES, n, g=g)
        before = kern[key].launches_global
        shared, _ = check(key, args, f"shared B={CHECK_LANES} n={n}",
                          rtol=None if key == "cholesky_solve" else MID_RTOL)
        with global_form(common):
            glob = fused[key](*args)
        if kern[key].launches_global != before + 1:
            failures.append(f"{key} n={n}: the forms did not both run")
        same = torch.equal(shared, glob)
        print(f"  {key:<22} n={n}: global form == shared form bit for "
              f"bit: {same}", flush=True)
        if not same:
            failures.append(f"{key} n={n}: global form != shared form")
    # K1 at n = 200 on a rank-deficient pivot inside a later panel (lane
    # 1: row 150 of X copies row 3) and NaN in the upper triangle (lane
    # 2): the shared form, the poisoned lane equal to its clean copy, and
    # the global form at each panel width equal to it bit for bit
    n = 200
    x = grand(64, n, n + 16, g=pgen)
    x[1, 150] = x[1, 3]
    a = torch.bmm(x, x.transpose(-1, -2))
    a[2:] += n * torch.eye(n, device=dev)
    a[0] += n * torch.eye(n, device=dev)
    clean = a.clone()
    iu = torch.triu_indices(n, n, offset=1, device=dev)
    a[2, iu[0], iu[1]] = float("nan")
    rhs = grand(64, n, 2, g=pgen)
    shared = pp.cholesky_solve_fused(a, rhs)
    same = (torch.equal(shared, pp.cholesky_solve_fused(clean, rhs))
            and bool(torch.isfinite(shared).all()))
    print(f"  {'cholesky_solve':<22} n={n} deficient pivot 150, NaN "
          f"upper: finite, poisoned == clean bit for bit: {same}",
          flush=True)
    if not same:
        failures.append(f"cholesky_solve n={n}: poisoned lane leaked")
    for bs in PANEL_WIDTHS:
        before = kern["cholesky_solve"].launches_global
        with global_form(common), patched(KCS, "PANEL_WIDTH", bs):
            glob = pp.cholesky_solve_fused(a, rhs)
        same = (torch.equal(shared, glob) and
                kern["cholesky_solve"].launches_global == before + 1)
        print(f"  {'cholesky_solve':<22} n={n} bs={bs}: global form == "
              f"shared form bit for bit: {same}", flush=True)
        if not same:
            failures.append(f"cholesky_solve n={n} bs={bs}: global form "
                            f"!= shared form")
    del x, a, clean, rhs, shared, glob
    # K4 at (n + 4) x n on a duplicated column inside a later panel (lane
    # 1: column 150, or 3n/4, copies column 3), an exact zero column (lane
    # 2) and a NaN (lane 3): the shared form finite with the zero column's
    # component zeroed, the lanes beside the NaN equal to their clean
    # batch's bit for bit, and the global form at each panel width and at
    # its plan's own equal to the shared form bit for bit, NaN lane too
    qgen = torch.Generator(device=dev)
    qgen.manual_seed(2)
    for n in QR_PANEL_SIZES:
        qa = grand(64, n + 4, n, g=qgen)
        qb = grand(64, n + 4, 1, g=qgen)
        qa[1, :, min(150, 3 * n // 4)] = qa[1, :, 3]
        qa[2, :, n // 2] = 0.0
        clean = qa.clone()
        qa[3, n // 3, n // 5] = float("nan")
        shared = pp.qr_solve_fused(qa, qb)
        keep = [i for i in range(qa.shape[0]) if i != 3]
        same = (torch.equal(shared[keep], pp.qr_solve_fused(clean, qb)[keep])
                and bool(torch.isfinite(shared[keep]).all())
                and torch.equal(shared[2, n // 2],
                                torch.zeros_like(shared[2, n // 2])))
        print(f"  {'qr_solve':<22} {n + 4}x{n} duplicated column, zero "
              f"column, NaN lane: finite, zeroed, the NaN isolated bit "
              f"for bit: {same}", flush=True)
        if not same:
            failures.append(f"qr_solve {n + 4}x{n}: special lanes")
        for bs in QR_PANEL_WIDTHS + (None,):
            before = kern["qr_solve"].launches_global
            with global_form(common), patched(
                    QS, "QR_PANEL_WIDTH", bs or QS.QR_PANEL_WIDTH):
                plan = pp.qr_panel_plan(n + 4, n, 1)
                glob = pp.qr_solve_fused(qa, qb)
            same = (torch.equal(shared.view(torch.int32),
                                glob.view(torch.int32))
                    and (bs is None or plan.bs == bs)
                    and kern["qr_solve"].launches_global == before + 1)
            print(f"  {'qr_solve':<22} {n + 4}x{n} "
                  f"{'bs=' + str(bs) if bs else 'plan ' + str(tuple(plan))}"
                  f": global form == shared form bit for bit: {same}",
                  flush=True)
            if not same:
                failures.append(f"qr_solve {n + 4}x{n} bs={bs}: global "
                                f"form != shared form")
    del qa, qb, clean, shared, glob

    a, rhs = mid_case("cholesky_solve", 4, 128)
    clean = pp.cholesky_solve_blocked_fused(a, rhs, bs=32)
    poisoned = a.clone()
    iu = torch.triu_indices(128, 128, offset=1)
    poisoned[:, iu[0], iu[1]] = float("nan")
    got, _ = check("cholesky_solve_blocked", (poisoned, rhs),
                   "poisoned upper n=128", oracle_args=(a, rhs), bs=32)
    if not torch.equal(got, clean):
        failures.append("cholesky_solve_blocked: upper-triangle NaN leaked")
    v = grand(1, 128, 5)
    singular = v @ v.transpose(-1, -2)
    mm = grand(1, 128, 128)
    mm[:, 40] = mm[:, 3]                  # pivot 40: the second bs=32 panel
    deficient = mm @ mm.transpose(-1, -2)
    for label, sys_a in (("singular rank 5", singular),
                         ("deficient pivot 40", deficient)):
        b2 = grand(1, 128, 2)
        out = pp.cholesky_solve_blocked_fused(sys_a.contiguous(), b2, bs=32)
        want = pp.cholesky_solve_blocked_plain(sys_a.contiguous(), b2,
                                               bs=32)
        guards.append((f"cholesky_solve_blocked {label}", out))
        zeros = torch.all(out == 0, dim=-1)
        if not torch.equal(zeros, torch.all(want == 0, dim=-1)) \
                or not bool(zeros.any()):
            failures.append(f"cholesky_solve_blocked {label}: zeroed "
                            f"components differ from the plain version")
    qa, qb = mid_case("qr_solve", 2, 128)
    qa[:, :, 40] = 0.0                    # zero column in the second panel
    qa[1, :, 50] = qa[1, :, 3]            # and a duplicated one
    xq = pp.qr_solve_blocked_fused(qa, qb, bs=32)
    guards.append(("qr_solve_blocked deficient panel 2", xq))
    if not torch.equal(xq[:, 40], torch.zeros_like(xq[:, 40])):
        failures.append("qr_solve_blocked: zero column not zeroed")
    for name, key in (("cholesky_solve", "cholesky_solve_blocked"),
                      ("qr_solve", "qr_solve_blocked")):
        spec = K.get(name)
        for n in MID_SIZES:
            case = mid_case(key, 1, n)
            lane = spec.filler(tuple(tuple(t.shape[1:]) for t in case),
                               (np.dtype("float32"),) * 2)
            out = fused[key](*(torch.from_numpy(t)[None].to(dev)
                               for t in lane))
            guards.append((f"{key} filler lane n={n}", out))
            if not torch.equal(out, torch.zeros_like(out)):
                failures.append(f"{key}: filler lane n={n} not exactly 0")

    # ---- the HBM-scale path: K12-K14, and K10/K11 at any panel width ----
    print("HBM-scale path (n >= 512):", flush=True)
    for key in ("cholesky_solve_blocked", "qr_solve_blocked"):
        for n, bs in ODD_WIDTHS:
            check(key, mid_case(key, LANES, n), f"B={LANES} n={n} bs={bs}",
                  bs=bs)

    def solve64(key, args):
        """The float64 answer of a tiled check's first 64 lanes: the
        normal equations in float64 for QR (its 516 x 512 Gaussian
        matrices have condition ~500)."""
        a, b = (t[:64].double() for t in args)
        if key == "cholesky_solve_tiled":
            return torch.linalg.solve(a, b)
        at = a.transpose(-1, -2)
        g = at @ a
        if key == "mmse_equalize_tiled":
            g = g + 0.1 * torch.eye(g.shape[-1], dtype=g.dtype, device=dev)
        return torch.linalg.solve(g, at @ b)

    for key in TILED_TIMES:
        for n, b in TILED_CASES:
            args = mid_case(key, b, n)
            got, want = check(key, args, f"B={b} n={n} bs={TILED_BS}",
                              bs=TILED_BS)
            x64 = solve64(key, args)
            scale = float(x64.abs().max())
            print(f"  {key:<22} B={b} n={n}: |kernel-f64|/max|x| "
                  f"{float((got[:64] - x64).abs().max()) / scale:.3e}  "
                  f"|plain-f64|/max|x| "
                  f"{float((want[:64] - x64).abs().max()) / scale:.3e}"
                  f"  (first 64 lanes)", flush=True)
            del args, got, want, x64
    a, rhs = mid_case("cholesky_solve", 2, 512)
    clean = pp.cholesky_solve_tiled_fused(a, rhs)
    poisoned = a.clone()
    iu = torch.triu_indices(512, 512, offset=1)
    poisoned[:, iu[0], iu[1]] = float("nan")
    got, _ = check("cholesky_solve_tiled", (poisoned, rhs), "poisoned "
                   "upper n=512", oracle_args=(a, rhs))
    if not torch.equal(got, clean):
        failures.append("cholesky_solve_tiled: upper-triangle NaN leaked")
    for rank in (40, 100, 129):           # ends in tiles 1, 2, 3 at bs = 64
        x = grand(1, 256, rank)
        sys_a = (x @ x.transpose(-1, -2)).contiguous()
        b2 = (sys_a @ grand(1, 256, 2)).contiguous()
        out = pp.cholesky_solve_tiled_fused(sys_a, b2, bs=64)
        guards.append((f"cholesky_solve_tiled rank {rank} of 256", out))
        resid = float((sys_a @ out - b2).abs().max() / b2.abs().max())
        print(f"  cholesky_solve_tiled   rank {rank} of 256 (bs=64): "
              f"|A x - b| / max|b| {resid:.3e}", flush=True)
        if not resid < 1e-3:
            failures.append(f"cholesky_solve_tiled rank {rank}: residual "
                            f"{resid:.3e}")
    for col in (10, 70, 130):             # panels 0, 1, 2 at bs = 64
        qa, qb = mid_case("qr_solve", 1, 192, 200)
        qa[:, :, col] = 0.0
        qb = grand(1, 200, 2)
        xq = pp.qr_solve_tiled_fused(qa, qb, bs=64)
        ok, err = close(xq, pp.qr_solve_tiled_plain(qa, qb, bs=64),
                        TILED_RTOL)
        print(f"  qr_solve_tiled         zero column {col} (bs=64): "
              f"|kernel-plain| {err:.3e} {'ok' if ok else 'MISMATCH'}",
              flush=True)
        guards.append((f"qr_solve_tiled zero column {col}", xq))
        if not ok or not torch.equal(xq[:, col],
                                     torch.zeros_like(xq[:, col])):
            failures.append(f"qr_solve_tiled zero column {col}")
    for name, key in (("cholesky_solve", "cholesky_solve_tiled"),
                      ("qr_solve", "qr_solve_tiled"),
                      ("mmse_equalize", "mmse_equalize_tiled")):
        spec = K.get(name)
        case = mid_case(key, 1, 512)
        lane = spec.filler(tuple(tuple(t.shape[1:]) for t in case),
                           (np.dtype("float32"),) * 2)
        out = fused[key](*(torch.from_numpy(t)[None].to(dev) for t in lane))
        guards.append((f"{key} filler lane n=512", out))
        if not torch.equal(out, torch.zeros_like(out)):
            failures.append(f"{key}: filler lane n=512 not exactly 0")

    # K11 / K13 under every plan the cluster plan may take for a shape
    # (each cluster size, the bands in shared or device memory): one answer
    # bit for bit; within the spec's rtol of the plain version on the
    # clean lanes; the duplicated-column lane finite, the zero column's
    # component zeroed, the lanes beside the NaN lane their clean batch's
    cgen = torch.Generator(device=dev)
    cgen.manual_seed(4)
    for name, m, n, bs, b in QR_CLUSTER_BITS:
        qa = grand(b, m, n, g=cgen)
        qb = grand(b, m, 1, g=cgen)
        qa[1, :, 3 * n // 4] = qa[1, :, 3]
        qa[2, :, n // 2] = 0.0
        clean = qa.clone()
        clean[3] = qa[0]
        qa[3, n // 3, n // 5] = float("nan")
        forms = pp.qr_cluster_forms(m, n, 1, bs)
        outs = [fused[name](qa, qb, bs=bs, plan=plan) for plan in forms]
        same = all(torch.equal(x.view(torch.int32), outs[0].view(torch.int32))
                   for x in outs)
        keep = [i for i in range(b) if i != 3]
        rows = [i for i in keep if i not in (1, 2)]
        ok, err = close(outs[0][rows], plain[name](qa, qb, bs=bs)[rows],
                        RTOLS[name])
        max_err[name] = max(max_err[name], err)
        guard = (bool(torch.isfinite(outs[0][keep]).all())
                 and torch.equal(outs[0][2, n // 2],
                                 torch.zeros_like(outs[0][2, n // 2]))
                 and torch.equal(outs[0][keep], fused[name](
                     clean, qb, bs=bs, plan=forms[0])[keep]))
        print(f"  {name:<22} {m}x{n} bs={bs}: {len(forms)} forms "
              f"{[(p.clusters, p.panel_shared) for p in forms]} bit for "
              f"bit: {same}; |kernel-plain| {err:.3e} (rtol {RTOLS[name]:g}); "
              f"guards: {guard}", flush=True)
        if not (same and ok and guard):
            failures.append(f"{name} {m}x{n} bs={bs}: forms {same}, plain "
                            f"{ok}, guards {guard}")
        del qa, qb, clean, outs

    # K12 / K14 under every plan of chol_tiled_forms (each cluster size and
    # product tile): C = 1's answer bit for bit; within the spec's rtol of
    # the plain version on the clean lanes; K12's poisoned upper triangle
    # its clean lane's answer, K14's NaN lane leaving its neighbours their
    # clean batch's, the deficient lane finite (inputs from a generator of
    # their own, so every other check keeps its draw)
    kgen = torch.Generator(device=dev)
    kgen.manual_seed(5)
    for name, m, n, bs, b in CHOL_TILED_BITS:
        k14 = name == "mmse_equalize_tiled"
        if k14:
            ta, tb = grand(b, m, n, g=kgen), grand(b, m, 2, g=kgen)
            ta[1, :, 3 * n // 5] = ta[1, :, 3]
            clean = ta.clone()
            ta[2, m // 3, n // 5] = float("nan")
        else:
            ta, tb = mid_case("cholesky_solve", b, n, g=kgen)
            f_ = grand(n, n, g=kgen)
            f_[:, 3 * n // 5] = f_[:, 3]
            ta[1] = f_ @ f_.T
            ta[2] = ta[0]
            tb[2] = tb[0]
            iu = torch.triu_indices(n, n, offset=1, device=dev)
            ta[2, iu[0], iu[1]] = float("nan")
        forms = pp.chol_tiled_forms(n, 2, bs, name, m if k14 else None)
        outs = [fused[name](ta, tb, bs=bs, plan=plan) for plan in forms]
        one = next(o for p, o in zip(forms, outs) if p.clusters == 1)
        same = all(torch.equal(x.view(torch.int32), one.view(torch.int32))
                   for x in outs)
        rows = [0, 3]
        ok, err = close(one[rows], plain[name](ta[rows], tb[rows], bs=bs),
                        RTOLS.get(name, RTOL))
        max_err[name] = max(max_err[name], err)
        if k14:
            keep = [0, 1, 3]
            guard = torch.equal(one[keep].view(torch.int32), fused[name](
                clean[keep].contiguous(), tb[keep].contiguous(), bs=bs,
                plan=forms[0]).view(torch.int32))
        else:
            guard = torch.equal(one[2].view(torch.int32),
                                one[0].view(torch.int32))
        guard = guard and bool(torch.isfinite(one[1]).all())
        print(f"  {name:<22} {m}x{n} bs={bs}: {len(forms)} forms "
              f"{[(p.clusters, p.tile) for p in forms]} bit for bit: "
              f"{same}; |kernel-plain| {err:.3e} (rtol "
              f"{RTOLS.get(name, RTOL):g}); guards: {guard}", flush=True)
        if not (same and ok and guard):
            failures.append(f"{name} {m}x{n} bs={bs}: forms {same}, plain "
                            f"{ok}, guards {guard}")
        del ta, tb, outs, one

    # K10 under every plan of chol_tiled_forms (each cluster size and
    # product tile): C = 1's answer bit for bit; within the spec's rtol of
    # the plain version on the clean lanes; the poisoned upper triangle its
    # clean lane's answer, the deficient lane finite; the first right-hand
    # side solved alone its bits inside the pair (inputs from a generator
    # of their own, so every other check keeps its draw)
    bgen = torch.Generator(device=dev)
    bgen.manual_seed(7)
    k10 = "cholesky_solve_blocked"
    for n, bs, b, k in BLOCKED_BITS:
        ta, tb = mid_case("cholesky_solve", b, n, g=bgen)
        f_ = grand(n, n, g=bgen)
        if k != 2:
            tb = grand(b, n, k, g=bgen)
        f_[:, 3 * n // 5] = f_[:, 3]
        ta[1] = f_ @ f_.T
        ta[2] = ta[0]
        tb[2] = tb[0]
        iu = torch.triu_indices(n, n, offset=1, device=dev)
        ta[2, iu[0], iu[1]] = float("nan")
        forms = pp.chol_tiled_forms(n, pp.blocked_rhs_groups(n, k, bs)[0],
                                    bs, k10)
        outs = [fused[k10](ta, tb, bs=bs, plan=plan) for plan in forms]
        one = next(o for p, o in zip(forms, outs) if p.clusters == 1)
        same = all(torch.equal(x.view(torch.int32), one.view(torch.int32))
                   for x in outs)
        rows = [0, 3]
        ok, err = close(one[rows], plain[k10](ta[rows], tb[rows], bs=bs),
                        RTOLS.get(k10, RTOL))
        max_err[k10] = max(max_err[k10], err)
        guard = (torch.equal(one[2].view(torch.int32),
                             one[0].view(torch.int32))
                 and bool(torch.isfinite(one[1]).all()))
        alone = torch.equal(
            fused[k10](ta, tb[:, :, :1].contiguous(), bs=bs)
            .view(torch.int32), one[:, :, :1].contiguous().view(torch.int32))
        print(f"  {k10:<22} n={n} bs={bs} k={k}: {len(forms)} forms "
              f"{[(p.clusters, p.tile) for p in forms]} bit for bit: "
              f"{same}; |kernel-plain| {err:.3e} (rtol "
              f"{RTOLS.get(k10, RTOL):g}); guards: {guard}; one rhs alone: "
              f"{alone}", flush=True)
        if not (same and ok and guard and alone):
            failures.append(f"{k10} n={n} bs={bs} k={k}: forms {same}, "
                            f"plain {ok}, guards {guard}, alone {alone}")
        del ta, tb, outs, one

    # K8 under every plan of svd_forms: one set of U, S and V bits at every
    # group size; each special lane alone its bits in the batch; the DAG
    # stage svd's bits; within the spec's rtol of the plain version (by
    # spectrum and reconstruction) on the clean lanes; the zero lane s = 0
    # exactly, the rank-2 lane finite (inputs from a generator of their
    # own, so every other check keeps its draw)
    sgen = torch.Generator(device=dev)
    sgen.manual_seed(6)

    def svd_bits(factors):
        return torch.cat([t.reshape(-1).view(torch.int32) for t in factors])

    for n, b in SVD_BITS:
        m = n + 4
        sa = grand(b, m, n, g=sgen)
        sa[1] = 0.0
        sa[2] = grand(m, 2, g=sgen) @ grand(2, n, g=sgen)
        sa[3, n // 3, n // 5] = float("nan")
        forms = S.svd_forms(m, n)
        outs = [S.svd_fused(sa, SWEEPS, plan=plan) for plan in forms]
        same = all(torch.equal(svd_bits(o), svd_bits(outs[0]))
                   for o in outs)
        plan = S.svd_plan(b, m, n)
        u, s_, v = outs[forms.index(plan)]
        alone = all(torch.equal(
            svd_bits(S.svd_fused(sa[i:i + 1].contiguous(), SWEEPS)),
            svd_bits((u[i:i + 1], s_[i:i + 1], v[i:i + 1])))
            for i in range(4))
        stage = torch.equal(
            svd_bits(pp.unpack_factors(pp.svd_factor_fused(sa))),
            svd_bits((u, s_, v)))
        rows = [0] + list(range(4, b))
        ok, err = close(spectrum_recon(u[rows], s_[rows], v[rows]),
                        spectrum_recon(*S.svd_plain(sa[rows], SWEEPS)),
                        SVD_RTOL)
        max_err["svd"] = max(max_err["svd"], err)
        guard = (torch.equal(s_[1], torch.zeros_like(s_[1]))
                 and all(bool(torch.isfinite(t[2]).all())
                         for t in (u, s_, v)))
        print(f"  svd {m}x{n} B={b}: plan {tuple(plan)}; {len(forms)} "
              f"forms {[(p.group, p.cache) for p in forms]} bit for bit: "
              f"{same}; "
              f"alone == in the batch: {alone}; svd_factor == svd: "
              f"{stage}; |kernel-plain| {err:.3e} (rtol {SVD_RTOL:.3g}); "
              f"guards: {guard}", flush=True)
        if not (same and alone and stage and ok and guard):
            failures.append(f"svd {m}x{n} B={b}: forms {same}, alone "
                            f"{alone}, stage {stage}, plain {ok}, guards "
                            f"{guard}")
        del sa, outs

    # ---- the primitives: K15-K17 and K19 ----
    print("primitive kernels (K15-K17, K19):", flush=True)
    for n in K.get("trisolve").sizes:
        l, b3 = (t.to(dev) for t in K.get("trisolve").make_case(rng, n))
        check("trisolve_upper", (l.mT.contiguous(), b3), f"registry n={n}")
    for taps in FIR_TAPS:
        check("fir", fir_case(rng, FIR_OUTPUTS, taps),
              f"{FIR_OUTPUTS} outputs, {taps} taps")
    for outputs, taps in ((1000, 30), (1000, 31), (300, 1), (257, 2)):
        check("fir", fir_case(rng, outputs, taps),
              f"{outputs} outputs, {taps} taps")
    # one lane past shared memory: the global form, in the output
    past = {"cholesky": (256,), "trisolve": (256, 2),
            "trisolve_upper": (256, 2), "qr": (260, 256)}
    for key, dims in past.items():
        k = kern[KERNEL_OF.get(key, key)]
        if k.fits_shared(*dims):
            fail(f"{key} at {dims} fits in shared memory")
        before = k.launches_global
        check(key, slot_case(key, rng, CHECK_LANES, 256),
              f"global B={CHECK_LANES} n=256")
        if k.launches_global != before + 1:
            failures.append(f"{key} n=256: the global form did not run")
    # both forms fit at n = 32: the global form equals the shared one
    for key in past:
        args = slot_case(key, rng, CHECK_LANES, 32)
        shared = fused[key](*args)
        with global_form(common):
            glob = fused[key](*args)
        same = all(torch.equal(x, y) for x, y in zip(
            shared if isinstance(shared, tuple) else (shared,),
            glob if isinstance(glob, tuple) else (glob,)))
        print(f"  {key:<22} n=32: global form == shared form bit for bit: "
              f"{same}", flush=True)
        if not same:
            failures.append(f"{key} n=32: global form != shared form")
    # K16's warp form against its CTA form (WARP_MAX_N = 0) bit for bit,
    # at every edge of the warp, NaN in the triangle neither reads never
    # leaking (the poisoned solve equals the clean one), and each call
    # one launch of the form it names
    tgen = torch.Generator(device=dev)
    tgen.manual_seed(3)
    k16 = kern["trisolve"]
    for lower in (True, False):
        bad = []
        for n in TRI_WARP_NS:
            x = grand(CHECK_LANES, n, n, g=tgen)
            l = torch.linalg.cholesky(torch.baddbmm(
                n * torch.eye(n, device=dev), x, x.mT))
            l = (l if lower else l.mT).contiguous()
            poisoned = l.clone()
            idx = torch.triu_indices(n, n, offset=1, device=dev)
            if not lower:
                idx = idx.flip(0)
            poisoned[:, idx[0], idx[1]] = float("nan")
            for m in TRI_WARP_MS:
                rhs = grand(CHECK_LANES, n, m, g=tgen)
                before = (k16.launches, k16.launches_warp)
                warp = KT.trisolve_fused(poisoned, rhs, lower=lower)
                clean = KT.trisolve_fused(l, rhs, lower=lower)
                with patched(KT, "WARP_MAX_N", 0):
                    cta = KT.trisolve_fused(poisoned, rhs, lower=lower)
                if not (torch.equal(warp, cta) and torch.equal(warp, clean)
                        and bool(torch.isfinite(warp).all())
                        and (k16.launches - before[0],
                             k16.launches_warp - before[1]) == (3, 2)):
                    bad.append((n, m))
        print(f"  {'trisolve':<22} {'lower' if lower else 'upper'} warp "
              f"form == CTA form bit for bit, NaN unread, at n in "
              f"{TRI_WARP_NS} x m in {TRI_WARP_MS}: "
              f"{'all' if not bad else 'not ' + str(bad)}", flush=True)
        if bad:
            failures.append(f"trisolve warp form != CTA form at {bad}")
    # K2's, K3's, K5's and K6's warp forms against their CTA forms bit for
    # bit (a deficient lane, a zero lane and a NaN lane among each
    # batch's), each default call one launch of the warp form; at the
    # served widths also against the plain version and the oracle
    MM = importlib.import_module("repro_torch.pipelines.mmse")
    PU = importlib.import_module("repro_torch.pipelines.pusch")
    wgen = torch.Generator(device=dev)
    wgen.manual_seed(5)
    # K2's and K5's served widths draw from a generator of their own, so
    # that every other check keeps its inputs (rng's and gen's draws)
    wrng = np.random.default_rng(5)
    bits = lambda t: t.reshape(-1).view(torch.int32)       # noqa: E731

    def special_lanes(key, b, n, k=2):
        """``key``'s lanes at m = n + 4, p = 2n (made on the card) with a
        deficient lane (1), a zero lane (2) and a NaN lane (3)."""
        m, p = n + 4, 2 * n
        if key == "mmse_equalize_split":
            args = [grand(b, m, n, g=wgen), grand(b, m, n, g=wgen),
                    grand(b, m, k, g=wgen), grand(b, m, k, g=wgen)]
            args[0][1, :, 1] = args[0][1, :, 0]
            args[1][1, :, 1] = args[1][1, :, 0]
            args[0][2], args[1][2] = 0.0, 0.0
        elif key == "mmse_equalize":
            args = [grand(b, m, n, g=wgen), grand(b, m, k, g=wgen)]
            args[0][1, :, 1] = args[0][1, :, 0]
            args[0][2] = 0.0
        else:
            args = [grand(b, n, p, g=wgen), grand(b, m, p, g=wgen)]
            if key == "pusch_chain":
                args.append(grand(b, m, k, g=wgen))
            args[0][1, 1] = args[0][1, 0]
            args[1][2] = 0.0
        args[0][3, 0, 0] = float("nan")
        return args

    for key in WARP_SERVED:
        k = kern[key]
        fn = fused[key]
        bad = []
        for n, b in WARP_BITS + WARP_SERVED[key]:
            args = special_lanes(key, max(b, 4), n)
            before = (k.launches, k.launches_warp)
            warp = fn(*args)
            cta = fn(*args, form="cta")
            torch.cuda.synchronize()
            if not ((k.launches - before[0], k.launches_warp - before[1])
                    == (2, 1) and torch.equal(bits(warp), bits(cta))
                    and bool(torch.isfinite(warp[:3]).all())):
                bad.append((n, b))
            del args, warp, cta
        print(f"  {key:<22} warp form == CTA form bit for bit at (n, "
              f"lanes) in {WARP_BITS + WARP_SERVED[key]}, deficient, zero "
              f"and NaN lanes: "
              f"{'all' if not bad else 'not ' + str(bad)}", flush=True)
        if bad:
            failures.append(f"{key} warp form != CTA form at {bad}")
        for n, b in WARP_SERVED[key]:
            own = key in ("mmse_equalize", "channel_estimate")
            check(key, slot_case(key, wrng if own else rng, b, n),
                  f"served B={b} n={n}")
    # K2's wide form against its CTA form bit for bit, each call one
    # launch of the wide form; on the mid-range mix's 32 lanes also
    # against the plain version and oracle, within 1e-4
    k2 = kern["mmse_equalize"]
    bad = []
    for n, b in WIDE_BITS:
        args = special_lanes("mmse_equalize", b, n)
        cta = MM.mmse_equalize_fused(*args, form="cta")
        before = (k2.launches, k2.launches_wide)
        wide = MM.mmse_equalize_fused(*args)
        torch.cuda.synchronize()
        if not ((k2.launches - before[0], k2.launches_wide - before[1])
                == (1, 1) and torch.equal(bits(wide), bits(cta))
                and bool(torch.isfinite(wide[:3]).all())):
            bad.append((n, b, MM.mmse_wide_plan(n + 4, n, 2)))
        del args, cta, wide
    print(f"  {'mmse_equalize':<22} wide form == CTA form bit for bit at "
          f"(n, lanes) in {WIDE_BITS}, the plan's W, deficient, zero and "
          f"NaN lanes: {'all' if not bad else 'not ' + str(bad)}",
          flush=True)
    if bad:
        failures.append(f"mmse_equalize wide form != CTA form at {bad}")
    check("mmse_equalize", mid_case("mmse_equalize", SERVED_LANES, 128,
                                    g=wgen),
          f"wide B={SERVED_LANES} n=128", rtol=1e-4)
    # guard cases: NaN in the triangle a kernel never reads
    a = torch.from_numpy(sample_spd(rng, 2, 16)).to(dev)
    clean = KC.cholesky_fused(a)
    poisoned = a.clone()
    iu = torch.triu_indices(16, 16, offset=1)
    poisoned[:, iu[0], iu[1]] = float("nan")
    got, _ = check("cholesky", (poisoned,), "poisoned upper",
                   oracle_args=(a,))
    if not torch.equal(got, clean):
        failures.append("cholesky: upper-triangle NaN leaked")
    for key, off in (("trisolve", 1), ("trisolve_upper", -1)):
        l, b3 = slot_case(key, rng, 2, 16)
        clean = fused[key](l, b3)
        poisoned = l.clone()
        idx = torch.triu_indices(16, 16, offset=1)
        if off < 0:
            idx = idx.flip(0)             # the strict lower triangle
        poisoned[:, idx[0], idx[1]] = float("nan")
        got, _ = check(key, (poisoned, b3), "poisoned unread triangle",
                       oracle_args=(l, b3))
        if not torch.equal(got, clean):
            failures.append(f"{key}: unread-triangle NaN leaked")
    for m, n in ((17, 16), (33, 32), (1, 1)):
        check("qr", (rand(rng, 64, m, n),), f"B=64 {m}x{n}")
    a1 = rand(rng, 3, 1, 1)
    q1, r1 = KQ.qr_fused(a1)
    if not (torch.equal(q1, torch.ones_like(q1)) and torch.equal(r1, a1)):
        failures.append("qr: m = 1 is not Q = I, R = A")
    # a wide matrix (M < N): min(N, M - 1) reflectors, R an upper trapezoid
    got, _ = check("qr", (rand(rng, 2, 4, 6),), "wide 4x6")
    if not torch.all(torch.tril(got[1], -1) == 0):
        failures.append("qr: wide R not zero below its diagonal")
    # K1 takes bfloat16: float32 inside, bf16 out (the reference's case)
    a16 = torch.from_numpy(sample_spd(rng, 2, 16)).to(dev)
    b16 = rand(rng, 2, 16, 2)
    x16 = pp.cholesky_solve_fused(a16.bfloat16(), b16.bfloat16())
    ok, err = close(x16, ref.cholesky_solve(a16, b16), 8e-2)
    print(f"  cholesky_solve         bf16 registry n=16          "
          f"|kernel-oracle| {err:.3e}  (rtol 0.08) "
          f"{'ok' if ok and x16.dtype == torch.bfloat16 else 'MISMATCH'}")
    if not (ok and x16.dtype == torch.bfloat16):
        failures.append("cholesky_solve: bf16")

    # ---- the LM kernels: K18 and K20 ----
    print("LM kernels (K18 GEMM, K20 flash attention):", flush=True)
    for m, kk, n in ((1000, 300, 700), (129, 257, 65), (1, 1, 1)):
        check("ops_gemm", (rand(rng, m, kk), rand(rng, kk, n)),
              f"ops.gemm {m}x{kk}x{n}")
    check("ops_gemm", (rand(rng, 1000, 300).bfloat16(),
                       rand(rng, 300, 700).bfloat16()),
          "ops.gemm 1000x300x700 bf16", rtol=BF16_RTOL)

    def gemm_bf16_check(x, y):
        """K18 in bf16 (its tensor-core form: ``check`` holds the form)
        against its plain version and the float32 oracle on the same
        inputs, at BF16_RTOL and element by element within
        GEMM_BF16_STEP |want| + GEMM_BF16_SUM (|x| |y|).  Returns the
        kernel's answer."""
        label = f"{x.shape[0]}x{x.shape[1]}x{y.shape[1]} bf16"
        got, want = check("gemm", (x, y), label, rtol=BF16_RTOL)
        wide = x.float() @ y.float()
        limit = (GEMM_BF16_SUM * (x.float().abs() @ y.float().abs())).double()
        worst = [float(((got.double() - w.double()).abs()
                        / (GEMM_BF16_STEP * w.double().abs() + limit)
                        .clamp_min(1e-300)).max()) for w in (want, wide)]
        print(f"    worst |diff| / limit: {worst[0]:.3f} against the plain "
              f"version, {worst[1]:.3f} against the float32 oracle",
              flush=True)
        if max(worst) > 1.0:
            failures.append(f"gemm {label}: element beyond its limit")
        return got

    for m, kk, n in GEMM_BF16_CASES:
        x, y = grand(m, kk).bfloat16(), grand(kk, n).bfloat16()
        got = gemm_bf16_check(x, y)
        if (m, kk, n) == GEMM_BF16_CASES[-1]:
            again = KG.gemm_fused(x, y)
            same = torch.equal(got, again)
            print(f"    run twice: bit-identical {same}", flush=True)
            if not same:
                failures.append(f"gemm {m}x{kk}x{n} bf16: two runs differ")
        del x, y, got

    def attn_case(b, h, hkv, s, d, dtype):
        """Peaked scores: q and k at sigma 1.5 (scaled scores of sigma
        ~2.25, so each row's max moves from kv tile to kv tile), q with
        a common component 3 / sqrt(D) per element and the key at
        s - 1 - s // 16, in the last kv tile, set to 6 per element: a
        score of ~18 planted late, where the running max jumps and all
        that came before must be rescaled.  v standard normal."""
        q = rand(rng, b, h, s, d) * 1.5 + 3.0 / math.sqrt(d)
        k = rand(rng, b, hkv, s, d) * 1.5
        k[:, :, s - 1 - s // 16] = 6.0
        return q.to(dtype), k.to(dtype), rand(rng, b, hkv, s, d).to(dtype)

    def attn_check(args, label, keys=("flash_attention",
                                      "flash_attention_full")):
        """K20 against its plain version and the float32 oracle on the
        same inputs, element by element: the limit is ATTN_RTOLS[dtype]
        of softmax(q k^T) |v| + |out| (the error p's rounding can make).
        bf16 must run the tensor-core form, float32 the SIMT form.
        Returns the kernel's answer of the last key."""
        dtype = str(args[0].dtype)[6:]
        rtol = ATTN_RTOLS[dtype]
        wide = tuple(t.float() for t in args)
        k20 = kern["flash_attention"]
        for key in keys:
            scale = oracle[key](wide[0], wide[1], wide[2].abs())
            before = (k20.launches, k20.launches_tc)
            got, want = check(key, args, f"{label} {dtype}",
                              oracle_args=wide, rtol=rtol, scale=scale)
            tc = int(dtype == "bfloat16")
            if (k20.launches, k20.launches_tc) != (before[0] + 1,
                                                   before[1] + tc):
                failures.append(f"{key} {label} {dtype}: ran the "
                                f"{'SIMT' if tc else 'tensor-core'} form")
            worst = [float(((got.double() - w.double()).abs()
                            / (rtol * (scale.double() + w.double().abs())))
                           .max()) for w in (want, oracle[key](*wide))]
            print(f"    worst |diff| / limit: {worst[0]:.3f} against the "
                  f"plain version, {worst[1]:.3f} against the oracle",
                  flush=True)
        return got

    for d in FLASH_DIMS:
        h, hkv = (24, 8) if d == 128 else (4, 2)
        for s in FLASH_SEQS:
            for dtype in (torch.float32, torch.bfloat16):
                attn_check(attn_case(1, h, hkv, s, d, dtype),
                           f"D={d} S={s}")
    attn_check(attn_case(LM_BATCH, 24, 8, LM_SEQS[0], 128, torch.bfloat16),
               f"B={LM_BATCH} 24/8 S=512", keys=("flash_attention",))
    attn_check(attn_case(LM_BATCH, 32, 32, LM_SEQS[0], 80, torch.bfloat16),
               f"B={LM_BATCH} 32/32 S=512 D=80", keys=("flash_attention",))
    # the models' route: ops.flash_attention on (B, S, H, D) tensors handed
    # over as transposed views, read through strides and answered in their
    # layout, held like the cases above and equal bit for bit to the
    # kernel on contiguous (B, H, S, D) copies, in both forms
    for b, h, hkv, s, d in FLASH_STRIDED:
        for dtype in (torch.float32, torch.bfloat16):
            views = tuple(t.transpose(1, 2).contiguous().transpose(1, 2)
                          for t in attn_case(b, h, hkv, s, d, dtype))
            got = attn_check(views, f"({b},{s},{h},{d}) strided",
                             keys=("ops_flash_attention",))
            same = torch.equal(got, KA.flash_attention_fused(
                *(t.contiguous() for t in views)))
            layout = got.transpose(1, 2).is_contiguous()
            print(f"    strided == contiguous bit for bit: {same}; answer "
                  f"in the (B, S, H, D) layout: {layout}", flush=True)
            if not (same and layout):
                failures.append(f"ops_flash_attention ({b},{s},{h},{d}) "
                                f"{dtype}: strided route differs")
            del views, got

    print("K21 (chunked SSD scan):", flush=True)

    def ssm_case(b, h, s, p, n, per_head, decays):
        """Kernel-layout inputs made on the card: x standard normal,
        decays uniform over ``decays``, B/C normal of variance 1 / N."""
        bc = (b, h, s, n) if per_head else (b, s, n)
        a = torch.rand((b, h, s), generator=gen, device=dev)
        return (grand(b, h, s, p), decays[0] + (decays[1] - decays[0]) * a,
                grand(*bc) / math.sqrt(n), grand(*bc) / math.sqrt(n))

    for label, b, h, s, p, n, per_head, chunk, decays in SSM_CASES:
        args = ssm_case(b, h, s, p, n, per_head, decays)
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            targs = tuple(t.to(dtype) for t in args)
            got, _ = check("ssm_scan", targs,
                           f"{label} ({b},{h},{s},{p}) N={n} "
                           f"{'bf16' if bf16 else 'f32'}",
                           oracle_args=tuple(t.float() for t in targs),
                           rtol=SSM_BF16_RTOL if bf16 else None, chunk=chunk)
            # every cluster size (and the narrowest lane) the plan can
            # pick: the plan's bits
            forms = KS.ssm_check_forms(b, h, s, p, n, min(chunk, s))
            same = all(all(torch.equal(g, w) for g, w in zip(
                KS.ssm_scan_fused(*targs, chunk=chunk, plan=f), got))
                for f in forms[1:])
            print(f"    forms {[tuple(f)[:3] for f in forms]} bit for bit "
                  f"the plan's: {same}", flush=True)
            if not same:
                failures.append(f"ssm_scan {label} {dtype}: a form's "
                                f"answer differs from the plan's")
            del targs, got
        del args
    # the models' route: ops.ssm_scan on its (B, S, H, P) layout with shared
    # or per-head B/C, which the kernel reads through strides (x's sequence
    # axis strided over the heads, a head stride of 0 for shared B/C), held
    # like the kernel-layout cases above
    for label, b, h, s, p, n, per_head, chunk, decays in SSM_CASES[1:3]:
        x, a, bb, cc = ssm_case(b, h, s, p, n, per_head, decays)
        move = lambda t: t.transpose(1, 2).contiguous()
        args = (move(x), move(a), *((move(bb), move(cc)) if per_head
                                    else (bb, cc)))
        del x, a, bb, cc
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            check("ops_ssm_scan", tuple(t.to(dtype) for t in args),
                  f"{label} ({b},{s},{h},{p}) N={n} "
                  f"{'bf16' if bf16 else 'f32'}",
                  oracle_args=tuple(t.to(dtype).float() for t in args),
                  rtol=SSM_BF16_RTOL if bf16 else None, chunk=chunk)
        del args
    for label, call in (
            ("flash_attention S=200 (not a multiple of 128)",
             lambda: KA.flash_attention_fused(
                 *(torch.ones((1, 2, 200, 64), device=dev),) * 3)),
            ("ssm_scan S=100 (not a multiple of its chunk 64)",
             lambda: KS.ssm_scan_fused(
                 *ssm_case(1, 2, 100, 4, 8, False, (0.8, 0.99)), chunk=64)),
            ("ssm_scan chunk 256 (past the kernel's 128)",
             lambda: KS.ssm_scan_fused(
                 *ssm_case(1, 2, 512, 4, 8, False, (0.8, 0.99)),
                 chunk=256)),
            ("ssm_scan N=160 at chunk 128 (past shared memory)",
             lambda: KS.ssm_scan_fused(
                 *ssm_case(1, 2, 128, 4, 160, False, (0.8, 0.99)),
                 chunk=128)),
            ("gemm K mismatch (4x5 @ 6x3)",
             lambda: KG.gemm_fused(torch.ones((4, 5), device=dev),
                                   torch.ones((6, 3), device=dev))),
            ("ops.gemm K mismatch (4x5 @ 6x3)",
             lambda: K.gemm(torch.ones((4, 5), device=dev),
                            torch.ones((6, 3), device=dev), device=dev))):
        try:
            call()
        except ValueError as e:
            print(f"  guard {label}: raises ({e})")
        else:
            failures.append(f"guard {label}: did not raise")

    for label, out in guards:
        finite = bool(torch.isfinite(out).all())
        print(f"  guard {label:<38} finite={finite}")
        if not finite:
            failures.append(f"guard {label}: non-finite output")
    if failures:
        fail("kernel checks: " + "; ".join(failures))

    # ---------------- 4. serve: the main paths ----------------
    from repro_torch.launch import serve_solvers as S_
    from repro_torch.serve import CostModel, OverloadPolicy
    launches = {name: 0 for name in kern}

    launches_global = {name: 0 for name in kern}
    launches_tc = {name: 0 for name in kern}
    launches_warp = {name: 0 for name in kern}
    launches_wide = {name: 0 for name in kern}
    k2_forms = {}                     # path -> K2's launches by form

    def reset_launches():
        for k in common.KERNELS:
            k.launches = 0
            k.launches_global = 0
            k.launches_tc = 0
            k.launches_warp = 0
            k.launches_wide = 0

    def read_launches(path: str, expect: tuple, expect_global=(),
                      exact: dict | None = None, expect_warp=(),
                      expect_wide=()):
        """Print and add up the launches since the last reset; fail if a
        kernel in ``expect`` (a global form in ``expect_global``, a warp
        form in ``expect_warp``, K2's wide form in ``expect_wide``) never
        launched or, given ``exact``, if the launched kernels and their
        counts are not exactly those.  K2's launches are split by form
        (warp, wide, CTA, global)."""
        counts = {k.name: k.launches for k in common.KERNELS}
        glob = {k.name: k.launches_global for k in common.KERNELS
                if k.launches_global}
        tc = {k.name: k.launches_tc for k in common.KERNELS
              if k.launches_tc}
        warp = {k.name: k.launches_warp for k in common.KERNELS
                if k.launches_warp}
        wide = {k.name: k.launches_wide for k in common.KERNELS
                if k.launches_wide}
        k2 = kern["mmse_equalize"]
        k2_forms[path] = {
            "warp": k2.launches_warp, "wide": k2.launches_wide,
            "cta": (k2.launches - k2.launches_warp - k2.launches_wide
                    - k2.launches_global),
            "global": k2.launches_global}
        print(f"main-path launches ({path}): {json.dumps(counts)}; "
              f"of them in the global form: {json.dumps(glob)}, in a "
              f"tensor-core form: {json.dumps(tc)}, in a warp form: "
              f"{json.dumps(warp)}, in K2's wide form: {json.dumps(wide)};"
              f" K2 by form: {json.dumps(k2_forms[path])}", flush=True)
        if not all(counts[name] for name in expect):
            fail(f"a kernel of the {path} path never launched: {counts}")
        if not all(glob.get(name) for name in expect_global):
            fail(f"a global form of the {path} path never ran: {glob}")
        if not all(warp.get(name) for name in expect_warp):
            fail(f"a warp form of the {path} path never ran: {warp}")
        if not all(wide.get(name) for name in expect_wide):
            fail(f"a wide form of the {path} path never ran: {wide}")
        if exact is not None and {n: c for n, c in counts.items() if c} \
                != exact:
            fail(f"the {path} path launched {counts}, not exactly {exact}")
        for name, c in counts.items():
            launches[name] += c
            launches_global[name] += glob.get(name, 0)
            launches_tc[name] += tc.get(name, 0)
            launches_warp[name] += warp.get(name, 0)
            launches_wide[name] += wide.get(name, 0)

    reset_launches()
    for argv in (["--slots", "8", "--lanes", "8", "--sizes", "8,12",
                  "--policy"],
                 ["--slots", "8", "--lanes", "32", "--sizes", "16,32",
                  "--policy"]):
        print(f"serve_solvers {' '.join(argv)}", flush=True)
        summary = S_.main(argv)
        print(f"  summary {json.dumps(summary)}")
        if summary is None or summary["hard_dropped"] != 0 \
                or not summary["oracle_rel_err"] < 1e-3 \
                or summary["done"] != summary["jobs"]:
            fail(f"serve {argv}: {summary}")
    trace = S_.load_trace(ROOT / "tests" / "data" / "overload_trace.json")
    mux = S_.replay_trace(trace, lanes=2, policy=OverloadPolicy(
        budget=6.5e-5, cost_model=CostModel()), pressure=4)
    want = json.loads((ROOT / "tests" / "data"
                       / "overload_golden.json").read_text())
    got = json.loads(json.dumps(mux.events))
    print(f"golden replay: {len(got)} events, equal={got == want}")
    if got != want:
        fail("overload trace replay differs from overload_golden.json")
    read_launches("TTI slot mix", ("cholesky_solve", "mmse_equalize",
                                   "mmse_equalize_split", "qr_solve"),
                  expect_warp=("mmse_equalize", "mmse_equalize_split"))

    reset_launches()
    fault_trace = str(ROOT / "tests" / "data" / "pusch_fault_trace.json")
    for argv in (["--pusch", "--fault-trace", fault_trace],
                 ["--pusch", "--sizes", "24", "--lanes", "32",
                  "--ticks", "8"]):
        print(f"serve_solvers {' '.join(argv)}", flush=True)
        out = S_.main(argv)
        for mode, s in out.items():
            if s["done"] != s["dags"] or s["hard_lost"] != 0 \
                    or not s["max_rel_err"] < 2e-3 or s["pending"]:
                fail(f"pusch {argv} {mode}: {s}")
        if "--fault-trace" in argv and not out["staged"]["retries"] >= 1:
            fail(f"pusch fault trace did not fire: {out['staged']}")
    trace = json.loads((ROOT / "tests" / "data"
                        / "pusch_trace.json").read_text())
    mux, dags = S_.replay_pusch(trace)
    got = json.dumps(mux.drain_events(), indent=1) + "\n"
    want = (ROOT / "tests" / "data" / "pusch_golden.json").read_text()
    print(f"pusch golden replay: equal={got == want}", flush=True)
    if got != want:
        fail("pusch trace replay differs from pusch_golden.json")
    for d in dags:
        ok, err = close(torch.from_numpy(d.out),
                        torch.from_numpy(d.spec.oracle(*d.args)),
                        d.spec.rtol)
        if d.state != "done" or not ok:
            fail(f"pusch golden dag {d.dag} {d.seq}: {d.state}, "
                 f"|out - oracle| {err:.3e}")
    read_launches("served DAGs", ("mmse_equalize", "channel_estimate",
                                  "pusch_chain", "fft", "svd",
                                  "svd_apply"),
                  expect_warp=("mmse_equalize", "channel_estimate",
                               "pusch_chain"))

    reset_launches()
    for argv in (["--slots", "8", "--lanes", "32", "--sizes", "128,256"],
                 ["--slots", "8", "--lanes", "32", "--sizes", "128,256",
                  "--policy"]):
        print(f"serve_solvers {' '.join(argv)}", flush=True)
        summary = S_.main(argv)
        print(f"  summary {json.dumps(summary)}")
        if summary is None or summary["hard_dropped"] != 0 \
                or not summary["oracle_rel_err"] < 1e-3 \
                or summary["done"] != summary["jobs"]:
            fail(f"serve {argv}: {summary}")
    read_launches("mid-range slot mix",
                  ("cholesky_solve_blocked", "qr_solve_blocked",
                   "mmse_equalize", "mmse_equalize_split"),
                  ("mmse_equalize", "mmse_equalize_split"),
                  expect_wide=("mmse_equalize",))

    reset_launches()
    for argv in (["--slots", "4", "--lanes", "32", "--sizes", "512"],
                 ["--slots", "4", "--lanes", "32", "--sizes", "512",
                  "--policy"]):
        print(f"serve_solvers {' '.join(argv)}", flush=True)
        summary = S_.main(argv)
        print(f"  summary {json.dumps(summary)}")
        if summary is None or summary["hard_dropped"] != 0 \
                or not summary["oracle_rel_err"] < TILED_RTOL \
                or summary["done"] != summary["jobs"]:
            fail(f"serve {argv}: {summary}")
    read_launches("HBM-scale slot mix",
                  ("cholesky_solve_tiled", "qr_solve_tiled",
                   "mmse_equalize_tiled", "mmse_equalize_split"),
                  ("mmse_equalize_split",))

    from repro_torch.launch import dsp_pipeline
    for argv in ([], ["--batch", str(LANES), "--samples",
                      str(FIR_OUTPUTS + FIR_TAPS[0] - 1)]):
        reset_launches()
        print(f"dsp_pipeline {' '.join(argv)}", flush=True)
        errors = dsp_pipeline.main(argv)
        print(f"  errors {json.dumps(errors)}", flush=True)
        if not (errors["nmse"] < 1.0 and errors["fft_err"] < 1e-3
                and errors["fir_err"] < 1e-4 and errors["svd_err"] < 1e-4):
            fail(f"dsp_pipeline {argv}: {errors}")
        read_launches(f"DSP chain {' '.join(argv) or 'defaults'}",
                      tuple(DSP_LAUNCHES), exact=DSP_LAUNCHES)

    def baseline_case(name, n):
        """The inputs of the reference's fused-vs-unfused tests
        (tests/test_pipelines.py: SPD systems, (n + 4) x n matrices, two
        right-hand sides) at a carrier's width."""
        if name == "cholesky_solve":
            return (torch.from_numpy(sample_spd(rng, LANES, n)).to(dev),
                    rand(rng, LANES, n, 2))
        return rand(rng, LANES, n + 4, n), rand(rng, LANES, n + 4, 2)

    # the unfused baselines against their fused kernels
    for name, base, tol in BASELINES:
        for n in SLOT_SIZES:
            args = baseline_case(name, n)
            reset_launches()
            got = getattr(pp, base)(*args)
            torch.cuda.synchronize()
            read_launches(f"{base} B={LANES} n={n}",
                          tuple(BASELINE_LAUNCHES[name]),
                          exact=BASELINE_LAUNCHES[name])
            ok, err = close(got, fused[name](*args), tol)
            print(f"  {base:<24} B={LANES} n={n}: |unfused-fused| "
                  f"{err:.3e} (rtol {tol:g}) {'ok' if ok else 'MISMATCH'}",
                  flush=True)
            if not ok:
                fail(f"{base} n={n} differs from {name}: {err:.3e}")

    # the primitive API of the LM kernels: ops.gemm (K18) at the
    # registry's squares, at shapes that are not multiples of its tile and
    # in bf16, and ops.flash_attention (K20) at the registry case
    reset_launches()
    for n in K.get("gemm").sizes:
        K.gemm(*(a.to(dev) for a in K.get("gemm").make_case(rng, n)),
               device=dev)
    K.gemm(rand(rng, 1000, 300), rand(rng, 300, 700), device=dev)
    K.gemm(rand(rng, 1000, 300).bfloat16(), rand(rng, 300, 700).bfloat16(),
           device=dev)
    K.flash_attention(*(a.to(dev) for a in K.get("flash_attention")
                        .make_case(rng, 128)), device=dev)
    torch.cuda.synchronize()
    read_launches("primitive API ops.gemm / ops.flash_attention",
                  ("gemm", "flash_attention"),
                  exact={"gemm": 4, "flash_attention": 1})
    if kern["gemm"].launches_tc != 1:          # the bf16 call, and no other
        fail(f"ops.gemm: {kern['gemm'].launches_tc} of 4 K18 launches in "
             f"the tensor-core form, not 1 (the bf16 call)")

    # the decode golden: the committed mixed solver + decode trace through
    # the port's mux on the card (K2 serves its solver jobs), event for
    # event equal to the golden file; then the --decode entry point
    reset_launches()
    trace = json.loads((ROOT / "tests" / "data"
                        / "decode_trace.json").read_text())
    mux, _, reqs, jobs = S_.replay_decode(trace)
    got = json.dumps(mux.drain_events(), indent=1) + "\n"
    want = (ROOT / "tests" / "data" / "decode_golden.json").read_text()
    print(f"decode golden replay: {len(reqs)} requests, {len(jobs)} solver "
          f"jobs, equal={got == want}", flush=True)
    if got != want or not all(r.done for r in reqs) \
            or not all(j.state == "done" for j in jobs):
        fail("decode trace replay differs from decode_golden.json")
    print("serve_solvers --decode", flush=True)
    out = S_.main(["--decode"])
    print(f"  summary {json.dumps(out)}", flush=True)
    read_launches("decode golden + --decode", ("mmse_equalize",),
                  expect_warp=("mmse_equalize",))

    # ---------------- 5. times ----------------
    flush = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=dev)

    def timed_call(fn):
        """Device time of one fn() in ms, L2 flushed before it.  The card
        first spins for ~0.5 ms so that the host has enqueued the call
        before the start event fires: the host's launch path (argument
        checks, ctypes) is not counted as device time."""
        torch.cuda._sleep(1_000_000)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    def time_ms(fn, reps):
        """Median device time of fn() per call over ``reps`` calls after a
        warm-up, or over 5 where the warm-up passes SLOW_MS.  Returns
        (median, slowest, calls): one slow call moves a mean by its whole
        excess over the number of calls, the median not at all."""
        if timed_call(fn) > SLOW_MS:
            reps = min(reps, 5)
        times = [timed_call(fn) for _ in range(reps)]
        return statistics.median(times), max(times), reps

    def work(key, shapes, chunk=None):
        """(bytes, FLOPs) one call must move and do at these per-lane
        shapes (per row for the FFT): each input read once, each output
        written once; the least float32 work, an FMA counted as two, a
        symmetric Gram matrix counted by one triangle (the registry's
        flops models count it whole, because they price work for the
        cost model, not bound it).  A blocked kernel computes its base
        kernel's function, so it has the same least work."""
        key = key.removesuffix("_blocked").removesuffix("_tiled")
        if key == "ssm_scan":                  # whole shapes, float32: x, a,
            (b, h, s, p), _, bc = shapes[:3]   # B, C read, y and h written;
            n = bc[-1]                         # per (b, h, chunk) M x, C h
            cs = min(chunk, s)                 # and the update, and the
            gram = b * (s // cs) * cs * (cs + 1) * n   # triangle of C B^T
            if len(bc) == 4:                   # per (b, chunk) where B, C
                gram *= h                      # are shared, per head not
            return (4 * (2 * b * h * s * p + b * h * s
                         + 2 * math.prod(bc) + b * h * n * p),
                    gram + b * h * (s // cs) * (cs * (cs + 1) * p
                                                + 4 * cs * n * p))
        if key == "gemm":                      # whole shapes, float32
            (m, kk), (_, n) = shapes
            return 4 * (m * kk + kk * n + m * n), 2 * m * n * kk
        if key == "flash_attention":           # causal: the lower
            b, h, s, d = shapes[0]             # triangle with its diagonal
            hkv = shapes[1][1]                 # (QK^T and PV, 2 FLOPs a
            return (4 * (2 * b * h * s * d + 2 * b * hkv * s * d),  # MAC)
                    2 * b * h * s * (s + 1) * d)
        if key == "fir":                       # whole shapes, one signal
            (nx,), (taps,) = shapes
            out = nx - taps + 1
            return (4 * (nx + taps + out),
                    out * (3 * (taps // 2) + 2 * (taps % 2)))
        if key == "cholesky":                  # reads the lower triangle
            n = shapes[0][0]
            return 4 * (n * (n + 1) // 2 + n * n), n ** 3 / 3
        if key in ("trisolve", "trisolve_upper"):
            (n, _), (_, k) = shapes            # reads one triangle
            return 4 * (n * (n + 1) // 2 + 2 * n * k), n * n * k
        if key == "qr":                        # Householder R, then Q
            m, n = shapes[0]                   # from I, columns >= k
            return (4 * (m * n + m * m + m * n),
                    2 * m * n * n - 2 * n ** 3 / 3 + 4 * m * m * n
                    - 2 * m * n * n)
        if key in ("fft", "pusch_fft"):
            nf = shapes[0][-1]
            rows = shapes[0][0] if key == "pusch_fft" else 1
            return 16 * nf * rows, 5 * nf * math.log2(nf) * rows
        if key in ("svd", "svd_factor"):
            m, n = shapes[0]
            return (4 * (2 * m * n + n * n + n),
                    SWEEPS * n * (n - 1) / 2 * (6 * m + 6 * (m + n)))
        if key == "svd_apply":
            (mn1, n), (m, k) = shapes
            return (4 * (mn1 * n + m * k + n * k),
                    2 * m * n * k + 2 * n * n * k + 3 * n * k)
        if key in ("channel_estimate", "pusch_chain"):
            n, p = shapes[0]
            m = shapes[1][0]
            est = n * (n + 1) * p + 2 * n * p * m + n ** 3 / 3 \
                + 2 * n * n * m
            if key == "channel_estimate":
                return 4 * (n * p + m * p + m * n), est
            k = shapes[2][1]
            return (4 * (n * p + m * p + m * k + n * k),
                    est + m * n * (n + 1) + 2 * m * n * k + n ** 3 / 3
                    + 2 * n * n * k)
        m = shapes[0][0]
        n = shapes[0][1]
        k = shapes[-1][1]
        chain = n ** 3 / 3 + 2 * n * n * k     # factor + two substitutions
        if key == "cholesky_solve":            # reads the lower triangle
            return 4 * (n * (n + 1) // 2 + n * k + n * k), chain
        if key == "mmse_equalize":             # G = H^T H, H^T y, chain
            return (4 * (m * n + m * k + n * k),
                    m * n * (n + 1) + 2 * m * n * k + chain)
        if key == "mmse_equalize_split":       # Gr over [Hr; Hi], C =
            n2 = 2 * n                         # Hr^T Hi, two stacked matched
            return (4 * (2 * m * n + 2 * m * k + 2 * n * k),   # filters,
                    2 * m * n * (n + 1) + 2 * m * n * n        # chain
                    + 8 * m * n * k + n2 ** 3 / 3 + 2 * n2 * n2 * k)
        # Householder QR of A, Q^T b, back substitution
        return (4 * (m * n + m * k + n * k),
                2 * m * n * n - 2 * n ** 3 / 3 + 4 * m * n * k
                - 2 * n * n * k + n * n * k)

    def syncs(fn):
        """Whether fn() makes the host wait for the card, as torch's sync
        debug mode reports it."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return any("synchroniz" in str(w.message).lower() for w in caught)

    def library(key, args):
        """One PyTorch call computing the same function, where there is
        one (its inputs prepared outside the timed call), else None."""
        key = key.removesuffix("_blocked").removesuffix("_tiled")
        if key == "cholesky_solve":
            return lambda: torch.linalg.solve_ex(
                *args, check_errors=False).result
        if key == "qr_solve":
            return lambda: torch.linalg.lstsq(*args).solution
        if key in ("fft", "pusch_fft"):
            z = torch.complex(*args)
            return lambda: torch.fft.fft(z)
        if key == "svd_factor":
            return lambda: torch.linalg.svd(args[0], full_matrices=False)
        if key == "cholesky":
            return lambda: torch.linalg.cholesky_ex(args[0]).L
        if key in ("trisolve", "trisolve_upper"):
            return lambda: torch.linalg.solve_triangular(
                *args, upper=key == "trisolve_upper")
        if key == "qr":
            return lambda: torch.linalg.qr(args[0], mode="complete")
        if key == "gemm":                      # cuBLAS with TF32 off (above)
            return lambda: torch.matmul(*args)
        if key == "flash_attention":           # KV heads repeated outside
            q, k, v = args
            g = q.shape[1] // k.shape[1]
            kr = k.repeat_interleave(g, dim=1)
            vr = v.repeat_interleave(g, dim=1)
            return lambda: torch.nn.functional.scaled_dot_product_attention(
                q, kr, vr, is_causal=True)
        if key == "fir":                       # cuDNN with TF32 off (above)
            return lambda: torch.nn.functional.conv1d(args[0][None, None],
                                                      args[1][None, None])
        return None

    # ---- 4b. the LM serving paths at full width (timed here) ----
    lm = {arch: lm_path(arch, dev, read_launches, reset_launches, kern)
          for arch in LM_ARCHS}

    # the timed call of each kernel: its main-path entry point, returning
    # what the main path gets (not the spectrum/reconstruction view)
    timed = {"fft": "pusch_fft", "svd": "svd_factor"}
    calls = {"pusch_fft": (pp.pusch_fft_fused, pp.pusch_fft_plain),
             "svd_factor": (pp.svd_factor_fused, pp.svd_factor_plain),
             "fft": (F.fft_fused, F.fft_plain)}
    # the large plain versions (n >= 128) are timed once, after one
    # warm-up call
    rows = []
    for name, k in kern.items():
        key = timed.get(name, name)
        # (label, n, form, lanes, make, the key of the timed call)
        cases = [(f"n={n}", n, None, LANES,
                  lambda n=n: slot_case(key, rng, LANES, n), key)
                 for n in SLOT_SIZES if key in SLOT_KEYS]
        if name == "trisolve":
            cases += [(f"upper n={n}", n, None, LANES,
                       lambda n=n: slot_case("trisolve_upper", rng, LANES,
                                             n), "trisolve_upper")
                      for n in SLOT_SIZES]
        if name == "fir":                  # one signal: lanes = 1
            cases += [(f"{taps} taps", None, None, 1,
                       lambda taps=taps: fir_case(rng, FIR_OUTPUTS, taps),
                       "fir") for taps in FIR_TAPS]
        if name == "fft":
            cases += [(f"nf={nf}", None, None, LANES,
                       lambda nf=nf: (rand(rng, LANES, nf),
                                      rand(rng, LANES, nf)), "fft")
                      for nf in (NFFT_MAX, NFFT_CARRIER)]
        for n, m, form, b in MID_TIMES.get(name, ()):
            cases.append((f"n={n}" + (f" {form}" if form else "")
                          + (f" B={b}" if b != LANES else ""), n, form, b,
                          lambda n=n, m=m, b=b: mid_case(key, b, n, m),
                          key))
        if name in TILED_TIMES:
            cases += [(f"n={n} B={b}", n, None, b,
                       lambda n=n, b=b: mid_case(key, b, n), key)
                      for n, b in TILED_CASES + ((512, SERVED_LANES),)]
        if name in WARP_SERVED:            # the served widths
            cases += [(f"n={n} B={b}", n, None, b,
                       lambda n=n, b=b: slot_case(key, rng, b, n), key)
                      for n, b in WARP_SERVED[name]]
        if name in ("svd", "svd_apply"):   # the served DAGs' widths
            cases += [(f"n={n} B={b}", n, None, b,
                       lambda n=n, b=b: slot_case(key, rng, b, n), key)
                      for n, b in SVD_SERVED]
        if name == "gemm":                 # whole shapes: lanes = 1
            cases += [(f"{m}x{kk}x{n} {dt}", None, None, 1,
                       lambda m=m, kk=kk, n=n, dt=getattr(torch, dt): (
                           grand(m, kk).to(dt), grand(kk, n).to(dt)),
                       "gemm")
                      for m, kk, n, dt in GEMM_TIMES]
        if name == "ssm_scan":             # whole shapes: lanes = 1
            cases += [(f"{label} ({b},{h},{s},{p}) N={n} bf16", None, None,
                       1, lambda b=b, h=h, s=s, p=p, n=n, ph=ph: tuple(
                           t.bfloat16() for t in ssm_case(
                               b, h, s, p, n, ph, (0.8, 0.999))),
                       "ssm_scan", chunk)
                      for label, b, h, s, p, n, ph, chunk in SSM_TIMES]
        if name == "flash_attention":
            cases += [(f"B={b} {h}/{hkv} S={s} D={d} {dt}", None, None,
                       1,
                       lambda b=b, h=h, hkv=hkv, s=s, d=d,
                       dt=getattr(torch, dt): tuple(
                           (grand(b, hh, s, d) * sc).to(dt)
                           for hh, sc in ((h, 0.3), (hkv, 0.3), (hkv, 1.0))),
                       "flash_attention")
                      for b, h, hkv, s, d, dt in FLASH_TIMES]
        sweep = []
        for label, n, form, lanes, make, tkey, *chunk in cases:
            args = make()
            kw = {"chunk": chunk[0]} if chunk else {}   # K21's chunk
            tk, tp_ = calls.get(tkey, (fused[tkey], plain[tkey]))
            shapes = tuple(tuple(a.shape if lanes == 1 else a.shape[1:])
                           for a in args)
            lane_bytes, lane_flops = work(tkey, shapes, **kw)
            nbytes, flops = lanes * lane_bytes, lanes * lane_flops
            peak = PEAK_F32_FLOPS
            if args[0].dtype == torch.bfloat16:   # 2 bytes, tensor cores
                nbytes //= 2                      # (K21 computes in f32)
                if tkey != "ssm_scan":
                    peak = PEAK_BF16_FLOPS
            t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
            t_ops = flops / peak * 1e3
            before = (k.launches_global, k.launches, k.launches_tc)
            ms, ms_max, reps = time_ms(lambda: tk(*args, **kw), 30)
            if (form == "global") != (k.launches_global > before[0]):
                fail(f"{name} {label}: ran the wrong form")
            ran, tc = k.launches - before[1], k.launches_tc - before[2]
            if name == "gemm" and tc != (
                    ran if args[0].dtype == torch.bfloat16 else 0):
                fail(f"gemm {label}: {tc} of {ran} launches in the "
                     f"tensor-core form")
            # K20's rows: the SM clock right after the kernel's window
            # (two cards of one power limit can run at different clocks)
            clocks = clocks_line() if name == "flash_attention" else None
            large = n is not None and n >= MID_SIZES[0]
            plain_ms, _, plain_reps = time_ms(
                lambda: tp_(*args, **kw), 1 if name == "svd" or large else 3)
            lib = library(tkey, args)
            lib_ms, _, lib_reps = time_ms(lib, 10) if lib else (None, 0, 0)
            sweep.append({
                "case": label, "n": n, "form": form, "lanes": lanes,
                "shapes": [list(s) for s in shapes], "reps": reps,
                "ms": ms, "ms_max": ms_max, "plain_ms": plain_ms,
                "plain_reps": plain_reps, "library_reps": lib_reps,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops, "library_ms": lib_ms,
                "hbm_share": nbytes / (ms * 1e-3) / PEAK_HBM_BYTES,
                "library_hbm_share": (nbytes / (lib_ms * 1e-3)
                                      / PEAK_HBM_BYTES if lib_ms else None),
                "library_syncs": syncs(lib) if lib else None,
                "clocks": clocks,
                "plan": (list(global_plan(name, shapes))
                         if form == "global" and (name in GLOBAL_SOURCES
                                                  or name == "qr_solve")
                         else list(cluster_plan(name, lanes, shapes))
                         if name in QR_CLUSTER_KERNELS
                         else list(tiled_plan(name, lanes, shapes))
                         if name in CHOL_TILED_KERNELS
                         + ("cholesky_solve_blocked",)
                         else list(S.svd_plan(lanes, *shapes[0]))
                         if name == "svd"
                         else list(KS.ssm_plan(*shapes[0], shapes[2][-1],
                                               min(kw["chunk"],
                                                   shapes[0][2])))
                         if name == "ssm_scan"
                         else lane_form(name, shapes, lanes)
                         if name in WARP_SERVED else None)})
            print(f"  time {name:<22} {label:<12} kernel {ms:.4f} ms "
                  f"(median of {reps}, slowest {ms_max:.4f})  plain "
                  f"{plain_ms:.3f} ms  bound {max(t_bytes, t_ops):.5f} ms"
                  + (f"  library {lib_ms:.4f} ms" if lib_ms else "")
                  + ("  (library syncs the host)"
                     if sweep[-1]["library_syncs"] else "")
                  + (f"  of 3.35 TB/s: kernel {sweep[-1]['hbm_share']:.3f}"
                     f" library {sweep[-1]['library_hbm_share']:.3f}"
                     if name == "fft" else "")
                  + (f"  clocks (sm, max sm, temperature, power draw) "
                     f"{clocks}" if clocks else "")
                  + (f"  plan (clusters, threads, smem, "
                     f"panel shared) {sweep[-1]['plan']}"
                     if name in QR_CLUSTER_KERNELS else
                     f"  plan (clusters, threads, smem, tile) "
                     f"{sweep[-1]['plan']}"
                     if name in CHOL_TILED_KERNELS
                     + ("cholesky_solve_blocked",) else
                     f"  plan (group, threads, held) {sweep[-1]['plan']}"
                     if name == "svd" else
                     f"  plan (clusters, tiles, slots, smem) "
                     f"{sweep[-1]['plan']}" if name == "ssm_scan" else
                     f"  form {sweep[-1]['plan']}" if name in WARP_SERVED
                     and form != "global" else
                     f"  plan (threads, bs, "
                     f"{'tile, ' if name == 'qr_solve' else ''}smem) "
                     f"{sweep[-1]['plan']}" if sweep[-1]["plan"] else ""),
                  flush=True)
            del args
        if key in SLOT_KEYS:
            head = next(r for r in sweep if r["n"] == SLOT_SIZES[-1])
        else:       # the tiled kernels' head row is n = 512, K19's 31 taps
            head = sweep[0] if name in TILED_TIMES or name == "fir" \
                else sweep[-1]
        rows.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[name],
            "launches_global": launches_global[name],
            "launches_tc": launches_tc[name],
            "launches_warp": launches_warp[name],
            "launches_wide": launches_wide[name],
            "launches_by_form": (k2_forms if name == "mmse_equalize"
                                 else None),
            "max_abs_err": max_err[name],
            "rtol": RTOLS.get(name, RTOL),
            "lanes": head["lanes"], "shapes": head["shapes"],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library_syncs": head["library_syncs"], "plan": head["plan"],
            "sweep": sweep})
    for r in rows:
        if not all(math.isfinite(r[key]) for key in
                   ("ms", "plain_ms", "bound_ms", "max_abs_err")):
            fail(f"non-finite measurement for {r['name']}")

    # the fusion block: each unfused chain's wall (events around the
    # whole chain) beside its fused kernel, on the same inputs
    fusion = []
    for name, base, _ in BASELINES:
        for n in SLOT_SIZES:
            args = baseline_case(name, n)
            chain_ms, chain_max, reps = time_ms(
                lambda: getattr(pp, base)(*args), 30)
            fused_ms, _, fused_reps = time_ms(lambda: fused[name](*args), 30)
            fusion.append({
                "chain": base, "fused": name, "n": n, "lanes": LANES,
                "shapes": [list(a.shape[1:]) for a in args],
                "unfused_ms": chain_ms, "unfused_ms_max": chain_max,
                "fused_ms": fused_ms, "ratio": chain_ms / fused_ms,
                "reps": reps, "fused_reps": fused_reps,
                "unfused_launches": BASELINE_LAUNCHES[name]})
            print(f"  fusion {base:<24} n={n:<3} unfused chain "
                  f"{chain_ms:.4f} ms  fused {name} {fused_ms:.4f} ms  "
                  f"unfused/fused {chain_ms / fused_ms:.2f}", flush=True)
            del args

    print(f"clocks after timing (sm, max sm, temperature, power draw): "
          f"{clocks_line()}", flush=True)
    print(json.dumps({"fusion": fusion}))
    print(json.dumps({"lm": lm}))
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
