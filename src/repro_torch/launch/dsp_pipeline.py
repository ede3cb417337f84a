"""A 4G/5G-style MIMO receiver chain built from the primitive kernels
(paper Fig. 4), the port's counterpart of the reference's
``examples/dsp_pipeline.py``:

  LMMSE equalization  G = H^H H + s I expanded to a real 2n x 2n SPD
                      system, then ``ops.cholesky`` (K15), ``ops.trisolve``
                      forward and backward on the materialised L^T (K16)
  OFDM demodulation   ``ops.fft`` (K7)
  front-end filter    ``ops.fir``, centro-symmetric taps (K19)
  SVD                 ``ops.svd`` (K8), sorted singular values

Each step is one kernel launch on ``--device cuda`` (the default): five
launches in all, K15 once, K16 twice, K7, K19 and K8 once each.  The
reference's example sends its SVD through ``backend="xla"``, a plain
path; here it runs on K8 like every other step, because a plain version
does not serve the card's path.  ``--device cpu`` runs the kernels'
plain PyTorch versions.

    PYTHONPATH=src python -m repro_torch.launch.dsp_pipeline --device cpu

The defaults are the reference's: 16 antennas (32 x 32 expanded
systems), 8 symbols, a 64-point FFT, 31 taps over 2048 samples and one
16 x 12 SVD.  ``--batch`` (symbols, and FFT rows) and ``--samples``
(FIR input length) widen the run — ``--batch 3276 --samples 61470`` is
one 100 MHz carrier's subcarriers and one 0.5 ms slot of one antenna at
122.88 Msps — and change nothing of what is computed.  Inputs come from
numpy's generator at seed 0, in the reference's order.  Prints the
reference's error lines and ``pipeline OK.``; a non-finite error raises.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.common import resolve_device

ANTENNAS = 16      # matrix size n (paper: 12-32 antennas/beams)
SUBCARRIERS = 64   # FFT size
BATCH = 8          # OFDM symbols processed per call (lanes)
TAPS = 31          # FIR taps
SAMPLES = 2048     # FIR input samples
SVD_SHAPE = (1, 16, 12)


def make_channel(rng, b, n):
    hr = rng.standard_normal((b, n, n)).astype(np.float32)
    hi = rng.standard_normal((b, n, n)).astype(np.float32)
    return hr, hi


def lmmse_equalize(hr, hi, yr, yi, sigma2=0.1):
    """LMMSE: x = (H^H H + s I)^-1 H^H y, via Cholesky + two trisolves on
    the real expansion of the complex system.  hr/hi (B, n, n), yr/yi
    (B, n) tensors on one device -> (Re x, Im x), each (B, n)."""
    n = hr.shape[-1]
    dev = hr.device
    e = torch.einsum
    # G = H^H H + sigma I  (hermitian -> real SPD in expanded form)
    gr = e("bij,bik->bjk", hr, hr) + e("bij,bik->bjk", hi, hi) \
        + sigma2 * torch.eye(n, dtype=hr.dtype, device=dev)
    gi = e("bij,bik->bjk", hr, hi) - e("bij,bik->bjk", hi, hr)
    # expanded real SPD:  [[Gr, -Gi], [Gi, Gr]]
    g = torch.cat([torch.cat([gr, -gi], dim=-1),
                   torch.cat([gi, gr], dim=-1)], dim=-2)
    # rhs = H^H y, expanded
    br = e("bij,bi->bj", hr, yr) + e("bij,bi->bj", hi, yi)
    bi = e("bij,bi->bj", hr, yi) - e("bij,bi->bj", hi, yr)
    rhs = torch.cat([br, bi], dim=-1)[..., None]
    # FGOP kernels: cholesky + forward/backward substitution
    l = ops.cholesky(g, device=dev)
    z = ops.trisolve(l, rhs, lower=True, device=dev)
    x = ops.trisolve(l.mT.contiguous(), z, lower=False, device=dev)[..., 0]
    return x[:, :n], x[:, n:]


def ofdm_demod(sym_r, sym_i):
    """FFT demodulation of an OFDM symbol batch."""
    return ops.fft(sym_r, sym_i, device=sym_r.device)


def channel_filter(x, taps):
    return ops.fir(x, taps, device=x.device)


def main(argv=None) -> dict:
    """Run the chain and print its error lines; returns them (``nmse``,
    ``fft_err``, ``fir_err``, ``svd_err``) and the equalizer's host wall
    ``equalize_s``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--batch", type=int, default=BATCH,
                    help="OFDM symbols (lanes) per call")
    ap.add_argument("--samples", type=int, default=SAMPLES,
                    help="FIR input samples")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    bsz = args.batch

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(0)
    print(f"MIMO LMMSE chain: {ANTENNAS} antennas, batch {bsz}")

    # --- channel + signal ---
    hr, hi = make_channel(rng, bsz, ANTENNAS)
    x_true_r = rng.standard_normal((bsz, ANTENNAS)).astype(np.float32)
    x_true_i = rng.standard_normal((bsz, ANTENNAS)).astype(np.float32)
    yr = np.einsum("bij,bj->bi", hr, x_true_r) \
        - np.einsum("bij,bj->bi", hi, x_true_i)
    yi = np.einsum("bij,bj->bi", hr, x_true_i) \
        + np.einsum("bij,bj->bi", hi, x_true_r)

    # --- equalize (Cholesky + solves: the FGOP kernels) ---
    args_eq = [put(a) for a in (hr, hi, yr, yi)]
    sync()
    t0 = time.perf_counter()
    xr, xi = lmmse_equalize(*args_eq)
    sync()
    dt = time.perf_counter() - t0
    xr, xi = xr.cpu().numpy(), xi.cpu().numpy()
    nmse = (np.linalg.norm(xr - x_true_r) ** 2
            + np.linalg.norm(xi - x_true_i) ** 2) \
        / (np.linalg.norm(x_true_r) ** 2 + np.linalg.norm(x_true_i) ** 2)
    print(f"  equalized {bsz} symbols in {dt * 1e3:.2f} ms "
          f"(host clock, synchronized), NMSE={nmse:.3e}")

    # --- OFDM demod (FFT kernel) ---
    sym = rng.standard_normal((bsz, SUBCARRIERS)).astype(np.float32)
    fre, _ = ofdm_demod(put(sym), put(np.zeros_like(sym)))
    ref = np.fft.fft(sym, axis=-1)
    fft_err = float(np.abs(fre.cpu().numpy() - ref.real).max())
    print(f"  FFT demod err: {fft_err:.2e}")

    # --- front-end FIR (centro-symmetric taps) ---
    taps = rng.standard_normal(TAPS).astype(np.float32)
    taps = (taps + taps[::-1]) / 2
    sig = rng.standard_normal(args.samples).astype(np.float32)
    y = channel_filter(put(sig), put(taps))
    ref = np.convolve(sig, taps[::-1], mode="valid")
    fir_err = float(np.abs(y.cpu().numpy() - ref).max())
    print(f"  FIR err: {fir_err:.2e}")

    # --- SVD-based noise reduction (paper: SVD for noise suppression) ---
    a = rng.standard_normal(SVD_SHAPE).astype(np.float32)
    _, s, _ = ops.svd(put(a), device=dev)
    want = np.linalg.svd(a[0], compute_uv=False)
    svd_err = float(np.abs(np.sort(s.cpu().numpy()[0])[::-1] - want).max())
    print(f"  SVD sigma err: {svd_err:.2e}")

    errors = {"nmse": float(nmse), "fft_err": fft_err, "fir_err": fir_err,
              "svd_err": svd_err}
    bad = [k for k, v in errors.items() if not math.isfinite(v)]
    if bad:
        raise RuntimeError(f"dsp_pipeline: non-finite {bad}: {errors}")
    print("pipeline OK.")
    return {**errors, "equalize_s": dt}


if __name__ == "__main__":
    main()
