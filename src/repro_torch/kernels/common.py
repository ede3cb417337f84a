"""Shared kernel plumbing: device resolution, the shared test-matrix
generator, and the loader of the hand-written Hopper kernels.

Every kernel of this package has two faces in its pipeline module:

  * a CUDA C++ kernel under ``src/repro_torch/csrc/`` (one CTA per lane,
    built for ``sm_90a``), launched through a :class:`CudaKernel` — the
    path every CUDA tensor takes.  A lane's matrices live in shared
    memory, or, where they do not fit, in a device work buffer the
    wrapper allocates (:meth:`CudaKernel.work_buffer`);
  * a plain PyTorch version following the reference's per-lane op order,
    which a CPU tensor takes and which tests and ``chip_smoke.py`` hold
    the kernel against.

The kernels build into one shared library with a plain C interface
(``nvcc`` per source, all started together, then one link) at the first
CUDA launch, never at import, and are bound with ``ctypes``.  The build
lands in ``build/repro_torch_kernels/<digest>/`` at the repo root, keyed
by a digest of the sources and flags, so an unchanged tree builds once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["resolve_device", "on_hopper", "sample_spd", "check_f32",
           "check_tensors",
           "CudaKernel", "KERNELS", "load_library", "build_library",
           "MAX_SMEM_BYTES", "data_ptr", "clusters_at_once",
           "cluster_occupancy"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"
# Dynamic shared memory one block may use on sm_90 (227 KB).
MAX_SMEM_BYTES = 232448
# Shared memory of one SM on sm_90 (228 KB), of which each resident block
# also holds 1 KB.
SM_SMEM_BYTES = 233472
# Clusters an H100 SXM (132 SMs) holds at once, by the CTAs an SM holds
# and the cluster size: cudaOccupancyMaxActiveClusters, which places a
# cluster within one GPC, so clusters of 4 and 8 leave SMs idle.  The
# CPU's stand-in for the card's own answer (clusters_at_once).
H100_CLUSTERS_AT_ONCE = {1: {1: 132, 2: 66, 4: 30, 8: 15},
                         2: {1: 264, 2: 132, 4: 62, 8: 30}}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Without a usable CUDA device this raises rather than
    carrying on quietly on the CPU — pass ``device="cpu"`` to run the
    plain PyTorch versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or "
            "--device cpu) to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_hopper(device=None) -> bool:
    """True when ``device`` (default: the current CUDA device) is a
    compute-capability 9.0 card, the only target the kernels are built
    for."""
    if not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(device) == (9, 0)


def sample_spd(rng, b: int, n: int):
    """Batched well-conditioned SPD test matrices (B,N,N) float32 — the
    shared generator for registry cases, benchmarks, and tests."""
    a = rng.standard_normal((b, n, n)).astype(np.float32)
    return a @ a.swapaxes(-1, -2) + n * np.eye(n, dtype=np.float32)


def check_f32(name: str, *tensors: torch.Tensor) -> torch.device:
    """Validate a kernel's tensor arguments: float32, contiguous, on one
    CPU or CUDA device.  Returns that device."""
    return check_tensors(name, *tensors, dtypes=(torch.float32,))


def check_tensors(name: str, *tensors: torch.Tensor, dtypes: tuple,
                  contiguous: bool = True) -> torch.device:
    """Validate a kernel's tensor arguments: one dtype among ``dtypes``
    for all of them, contiguous (unless ``contiguous`` is False, for a
    kernel that reads strides), on one CPU or CUDA device.  Returns that
    device."""
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected tensors, got {type(t)}")
    dev = tensors[0].device
    for t in tensors:
        if t.dtype not in dtypes or t.dtype != tensors[0].dtype:
            want = " or ".join(str(d).removeprefix("torch.")
                               for d in dtypes)
            raise TypeError(f"{name}: expected {want} tensors of one "
                            f"dtype, got {[x.dtype for x in tensors]}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


# ---------------- build + load ----------------

_LIB = None
_LIB_LOCK = threading.Lock()
build_info: dict = {}
"""``path``, ``seconds`` (0.0 when an earlier build was reused) and
``log`` (nvcc's output, ``-Xptxas -v`` register and shared-memory lines
included) of the library this process loaded."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        "src/repro_torch/csrc at their first launch")


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` each, all started
    together) and link them into one shared library; reuse an earlier
    build of the same sources.  Returns the library's path."""
    sources = sorted(CSRC.glob("*.cu"))
    out = BUILD_ROOT / _digest(sorted(CSRC.glob("*.cu*"))) / LIB_NAME
    if out.exists():
        build_info.update(path=str(out), seconds=0.0,
                          log=(out.parent / "build.log").read_text())
        return out
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        log, failed = [], []
        for src, proc in zip(sources, procs):
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n"
                               + "\n".join(log))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(Path(tmp) / LIB_NAME),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link\n{link.stdout}")
        if link.returncode:
            raise RuntimeError("linking the kernels failed:\n"
                               + "\n".join(log))
        out.parent.mkdir(parents=True, exist_ok=True)
        (out.parent / "build.log").write_text("\n".join(log))
        # atomic: a concurrent builder of the same digest wins or loses
        # whole, and a reader never sees a half-written library
        os.replace(Path(tmp) / LIB_NAME, out)
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      log="\n".join(log))
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


class CudaKernel:
    """One hand-written kernel of the shared library: its C entry point
    ``symbol(<pointers and sizes>..., stream) -> cudaError_t``, its
    shared-memory query ``<prefix>_smem(dims...) -> size_t`` (None where
    the wrapper's plan holds the bytes and passes them as the one dim,
    as K7's does) and, for a
    kernel with a global form (K1-K4), its work-buffer query
    ``work_symbol(dims...) -> size_t`` (floats per lane).

    A kernel with a global form keeps a lane in shared memory when it
    fits and, past :data:`MAX_SMEM_BYTES`, in device memory: a work
    buffer (K1-K4) or its own output (K15-K17); a launch given that
    memory as ``work`` runs the global form.

    ``launches`` counts the kernel's launches in this process; it rises
    by one where :meth:`launch` launches the kernel and nowhere else, so
    a run can show that its path went through the kernel.
    ``launches_global`` counts those of them that ran the global form,
    ``launches_tc`` those that the C entry reports in a tensor-core form
    (K18's and K20's wrappers count it), ``launches_warp`` those in a
    warp form (K2's, K3's, K5's, K6's and K16's wrappers count it),
    ``launches_wide`` those in K2's wide form.  ``source`` and ``replaces``
    name the CUDA source and the TPU kernel it ports."""

    def __init__(self, name: str, symbol: str, argtypes: list,
                 smem_symbol: str | None, smem_args: int, source: str,
                 replaces: str, work_symbol: str | None = None):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]   # + stream
        self.smem_symbol = smem_symbol
        self.smem_args = smem_args
        self.work_symbol = work_symbol
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self.launches_global = 0
        self.launches_tc = 0
        self.launches_warp = 0
        self.launches_wide = 0
        self._fn = None
        self._smem_fn = None
        self._work_fn = None
        KERNELS.append(self)

    def _query(self, lib, symbol: str):
        q = getattr(lib, symbol)
        q.argtypes = [ctypes.c_int] * self.smem_args
        q.restype = ctypes.c_size_t
        return q

    def _bind(self):
        if self._fn is None:
            lib = load_library()
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._smem_fn = (self._query(lib, self.smem_symbol)
                             if self.smem_symbol else int)
            if self.work_symbol:
                self._work_fn = self._query(lib, self.work_symbol)
            self._fn = fn
        return self._fn

    def smem_bytes(self, *dims: int) -> int:
        """Dynamic shared memory one lane of the kernel needs (for a
        kernel with a global form: the shared form)."""
        self._bind()
        return int(self._smem_fn(*dims))

    def fits_shared(self, *dims: int) -> bool:
        """Whether one lane at ``dims`` fits in :data:`MAX_SMEM_BYTES`
        (read at each call) in the kernel's shared form."""
        return self.smem_bytes(*dims) <= MAX_SMEM_BYTES

    def work_buffer(self, device: torch.device, batch: int,
                    *dims: int) -> torch.Tensor | None:
        """The device work buffer of the global form for ``batch`` lanes
        at per-lane ``dims``, or None when the kernel has no global form
        or the lane fits in :data:`MAX_SMEM_BYTES` (read at each call).
        Chosen from the shape alone, before the launch."""
        if self.work_symbol is None or self.fits_shared(*dims):
            return None
        return torch.empty(batch * int(self._work_fn(*dims)),
                           dtype=torch.float32, device=device)

    def launch(self, device: torch.device, smem_dims: tuple, *args,
               work: torch.Tensor | None = None) -> None:
        """Launch on ``device``'s current stream; ``work`` is the device
        memory the global form works in (its pointer is among ``args``):
        the buffer from :meth:`work_buffer` or, for a kernel whose global
        form works in its own output (K15-K17), that output.  Raise
        when the lane does not fit in shared memory (the global form's
        shared memory is its C entry's to check: per-step scratch, or
        K1-K3's panel plan), the card is not a Hopper, or the launch is
        refused.  Never synchronises."""
        fn = self._bind()
        if not on_hopper(device):
            raise RuntimeError(
                f"{self.name}: the kernels are built for sm_90a; "
                f"{torch.cuda.get_device_name(device)} is not a Hopper card")
        global_form = work is not None
        smem = self.smem_bytes(*smem_dims)
        if not global_form and smem > MAX_SMEM_BYTES:
            raise ValueError(
                f"{self.name}: one lane at {smem_dims} needs {smem} bytes "
                f"of shared memory, more than the {MAX_SMEM_BYTES} a "
                f"block may use")
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, stream)
        if err:
            msg = load_library().repro_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name}: launch failed: {msg}")
        self.launches += 1
        if global_form:
            self.launches_global += 1


def data_ptr(t: torch.Tensor | None):
    """A tensor's device pointer for a C entry point; None (NULL) for no
    tensor."""
    return None if t is None else t.data_ptr()


KERNELS: list[CudaKernel] = []
"""Every kernel of the package, in registration (import) order."""


def cluster_occupancy(symbol: str, *args: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of a cluster kernel's served
    instance at a plan, through its C entry ``symbol(plan...) -> int``
    (-1 where the query fails)."""
    fn = getattr(load_library(), symbol)
    fn.argtypes = [ctypes.c_int] * len(args)
    fn.restype = ctypes.c_int
    return int(fn(*args))


def clusters_at_once(query, clusters: int, smem_bytes: int,
                     min_blocks: int, static_bytes: int = 0) -> int:
    """Clusters of ``clusters`` CTAs of ``smem_bytes`` dynamic (and
    ``static_bytes`` static) shared memory each the card holds at once:
    on a machine with a card ``query()``, its
    ``cudaOccupancyMaxActiveClusters``; on the CPU an H100's
    (:data:`H100_CLUSTERS_AT_ONCE` at the CTAs an SM holds by shared
    memory, at most the instance's launch bound ``min_blocks``)."""
    if torch.cuda.is_available():
        at_once = query()
        if at_once < 1:
            raise RuntimeError(f"the card holds no cluster of {clusters} "
                               f"CTAs of {smem_bytes} bytes")
        return at_once
    per_sm = min(min_blocks,
                 SM_SMEM_BYTES // (smem_bytes + static_bytes + 1024))
    return H100_CLUSTERS_AT_ONCE[per_sm][clusters]
