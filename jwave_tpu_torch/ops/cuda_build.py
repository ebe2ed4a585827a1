"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` holds kernels behind a plain ``extern "C"``
interface; it is compiled on its own by ``nvcc`` for Hopper (``sm_90a``)
into ``jwave_tpu_torch/_build/lib<name>_<hash>.so``. The hash covers the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source or header builds anew. Importing this module
builds nothing; :func:`library` builds on the first call for a name. A
missing ``nvcc`` or a failed compile raises with the compiler's output.

Every launch of K1-K9 goes through one seam, :func:`launch`: it takes the
kernel's C function by :func:`entry` (its signature set once), calls it on
the tensor's current stream, raises on a CUDA error and then counts the
launch in ``utils.profiling`` as ``launch.<K-name>`` (:data:`KERNELS`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from ..exceptions import JWaveError, JWaveFailure
from ..utils.profiling import count, count_upload

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the most taps a filter of the kernels has (``csrc/*.cu`` kMaxTaps)
MAX_TAPS = 64
#: the kernels whose launches are counted, as ``launch.<name>`` in
#: ``profiling.counts()``: K1-K9, K6's fused form (a K6 launch too) and the
#: peak kernel that the fused form's default threshold runs first
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "K6.fused", "K6.peak")
for _name in KERNELS:  # listed (at 0) from the start
    count(f"launch.{_name}", 0)

#: name -> loaded library; name -> (seconds, ptxas report) of the build
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, tuple[float, str]] = {}
#: (taps, device) -> float32 device tensor of the two filters, concatenated
_TAPS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise JWaveError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                     "the CUDA kernels cannot be built")


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library built from ``csrc/<name>.cu``. The first
    load in a process counts its seconds (hash, ``nvcc`` where it ran,
    dlopen) as ``library.<name>.load_s``."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    t_load = time.perf_counter()
    src = CSRC / f"{name}.cu"
    # the shared headers count too, so editing one rebuilds every source
    text = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    target = BUILD_DIR / f"lib{name}_{digest}.so"
    if not target.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise JWaveError(f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                             f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)  # atomic: a concurrent build never loads half a file
        BUILD_LOG[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(target))
    lib.jw_error_string.argtypes = [ctypes.c_int]
    lib.jw_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    count(f"library.{name}.load_s", time.perf_counter() - t_load)
    return lib


def entry(lib_name: str, symbol: str, argtypes: list):
    """The C function ``symbol`` of library ``lib_name``, its ``argtypes``
    and an int return (the CUDA error) set on the first call."""
    fn = getattr(library(lib_name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise JWaveError(f"{what}: CUDA error {err}: {lib.jw_error_string(err).decode()}")


def launch(kernel: tuple, args: tuple, device, what: str, *names: str):
    """One launch of ``kernel``, the (library, symbol, signature) of an
    :func:`entry`: its function called with ``args`` and the current stream
    of ``device``. A CUDA error raises (:func:`check`, named ``what``); else
    each K-name of ``names`` counts one launch."""
    err = entry(*kernel)(*args, stream_handle(device))
    check(library(kernel[0]), err, what)
    for name in names:
        count(f"launch.{name}")


def stream_handle(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


@functools.cache
def sm_count(device_index: int) -> int:
    """The card's streaming multiprocessors."""
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check_filters(f1, f2, what: str):
    """Raise unless the filter pair has equal lengths of 1 to ``MAX_TAPS``."""
    if len(f1) != len(f2) or not 1 <= len(f1) <= MAX_TAPS:
        raise JWaveFailure(f"{what} - filters must have equal length in [1, {MAX_TAPS}]")


def device_taps(f1, f2, device, gain: float = 1.0):
    """The filters [f1 | f2] times ``gain`` (the float64 product, then
    float32) as a tensor on ``device``, made once (an upload, counted, on
    the first call for a key)."""
    import numpy as np
    import torch

    taps = np.concatenate([np.asarray(f1, np.float64), np.asarray(f2, np.float64)]) * gain
    key = (taps.tobytes(), len(f1), str(device))
    t = _TAPS.get(key)
    if t is None:
        t = _TAPS[key] = count_upload(torch.as_tensor(taps, dtype=torch.float32, device=device))
    return t
