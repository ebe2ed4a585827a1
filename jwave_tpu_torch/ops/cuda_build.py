"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` holds kernels behind a plain ``extern "C"``
interface; it is compiled on its own by ``nvcc`` for Hopper (``sm_90a``)
into ``jwave_tpu_torch/_build/lib<name>_<hash>.so``. The hash covers the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source or header builds anew. Importing this module
builds nothing; :func:`library` builds on the first call for a name. A
missing ``nvcc`` or a failed compile raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from ..exceptions import JWaveError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    """The loaded kernel library built from ``csrc/<name>.cu``."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
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
    return lib


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise JWaveError(f"{what}: CUDA error {err}: {lib.jw_error_string(err).decode()}")


def stream_handle(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def device_taps(f1, f2, device):
    """The filters [f1 | f2] as a float32 tensor on ``device``, made once."""
    import numpy as np
    import torch

    taps = np.concatenate([np.asarray(f1, np.float64), np.asarray(f2, np.float64)])
    key = (taps.tobytes(), len(f1), str(device))
    t = _TAPS.get(key)
    if t is None:
        t = _TAPS[key] = torch.as_tensor(taps, dtype=torch.float32, device=device)
    return t
