"""K3/K4: the fused FWT pyramid (``csrc/pyramid.cu``), with plain versions.

Replaces ``jwave_tpu/ops/pallas_pyramid.py`` ``_pyramid_rows_kernel_flat``
(K3: the pyramid along each row, in place, output (R, N)) and
``_pyramid_rows_kernel`` (K4: the same with each row stored transposed,
output (N, R)). Per row, for each of ``levels`` levels on the head h:

    a[i] = sum_j x[(2i+j) mod h] dec_lo[j],  d[i] = sum_j x[(2i+j) mod h] dec_hi[j]

``d`` goes to ``out[h/2:h]``, the head becomes ``a``, and the last ``a``
goes to ``out[:h]``: the layout ``[A_L | D_L | ... | D_1]``. ``levels`` is
the number of levels actually done (:func:`levels_done`).

The wrappers launch the kernels for CUDA tensors and take the plain
versions only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from ..exceptions import JWaveFailure
from . import cuda_build

#: launches of each kernel since the last :func:`reset_launch_counts`
launch_counts = {"pyramid_rows": 0, "pyramid_rows_transposed": 0}

MAX_TAPS = 64
#: longest head one K3 block holds in shared memory (h/2 + h/4 floats)
MAX_FUSED_HEAD = 65536
#: shared-memory floats a K4 block may use (227 KB on Hopper, less the taps)
_K4_SMEM_FLOATS = 56 * 1024
K3_THREADS = 1024
K4_THREADS = 512
K4_MAX_ROWS_PER_BLOCK = 8


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def levels_done(n: int, tw: int, level: int) -> int:
    """How many levels the reference forward performs: it stops at ``level``
    or when the head drops below ``transform_wavelength``
    (jwave_tpu/ops/mxu_pyramid.py::_levels_done)."""
    done = 0
    h = n
    while h >= tw and done < level:
        done += 1
        h >>= 1
    return done


# ----------------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------------

def pyramid_rows_torch(x: torch.Tensor, dec_lo, dec_hi, levels: int) -> torch.Tensor:
    """(R, N) -> (R, N): ``levels`` analysis butterflies, by gathers and FMAs."""
    out = x.clone()
    h = x.shape[-1]
    for _ in range(levels):
        half = h // 2
        i2 = 2 * torch.arange(half, device=x.device)
        head = out[..., :h]
        a = torch.zeros_like(head[..., :half])
        d = torch.zeros_like(a)
        for j in range(len(dec_lo)):
            v = head[..., (i2 + j) % h]
            a = a + float(dec_lo[j]) * v
            d = d + float(dec_hi[j]) * v
        out[..., :half] = a
        out[..., half:h] = d
        h = half
    return out


def pyramid_rows_transposed_torch(x: torch.Tensor, dec_lo, dec_hi, levels: int) -> torch.Tensor:
    """(R, N) -> (N, R): :func:`pyramid_rows_torch` of each row, transposed."""
    return pyramid_rows_torch(x, dec_lo, dec_hi, levels).transpose(0, 1).contiguous()


# ----------------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------------

def _check(x: torch.Tensor, dec_lo, dec_hi, levels: int, what: str):
    if x.device.type != "cuda":
        raise JWaveFailure(f"{what} - tensor on {x.device}; the kernel runs on CUDA tensors")
    if x.dtype != torch.float32:
        raise JWaveFailure(f"{what} - dtype {x.dtype}; the kernel takes float32")
    if x.dim() != 2 or not x.is_contiguous():
        raise JWaveFailure(f"{what} - expected a contiguous (R, N) tensor, got {tuple(x.shape)}")
    n = x.shape[1]
    if n & (n - 1) or n == 0:
        raise JWaveFailure(f"{what} - row length {n} is not a power of two")
    if not 0 <= levels <= n.bit_length() - 1:
        raise JWaveFailure(f"{what} - {levels} levels do not fit rows of {n}")
    if len(dec_lo) != len(dec_hi) or not 1 <= len(dec_lo) <= MAX_TAPS:
        raise JWaveFailure(f"{what} - filters must have equal length in [1, {MAX_TAPS}]")
    if x.requires_grad:
        raise JWaveFailure(f"{what} - gradients through the CUDA kernel are not available "
                           "yet; they come with a torch.autograd.Function in a later release")


def _fn(lib, name, argtypes):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def pyramid_rows(x: torch.Tensor, dec_lo, dec_hi, levels: int) -> torch.Tensor:
    """K3: the pyramid along each row of (R, N) f32, output (R, N)."""
    if x.device.type == "cpu":
        return pyramid_rows_torch(x, dec_lo, dec_hi, levels)
    _check(x, dec_lo, dec_hi, levels, "pyramid_rows")
    r, n = x.shape
    out = torch.empty_like(x)
    if r == 0:
        return out
    lib = cuda_build.library("pyramid")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _fn(lib, "jw_pyramid_rows", [p, ll, p, ll, p, ll, p, i, i, i, i, i, p])
    taps = cuda_build.device_taps(dec_lo, dec_hi, x.device)
    stream = cuda_build.stream_handle(x.device)
    m = len(dec_lo)
    src, src_stride, h = x, n, n
    # rows longer than one block's shared memory lose leading levels to
    # single-level launches that park the approximation in a scratch row
    while h > MAX_FUSED_HEAD and levels > 1:
        scratch = torch.empty((r, h // 2), dtype=torch.float32, device=x.device)
        err = fn(src.data_ptr(), src_stride, out.data_ptr(), n, scratch.data_ptr(), h // 2,
                 taps.data_ptr(), r, h, 1, m, K3_THREADS, stream)
        cuda_build.check(lib, err, "pyramid_rows")
        launch_counts["pyramid_rows"] += 1
        src, src_stride, h, levels = scratch, h // 2, h // 2, levels - 1
    err = fn(src.data_ptr(), src_stride, out.data_ptr(), n, out.data_ptr(), n,
             taps.data_ptr(), r, h, levels, m, K3_THREADS, stream)
    cuda_build.check(lib, err, "pyramid_rows")
    launch_counts["pyramid_rows"] += 1
    return out


def k4_rows_per_block(n: int) -> int:
    """Rows a K4 block stages: the most (up to 8) whose n+1-float rows and
    the n/2 + n/4 scratch fit shared memory; 0 when not even one fits."""
    rb = K4_MAX_ROWS_PER_BLOCK
    while rb >= 1:
        if 2 * MAX_TAPS + rb * (n + 1) + n // 2 + n // 4 <= _K4_SMEM_FLOATS:
            return rb
        rb //= 2
    return 0


def pyramid_rows_transposed(x: torch.Tensor, dec_lo, dec_hi, levels: int) -> torch.Tensor:
    """K4: the pyramid along each row of (R, N) f32, output (N, R)."""
    if x.device.type == "cpu":
        return pyramid_rows_transposed_torch(x, dec_lo, dec_hi, levels)
    _check(x, dec_lo, dec_hi, levels, "pyramid_rows_transposed")
    r, n = x.shape
    rb = k4_rows_per_block(n)
    if rb == 0:
        raise JWaveFailure(f"pyramid_rows_transposed - rows of {n} exceed one block's "
                           "shared memory")
    out = torch.empty((n, r), dtype=x.dtype, device=x.device)
    if r == 0:
        return out
    lib = cuda_build.library("pyramid")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _fn(lib, "jw_pyramid_rows_t", [p, p, p, i, i, i, i, i, i, p])
    taps = cuda_build.device_taps(dec_lo, dec_hi, x.device)
    err = fn(x.data_ptr(), out.data_ptr(), taps.data_ptr(), r, n, levels, len(dec_lo), rb,
             K4_THREADS, cuda_build.stream_handle(x.device))
    cuda_build.check(lib, err, "pyramid_rows_transposed")
    launch_counts["pyramid_rows_transposed"] += 1
    return out
