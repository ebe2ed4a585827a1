"""K3/K4/K5: the fused FWT pyramid and its inverse (``csrc/pyramid.cu``),
with plain versions.

Replaces ``jwave_tpu/ops/pallas_pyramid.py`` ``_pyramid_rows_kernel_flat``
(K3: the pyramid along each row, in place, output (R, N)),
``_pyramid_rows_kernel`` (K4: the same with each row stored transposed,
output (N, R)) and ``_ipyramid_rows_kernel`` (K5: the inverse pyramid of
each row, stored transposed, output (N, R)). Per row, for each of
``levels`` levels on the head h:

    a[i] = sum_j x[(2i+j) mod h] dec_lo[j],  d[i] = sum_j x[(2i+j) mod h] dec_hi[j]

``d`` goes to ``out[h/2:h]``, the head becomes ``a``, and the last ``a``
goes to ``out[:h]``: the layout ``[A_L | D_L | ... | D_1]``. ``levels`` is
the number of levels actually done (:func:`levels_done`). K5 undoes them
from the smallest head up, each level the synthesis butterfly of
``ops/butterfly.py`` scaled by the bank's ``recon_gain``.

The wrappers launch the kernels for CUDA tensors and take the plain
versions only for tensors on the CPU. Each wrapper goes through a
``torch.autograd.Function`` whose backward is the operator's exact
adjoint (for K4 and K5 the other wrapper, so a backward on the card
launches a kernel and counts as its launch):

* K3's adjoint is ``ops/butterfly.synthesis_levels`` with the analysis
  filters and gain 1 (no kernel: K5's staged rows stop at 16384 samples,
  K3 runs rows of 65536 and longer);
* one K4 pass is T P (P the pyramid, T the transpose), so its adjoint
  P^T T is K5 with the same filters and gain on the transposed gradient,
  transposed back; one K5 pass likewise takes K4 with K5's filters as the
  analysis pair and ``recon_gain`` as K4's per-level ``gain``.

The backward of a transposing pass returns a transposed view and reads its
incoming gradient through one, so in ``fwt2d``/``ifwt2d`` (two passes) only
the first backward pass copies its gradient.
"""
from __future__ import annotations

import ctypes

import torch

from ..exceptions import JWaveFailure
from . import cuda_build
from .butterfly import synthesis_levels

#: launches of each kernel since the last :func:`reset_launch_counts`
launch_counts = {"pyramid_rows": 0, "pyramid_rows_transposed": 0,
                 "ipyramid_rows_transposed": 0}

MAX_TAPS = 64
#: longest head one K3 block holds in shared memory (h/2 + h/4 floats)
MAX_FUSED_HEAD = 65536
#: shared-memory floats a K4 block may use (227 KB on Hopper, less the taps)
_K4_SMEM_FLOATS = 56 * 1024
K3_THREADS = 1024
K4_THREADS = 512
K4_MAX_ROWS_PER_BLOCK = 8
K5_THREADS = 512
#: K5's plan (``csrc/pyramid.cu`` kK5MaxRows, kK5Pairs): at most 8 rows a
#: block, rb*n <= 16384 staged floats (64 KB), 8 output pairs a thread per level
K5_MAX_ROWS_PER_BLOCK = 8
K5_ROW_FLOATS = 16384
K5_PAIRS = 8


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

def pyramid_rows_torch(x: torch.Tensor, dec_lo, dec_hi, levels: int,
                       gain: float = 1.0) -> torch.Tensor:
    """(R, N) -> (R, N): ``levels`` analysis butterflies, by gathers and FMAs;
    each level's a and d are scaled by ``gain``."""
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
        if gain != 1.0:
            a, d = a * gain, d * gain
        out[..., :half] = a
        out[..., half:h] = d
        h = half
    return out


def pyramid_rows_transposed_torch(x: torch.Tensor, dec_lo, dec_hi, levels: int,
                                  gain: float = 1.0) -> torch.Tensor:
    """(R, N) -> (N, R): :func:`pyramid_rows_torch` of each row, transposed."""
    return pyramid_rows_torch(x, dec_lo, dec_hi, levels, gain).transpose(0, 1).contiguous()


def ipyramid_rows_torch(y: torch.Tensor, rec_lo, rec_hi, recon_gain: float,
                        levels: int) -> torch.Tensor:
    """(R, N) -> (R, N): ``levels`` synthesis butterflies from the smallest
    head up, by gathers and FMAs: on head h, with a = y[:h/2], d = y[h/2:h],
    x[k] = gain * sum over taps j of k's parity of
    rec_lo[j] a[m/2] + rec_hi[j] d[m/2], m = (k - j) mod h."""
    out = y.clone()
    n = y.shape[-1]
    if levels == 0:
        return out
    h = n >> (levels - 1)
    while h <= n:
        half = h // 2
        k = torch.arange(h, device=y.device)
        head = out[..., :h]
        x = torch.zeros_like(head)
        for j in range(len(rec_lo)):
            m = (k - j) % h
            even = (m % 2 == 0).to(y.dtype)
            i = m // 2
            x = x + even * (float(rec_lo[j]) * head[..., i]
                            + float(rec_hi[j]) * head[..., half + i])
        out[..., :h] = x * recon_gain if recon_gain != 1.0 else x
        h *= 2
    return out


def ipyramid_rows_transposed_torch(y: torch.Tensor, rec_lo, rec_hi, recon_gain: float,
                                   levels: int) -> torch.Tensor:
    """(R, N) -> (N, R): :func:`ipyramid_rows_torch` of each row, transposed."""
    return ipyramid_rows_torch(y, rec_lo, rec_hi, recon_gain, levels).transpose(0, 1).contiguous()


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


def _fn(lib, name, argtypes):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _k3(x: torch.Tensor, dec_lo, dec_hi, levels: int) -> torch.Tensor:
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


class _PyramidRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dec_lo, dec_hi, levels):
        ctx.args = (dec_lo, dec_hi, levels)
        return _k3(x, dec_lo, dec_hi, levels)

    @staticmethod
    def backward(ctx, g):
        return synthesis_levels(g.contiguous(), *ctx.args), None, None, None


def pyramid_rows(x: torch.Tensor, dec_lo, dec_hi, levels: int) -> torch.Tensor:
    """K3: the pyramid along each row of (R, N) f32, output (R, N)."""
    return _PyramidRows.apply(x, dec_lo, dec_hi, levels)


def k4_rows_per_block(n: int) -> int:
    """Rows a K4 block stages: the most (up to 8) whose n+1-float rows and
    the n/2 + n/4 scratch fit shared memory; 0 when not even one fits."""
    rb = K4_MAX_ROWS_PER_BLOCK
    while rb >= 1:
        if 2 * MAX_TAPS + rb * (n + 1) + n // 2 + n // 4 <= _K4_SMEM_FLOATS:
            return rb
        rb //= 2
    return 0


def _k4(x: torch.Tensor, dec_lo, dec_hi, levels: int, gain: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return pyramid_rows_transposed_torch(x, dec_lo, dec_hi, levels, gain)
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
    fn = _fn(lib, "jw_pyramid_rows_t", [p, p, p, i, i, i, i, i, ctypes.c_float, i, p])
    taps = cuda_build.device_taps(dec_lo, dec_hi, x.device)
    err = fn(x.data_ptr(), out.data_ptr(), taps.data_ptr(), r, n, levels, len(dec_lo), rb,
             float(gain), K4_THREADS, cuda_build.stream_handle(x.device))
    cuda_build.check(lib, err, "pyramid_rows_transposed")
    launch_counts["pyramid_rows_transposed"] += 1
    return out


class _PyramidRowsT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dec_lo, dec_hi, levels, gain):
        ctx.args = (dec_lo, dec_hi, gain, levels)
        return _k4(x, dec_lo, dec_hi, levels, gain)

    @staticmethod
    def backward(ctx, g):
        gt = g.transpose(0, 1).contiguous()  # free when g is a transposed view
        return ipyramid_rows_transposed(gt, *ctx.args).transpose(0, 1), None, None, None, None


def pyramid_rows_transposed(x: torch.Tensor, dec_lo, dec_hi, levels: int,
                            gain: float = 1.0) -> torch.Tensor:
    """K4: the pyramid along each row of (R, N) f32, output (N, R); each
    level's a and d scaled by ``gain``."""
    return _PyramidRowsT.apply(x, dec_lo, dec_hi, levels, gain)


def k5_rows_per_block(n: int) -> int:
    """Rows a K5 block stages: the most (up to 8) whose rb*n floats stay
    within ``K5_ROW_FLOATS``, so that three blocks share an SM and a level's
    rb*n/4 output pairs fit ``K5_PAIRS`` pairs of registers of each of
    ``K5_THREADS`` threads; 0 when one row is longer than that. Positive wherever
    :func:`k4_rows_per_block` is, as K5 is K4's backward."""
    if n > K5_ROW_FLOATS:
        return 0
    return min(K5_MAX_ROWS_PER_BLOCK, K5_ROW_FLOATS // n)


def k5_smem_bytes(n: int, rb: int) -> int:
    """Shared bytes of a K5 block (``csrc/pyramid.cu``): the taps, the
    mbarrier padded to 16 bytes, and the rb staged rows at a stride of n + 4
    floats."""
    return 4 * (2 * MAX_TAPS + 4 + rb * (n + 4))


def _k5(y: torch.Tensor, rec_lo, rec_hi, recon_gain: float, levels: int) -> torch.Tensor:
    if y.device.type == "cpu":
        return ipyramid_rows_transposed_torch(y, rec_lo, rec_hi, recon_gain, levels)
    _check(y, rec_lo, rec_hi, levels, "ipyramid_rows_transposed")
    r, n = y.shape
    rb = k5_rows_per_block(n)
    if rb == 0:
        raise JWaveFailure(f"ipyramid_rows_transposed - rows of {n} exceed one block's "
                           "shared memory")
    out = torch.empty((n, r), dtype=y.dtype, device=y.device)
    if r == 0:
        return out
    lib = cuda_build.library("pyramid")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _fn(lib, "jw_ipyramid_rows_t", [p, p, p, i, i, i, i, i, ctypes.c_float, i, p])
    taps = cuda_build.device_taps(rec_lo, rec_hi, y.device)
    err = fn(y.data_ptr(), out.data_ptr(), taps.data_ptr(), r, n, levels, len(rec_lo), rb,
             float(recon_gain), K5_THREADS, cuda_build.stream_handle(y.device))
    cuda_build.check(lib, err, "ipyramid_rows_transposed")
    launch_counts["ipyramid_rows_transposed"] += 1
    return out


class _IPyramidRowsT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, rec_lo, rec_hi, recon_gain, levels):
        ctx.args = (rec_lo, rec_hi, levels, recon_gain)
        return _k5(y, rec_lo, rec_hi, recon_gain, levels)

    @staticmethod
    def backward(ctx, g):
        gt = g.transpose(0, 1).contiguous()  # free when g is a transposed view
        return pyramid_rows_transposed(gt, *ctx.args).transpose(0, 1), None, None, None, None


def ipyramid_rows_transposed(y: torch.Tensor, rec_lo, rec_hi, recon_gain: float,
                             levels: int) -> torch.Tensor:
    """K5: the inverse pyramid along each row of (R, N) f32, output (N, R)."""
    return _IPyramidRowsT.apply(y, rec_lo, rec_hi, recon_gain, levels)
