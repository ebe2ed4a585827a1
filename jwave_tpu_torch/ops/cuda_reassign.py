"""K6: the synchrosqueezing reassignment (``csrc/reassign.cu``), with plain
versions and its gradient.

Replaces ``jwave_tpu/ops/pallas_reassign.py`` (``_reassign_kernel``, driven
by ``reassign_pallas``). For contributions ``c`` (..., S, N) and bin indices
``k_idx`` (..., S, N):

    T[..., k, t] = sum over s with k_idx[..., s, t] == k of c[..., s, t]

for k in [0, n_bins); an index outside that range (negative, or the
sentinel n_bins) is dropped. :func:`reassign` launches the kernel for CUDA
tensors and takes :func:`reassign_torch` only for tensors on the CPU. The
map is linear in ``c``, so its gradient is the gather ``ct[k_idx]``, zero
where dropped, as the JAX package's custom VJP computes it
(``pallas_reassign.py:77-86``) outside the kernel.

The fused form (:func:`squeeze`) is the same kernel with the phase
transform and the bin index inside: it reads W and dW (the inverse FFT's
output, in place) and computes each coefficient's contribution and bin in
registers, as ``transforms/ssq.py`` ``_reassign_inputs`` computes them;
:func:`squeeze_torch` is its plain version. The default threshold's peak,
each row's max |W|^2, is a kernel of its own (:func:`row_peaks`).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..exceptions import JWaveFailure
from ..utils.profiling import span
from . import cuda_build

#: bins one block accumulates (``kChunk`` in the source)
BIN_CHUNK = 64
#: the block's plan (``csrc/reassign.cu``): time columns (= threads) a
#: block, s-rows a ring stage, ring stages; the fused form's ring
K6_TILE = 128
K6_STAGE_ROWS = 4
K6_STAGES = 4
FUSED_STAGE_ROWS = 8
FUSED_STAGES = 3
#: columns a block of the peak kernel takes (``kPeakCols``)
PEAK_COLS = 4096

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
#: ``csrc/reassign.cu``'s entries (library, symbol, signature): K6, its fused
#: form and the peak kernel
_K6 = ("reassign", "jw_reassign", [_P, _P, _P, _I, _I, _I, _I, _P])
_FUSED = ("reassign", "jw_reassign_fused",
          [_P, _P, _LL, _LL, _P, _P, _I, _F, _F, _F, _F, _F, _P, _I, _P, _I, _I, _I, _I, _P])
_PEAK = ("reassign", "jw_ssq_peak", [_P, _LL, _LL, _I, _I, _I, _P, _P])


class BinGrid(NamedTuple):
    """The bin grid that the fused form indexes: ``n_bins`` bins; ``f_lo``,
    the lowest bin's frequency, which stands in for a coefficient that is
    not reassigned; ``affine``, (ln f_0, d ln f) of a log-uniform grid, else
    None; ``edges``, the K + 1 edges of any other grid (float32, on the
    card), else None."""
    n_bins: int
    f_lo: float
    affine: tuple | None
    edges: torch.Tensor | None


class RowThreshold(NamedTuple):
    """Each leading row's |W| threshold for the fused form: ``values``,
    (rows,) float32 on the card, holds the threshold itself or, with
    ``from_peak``, the row's max |W|^2, from which the kernel forms the
    default 10 sqrt(eps) sqrt(max |W|^2)."""
    values: torch.Tensor
    from_peak: bool


def _flat(contrib: torch.Tensor, k_idx: torch.Tensor):
    lead = contrib.shape[:-2]
    s, n = contrib.shape[-2:]
    return lead, contrib.reshape(-1, s, n), k_idx.reshape(-1, s, n)


# ----------------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------------

def reassign_torch(contrib: torch.Tensor, k_idx: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Scatter form: out-of-range indices go to an extra row n_bins, the
    re/im planes are scatter-added into n_bins + 1 rows, the extra row is
    dropped."""
    lead, c, k = _flat(contrib, k_idx)
    g, s, n = c.shape
    k = k.long()
    k = torch.where((k >= 0) & (k < n_bins), k, n_bins)
    parts = torch.view_as_real(c.resolve_conj()) if c.is_complex() else c[..., None]
    w = parts.shape[-1]  # 2 for (re, im), 1 for real input
    out = torch.zeros((g, n_bins + 1, n, w), dtype=parts.dtype, device=c.device)
    out.scatter_add_(1, k[..., None].expand(g, s, n, w), parts)
    out = out[:, :n_bins]
    out = torch.view_as_complex(out.contiguous()) if c.is_complex() else out[..., 0]
    return out.reshape(lead + (n_bins, n))


def reassign_dense_torch(contrib: torch.Tensor, k_idx: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Bin loop: per bin row one masked sum over the scale axis (no (K, S, N)
    mask is ever built)."""
    lead, c, k = _flat(contrib, k_idx)
    out = torch.empty((c.shape[0], n_bins, c.shape[2]), dtype=c.dtype, device=c.device)
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    for kk in range(n_bins):
        out[:, kk] = torch.where(k == kk, c, zero).sum(dim=1)
    return out.reshape(lead + (n_bins, c.shape[2]))


# ----------------------------------------------------------------------------
# kernel wrapper
# ----------------------------------------------------------------------------

def k6_smem_bytes(n_bins: int, fused: bool = False) -> int:
    """Shared bytes of a K6 block (``csrc/reassign.cu`` smem_bytes): the
    complex64 plane of min(n_bins, BIN_CHUNK) bin rows of ``K6_TILE``
    columns, the ring of ``K6_STAGES`` stages of ``K6_STAGE_ROWS`` s-rows
    (8 B of contribution and 4 B of index a column; in the fused form
    ``FUSED_STAGES`` stages of ``FUSED_STAGE_ROWS`` s-rows of 8 B of W and
    8 B of dW) and one 8-byte mbarrier a stage."""
    stages, rows, col = ((FUSED_STAGES, FUSED_STAGE_ROWS, 16) if fused
                         else (K6_STAGES, K6_STAGE_ROWS, 12))
    return min(n_bins, BIN_CHUNK) * K6_TILE * 8 + stages * rows * K6_TILE * col + stages * 8


def _launch(contrib: torch.Tensor, k_idx: torch.Tensor, n_bins: int,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's plane of ``contrib`` and ``k_idx``, written into ``out``
    ((..., n_bins, N) complex64, contiguous, on the same card) where given,
    else into a new tensor."""
    if contrib.device.type != "cuda":
        raise JWaveFailure(f"reassign - tensor on {contrib.device}; "
                           "the kernel runs on CUDA tensors")
    if k_idx.device != contrib.device or k_idx.shape != contrib.shape:
        raise JWaveFailure("reassign - k_idx must match contrib in shape and device")
    if contrib.dtype != torch.complex64:
        raise JWaveFailure(f"reassign - dtype {contrib.dtype}; the kernel takes complex64")
    if contrib.dim() < 2:
        raise JWaveFailure("reassign - expected (..., S, N) contributions")
    if not 1 <= n_bins <= 65535 * BIN_CHUNK:
        raise JWaveFailure(f"reassign - n_bins {n_bins} out of range")
    lead, c, k = _flat(contrib.resolve_conj().contiguous(), k_idx.to(torch.int32).contiguous())
    g, s, n = c.shape
    if out is None:
        out = torch.empty(lead + (n_bins, n), dtype=torch.complex64, device=c.device)
    elif (out.shape != lead + (n_bins, n) or out.dtype != torch.complex64
          or out.device != c.device or not out.is_contiguous()):
        raise JWaveFailure(f"reassign - out must be a contiguous complex64 tensor of shape "
                           f"{tuple(lead + (n_bins, n))} on {c.device}")
    if g * n == 0:
        return out
    if s == 0:
        return out.zero_()
    if g * -(-n // K6_TILE) >= 2**31:
        raise JWaveFailure(f"reassign - {g} x {n} columns exceed one launch")
    with span("launch.K6", rows=g, n=n, bins=n_bins):
        cuda_build.launch(_K6, (c.data_ptr(), k.data_ptr(), out.data_ptr(), g, s, n, n_bins),
                          c.device, "reassign", "K6")
    return out


def _rows(W: torch.Tensor) -> torch.Tensor:
    """(..., S, N) as (rows, S, N): a view where the leading axes allow one."""
    return W.reshape((math.prod(W.shape[:-2]),) + tuple(W.shape[-2:]))


def _check_block(W: torch.Tensor, what: str):
    if W.device.type != "cuda":
        raise JWaveFailure(f"{what} - tensor on {W.device}; the kernel runs on CUDA tensors")
    if W.dtype != torch.complex64:
        raise JWaveFailure(f"{what} - dtype {W.dtype}; the kernel takes complex64")
    if W.dim() < 2:
        raise JWaveFailure(f"{what} - expected (..., S, N) coefficients")


def row_peaks(W: torch.Tensor) -> torch.Tensor:
    """The peak kernel: each leading row's max over (S, N) of |W|^2 =
    re^2 + im^2, (rows,) float32, equal to the bit to ``torch.amax(W.real**2
    + W.imag**2, dim=(-2, -1))`` (a NaN wins, as there). ``W`` is a (..., S,
    N) complex64 CUDA tensor, read in place where its time axis has unit
    stride."""
    _check_block(W, "row_peaks")
    w3 = _rows(W.resolve_conj())
    if w3.stride(-1) != 1:
        w3 = w3.contiguous()
    g, s, n = w3.shape
    peak = torch.zeros(g, dtype=torch.float32, device=W.device) if s * n == 0 else \
        torch.empty(g, dtype=torch.float32, device=W.device)
    if g * s * n == 0:
        return peak
    if g * s * -(-n // PEAK_COLS) >= 2**31:
        raise JWaveFailure(f"row_peaks - {g} x {s} x {n} coefficients exceed one launch")
    cuda_build.launch(_PEAK, (w3.data_ptr(), w3.stride(0), w3.stride(1), g, s, n,
                              peak.data_ptr()),
                      W.device, "row_peaks", "K6.peak")
    return peak


def row_threshold(W: torch.Tensor, gamma=None) -> RowThreshold:
    """Each leading row's |W| threshold of a (..., S, N) block for
    :func:`squeeze`: None takes the default (the peak kernel, no host
    sync); a number fills every row with it as float32 (no upload); a tensor
    broadcastable to the leading axes with two trailing axes of one (as
    ``keepdim`` reductions give) is taken as it is."""
    lead = W.shape[:-2]
    rows = math.prod(lead)
    if gamma is None:
        return RowThreshold(row_peaks(W), True)
    if not isinstance(gamma, torch.Tensor):
        return RowThreshold(torch.full((rows,), float(gamma), dtype=torch.float32,
                                       device=W.device), False)
    t = gamma.to(device=W.device, dtype=torch.float32)
    try:
        t = t.reshape((1,) * (2 - t.dim()) + tuple(t.shape)) if t.dim() < 2 else t
        if tuple(t.shape[-2:]) != (1, 1):
            raise RuntimeError("a threshold per scale or time")
        t = t.expand(lead + (1, 1))
    except RuntimeError as e:
        raise JWaveFailure(f"squeeze - gamma of shape {tuple(gamma.shape)} is not one "
                           f"threshold a row of {tuple(lead)} ({e})") from None
    return RowThreshold(t.reshape(rows).contiguous(), False)


def squeeze(W: torch.Tensor, dW: torch.Tensor, wgt, gamma, grid: BinGrid, out_of_range: str,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """K6's fused form: the (..., K, N) complex64 plane of a (..., S, N)
    complex64 coefficient block ``W`` and its time derivative ``dW``, with
    the phase transform and the bin index of ``_reassign_inputs`` inside the
    kernel, in one launch (after the peak kernel where ``gamma`` is None).

    ``W`` and ``dW`` are read in place where they share their strides and
    their time axis has unit stride (the two halves of ``ssq``'s inverse
    FFT output); ``wgt`` is the per-scale weight (S,); ``gamma`` as
    :func:`row_threshold` takes it, or a :class:`RowThreshold`; ``grid`` a
    :class:`BinGrid`; ``out`` as in :func:`reassign`. Computes in float32
    with each rounding of torch's eager kernels, so the bins are theirs.
    Records no gradient."""
    if out_of_range not in ("clip", "drop"):
        raise JWaveFailure(f"ssq_cwt - out_of_range must be 'clip' or 'drop', got {out_of_range!r}")
    _check_block(W, "squeeze")
    if dW.shape != W.shape or dW.device != W.device or dW.dtype != W.dtype:
        raise JWaveFailure("squeeze - dW must match W in shape, device and dtype")
    n_bins = grid.n_bins
    if not 1 <= n_bins <= 65535 * BIN_CHUNK:
        raise JWaveFailure(f"squeeze - n_bins {n_bins} out of range")
    lead = W.shape[:-2]
    w3, dw3 = _rows(W.resolve_conj()), _rows(dW.resolve_conj())
    if w3.stride() != dw3.stride() or w3.stride(-1) != 1:
        w3, dw3 = w3.contiguous(), dw3.contiguous()
    g, s, n = w3.shape
    if out is None:
        out = torch.empty(lead + (n_bins, n), dtype=torch.complex64, device=W.device)
    elif (out.shape != lead + (n_bins, n) or out.dtype != torch.complex64
          or out.device != W.device or not out.is_contiguous()):
        raise JWaveFailure(f"squeeze - out must be a contiguous complex64 tensor of shape "
                           f"{tuple(lead + (n_bins, n))} on {W.device}")
    if g * n == 0:
        return out
    if s == 0:
        return out.zero_()
    if g * -(-n // K6_TILE) >= 2**31:
        raise JWaveFailure(f"squeeze - {g} x {n} columns exceed one launch")
    thr = gamma if isinstance(gamma, RowThreshold) else row_threshold(W, gamma)
    w_s = torch.as_tensor(wgt, device=W.device).to(torch.float32).contiguous()
    if w_s.shape != (s,):
        raise JWaveFailure(f"squeeze - wgt of shape {tuple(w_s.shape)}, expected ({s},)")
    if grid.affine is None:
        edges = grid.edges.to(device=W.device, dtype=torch.float32).contiguous()
        if edges.shape != (n_bins + 1,):
            raise JWaveFailure(f"squeeze - {tuple(edges.shape)} edges for {n_bins} bins")
        log_f0, inv_dlf = 0.0, 0.0
    else:
        edges = None
        log_f0 = float(np.float32(grid.affine[0]))
        # torch divides by a Python float as a product with its float32 reciprocal
        inv_dlf = float(np.float32(1) / np.float32(grid.affine[1]))
    inv_2pi = float(np.float32(1) / np.float32(2.0 * math.pi))
    peak_scale = 10.0 * math.sqrt(torch.finfo(torch.float32).eps)
    with span("launch.K6", rows=g, n=n, bins=n_bins, fused=1):
        cuda_build.launch(_FUSED, (w3.data_ptr(), dw3.data_ptr(), w3.stride(0), w3.stride(1),
                                   w_s.data_ptr(), thr.values.data_ptr(), int(thr.from_peak),
                                   peak_scale, grid.f_lo, log_f0, inv_dlf, inv_2pi,
                                   None if edges is None else edges.data_ptr(),
                                   int(out_of_range == "drop"), out.data_ptr(), g, s, n, n_bins),
                          W.device, "squeeze", "K6", "K6.fused")
    return out


def squeeze_torch(W: torch.Tensor, dW: torch.Tensor, wgt, gamma, freqs: np.ndarray,
                  out_of_range: str, edges=None) -> torch.Tensor:
    """Plain version of :func:`squeeze`: ``transforms/ssq.py``'s
    ``_reassign_inputs`` then :func:`reassign_torch`, on the Hz grid
    ``freqs``; ``gamma`` None is the default threshold 10 sqrt(eps)
    sqrt(max |W|^2) of each leading row, else the |W| threshold."""
    from ..transforms.ssq import _default_gamma, _reassign_inputs  # ssq imports this module

    if gamma is None:
        gamma = _default_gamma(W)
    else:
        gamma = torch.as_tensor(gamma, dtype=W.real.dtype, device=W.device)
    contrib, k_idx = _reassign_inputs(W, dW, wgt, freqs, gamma, out_of_range, edges)
    return reassign_torch(contrib, k_idx, freqs.shape[0])


def _reassign(contrib: torch.Tensor, k_idx: torch.Tensor, n_bins: int) -> torch.Tensor:
    if contrib.device.type == "cpu":
        return reassign_torch(contrib, k_idx, n_bins)
    return _launch(contrib, k_idx, n_bins)


class _Reassign(torch.autograd.Function):
    """Forward: the kernel on CUDA, the scatter form on the CPU. Backward:
    the gather ``ct[k_idx]``, zero where the index was dropped."""

    @staticmethod
    def forward(ctx, contrib, k_idx, n_bins):
        ctx.save_for_backward(k_idx)
        ctx.n_bins = n_bins
        return _reassign(contrib, k_idx, n_bins)

    @staticmethod
    def backward(ctx, ct):
        (k_idx,) = ctx.saved_tensors
        k = k_idx.long()
        valid = (k >= 0) & (k < ctx.n_bins)
        g = torch.gather(ct, -2, k.clamp(0, ctx.n_bins - 1))
        return torch.where(valid, g, torch.zeros((), dtype=g.dtype, device=g.device)), None, None


def reassign(contrib: torch.Tensor, k_idx: torch.Tensor, n_bins: int,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """K6: (..., S, N) complex64 contributions and integer bin indices ->
    (..., n_bins, N) complex64 squeezed plane. Computes in float32, as the
    TPU kernel does: 64-bit input raises rather than being cut silently.

    With ``out`` (contiguous, of the plane's shape and dtype) the plane is
    written there: by the kernel itself on a card, by a copy on the CPU or
    where a gradient is recorded."""
    if contrib.dtype in (torch.complex128, torch.float64):
        raise JWaveFailure(
            "reassign_pallas - the Pallas kernel computes in float32; use "
            "reassign='dense' or 'scatter' for 64-bit inputs"
        )
    if out is None:
        return cuda_build.apply(_Reassign, _reassign, contrib, k_idx, n_bins)
    if contrib.device.type == "cpu" or (torch.is_grad_enabled() and contrib.requires_grad):
        return out.copy_(_Reassign.apply(contrib, k_idx, n_bins))
    return _launch(contrib, k_idx, n_bins, out)
