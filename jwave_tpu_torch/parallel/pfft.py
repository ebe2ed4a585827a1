"""Distributed 1D FFT over a mesh axis (four-step / Bailey algorithm), and
the distributed 2D FFT.

Algorithm (N = D * L, D ranks, local length L, requiring D | L), as in the
JAX package (``jwave_tpu/parallel/pfft.py``):

  forward  x (contiguous-sharded) -> X in the "(D, L) spectrum layout"
    1. reshuffle: one all_to_all converts contiguous chunks to the
       stride-D decimated layout  A[d, j2] = x[d + D*j2]
    2. local length-L FFT over j2          B[d, k2]
    3. twiddle  C[d, k2] = B[d, k2] * exp(-2i*pi*d*k2/N)
    4. transpose: one all_to_all so rank i holds C[:, i-th k2 block]
    5. local length-D FFT over the d axis  -> X[k2 + L*k1]

The result is the full spectrum reshaped row-major to (D, L) and
column-sharded: G[k1, k2] = X[k1*L + k2], rank i holding k2 block i. The
inverse reverses the five steps with conjugate twiddles and 1/N scaling.
Local FFTs are ``torch.fft`` (cuFFT on the card), which takes any length.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..exceptions import JWaveFailure
from ._collectives import all_to_all, axis_index, axis_size
from ._layout import global_input, local_block, sharded_output

_TWIDDLES: OrderedDict = OrderedDict()
_TWIDDLES_MAX = 16


def _check_geometry(n: int, n_dev: int, who: str):
    if n % n_dev:
        raise JWaveFailure(f"{who} - length {n} must divide over {n_dev} devices")
    l = n // n_dev
    if l % n_dev:
        raise JWaveFailure(
            f"{who} - needs local length divisible by the device count "
            f"(N >= D^2 with D | L); got N={n}, D={n_dev}, L={l}"
        )


def _complex_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.complex128 if x.dtype in (torch.float64, torch.complex128) else torch.complex64


def _twiddle(n: int, d: int, l: int, cdtype: torch.dtype, device, sign: float) -> torch.Tensor:
    """exp(sign * 2i*pi * d*k2 / N) for k2 < L, computed in float64 and cached
    per geometry, rank, dtype and device."""
    key = (n, d, l, cdtype, str(device), sign)
    tw = _TWIDDLES.get(key)
    if tw is None:
        k2 = torch.arange(l, dtype=torch.float64, device=device)
        tw = torch.polar(torch.ones_like(k2), (sign * 2.0 * math.pi / n) * (d * k2)).to(cdtype)
        _TWIDDLES[key] = tw
        while len(_TWIDDLES) > _TWIDDLES_MAX:
            _TWIDDLES.popitem(last=False)
    else:
        _TWIDDLES.move_to_end(key)
    return tw


# ---------------------------------------------------------------------------
# local pieces, run on every rank
# ---------------------------------------------------------------------------

def pfft_local(x_loc: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Forward four-step FFT body. ``x_loc``: (..., L) local contiguous chunk
    of a length-N=D*L signal (real or complex). Returns the local (..., D,
    L/D) block of the (D, L) spectrum layout (this rank's k2 columns)."""
    n_dev = axis_size(mesh, axis)
    l = x_loc.shape[-1]
    n = n_dev * l
    lead = x_loc.shape[:-1]
    cdtype = _complex_dtype(x_loc)
    x_loc = x_loc.to(cdtype)
    if n_dev == 1:  # the (1, L) layout is the plain spectrum
        return torch.fft.fft(x_loc, dim=-1)[..., None, :]
    # 1. contiguous -> stride-D decimated: (L,) -> (L/D, D) -> (D, L/D), exchange
    m = x_loc.reshape(lead + (l // n_dev, n_dev)).transpose(-1, -2)
    m = all_to_all(m, mesh, axis, split_axis=-2, concat_axis=-2, tiled=True)
    a = m.reshape(lead + (l,))  # A[d, j2] for d = this rank
    # 2. local length-L FFT, 3. twiddle
    c = torch.fft.fft(a, dim=-1) * _twiddle(n, axis_index(mesh, axis), l, cdtype, a.device, -1.0)
    # 4. transpose so this rank holds all d for its k2 block
    t = all_to_all(c.reshape(lead + (n_dev, l // n_dev)), mesh, axis, split_axis=-2,
                   concat_axis=-2, tiled=True)
    # 5. local length-D FFT over the source-rank axis
    return torch.fft.fft(t, dim=-2)


def pifft_local(g_loc: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Inverse four-step FFT body. ``g_loc``: (..., D, L/D) local block of the
    (D, L) spectrum layout. Returns the local (..., L) contiguous chunk of
    the length-N time-domain signal (complex)."""
    n_dev = axis_size(mesh, axis)
    l = g_loc.shape[-1] * n_dev
    n = n_dev * l
    lead = g_loc.shape[:-2]
    if n_dev == 1:
        return torch.fft.ifft(g_loc[..., 0, :], dim=-1)
    # 5'. local inverse FFT over k1, 4'. transpose back
    t = all_to_all(torch.fft.ifft(g_loc, dim=-2), mesh, axis, split_axis=-2, concat_axis=-2,
                   tiled=True)
    c = t.reshape(lead + (l,))
    # 3'. conjugate twiddle, 2'. local inverse length-L FFT: A[d, j2] = x[d + D*j2]
    a = torch.fft.ifft(c * _twiddle(n, axis_index(mesh, axis), l, c.dtype, c.device, 1.0), dim=-1)
    # 1'. stride-D decimated -> contiguous
    m = all_to_all(a.reshape(lead + (n_dev, l // n_dev)), mesh, axis, split_axis=-2,
                   concat_axis=-2, tiled=True)
    return m.transpose(-1, -2).reshape(lead + (l,))


def pfft2_local(x_loc: torch.Tensor, mesh: DeviceMesh, axis: str,
                inverse: bool = False) -> torch.Tensor:
    """2D FFT body on a row-sharded block: ``x_loc`` (..., M/D, N) ->
    (..., M/D, N) block of the natural-order 2D spectrum (row-sharded).
    Local FFT along the resident N axis, one all_to_all to own a column
    chunk, local FFT along the now resident M axis, one all_to_all back."""
    fft = torch.fft.ifft if inverse else torch.fft.fft
    n_dev = axis_size(mesh, axis)
    b = fft(x_loc.to(_complex_dtype(x_loc)), dim=-1)
    if n_dev == 1:
        return fft(b, dim=-2)
    lead = b.shape[:-2]
    nl = len(lead)
    m_loc, n = b.shape[-2:]
    t = b.reshape(lead + (m_loc, n_dev, n // n_dev))
    t = all_to_all(t, mesh, axis, split_axis=nl + 1, concat_axis=nl)  # (..., D, M/D, n/D)
    t = fft(t.reshape(lead + (n_dev * m_loc, n // n_dev)), dim=-2)  # (..., M, n/D)
    t = t.reshape(lead + (n_dev, m_loc, n // n_dev))
    t = all_to_all(t, mesh, axis, split_axis=nl, concat_axis=nl + 1)  # (..., M/D, D, n/D)
    return t.reshape(lead + (m_loc, n))


# ---------------------------------------------------------------------------
# public sharded entry points
# ---------------------------------------------------------------------------

def pfft(signal, mesh: DeviceMesh, axis_name: str | None = None):
    """Distributed FFT along the last axis of a (..., N) signal batch, the
    time axis sharded over ``mesh`` (leading batch axes replicated).

    Returns the full spectrum as a (..., D, N/D) DTensor, the row-major
    reshape of ``torch.fft.fft(signal, dim=-1)``, sharded over its columns.
    ``.full_tensor().reshape(..., N)`` gives natural order; :func:`pifft`
    takes it as it is.
    """
    axis_name = axis_name or mesh.mesh_dim_names[0]
    n_dev = axis_size(mesh, axis_name)
    signal = global_input(signal, mesh)
    if signal.dim() < 1:
        raise JWaveFailure("pfft - expects at least a 1D signal")
    _check_geometry(signal.shape[-1], n_dev, "pfft")
    last = signal.dim() - 1
    out = pfft_local(local_block(signal, mesh, {axis_name: last}), mesh, axis_name)
    return sharded_output(out, mesh, {axis_name: last + 1},
                          tuple(signal.shape[:-1]) + (n_dev, signal.shape[-1] // n_dev))


def pifft(spectrum, mesh: DeviceMesh, axis_name: str | None = None):
    """Inverse of :func:`pfft`: the (..., D, N/D) column-sharded spectrum
    layout back to the (..., N) time-domain signal (contiguous-sharded,
    complex)."""
    axis_name = axis_name or mesh.mesh_dim_names[0]
    n_dev = axis_size(mesh, axis_name)
    spectrum = global_input(spectrum, mesh)
    if spectrum.dim() < 2 or spectrum.shape[-2] != n_dev:
        raise JWaveFailure(f"pifft - expects a (..., {n_dev}, N/{n_dev}) spectrum layout")
    _check_geometry(spectrum.shape[-2] * spectrum.shape[-1], n_dev, "pifft")
    last = spectrum.dim() - 1
    out = pifft_local(local_block(spectrum, mesh, {axis_name: last}), mesh, axis_name)
    return sharded_output(out, mesh, {axis_name: last - 1},
                          tuple(spectrum.shape[:-2]) + (n_dev * spectrum.shape[-1],))


def _pfft2_common(mat, mesh: DeviceMesh, axis_name, inverse: bool, who: str):
    axis_name = axis_name or mesh.mesh_dim_names[0]
    n_dev = axis_size(mesh, axis_name)
    mat = global_input(mat, mesh)
    if mat.dim() < 2:
        raise JWaveFailure(f"{who} - expects a (..., M, N) matrix")
    m, n = mat.shape[-2:]
    if m % n_dev or n % n_dev:
        raise JWaveFailure(
            f"{who} - matrix {m}x{n} must divide over {n_dev} devices on both axes"
        )
    rows = mat.dim() - 2
    out = pfft2_local(local_block(mat, mesh, {axis_name: rows}), mesh, axis_name, inverse)
    return sharded_output(out, mesh, {axis_name: rows}, tuple(mat.shape))


def pfft2(mat, mesh: DeviceMesh, axis_name: str | None = None):
    """Distributed 2D FFT of a (..., M, N) row-sharded matrix: the full 2D
    spectrum in natural order, row-sharded like the input. Unnormalized
    forward (matches ``torch.fft.fft2``)."""
    return _pfft2_common(mat, mesh, axis_name, False, "pfft2")


def pifft2(mat, mesh: DeviceMesh, axis_name: str | None = None):
    """Inverse distributed 2D FFT (matches ``torch.fft.ifft2``; complex out)."""
    return _pfft2_common(mat, mesh, axis_name, True, "pifft2")
