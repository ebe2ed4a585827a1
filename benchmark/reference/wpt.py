"""The wavelet packet transform (JWave's packet tree) along one axis, and the
separable 2D transform built from it.

JWave's ``WaveletPacketTransform.forward`` (``:96-124``): at each level the
analysis step of :mod:`.fwt` (JWave ``Wavelet.forward``) runs on every
packet of length h, the N/h consecutive runs of h samples of the row:

    out[p h + i]       = sum_j x[p h + (2i + j) mod h] lo[j]
    out[p h + i + h/2] = sum_j x[p h + (2i + j) mod h] hi[j],   i < h/2

so each packet splits into its approximation and its detail half in place;
h steps N, N/2, ... for ``level`` levels while h is at least the bank's
transform wavelength. After L levels the row holds 2^L packets of N/2^L in
JWave's order: the first level's choice (approximation or detail) is the
most significant bit of a packet's index. The inverse
(``WaveletPacketTransform.reverse``, ``:141-189``) runs the synthesis step
on every packet from the coarsest level back to h = N.

The 2D transform runs it along each of the last two axes
(``BasicTransform.forward``/``reverse`` for a matrix, ``:336-474``); the
passes along different axes commute. Plain torch on any device, in
float64; ``prec`` (:mod:`.precision`) rounds each step's operands and
results, for a copy in a lower precision; by default nothing is rounded.
"""
from __future__ import annotations

import torch

from .fwt import _along, _index
from .precision import FLOAT64

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: the smallest packet JWave's orthogonal banks split (``_transformWavelength``)
TRANSFORM_WAVELENGTH = 2


def _lengths(n: int, level: int) -> list[int]:
    """Packet lengths h = n, n/2, ... of the forward levels."""
    hs, h = [], n
    while h >= TRANSFORM_WAVELENGTH and len(hs) < level:
        hs.append(h)
        h //= 2
    return hs


def wpt_rows(x: torch.Tensor, lo, hi, level: int, prec=FLOAT64) -> torch.Tensor:
    """Forward packet tree along the last axis (a power of two), float64."""
    y = x.to(torch.float64)
    n = y.shape[-1]
    taps = prec.operand(torch.tensor([lo, hi], dtype=torch.float64, device=y.device).T)  # (M, 2)
    for h in _lengths(n, level):
        packets = prec.operand(y.reshape(y.shape[:-1] + (n // h, h)))
        ad = prec.result(packets[..., _index(h, len(lo), y.device)] @ taps)  # (..., g, h/2, 2)
        y = torch.cat([ad[..., 0], ad[..., 1]], dim=-1).reshape(y.shape)
    return y


def iwpt_rows(y: torch.Tensor, lo, hi, level: int, prec=FLOAT64) -> torch.Tensor:
    """Inverse of :func:`wpt_rows` along the last axis, float64."""
    x = y.to(torch.float64)
    n, m = x.shape[-1], len(lo)
    taps = prec.operand(torch.tensor([lo, hi], dtype=torch.float64, device=x.device))  # (2, M)
    for h in reversed(_lengths(n, level)):
        packets = x.reshape(x.shape[:-1] + (n // h, h))
        ad = prec.operand(torch.stack([packets[..., : h // 2], packets[..., h // 2:]], dim=-1))
        contrib = (ad @ taps).flatten(-2)  # (..., g, h/2 * M)
        out = torch.zeros(packets.shape, dtype=torch.float64, device=x.device)
        out.index_add_(-1, _index(h, m, x.device).flatten(), contrib)
        x = prec.result(out).reshape(x.shape)
    return x


def wpt_nd(x: torch.Tensor, lo, hi, levels, prec=FLOAT64) -> torch.Tensor:
    """Forward packet tree along each of the last len(levels) axes,
    ``levels`` in axis order (the columns of a matrix first: ``levels[-1]``
    bounds the transform along each row)."""
    y = x.to(torch.float64)
    for k, lvl in enumerate(levels):
        y = _along(wpt_rows, y, k - len(levels), lo, hi, lvl, prec=prec)
    return y


def iwpt_nd(y: torch.Tensor, lo, hi, levels, prec=FLOAT64) -> torch.Tensor:
    """Inverse of :func:`wpt_nd`."""
    x = y.to(torch.float64)
    for k, lvl in enumerate(levels):
        x = _along(iwpt_rows, x, k - len(levels), lo, hi, lvl, prec=prec)
    return x
