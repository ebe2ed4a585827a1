"""The fast wavelet transform (JWave's pyramid) along one axis, and the
separable 2D and 3D transforms built from it.

One analysis step on the first h samples of a row (JWave ``Wavelet.forward``):

    out[i]       = sum_j x[(2i + j) mod h] lo[j]
    out[i + h/2] = sum_j x[(2i + j) mod h] hi[j],        i < h/2

and its synthesis (``Wavelet.reverse``, an orthonormal bank):

    x[(2i + j) mod h] += out[i] lo[j] + out[i + h/2] hi[j]

The pyramid steps h = N, N/2, ... for ``level`` steps while h >= 2 and the
inverse walks back up (``FastWaveletTransform.forward``/``reverse``). The
2D and 3D transforms run the pyramid along every axis. Plain torch on any
device, in float64; ``prec`` as in :mod:`.modwt`.
"""
from __future__ import annotations

import torch

from .precision import FLOAT64


def _index(h: int, m: int, device) -> torch.Tensor:
    i = torch.arange(h // 2, device=device)[:, None]
    return (2 * i + torch.arange(m, device=device)[None, :]) % h  # (h/2, M)


def _steps(n: int, level: int) -> list[int]:
    hs, h = [], n
    while h >= 2 and len(hs) < level:
        hs.append(h)
        h //= 2
    return hs


def fwt_rows(x: torch.Tensor, lo, hi, level: int, prec=FLOAT64) -> torch.Tensor:
    """Forward pyramid along the last axis (a power of two), float64."""
    y = x.to(torch.float64).clone()
    taps = prec.operand(torch.tensor([lo, hi], dtype=torch.float64, device=y.device).T)  # (M, 2)
    for h in _steps(y.shape[-1], level):
        part = prec.operand(y[..., :h])[..., _index(h, len(lo), y.device)]  # (..., h/2, M)
        ad = prec.result(part @ taps)  # (..., h/2, 2)
        y[..., : h // 2] = ad[..., 0]
        y[..., h // 2: h] = ad[..., 1]
    return y


def ifwt_rows(y: torch.Tensor, lo, hi, level: int, prec=FLOAT64) -> torch.Tensor:
    """Inverse of :func:`fwt_rows` along the last axis, float64."""
    x = y.to(torch.float64).clone()
    m = len(lo)
    taps = prec.operand(torch.tensor([lo, hi], dtype=torch.float64, device=x.device))  # (2, M)
    for h in reversed(_steps(x.shape[-1], level)):
        ad = prec.operand(torch.stack([x[..., : h // 2], x[..., h // 2: h]], dim=-1))
        contrib = (ad @ taps).flatten(-2)  # (..., h/2 * M)
        out = torch.zeros(x.shape[:-1] + (h,), dtype=torch.float64, device=x.device)
        out.index_add_(-1, _index(h, m, x.device).flatten(), contrib)
        x[..., :h] = prec.result(out)
    return x


def _along(fn, x: torch.Tensor, axis: int, *args, **kw) -> torch.Tensor:
    return torch.movedim(fn(torch.movedim(x, axis, -1), *args, **kw), -1, axis)


def fwt_nd(x: torch.Tensor, lo, hi, levels, prec=FLOAT64) -> torch.Tensor:
    """Forward pyramid along each of the last len(levels) axes, ``levels``
    in axis order (rows of a matrix first)."""
    y = x.to(torch.float64)
    for k, lvl in enumerate(levels):
        y = _along(fwt_rows, y, k - len(levels), lo, hi, lvl, prec=prec)
    return y


def ifwt_nd(y: torch.Tensor, lo, hi, levels, prec=FLOAT64) -> torch.Tensor:
    """Inverse of :func:`fwt_nd`."""
    x = y.to(torch.float64)
    for k, lvl in enumerate(levels):
        x = _along(ifwt_rows, x, k - len(levels), lo, hi, lvl, prec=prec)
    return x
