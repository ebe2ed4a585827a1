"""Separable 2D/3D drivers and complex bridging.

Reference: jwave/transforms/BasicTransform.java — 2D = per-row then
per-column 1D transforms (:361-399), 3D = per-slice 2D then per-pillar 1D
(:509-566), complex = interleave re/im into a length-2N real array
(:257-322). Each axis pass is one batched 1D transform over the last axis;
transposes bring the other axes there.
"""
from __future__ import annotations

import torch

from ..utils.profiling import count, span

# listed from import on: a call that copied nothing reads 0
count("ndim.transposes", 0)
count("ndim.transpose_bytes", 0)


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    """A transposing copy that brings the next axis last, counted as
    ``ndim.transposes`` and ``ndim.transpose_bytes`` where it copies."""
    with span("ndim.transpose"):
        out = t.contiguous()
        if out is not t:
            count("ndim.transposes")
            count("ndim.transpose_bytes", out.numel() * out.element_size())
        return out


def forward_2d(fn1d, mat, level_rows: int | None = None, level_cols: int | None = None):
    """2D separable forward: rows (last axis) then columns. ``fn1d(x, level)``
    transforms the last axis; ``level_cols`` bounds the transform along each
    row, ``level_rows`` the one along each column. Each axis pass, its
    transposing copies included, is one ``ndim.pass`` span."""
    with span("ndim.pass", axis=-1):
        y = fn1d(mat, level_cols)
    with span("ndim.pass", axis=-2):
        y = fn1d(_contiguous(y.transpose(-1, -2)), level_rows)
        return _contiguous(y.transpose(-1, -2))


def reverse_2d(fn1d_rev, mat, level_rows: int | None = None, level_cols: int | None = None):
    """2D separable inverse (BasicTransform.java:412-474)."""
    with span("ndim.pass", axis=-1):
        y = fn1d_rev(mat, level_cols)
    with span("ndim.pass", axis=-2):
        y = fn1d_rev(_contiguous(y.transpose(-1, -2)), level_rows)
        return _contiguous(y.transpose(-1, -2))


def forward_3d(fn1d, spc, level_p: int | None = None, level_q: int | None = None,
               level_r: int | None = None):
    """3D separable forward over the last three axes: rows, columns, pillars."""
    with span("ndim.pass", axis=-1):
        y = fn1d(spc, level_r)
    with span("ndim.pass", axis=-2):
        y = fn1d(_contiguous(y.transpose(-1, -2)), level_q)
    y = y.transpose(-1, -2)
    with span("ndim.pass", axis=-3):
        y = fn1d(_contiguous(torch.movedim(y, -3, -1)), level_p)
        return _contiguous(torch.movedim(y, -1, -3))


def reverse_3d(fn1d_rev, spc, level_p: int | None = None, level_q: int | None = None,
               level_r: int | None = None):
    """3D separable inverse."""
    with span("ndim.pass", axis=-1):
        y = fn1d_rev(spc, level_r)
    with span("ndim.pass", axis=-2):
        y = fn1d_rev(_contiguous(y.transpose(-1, -2)), level_q)
    y = y.transpose(-1, -2)
    with span("ndim.pass", axis=-3):
        y = fn1d_rev(_contiguous(torch.movedim(y, -3, -1)), level_p)
        return _contiguous(torch.movedim(y, -1, -3))


def interleave(z: torch.Tensor) -> torch.Tensor:
    """complex (..., N) -> real (..., 2N) as [re0, im0, re1, im1, ...]."""
    return torch.view_as_real(z.resolve_conj()).reshape(z.shape[:-1] + (2 * z.shape[-1],))


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """real (..., 2N) -> complex (..., N)."""
    n = x.shape[-1] // 2
    return torch.view_as_complex(x.reshape(x.shape[:-1] + (n, 2)).contiguous())


def forward_complex(fn1d_real, z, level: int | None = None):
    """Complex 1D via the interleaved-real bridge (BasicTransform.java:257-292)."""
    return deinterleave(fn1d_real(interleave(z), level))


def reverse_complex(fn1d_real_rev, z, level: int | None = None):
    """Inverse complex bridge (BasicTransform.java:294-322)."""
    return deinterleave(fn1d_real_rev(interleave(z), level))
