"""Separable 2D/3D drivers and complex bridging.

Reference: jwave/transforms/BasicTransform.java — 2D = per-row then
per-column 1D transforms (:361-399), 3D = per-slice 2D then per-pillar 1D
(:509-566), complex = interleave re/im into a length-2N real array
(:257-322). Each axis pass is one batched 1D transform over the last axis;
transposes bring the other axes there.
"""
from __future__ import annotations

import torch


def forward_2d(fn1d, mat, level_rows: int | None = None, level_cols: int | None = None):
    """2D separable forward: rows (last axis) then columns. ``fn1d(x, level)``
    transforms the last axis; ``level_cols`` bounds the transform along each
    row, ``level_rows`` the one along each column."""
    y = fn1d(mat, level_cols)
    y = fn1d(y.transpose(-1, -2).contiguous(), level_rows)
    return y.transpose(-1, -2).contiguous()


def reverse_2d(fn1d_rev, mat, level_rows: int | None = None, level_cols: int | None = None):
    """2D separable inverse (BasicTransform.java:412-474)."""
    y = fn1d_rev(mat, level_cols)
    y = fn1d_rev(y.transpose(-1, -2).contiguous(), level_rows)
    return y.transpose(-1, -2).contiguous()


def forward_3d(fn1d, spc, level_p: int | None = None, level_q: int | None = None,
               level_r: int | None = None):
    """3D separable forward over the last three axes: rows, columns, pillars."""
    y = fn1d(spc, level_r)
    y = fn1d(y.transpose(-1, -2).contiguous(), level_q)
    y = y.transpose(-1, -2)
    y = fn1d(torch.movedim(y, -3, -1).contiguous(), level_p)
    return torch.movedim(y, -1, -3).contiguous()


def reverse_3d(fn1d_rev, spc, level_p: int | None = None, level_q: int | None = None,
               level_r: int | None = None):
    """3D separable inverse."""
    y = fn1d_rev(spc, level_r)
    y = fn1d_rev(y.transpose(-1, -2).contiguous(), level_q)
    y = y.transpose(-1, -2)
    y = fn1d_rev(torch.movedim(y, -3, -1).contiguous(), level_p)
    return torch.movedim(y, -1, -3).contiguous()


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
