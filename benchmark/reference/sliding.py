"""The causal MODWT of a stream, which a sliding-window analysis updates.

Over the whole stream x[0..T) with nothing before it (zeros):

    W_j[t] = sum_m h[m] V_{j-1}[t - m*2^(j-1)],   V_j[t] = sum_m g[m] V_{j-1}[t - m*2^(j-1)]

with V_0 = x and V_{j-1}[t] = 0 for t < 0: the linear, not circular,
cascade (JWave's ``MODWTSlidingWindowTest`` recomputes it per window; a
sliding update computes the newest columns of it). Plain torch on any
device, in float64; ``prec`` as in :mod:`.modwt`.
"""
from __future__ import annotations

import torch

from .precision import FLOAT64


def _shift(v: torch.Tensor, s: int) -> torch.Tensor:
    """r[t] = v[t - s], zero for t < s."""
    if s == 0:
        return v
    r = torch.zeros_like(v)
    if s < v.shape[-1]:
        r[..., s:] = v[..., :-s]
    return r


def causal_modwt(x: torch.Tensor, g, h, level: int, prec=FLOAT64) -> torch.Tensor:
    """(B, T) -> (B, level+1, T) rows [W_1 .. W_J, V_J], float64."""
    v = x.to(torch.float64)
    gt = prec.operand(torch.tensor(g, dtype=torch.float64, device=v.device))
    ht = prec.operand(torch.tensor(h, dtype=torch.float64, device=v.device))
    rows = []
    for j in range(1, level + 1):
        gap = 1 << (j - 1)
        src = prec.operand(v)
        w = torch.zeros_like(v)
        vn = torch.zeros_like(v)
        for m in range(len(g)):
            r = _shift(src, m * gap)
            w += ht[m] * r
            vn += gt[m] * r
        rows.append(prec.result(w))
        v = prec.result(vn)
    rows.append(v)
    return torch.stack(rows, dim=-2)
