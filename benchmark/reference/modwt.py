"""The MODWT and its inverse, periodic boundary, by their definitions.

For levels j = 1..J with gap 2^(j-1) and the MODWT filters (g, h):

    W_j[t] = sum_m h[m] V_{j-1}[(t - m*gap) mod N]
    V_j[t] = sum_m g[m] V_{j-1}[(t - m*gap) mod N],      V_0 = x
    V_{j-1}[t] = sum_m g[m] V_j[(t + m*gap) mod N] + h[m] W_j[(t + m*gap) mod N]

(Percival and Walden, "Wavelet Methods for Time Series Analysis", 2000,
sections 5.4-5.5). Plain torch on any device, in float64. ``prec`` rounds
each level's operands (the signal and the filters) and its results, for a
lower-precision copy (:mod:`.precision`); by default nothing is rounded.
"""
from __future__ import annotations

import torch

from .precision import FLOAT64


def _taps(f, like, prec):
    return prec.operand(torch.tensor(f, dtype=torch.float64, device=like.device))


def modwt(x: torch.Tensor, g, h, level: int, prec=FLOAT64) -> torch.Tensor:
    """(B, N) -> (B, level+1, N) rows [W_1 .. W_J, V_J], float64."""
    v = x.to(torch.float64)
    gt, ht = _taps(g, v, prec), _taps(h, v, prec)
    rows = []
    for j in range(1, level + 1):
        gap = 1 << (j - 1)
        src = prec.operand(v)
        w = torch.zeros_like(v)
        vn = torch.zeros_like(v)
        for m in range(len(g)):
            r = torch.roll(src, m * gap, dims=-1)  # r[t] = v[(t - m*gap) mod N]
            w += ht[m] * r
            vn += gt[m] * r
        rows.append(prec.result(w))
        v = prec.result(vn)
    rows.append(v)
    return torch.stack(rows, dim=-2)


def imodwt(c: torch.Tensor, g, h, prec=FLOAT64) -> torch.Tensor:
    """(B, J+1, N) -> (B, N), float64."""
    c = c.to(torch.float64)
    level = c.shape[-2] - 1
    gt, ht = _taps(g, c, prec), _taps(h, c, prec)
    v = c[..., level, :]
    for j in range(level, 0, -1):
        gap = 1 << (j - 1)
        vs, ws = prec.operand(v), prec.operand(c[..., j - 1, :])
        acc = torch.zeros_like(vs)
        for m in range(len(g)):
            acc += gt[m] * torch.roll(vs, -m * gap, dims=-1)  # v[(t + m*gap) mod N]
            acc += ht[m] * torch.roll(ws, -m * gap, dims=-1)
        v = prec.result(acc)
    return v
