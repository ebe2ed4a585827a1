"""The shared FWT butterfly as batched torch convolutions.

Semantics (reference Wavelet.java:236-260, analysis):

    approx[i] = sum_j x[(2i+j) mod h] * dec_lo[j]      i in [0, h/2)
    detail[i] = sum_j x[(2i+j) mod h] * dec_hi[j]
    out = [approx | detail]                            (length h)

and the adjoint (Wavelet.java:277-303, synthesis):

    y[(2i+j) mod h] += approx[i]*rec_lo[j] + detail[i]*rec_hi[j]

The analysis step is a stride-2 cross-correlation (``conv1d`` correlates) of
the circularly extended signal with a 2-output-channel filter stack; the
synthesis step correlates the zero-upsampled channels with the flipped
synthesis filters. A filter longer than the block wraps more than once, so
the extension tiles the block as often as needed.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def as_tensor(x, device=None) -> torch.Tensor:
    """A tensor stays where it lies; anything else becomes a tensor on
    ``device``, the card ("cuda") unless one is given. A caller asks for the
    CPU with a CPU tensor or ``device="cpu"``."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=device or "cuda")


def ensure_float(x: torch.Tensor) -> torch.Tensor:
    """Promote integer/bool inputs to torch's default float dtype (the filter
    constants would truncate to zero under integer arithmetic)."""
    if not (x.is_floating_point() or x.is_complex()):
        return x.to(torch.get_default_dtype())
    return x


def taps(f, like: torch.Tensor) -> torch.Tensor:
    """Host filter taps as a tensor of ``like``'s dtype on its device."""
    return torch.as_tensor(np.ascontiguousarray(f, dtype=np.float64), dtype=like.dtype,
                           device=like.device)


def _tile_to(x: torch.Tensor, length: int) -> torch.Tensor:
    """Circularly tile (..., h) along the last axis to ``length`` samples."""
    h = x.shape[-1]
    if length <= h:
        return x[..., :length]
    reps = -(-length // h)
    return torch.cat([x] * reps, dim=-1)[..., :length]


def butterfly_forward(x: torch.Tensor, dec_lo: np.ndarray, dec_hi: np.ndarray) -> torch.Tensor:
    """One analysis butterfly on the full last axis (length h, even):
    (..., h) -> (..., h) laid out as [approx | detail]."""
    x = ensure_float(x)
    h = x.shape[-1]
    m = int(dec_lo.shape[0])
    half = h // 2
    # largest index read: 2*(half-1) + (m-1) = h + m - 3 -> h + m - 2 samples
    ext = _tile_to(x, h + max(m - 2, 0))
    flat = ext.reshape(-1, 1, ext.shape[-1])
    w = taps(np.stack([dec_lo, dec_hi])[:, None, :], x)  # (2, 1, M)
    out = F.conv1d(flat, w, stride=2)[:, :, :half]
    merged = torch.cat([out[:, 0], out[:, 1]], dim=-1)
    return merged.reshape(x.shape[:-1] + (h,))


def butterfly_reverse(y: torch.Tensor, rec_lo: np.ndarray, rec_hi: np.ndarray,
                      recon_gain: float = 1.0) -> torch.Tensor:
    """One synthesis butterfly on the full last axis (length h, even), the
    adjoint of :func:`butterfly_forward` scaled by ``recon_gain``."""
    y = ensure_float(y)
    h = y.shape[-1]
    m = int(rec_lo.shape[0])
    half = h // 2
    z = torch.zeros_like(y[..., :half])
    # zero-upsample: u[2i] = a[i], u[2i+1] = 0, per channel
    ua = torch.stack([y[..., :half], z], dim=-1).reshape(y.shape[:-1] + (h,))
    ud = torch.stack([y[..., half:], z], dim=-1).reshape(y.shape[:-1] + (h,))
    u = torch.stack([ua, ud], dim=-2)  # (..., 2, h)
    # circular left-extension by M-1 so a VALID correlation gives index (k - j) mod h
    pad = m - 1
    reps = -(-pad // h)
    full = torch.cat([u] * (reps + 1), dim=-1)
    ext = full[..., reps * h - pad: reps * h + h]
    flat = ext.reshape(-1, 2, h + pad)
    w = taps(np.stack([rec_lo[::-1], rec_hi[::-1]])[None, :, :], y)  # (1, 2, M)
    res = F.conv1d(flat, w)[:, 0, :h].reshape(y.shape[:-1] + (h,))
    if recon_gain != 1.0:
        res = res * recon_gain
    return res


def synthesis_levels(y: torch.Tensor, rec_lo: np.ndarray, rec_hi: np.ndarray, levels: int,
                     recon_gain: float = 1.0) -> torch.Tensor:
    """``levels`` synthesis butterflies on the shrinking heads of the last
    axis, from the smallest (N >> (levels-1)) up: the inverse FWT with the
    synthesis filters, and with the analysis filters and gain 1 the
    transpose of the analysis pyramid."""
    n = y.shape[-1]
    if levels == 0:
        return y
    h = n >> (levels - 1)
    while h <= n:
        head = butterfly_reverse(y[..., :h], rec_lo, rec_hi, recon_gain)
        y = torch.cat([head, y[..., h:]], dim=-1) if h < n else head
        h <<= 1
    return y
