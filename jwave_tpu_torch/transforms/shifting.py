"""Shifting Wavelet Transform: single-level butterflies over growing blocks.

Reference: jwave/transforms/ShiftingWaveletTransform.java:43-139, as
``jwave_tpu.transforms.shifting`` implements it: forward applies the
butterfly to adjacent blocks of size div = 2, 4, 8, ... across the array
(floor(N/div) full blocks per pass; an odd trailing element passes through
untouched). Each pass is one batched butterfly over the reshaped full-block
prefix.
"""
from __future__ import annotations

import torch

from ..filters import get_filter
from ..ops.butterfly import butterfly_forward, butterfly_reverse
from ..utils.host import as_tensor


def _pass(x: torch.Tensor, div: int, fn) -> torch.Tensor:
    """``fn`` over the floor(N/div) full blocks of size ``div``; the rest (an
    odd trailing element among it) passes through."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    span = (n // div) * div
    head = fn(x[..., :span].reshape(lead + (n // div, div))).reshape(lead + (span,))
    return torch.cat([head, x[..., span:]], dim=-1) if span < n else head


def shifting_forward(x, wavelet):
    """Forward SWT along the last axis (arbitrary length)."""
    fb = get_filter(wavelet)
    x = as_tensor(x)
    div = 2
    while div <= x.shape[-1]:
        x = _pass(x, div, lambda b: butterfly_forward(b, fb.dec_lo, fb.dec_hi))
        div *= 2
    return x


def shifting_reverse(y, wavelet):
    """Inverse SWT.

    Applies the synthesis butterfly for div = largest power of two <= N
    down to 2: the exact mirror of :func:`shifting_forward`, so the round
    trip holds for *any* length. (The reference's reverse,
    ShiftingWaveletTransform.java:92-139, instead starts at the largest
    even div and walks through odd block sizes, which corrupts data for
    non-power-of-two lengths; for power-of-two lengths the two agree.)
    """
    fb = get_filter(wavelet)
    y = as_tensor(y)
    div = 1
    while div * 2 <= y.shape[-1]:
        div *= 2
    while div >= 2:
        y = _pass(y, div, lambda b: butterfly_reverse(b, fb.rec_lo, fb.rec_hi, fb.recon_gain))
        div //= 2
    return y
