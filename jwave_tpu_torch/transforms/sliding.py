"""Incremental sliding-window MODWT: each new sample costs O(M*J) work.

Reference usage pattern: jwave/transforms/MODWTSlidingWindowTest.java:17-98
slides a 512-sample window by 64 samples and recomputes ``forwardMODWT`` per
window. The MODWT pyramid is a causal cascade

    W_j[t] = sum_m h[m] * V_{j-1}[t - m*2^(j-1)],    V_0 = x,
    V_j[t] = sum_m g[m] * V_{j-1}[t - m*2^(j-1)],

with (g, h) the rescaled base filters, so one new sample needs M
multiply-adds per level and filter. The state carries, per level j, the
trailing (M-1)*2^(j-1) samples of V_{j-1} (the filter's reach-back), plus
the current window's coefficient columns.

Streaming coefficients are the *linear* (causal) convolution over the true
past; they equal the circular per-window transform on the interior columns
t >= L_j - 1 (L_j = (M-1)(2^j - 1) + 1), where the circular index never
wraps. Each level's update is one dilated ``conv1d`` with the two filters
as output channels (the JAX package writes it as M shifted-slice FMAs).
Batched over leading axes; init and update are plain functions of a
:class:`SlidingState` of tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import config
from ..exceptions import JWaveFailure
from ..filters import get_filter
from ..ops.butterfly import ensure_float
from ..utils.host import as_tensor, copy_to_device
from .modwt import MAX_DECOMPOSITION_LEVEL, _modwt_base_filters, _validate_level


class SlidingState(NamedTuple):
    """State of a sliding MODWT analysis.

    ``hist``: tuple of J tensors, ``hist[j]`` the trailing ``(M-1) * 2^j``
    samples of the smooth ``V_j`` (``V_0 = x``) that level ``j+1``'s strided
    taps reach back over. ``coeffs``: (..., J+1, W) causal coefficient
    columns of the current window, rows [W_1 .. W_J, V_J]. ``window``:
    (..., W) the current raw-sample window.
    """

    hist: tuple
    coeffs: torch.Tensor
    window: torch.Tensor

    @classmethod
    def from_numpy(cls, hist, coeffs, window, device=None) -> "SlidingState":
        """A state from numpy arrays (e.g. a state of the JAX package, as
        ``np.asarray`` of its leaves, which may be read-only), copied into
        tensors on ``device`` ("cuda" by default)."""
        return cls(tuple(copy_to_device(h, device) for h in hist),
                   copy_to_device(coeffs, device), copy_to_device(window, device))


def _hist_len(m: int, j: int) -> int:
    """Reach-back of level j+1's strided taps into V_j."""
    return (m - 1) * (1 << j)


def sliding_modwt_init(x0, wavelet, level: int) -> SlidingState:
    """Start a sliding analysis from an initial window ``x0`` (..., W).

    The pre-window past is taken as zero, so the first L_j - 1 columns of
    each row are ramp-in values; every later column is the exact causal
    coefficient, equal to ``modwt(x0)`` there.
    """
    x0 = ensure_float(as_tensor(x0))
    w = x0.shape[-1]
    if w < 1:
        raise JWaveFailure("sliding_modwt_init - window must be non-empty")
    _validate_level(w, level, "sliding_modwt_init")
    m = get_filter(wavelet).length
    lead = x0.shape[:-1]
    empty = SlidingState(
        hist=tuple(x0.new_zeros(lead + (_hist_len(m, j),)) for j in range(level)),
        coeffs=x0.new_zeros(lead + (level + 1, w)),
        window=torch.zeros_like(x0),
    )
    return sliding_modwt_update(empty, x0, wavelet, level)


def _filter_pair(wavelet, like: torch.Tensor) -> torch.Tensor:
    """(2, 1, M) conv1d weight [h; g], reversed: conv1d correlates, and
    out[t] = sum_m f[m] ext[need + t - m*stride] = sum_m' f[M-1-m'] ext[t + m'*stride]."""
    g0, h0 = _modwt_base_filters(wavelet)
    w = np.stack([h0[::-1], g0[::-1]])[:, None, :]
    return torch.as_tensor(np.ascontiguousarray(w), dtype=like.dtype, device=like.device)


def sliding_modwt_update(state: SlidingState, samples, wavelet, level: int) -> SlidingState:
    """Advance the window by a chunk of new samples (..., S), S >= 1.

    The oldest S columns fall out and S new coefficient columns are computed
    causally in O(S * M * J) work, independent of the window length.
    """
    samples = ensure_float(as_tensor(samples, state.window.device))
    s = samples.shape[-1]
    wlen = state.window.shape[-1]
    if s < 1:
        return state
    lead = samples.shape[:-1]
    weight = _filter_pair(wavelet, samples)
    v = samples.reshape(-1, 1, s)
    new_hist = []
    rows = []
    for j in range(level):
        need = state.hist[j].shape[-1]
        ext = torch.cat([state.hist[j].reshape(-1, 1, need), v], dim=-1)  # (B, 1, need + S)
        with config.dial():
            wv = F.conv1d(ext, weight, dilation=1 << j)  # (B, 2, S): W_{j+1}, V_{j+1}
        rows.append(wv[:, 0])
        new_hist.append(ext[:, 0, ext.shape[-1] - need:].reshape(lead + (need,)))
        v = wv[:, 1:]
    rows.append(v[:, 0])
    cols = torch.stack(rows, dim=-2).reshape(lead + (level + 1, s))
    if s >= wlen:
        coeffs = cols[..., -wlen:]
        window = samples[..., -wlen:]
    else:
        coeffs = torch.cat([state.coeffs[..., s:], cols], dim=-1)
        window = torch.cat([state.window[..., s:], samples], dim=-1)
    return SlidingState(hist=tuple(new_hist), coeffs=coeffs, window=window)


class SlidingMODWT:
    """Convenience driver for incremental sliding-window MODWT analysis.

    >>> sl = SlidingMODWT("db4", level=8, window=512)
    >>> state = sl.init(signal[:512])
    >>> for t in range(512, len(signal), 64):
    ...     state = sl.update(state, signal[t : t + 64])
    ...     feats = state.coeffs        # (9, 512) current window coefficients

    Each ``update`` costs O(S*M*J) regardless of the window length.
    Tensors stay where they lie; numpy chunks join the state's device.
    """

    def __init__(self, wavelet, level: int, window: int):
        if level < 1 or level > MAX_DECOMPOSITION_LEVEL:
            raise JWaveFailure(
                f"SlidingMODWT - level must be in [1, {MAX_DECOMPOSITION_LEVEL}], got {level}"
            )
        self.wavelet = wavelet
        self.level = level
        self.window = window

    def init(self, x0) -> SlidingState:
        x0 = as_tensor(x0)
        if x0.shape[-1] != self.window:
            raise JWaveFailure(
                f"SlidingMODWT.init - expected window length {self.window}, "
                f"got {x0.shape[-1]}"
            )
        return sliding_modwt_init(x0, self.wavelet, self.level)

    def update(self, state: SlidingState, samples) -> SlidingState:
        return sliding_modwt_update(state, samples, self.wavelet, self.level)
