"""Empirical wavelet transform (Gilles 2013).

A data-adaptive filter bank: detect the signal's dominant spectral lobes,
place Meyer-type bandpass wavelets between them and extract one narrowband
mode per lobe. Boundary detection is data-dependent peak picking and runs
on the host in numpy (:func:`ewt_boundaries`), as in the JAX package; the
transform is one batched FFT product against the (K, N) Meyer bank. The
bank is a tight frame (the squared responses sum to 1), so the inverse is
the adjoint: ``x = sum_k ifft(fft(mode_k) * filt_k)``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..exceptions import JWaveFailure
from ..ops.butterfly import ensure_fft_float
from ..utils.host import host_array
from .analytic import real_signal


def _beta(x):
    """Meyer transition polynomial on [0, 1] (C^3 at both ends)."""
    return x**4 * (35.0 - 84.0 * x + 70.0 * x**2 - 20.0 * x**3)


def ewt_boundaries(signal, n_modes: int, min_separation: int | None = None) -> np.ndarray:
    """Spectral segment boundaries (host side): the midpoints between the
    ``n_modes`` largest, at least ``min_separation`` bins apart, maxima of
    the magnitude spectrum pooled over batch rows; ``n_modes - 1``
    boundaries in (0, pi) rad/sample."""
    x = host_array(signal)
    n = x.shape[-1]
    if n_modes < 1:
        raise JWaveFailure("ewt_boundaries - n_modes must be >= 1")
    if n_modes == 1:
        return np.empty(0)
    half = n // 2
    # pool the magnitude spectra across batch rows (a time-domain mean would
    # cancel phase-incoherent components)
    spec = np.abs(np.fft.rfft(x.reshape(-1, n), axis=-1)).sum(axis=0)
    mag = spec[1 : half + 1]  # bins 1..half
    if min_separation is None:
        min_separation = max(2, half // (8 * n_modes))
    # greedy peak picking with an exclusion radius
    order = np.argsort(mag)[::-1]
    picks: list[int] = []
    for i in order:
        if len(picks) >= n_modes:
            break
        if all(abs(i - p) >= min_separation for p in picks):
            picks.append(int(i))
    if len(picks) < n_modes:
        raise JWaveFailure(
            f"ewt_boundaries - spectrum supports only {len(picks)} separated "
            f"peaks (asked for {n_modes} modes); lower n_modes or min_separation"
        )
    picks = np.sort(np.asarray(picks))
    mids = 0.5 * (picks[:-1] + picks[1:] + 2)  # midpoints, 1-based bins
    return mids * np.pi / half


def ewt_filter_bank(n: int, boundaries) -> np.ndarray:
    """(K, N) tight Meyer bank on an N-point FFT grid from K-1 boundaries in
    (0, pi): one scaling lowpass and K-1 band wavelets (the last reaches
    Nyquist). float64 numpy."""
    b = np.sort(np.atleast_1d(host_array(boundaries, np.float64)))
    if b.size and (b[0] <= 0 or b[-1] >= np.pi):
        raise JWaveFailure("ewt_filter_bank - boundaries must lie in (0, pi)")
    if np.any(np.diff(b) <= 0):
        raise JWaveFailure("ewt_filter_bank - boundaries must be strictly increasing")
    i = np.arange(n)
    omega = 2.0 * np.pi * i / n
    omega = np.where(omega > np.pi, 2.0 * np.pi - omega, omega)  # |folded|
    if b.size == 0:
        return np.ones((1, n))
    # gamma below the tightness bound min (w_{n+1}-w_n)/(w_{n+1}+w_n)
    edges = np.concatenate([b, [np.pi]])
    prev = np.concatenate([[0.0], b])
    ratios = (edges - prev) / (edges + prev + 1e-300)
    gamma = 0.45 * float(ratios[ratios > 0].min())

    def fall(w, wn):
        """1 -> 0 transition across [(1-g) wn, (1+g) wn]."""
        t = np.clip((w - (1.0 - gamma) * wn) / (2.0 * gamma * wn), 0.0, 1.0)
        return np.cos(0.5 * np.pi * _beta(t))

    def rise(w, wn):
        t = np.clip((w - (1.0 - gamma) * wn) / (2.0 * gamma * wn), 0.0, 1.0)
        return np.sin(0.5 * np.pi * _beta(t))

    filters = [fall(omega, b[0])]  # scaling function
    for k in range(b.size):
        down = fall(omega, b[k + 1]) if k + 1 < b.size else np.ones(n)  # last band to Nyquist
        filters.append(rise(omega, b[k]) * down)
    return np.stack(filters)


@dataclass
class EWTResult:
    """Empirical wavelet modes: ``modes`` (..., K, N) real narrowband
    components; ``boundaries`` the (K-1,) spectral boundaries (rad/sample)
    that defined the bank, sorted float64."""

    modes: torch.Tensor
    boundaries: np.ndarray

    def __post_init__(self):
        self.boundaries = np.sort(np.atleast_1d(host_array(self.boundaries, np.float64)))

    @property
    def n_modes(self) -> int:
        return self.modes.shape[-2]


def _bank(n: int, boundaries, like: torch.Tensor) -> torch.Tensor:
    cdtype = torch.complex128 if like.dtype == torch.float64 else torch.complex64
    return torch.as_tensor(ewt_filter_bank(n, boundaries), dtype=cdtype, device=like.device)


def ewt(signal, n_modes: int | None = None, boundaries=None) -> EWTResult:
    """Empirical wavelet transform of (..., N) real signals, with boundaries
    detected from the pooled spectrum (``n_modes``) or given explicitly in
    (0, pi) rad/sample. Invert with :func:`iewt` (exact: the bank is tight).
    """
    x = real_signal(signal, "ewt")
    n = x.shape[-1]
    if n < 8:
        raise JWaveFailure("ewt - need at least 8 samples")
    xf = ensure_fft_float(x)  # half precision computes in float32 and is cast back
    if boundaries is None:
        if n_modes is None:
            raise JWaveFailure("ewt - pass n_modes or explicit boundaries")
        boundaries = ewt_boundaries(xf, n_modes)
    spec = torch.fft.fft(xf, dim=-1)
    modes = torch.fft.ifft(spec[..., None, :] * _bank(n, boundaries, xf), dim=-1).real.to(x.dtype)
    return EWTResult(modes, boundaries)


def iewt(result: EWTResult) -> torch.Tensor:
    """Adjoint reconstruction ``sum_k ifft(fft(mode_k) * filt_k)``."""
    modes = result.modes
    n = modes.shape[-1]
    mf = ensure_fft_float(modes)
    spec = torch.fft.fft(mf, dim=-1)
    return torch.sum(torch.fft.ifft(spec * _bank(n, result.boundaries, mf), dim=-1).real,
                     dim=-2).to(modes.dtype)
