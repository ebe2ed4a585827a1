"""Wigner-Ville distribution and its smoothed-pseudo variant.

The WVD is the highest-resolution quadratic time-frequency distribution, at
the price of cross-terms between components; the smoothed-pseudo WVD applies
separable time and lag windows that suppress them. The instantaneous
autocorrelation ``K[t, m] = z[t + m] conj(z)[t - m]`` of the analytic signal
is Hermitian in the lag, so only its ``m >= 0`` half is built, as
shifted-slice products of one zero-padded copy; the lag-to-frequency step
is the circular-buffer FFT (the JAX package's form off its TPU, where its
Hermitian two-matmul form is an MXU formulation and is not ported).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..exceptions import JWaveFailure
from ..utils.numerics import next_power_of_two
from .analytic import analytic_signal, real_signal


def wigner_ville(
    signal,
    sampling_rate: float = 1.0,
    n_bins: int | None = None,
    time_window: int | None = None,
    lag_window: int | None = None,
):
    """(Smoothed-pseudo) Wigner-Ville distribution of (..., N) real input.

    ``n_bins`` frequency rows (default the next power of two of N, at most
    1024; the lag support is +- (n_bins // 2 - 1)); ``time_window`` odd width
    of a Gaussian time-smoothing window (None: none, the pseudo-WVD);
    ``lag_window`` odd width of a Gaussian lag window (None: a full-lag
    Hann taper). Returns ``(tfr, freqs)``: the real (..., n_bins, N)
    distribution and the (n_bins,) grid in Hz over [0, fs/2).
    """
    x = real_signal(signal, "wigner_ville")
    n = x.shape[-1]
    if n < 8:
        raise JWaveFailure("wigner_ville - need at least 8 samples")
    if n_bins is None:
        n_bins = min(next_power_of_two(n), 1024)
    if n_bins < 8:
        raise JWaveFailure("wigner_ville - n_bins must be >= 8")
    m = n_bins // 2 - 1  # max lag each side
    for w, name in ((time_window, "time_window"), (lag_window, "lag_window")):
        if w is not None and (w < 1 or w % 2 == 0):
            raise JWaveFailure(f"wigner_ville - {name} must be a positive odd int")

    z = analytic_signal(x)
    # K[t, tau] = z[t + tau] conj(z[t - tau]) for tau = 0..m, zero outside
    zp = F.pad(z, (m, m))
    zc = torch.conj_physical(zp)  # once, not a lazy conjugate resolved per lag
    K = torch.stack([zp[..., m + t : m + t + n] * zc[..., m - t : m - t + n]
                     for t in range(m + 1)], dim=-1)  # (..., N, m+1)

    tau = np.arange(0, m + 1)
    if lag_window is None:
        lw = np.hanning(2 * m + 3)[1:-1][m:]
    else:
        half = min(lag_window // 2, m)
        lw = np.exp(-0.5 * (tau / max(half / 2.0, 1.0)) ** 2)
    K = K * torch.as_tensor(lw, dtype=K.dtype, device=K.device)

    if time_window is not None:
        ht = time_window // 2
        g = np.exp(-0.5 * (np.arange(-ht, ht + 1) / max(ht / 2.0, 1.0)) ** 2)
        g = g / g.sum()
        Kp = F.pad(K, (0, 0, ht, ht))
        K = sum(Kp[..., i : i + n, :] * float(g[i]) for i in range(2 * ht + 1))

    # lag -> frequency: the Hermitian lag sequence in a circular buffer of
    # n_bins; its spectrum is real
    buf = torch.cat([K, K.new_zeros(K.shape[:-1] + (n_bins - 2 * m - 1,)),
                     torch.conj(torch.flip(K[..., 1:], dims=(-1,)))], dim=-1)
    tfr = torch.fft.fft(buf, dim=-1).real.transpose(-1, -2)  # (..., n_bins, N)
    freqs = np.arange(n_bins) * (sampling_rate / (2.0 * n_bins))
    return tfr, torch.as_tensor(freqs, device=x.device)
