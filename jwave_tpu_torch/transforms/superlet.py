"""Adaptive superlet transform (Moca, Barzan, Nagy & Muresan, Nature
Communications 2021).

The superlet takes the geometric mean of Morlet responses across a ladder
of cycle counts at each frequency, keeping the sharpest localization of
every member. Each order's response is the port's FFT-path :func:`cwt`
(cuFFT and one batched product on a card); per-order magnitudes are
peak-normalized (a matched unit tone reads 1/2 at every order), and the
adaptive per-frequency order is a log-domain weighted mean.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..cwavelets import MorletWavelet
from ..exceptions import JWaveFailure
from ..utils.host import host_array
from .cwt import PaddingType, cwt

K_SD = 5.0  # cycles-per-stddev convention of the superlet paper


def superlet(
    signal,
    freqs,
    sampling_rate: float = 1.0,
    base_cycles: float = 3.0,
    order_min: int = 1,
    order_max: int = 16,
    multiplicative: bool = True,
    padding: PaddingType = PaddingType.SYMMETRIC,
):
    """Adaptive superlet spectrum of (..., N) real signals.

    ``freqs`` (F,) are strictly positive analysis frequencies in Hz; the
    order ramps linearly from ``order_min`` at ``min(freqs)`` to
    ``order_max`` at ``max(freqs)``; the order-i member has ``i *
    base_cycles`` cycles (``multiplicative``) or ``base_cycles + i - 1``.
    Returns the (..., F, N) nonnegative superlet magnitude plane.
    """
    freqs_np = np.atleast_1d(host_array(freqs, np.float64))
    if freqs_np.ndim != 1 or freqs_np.size == 0:
        raise JWaveFailure("superlet - freqs must be a non-empty 1D grid")
    if np.any(freqs_np <= 0):
        raise JWaveFailure("superlet - frequencies must be positive")
    if order_min < 1 or order_max < order_min:
        raise JWaveFailure("superlet - need 1 <= order_min <= order_max")
    if base_cycles <= 0:
        raise JWaveFailure("superlet - base_cycles must be positive")

    f_lo, f_hi = float(freqs_np.min()), float(freqs_np.max())
    span = max(f_hi - f_lo, 1e-30)
    orders = np.rint(order_min + (order_max - order_min)
                     * (freqs_np - f_lo) / span).astype(np.int64)

    scales = 1.0 / freqs_np  # Morlet fc = 1: scale a analyzes f = 1/a
    eps = 1e-20
    n_f = freqs_np.shape[0]
    log_acc = None
    for i in range(1, order_max + 1):
        # only the frequencies whose adaptive order reaches i
        idx = np.nonzero(orders >= i)[0]
        if idx.size == 0:
            continue
        cycles = base_cycles * i if multiplicative else base_cycles + i - 1
        # cycles c at frequency f: sigma_t = c / (K_SD f) = a sqrt(fb)
        fb = (cycles / K_SD) ** 2
        w = cwt(signal, scales[idx], MorletWavelet(fb, 1.0), sampling_rate, padding).coefficients
        # divide out sqrt(a) * sqrt(2 pi fb): a matched unit tone reads 1/2
        gain = np.sqrt(scales[idx]) * math.sqrt(2.0 * math.pi * fb)
        mag = torch.abs(w) / torch.as_tensor(gain[:, None], dtype=w.real.dtype, device=w.device)
        if log_acc is None:
            log_acc = mag.new_zeros(mag.shape[:-2] + (n_f, mag.shape[-1]))
        log_acc = log_acc.index_add(-2, torch.as_tensor(idx, device=mag.device),
                                    torch.log(mag + eps))
    inv = torch.as_tensor(1.0 / np.maximum(orders, 1)[:, None], dtype=log_acc.dtype,
                          device=log_acc.device)
    return torch.exp(log_acc * inv)
