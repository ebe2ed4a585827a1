"""Analytic-signal utilities (discrete Hilbert transform via FFT): the
one-sided-spectrum analytic signal, its envelope and the phase-derivative
instantaneous frequency. One batched FFT round trip each (cuFFT on a card,
any N); differentiable.
"""
from __future__ import annotations

import numpy as np
import torch

from ..exceptions import JWaveFailure
from ..ops.butterfly import ensure_fft_float, ensure_float
from ..utils.host import as_tensor


def real_signal(x, who: str) -> torch.Tensor:
    """A real floating tensor: complex input raises, integers are promoted
    (the JAX package's rule for the time-frequency layer)."""
    x = as_tensor(x)
    if x.is_complex():
        raise JWaveFailure(f"{who} - expected a real signal")
    return ensure_float(x)


def analytic_signal(x):
    """One-sided-spectrum analytic signal of (..., N) real input.

    ``z = x + i H{x}``: the positive-frequency bins doubled, the negative
    ones zeroed (DC and Nyquist kept single). ``z.real`` equals the input.
    """
    x = as_tensor(x)
    if x.is_complex():
        raise JWaveFailure("analytic_signal - input must be real")
    x = ensure_fft_float(x)
    n = x.shape[-1]
    if n < 2:
        raise JWaveFailure("analytic_signal - need at least 2 samples")
    spec = torch.fft.fft(x, dim=-1)
    gain = np.zeros(n)
    gain[0] = 1.0
    if n % 2 == 0:
        gain[1 : n // 2] = 2.0
        gain[n // 2] = 1.0
    else:
        gain[1 : (n + 1) // 2] = 2.0
    return torch.fft.ifft(spec * torch.as_tensor(gain, dtype=x.dtype, device=x.device), dim=-1)


def envelope(x):
    """Instantaneous amplitude |x + i H{x}| of (..., N) real input."""
    return torch.abs(analytic_signal(x))


def instantaneous_frequency(x, sampling_rate: float = 1.0):
    """Phase-derivative instantaneous frequency (Hz) of (..., N) real input:
    central differences of the analytic phase as
    ``angle(z[k+1] * conj(z[k-1])) / 2`` (no unwrapping needed below
    Nyquist/2), one-sided at the ends. Returns (..., N)."""
    z = analytic_signal(x)
    fwd = torch.angle(z[..., 1:] * torch.conj(z[..., :-1]))  # per-step advance
    mid = 0.5 * (fwd[..., 1:] + fwd[..., :-1])
    dphi = torch.cat([fwd[..., :1], mid, fwd[..., -1:]], dim=-1)
    return dphi * (sampling_rate / (2.0 * np.pi))
