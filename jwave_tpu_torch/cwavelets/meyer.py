"""Meyer wavelet (frequency-domain compact support).

Reference: jwave/transforms/wavelets/continuous/MeyerWavelet.java:162-331:
the Fourier form is exact (sin/cos branches over [2*pi/3, 8*pi/3] with the
C-infinity transition polynomial and exp(i w/2) phase); the time form is the
reference's truncated sinc-series approximation.
"""
from __future__ import annotations

import math

import torch

from .base import ContinuousWavelet, real_tensor, to_complex

_TIME_DECAY = 25.0
_H1_AMP, _H1_MULT = 0.2, 1.4
_H2_AMP, _H2_MULT = -0.1, 0.5
_TIME_CENTER_FREQ = 0.7
_SUPPORT_RADIUS = 15.0
_W_LO = 2.0 * math.pi / 3.0
_W_MID = 4.0 * math.pi / 3.0
_W_HI = 8.0 * math.pi / 3.0


def _nu(x):
    """C-inf transition x^4*(35 - 84x + 70x^2 - 20x^3), clamped to [0,1]
    (MeyerWavelet.java:276-291)."""
    xc = torch.clamp(x, 0.0, 1.0)
    return xc**4 * (35.0 + xc * (-84.0 + xc * (70.0 - 20.0 * xc)))


def _sinc(x):
    return torch.sinc(x / math.pi)  # torch.sinc is normalized; the reference uses sin(x)/x


class MeyerWavelet(ContinuousWavelet):
    def __init__(self):
        self.name = "Meyer"
        self.center_frequency = 0.7 / (2.0 * math.pi)

    def psi(self, t):
        """Truncated sinc-series time-domain approximation
        (MeyerWavelet.java:176-215)."""
        t = real_tensor(t)
        envelope = torch.exp(-0.5 * t * t / _TIME_DECAY)
        w0 = _TIME_CENTER_FREQ
        val = w0 * _sinc(w0 * t) * envelope
        w1 = _H1_MULT * w0
        val = val + _H1_AMP * w1 * _sinc(w1 * t) * envelope
        w2 = _H2_MULT * w0
        val = val + _H2_AMP * w2 * _sinc(w2 * t) * envelope
        val = val * math.sqrt(2.0 / math.pi)
        val = torch.where(torch.abs(t) > _SUPPORT_RADIUS, 0.0, val)
        return to_complex(val)

    def psi_hat(self, omega):
        """Exact Meyer spectrum with exp(i w/2) phase
        (MeyerWavelet.java:222-253)."""
        omega = real_tensor(omega)
        aw = torch.abs(omega)
        sin_branch = torch.sin(0.5 * math.pi * _nu(3.0 * aw / (2.0 * math.pi) - 1.0))
        cos_branch = torch.cos(0.5 * math.pi * _nu(3.0 * aw / (4.0 * math.pi) - 1.0))
        val = torch.where(
            (aw >= _W_LO) & (aw <= _W_MID),
            sin_branch,
            torch.where((aw > _W_MID) & (aw <= _W_HI), cos_branch, 0.0),
        )
        val = val * math.sqrt(2.0 * math.pi)
        phase = omega / 2.0
        return val * (torch.cos(phase) + 1j * torch.sin(phase))

    def admissibility_constant(self) -> float:
        return 2.0 * math.pi

    def effective_support(self):
        return (-_SUPPORT_RADIUS, _SUPPORT_RADIUS)

    def bandwidth(self):
        return (2.0 / 3.0 / (2.0 * math.pi), 8.0 / 3.0 / (2.0 * math.pi))
