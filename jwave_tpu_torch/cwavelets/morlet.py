"""Complex Morlet (Gabor) wavelet.

Reference: jwave/transforms/wavelets/continuous/MorletWavelet.java:89-124.
"""
from __future__ import annotations

import math

import torch

from .base import ContinuousWavelet, real_tensor, to_complex


class MorletWavelet(ContinuousWavelet):
    """psi(t) = (2*pi*fb)^(-1/2) * exp(-t^2/(2 fb)) * exp(2*pi*i*fc*t)."""

    def __init__(self, fb: float = 1.0, fc: float = 1.0):
        if fb <= 0 or fc <= 0:
            raise ValueError("Morlet fb and fc must be positive")
        self.fb = float(fb)
        self.fc = float(fc)
        self.name = "Morlet"
        self.center_frequency = fc
        # psi_hat is a Gaussian centred at fc with a negative-frequency tail
        # of exp(-2 pi^2 fb fc^2); it counts as analytic only while that
        # tail is negligible (synchrosqueezing needs it)
        self.is_analytic = math.exp(-2.0 * math.pi**2 * fb * fc * fc) < 1e-3

    def psi(self, t):
        t = real_tensor(t)
        norm = 1.0 / math.sqrt(2.0 * math.pi * self.fb)
        envelope = torch.exp(-t * t / (2.0 * self.fb))
        phase = 2.0 * math.pi * self.fc * t
        return norm * envelope * (torch.cos(phase) + 1j * torch.sin(phase))

    def psi_hat(self, omega):
        """Real-valued: sqrt(2*pi*fb)*exp(-2*pi^2*fb*(f-fc)^2), f = w/(2*pi)
        (MorletWavelet.java:114-124); the sqrt(2*pi*fb) factor is the
        reference's."""
        omega = real_tensor(omega)
        f = omega / (2.0 * math.pi)
        norm = math.sqrt(2.0 * math.pi * self.fb)
        val = norm * torch.exp(-2.0 * math.pi**2 * self.fb * (f - self.fc) ** 2)
        return to_complex(val)

    def admissibility_constant(self) -> float:
        """~2*pi for fc > 0.8 (MorletWavelet.java:133-142)."""
        return 2.0 * math.pi * (1.1 if self.fc < 0.8 else 1.0)

    def effective_support(self):
        r = 4.0 * math.sqrt(self.fb)
        return (-r, r)

    def bandwidth(self):
        hw = 2.0 / math.sqrt(2.0 * math.pi * self.fb)
        return (self.fc - hw, self.fc + hw)
