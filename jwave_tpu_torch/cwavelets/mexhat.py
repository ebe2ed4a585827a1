"""Mexican Hat (Ricker) wavelet.

Reference: jwave/transforms/wavelets/continuous/MexicanHatWavelet.java:56-157.
"""
from __future__ import annotations

import math

import torch

from .base import ContinuousWavelet, real_tensor, to_complex


class MexicanHatWavelet(ContinuousWavelet):
    """psi(t) = norm * (1-(t/s)^2) * exp(-t^2/(2 s^2)),
    norm = 2/(sqrt(3 s)*pi^(1/4))."""

    def __init__(self, sigma: float = 1.0):
        if sigma <= 0:
            raise ValueError("MexicanHat sigma must be positive")
        self.sigma = float(sigma)
        self.norm = 2.0 / (math.sqrt(3.0 * sigma) * math.pi**0.25)
        self.name = "Mexican Hat"
        self.center_frequency = 1.0 / (2.0 * math.pi * sigma)

    def psi(self, t):
        x = real_tensor(t) / self.sigma
        val = self.norm * (1.0 - x * x) * torch.exp(-0.5 * x * x)
        return to_complex(val)

    def psi_hat(self, omega):
        """norm * sigma * sqrt(2*pi) * w^2 * exp(-s^2 w^2/2)
        (MexicanHatWavelet.java:109-119)."""
        omega = real_tensor(omega)
        ft_norm = self.norm * self.sigma * math.sqrt(2.0 * math.pi)
        w2 = omega * omega
        val = ft_norm * w2 * torch.exp(-0.5 * self.sigma**2 * w2)
        return to_complex(val)

    def admissibility_constant(self) -> float:
        return math.pi

    def effective_support(self):
        r = 5.0 * self.sigma
        return (-r, r)

    def bandwidth(self):
        return (0.0, 3.0 / (2.0 * math.pi * self.sigma))
