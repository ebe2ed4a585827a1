"""Paul wavelet (analytic).

Reference: jwave/transforms/wavelets/continuous/PaulWavelet.java:80-191.
"""
from __future__ import annotations

import math

import torch

from .base import ContinuousWavelet, real_tensor, to_complex


def _factorial(n: int) -> float:
    r = 1.0
    for i in range(2, n + 1):
        r *= i
    return r


class PaulWavelet(ContinuousWavelet):
    """psi(t) = norm * i^m * (1-it)^(-(m+1)),
    norm = 2^m m! / sqrt(pi (2m)!)."""

    def __init__(self, m: int = 4):
        if m < 1:
            raise ValueError("Paul order m must be >= 1")
        self.m = int(m)
        self.norm = (2.0**m) * _factorial(m) / math.sqrt(math.pi * _factorial(2 * m))
        self.i_pow_m = 1j**m
        self.name = f"Paul (m={m})"
        self.center_frequency = (m + 0.5) / (2.0 * math.pi)
        self.is_analytic = True  # psi_hat is exactly zero for w <= 0

    def psi(self, t):
        base = 1.0 - 1j * real_tensor(t)
        return self.norm * self.i_pow_m * base ** (-(self.m + 1))

    def psi_hat(self, omega):
        """sqrt(2*pi) * w^m * exp(-w) * H(w): zero for w <= 0
        (PaulWavelet.java:128-140)."""
        omega = real_tensor(omega)
        pos = omega > 0
        w = torch.where(pos, omega, 1.0)  # no 0^m or exp overflow on the dead branch
        val = math.sqrt(2.0 * math.pi) * w**self.m * torch.exp(-w)
        return to_complex(torch.where(pos, val, 0.0))

    def admissibility_constant(self) -> float:
        return 2.0 * math.pi / (2 * self.m + 1)

    def effective_support(self):
        return (-1.0, 2.0 * (self.m + 1))

    def bandwidth(self):
        """Peak at w=m, significant to w=2m+2 (PaulWavelet.java:200-206)."""
        return (0.0, (2 * self.m + 2) / (2.0 * math.pi))
