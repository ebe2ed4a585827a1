"""DOG (Derivative of Gaussian) wavelet family.

Reference: jwave/transforms/wavelets/continuous/DOGWavelet.java:97-262.
n=2 is the Mexican Hat (up to normalization convention).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import ContinuousWavelet, real_tensor, to_complex


def _hermite_coeffs(n: int) -> np.ndarray:
    """Physicists' Hermite polynomial coefficients via the recurrence
    H_k = 2x H_{k-1} - 2(k-1) H_{k-2} (DOGWavelet.java:289-330)."""
    coeffs = [np.array([1.0])]
    if n > 0:
        coeffs.append(np.array([0.0, 2.0]))
    for k in range(2, n + 1):
        c = np.zeros(k + 1)
        c[1:] += 2.0 * coeffs[k - 1]
        c[: k - 1] -= 2.0 * (k - 1) * coeffs[k - 2]
        coeffs.append(c)
    return coeffs[n]


def _double_factorial(n: int) -> float:
    r = 1.0
    i = n
    while i > 0:
        r *= i
        i -= 2
    return r


class DOGWavelet(ContinuousWavelet):
    """psi(t) = norm * H_n(t/sigma) * exp(-t^2/(2 sigma^2))."""

    BASE_SUPPORT_FACTOR = 3.0

    def __init__(self, n: int = 2, sigma: float = 1.0):
        if n < 1:
            raise ValueError("DOG derivative order n must be a positive integer")
        if n > 10:
            raise ValueError("DOG derivative order n > 10 may cause numerical issues")
        if sigma <= 0:
            raise ValueError("DOG sigma must be positive")
        self.n = int(n)
        self.sigma = float(sigma)
        self.hermite = _hermite_coeffs(n)
        # sqrt((2n-1)!! / (2^n sqrt(pi) sigma^(2n+1))) (DOGWavelet.java:357-368)
        self.norm = math.sqrt(
            _double_factorial(2 * n - 1) / (2.0**n * math.sqrt(math.pi) * sigma ** (2 * n + 1))
        )
        self.name = f"DOG (n={n})"
        self.center_frequency = math.sqrt(n) / (2.0 * math.pi * sigma)

    def _hermite_eval(self, x):
        res = torch.zeros_like(x)
        for c in self.hermite[::-1]:
            res = res * x + float(c)
        return res

    def psi(self, t):
        x = real_tensor(t) / self.sigma
        val = self.norm * self._hermite_eval(x) * torch.exp(-0.5 * x * x)
        return to_complex(val)

    def psi_hat(self, omega):
        """i^n * norm * sqrt(2*pi) * sigma^(n+1) * |w|^n * exp(-s^2 w^2 / 2),
        with sign(w) applied on odd n (DOGWavelet.java:187-216)."""
        omega = real_tensor(omega)
        mag = (
            self.norm
            * math.sqrt(2.0 * math.pi)
            * self.sigma ** (self.n + 1)
            * torch.abs(omega) ** self.n
            * torch.exp(-0.5 * self.sigma**2 * omega * omega)
        )
        n_mod_4 = self.n % 4
        if n_mod_4 == 0:
            return to_complex(mag)
        if n_mod_4 == 1:
            return 1j * mag * torch.sign(omega)
        if n_mod_4 == 2:
            return to_complex(-mag)
        return -1j * mag * torch.sign(omega)

    def admissibility_constant(self) -> float:
        return 2.0 * math.pi

    def effective_support(self):
        r = (self.BASE_SUPPORT_FACTOR + self.n / 2.0) * self.sigma
        return (-r, r)

    def bandwidth(self):
        return (0.0, (1.0 + self.n / 2.0) / (2.0 * math.pi * self.sigma))

    @property
    def is_mexican_hat(self) -> bool:
        return self.n == 2
