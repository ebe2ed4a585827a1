"""Generalized Morse wavelets (Olhede & Walden 2002; Lilly & Olhede 2009).

Frequency domain (closed form):

    psi_hat(w) = H(w) * a_{beta,gamma} * w^beta * exp(-w^gamma),
    a = 2 (e gamma / beta)^(beta/gamma)   (peak value psi_hat(w_p) = 2),
    w_p = (beta / gamma)^(1/gamma)        (peak angular frequency).

The time-domain waveform has no closed form; :meth:`psi` synthesizes it by
direct numerical Fourier inversion over a fixed quadrature grid built on the
host in numpy. gamma=1 is the Paul family, gamma=3 with beta=20 (the
default, following jLab/MATLAB) has zero frequency-domain skewness.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import ContinuousWavelet, real_tensor, to_complex


class MorseWavelet(ContinuousWavelet):
    """Generalized Morse wavelet psi_{beta,gamma} (analytic)."""

    def __init__(self, beta: float = 20.0, gamma: float = 3.0):
        if beta <= 0 or gamma <= 0:
            raise ValueError("Morse beta and gamma must be positive")
        self.beta = float(beta)
        self.gamma = float(gamma)
        # the normalization stays in log space: for large beta both the
        # amplitude a and exp(beta log w - w^gamma) overflow on their own
        # (float32 near beta ~ 90) while their product is O(1)
        self.log_norm = math.log(2.0) + (beta / gamma) * (
            1.0 + math.log(gamma) - math.log(beta)
        )
        self.norm = math.exp(self.log_norm) if self.log_norm < 700 else math.inf
        self.omega_peak = (beta / gamma) ** (1.0 / gamma)
        self.name = f"Morse (beta={beta:g}, gamma={gamma:g})"
        self.center_frequency = self.omega_peak / (2.0 * math.pi)
        self.is_analytic = True  # psi_hat is exactly zero for w <= 0
        # time-bandwidth product P^2 = beta*gamma; duration ~ sqrt(beta*gamma)/w_p
        self._duration = math.sqrt(beta * gamma) / self.omega_peak

    def psi_hat(self, omega):
        omega = real_tensor(omega)
        pos = omega > 0
        w = torch.where(pos, omega, 1.0)  # dead-branch guard (0^beta, exp overflow)
        # one exp of the folded log magnitude: each factor alone overflows
        # float32 for jLab-range beta (e.g. beta=120)
        val = torch.exp(self.log_norm + self.beta * torch.log(w) - w**self.gamma)
        return to_complex(torch.where(pos, val, 0.0))

    def psi(self, t):
        """Numerical Fourier synthesis psi(t) = (1/2pi) int psi_hat(w) e^{iwt} dw
        on a fixed 4096-node grid over (0, w_cut]; vectorized over any ``t``."""
        t = real_tensor(t)
        w = torch.as_tensor(self._quad_nodes(), dtype=t.dtype, device=t.device)
        spec = self.psi_hat(w)  # (Q,) complex
        dw = w[1] - w[0]
        phase = w * t[..., None]  # (..., Q)
        kern = torch.cos(phase) + 1j * torch.sin(phase)
        return torch.sum(spec * kern, dim=-1) * (dw / (2.0 * math.pi))

    def _quad_nodes(self) -> np.ndarray:
        # w_cut: beta*log(w) - w^gamma falls 30 nats below the peak value
        wp = self.omega_peak
        peak_log = self.beta * math.log(wp) - wp**self.gamma
        hi = wp
        while self.beta * math.log(hi) - hi**self.gamma > peak_log - 30.0:
            hi *= 1.25
        q = 4096
        return (np.arange(1, q + 1) / q) * hi

    def admissibility_constant(self) -> float:
        """C = int |psi_hat|^2 / w dw = a^2 Gamma(2 beta / gamma) /
        (gamma 2^(2 beta / gamma)), in log space."""
        r = 2.0 * self.beta / self.gamma
        return math.exp(
            2.0 * self.log_norm + math.lgamma(r) - math.log(self.gamma) - r * math.log(2.0)
        )

    def effective_support(self):
        r = 6.0 * self._duration
        return (-r, r)

    def bandwidth(self):
        """Frequency band where psi_hat exceeds ~1% of its peak (numeric)."""
        w = self._quad_nodes()
        log_mag = self.beta * np.log(w) - w**self.gamma  # the norm cancels
        sig = w[log_mag > log_mag.max() + math.log(0.01)]
        return (float(sig[0]) / (2.0 * math.pi), float(sig[-1]) / (2.0 * math.pi))
