"""Continuous wavelet base class.

Reference: jwave/transforms/wavelets/continuous/ContinuousWavelet.java.
Subclasses implement vectorized :meth:`psi` and :meth:`psi_hat` on tensors;
the scaled and translated variants follow from the standard identities
(ContinuousWavelet.java:90-141). A non-tensor argument becomes a tensor the
way numpy holds it (a Python float is float64); the complex width follows
the real input: float64 gives complex128, float32 gives complex64.
"""
from __future__ import annotations

import math

import torch

from .. import config
from ..utils.host import as_tensor


def to_complex(val: torch.Tensor) -> torch.Tensor:
    """float tensor -> complex tensor of matching precision."""
    return val.to(torch.complex128 if val.dtype == torch.float64 else torch.complex64)


def real_tensor(t) -> torch.Tensor:
    """``t`` as a floating tensor (integers promote to
    :func:`config.default_real_dtype`)."""
    t = as_tensor(t)
    return t if t.is_floating_point() else t.to(config.default_real_dtype())


def _sqrt(v):
    return torch.sqrt(v) if isinstance(v, torch.Tensor) else math.sqrt(v)


class ContinuousWavelet:
    name: str = "continuous"
    center_frequency: float = 0.0
    #: True when psi_hat is (numerically) supported on positive frequencies
    #: only; synchrosqueezing's instantaneous-frequency estimate needs it.
    is_analytic: bool = False

    def psi(self, t):
        """Mother wavelet psi(t) (complex tensor)."""
        raise NotImplementedError

    def psi_hat(self, omega):
        """Fourier transform of psi at angular frequency omega (complex tensor)."""
        raise NotImplementedError

    def psi_scaled(self, t, scale, translation=0.0):
        """psi_{a,b}(t) = psi((t-b)/a)/sqrt(a) (ContinuousWavelet.java:90-102)."""
        return self.psi((real_tensor(t) - translation) / scale) / _sqrt(scale)

    def psi_hat_scaled(self, omega, scale, translation=0.0):
        """F[psi_{a,b}](w) = sqrt(a)*exp(-iwb)*psi_hat(a*w)
        (ContinuousWavelet.java:111-141)."""
        omega = real_tensor(omega)
        ft = self.psi_hat(scale * omega) * _sqrt(scale)
        if translation != 0.0:
            ft = ft * torch.exp(-1j * omega * translation)
        return ft

    def admissibility_constant(self) -> float:
        raise NotImplementedError

    def effective_support(self) -> tuple[float, float]:
        """[min_t, max_t] where the wavelet is significant."""
        raise NotImplementedError

    def bandwidth(self) -> tuple[float, float]:
        """[min_f, max_f] (ordinary frequency) of significant response."""
        raise NotImplementedError
