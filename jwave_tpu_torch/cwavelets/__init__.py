"""Continuous (CWT) mother wavelets as pairs of tensor functions.

Each wavelet provides vectorized ``psi(t)`` (time domain) and
``psi_hat(omega)`` (Fourier transform) evaluations, plus the scale and
translation identities of the reference base class
(jwave/transforms/wavelets/continuous/ContinuousWavelet.java:90-141):

    psi_{a,b}(t)       = psi((t-b)/a) / sqrt(a)
    psi_hat_{a,b}(w)   = sqrt(a) * exp(-i*w*b) * psi_hat(a*w)
"""
from ..exceptions import JWaveNotKnown
from .base import ContinuousWavelet
from .dog import DOGWavelet
from .mexhat import MexicanHatWavelet
from .meyer import MeyerWavelet
from .morlet import MorletWavelet
from .morse import MorseWavelet
from .paul import PaulWavelet

__all__ = [
    "ContinuousWavelet",
    "MorletWavelet",
    "MexicanHatWavelet",
    "PaulWavelet",
    "DOGWavelet",
    "MeyerWavelet",
    "MorseWavelet",
    "get_continuous_wavelet",
]

_FACTORIES = {
    "morlet": MorletWavelet,
    "mexicanhat": MexicanHatWavelet,
    "mexican hat": MexicanHatWavelet,
    "ricker": MexicanHatWavelet,
    "paul": PaulWavelet,
    "dog": DOGWavelet,
    "meyer": MeyerWavelet,
    "morse": MorseWavelet,
}


def get_continuous_wavelet(name, *args, **kwargs) -> ContinuousWavelet:
    """Create a continuous wavelet by name (case-insensitive); a wavelet
    object passes through."""
    if isinstance(name, ContinuousWavelet):
        return name
    key = str(name).lower().strip()
    if key not in _FACTORIES:
        raise JWaveNotKnown(f"unknown continuous wavelet {name!r}; "
                            f"available: {sorted(set(_FACTORIES))}")
    return _FACTORIES[key](*args, **kwargs)
