"""DFT / FFT with the reference's conventions.

Reference: jwave/transforms/FastFourierTransform.java (Cooley-Tukey radix-2
plus Bluestein chirp-z for arbitrary N, NumPy normalization: forward
unscaled, inverse 1/N, :205-211, and an interleaved [re0, im0, re1, im1, ...]
real-array API, :55-103); jwave/transforms/DiscreteFourierTransform.java:
73-117 is the naive O(N^2) variant.

``torch.fft`` (cuFFT on a card) takes any N, so :func:`fft`/:func:`ifft` are
one call each. :func:`bluestein_fft` stays as a public function that reduces
any N to power-of-two FFTs, and :func:`dft` is the dense O(N^2) product.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ops.butterfly import ensure_fft_float, ensure_float
from ..utils.host import as_tensor
from ..utils.numerics import next_power_of_two
from .ndim import deinterleave, interleave


def fft(z, axis: int = -1) -> torch.Tensor:
    """Forward FFT (unscaled, the NumPy convention) of real or complex input;
    bfloat16 and float16 input computes in float32 (complex64 out)."""
    return torch.fft.fft(ensure_fft_float(as_tensor(z)), dim=axis)


def ifft(z, axis: int = -1) -> torch.Tensor:
    """Inverse FFT (scaled by 1/N)."""
    return torch.fft.ifft(ensure_fft_float(as_tensor(z)), dim=axis)


def fft_interleaved(x) -> torch.Tensor:
    """FFT on the reference's interleaved real format
    (FastFourierTransform.java:55-103): (..., 2N) -> (..., 2N)."""
    return interleave(fft(deinterleave(ensure_fft_float(as_tensor(x)))))


def ifft_interleaved(x) -> torch.Tensor:
    """Inverse of :func:`fft_interleaved`."""
    return interleave(ifft(deinterleave(ensure_fft_float(as_tensor(x)))))


def _bluestein_consts(n: int):
    """Host-side chirp constants for the length-n Bluestein (chirp-z) DFT
    (FastFourierTransform.java:259-324)."""
    idx = np.arange(n, dtype=np.float64)
    c = np.exp(-1j * np.pi * (idx * idx % (2 * n)) / n)  # e^{-i pi n^2 / N}
    l = next_power_of_two(2 * n - 1)
    v = np.zeros(l, dtype=np.complex128)
    chirp = np.conj(c)  # e^{+i pi m^2 / N}
    v[:n] = chirp
    v[l - n + 1:] = chirp[1:][::-1]
    return c, np.fft.fft(v), l


def bluestein_fft(z, inverse: bool = False) -> torch.Tensor:
    """Arbitrary-length DFT along the last axis through power-of-two FFTs.
    complex128 input computes in complex128, anything else in complex64, as
    in the JAX package."""
    z = as_tensor(z)
    n = z.shape[-1]
    c, v_hat, l = _bluestein_consts(n)
    cdtype = torch.complex128 if z.dtype == torch.complex128 else torch.complex64
    z = z.to(cdtype)
    cj = torch.as_tensor(np.conj(c) if inverse else c, dtype=cdtype, device=z.device)
    vh = torch.as_tensor(np.conj(v_hat) if inverse else v_hat, dtype=cdtype, device=z.device)
    u = torch.nn.functional.pad(z * cj, (0, l - n))
    conv = torch.fft.ifft(torch.fft.fft(u, dim=-1) * vh, dim=-1)[..., :n]
    out = conv * cj
    if inverse:
        out = out / n
    return out


def _dft_matrix(n: int, sign: float) -> np.ndarray:
    k = np.arange(n)
    return np.exp(sign * 2j * np.pi * np.outer(k, k) / n)


def _dense(z, sign: float) -> torch.Tensor:
    z = ensure_float(as_tensor(z))
    dt = torch.promote_types(z.dtype, torch.complex64)
    w = torch.as_tensor(_dft_matrix(z.shape[-1], sign), dtype=dt, device=z.device)
    with config.dial():
        return z.to(dt) @ w.T


def dft(z) -> torch.Tensor:
    """Naive O(N^2) DFT as a dense product (DiscreteFourierTransform.java:73-117)."""
    return _dense(z, -1.0)


def idft(z) -> torch.Tensor:
    """Inverse naive DFT (scaled by 1/N)."""
    z = as_tensor(z)
    return _dense(z, +1.0) / z.shape[-1]


def dft_interleaved(x) -> torch.Tensor:
    """Naive DFT on the interleaved real format (DiscreteFourierTransform.java:73-117)."""
    return interleave(dft(deinterleave(ensure_float(as_tensor(x)))))


def idft_interleaved(x) -> torch.Tensor:
    """Inverse naive DFT on the interleaved real format."""
    return interleave(idft(deinterleave(ensure_float(as_tensor(x)))))
