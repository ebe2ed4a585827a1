"""Circular convolution primitives for MODWT (direct and FFT paths).

Semantics (reference MODWTTransform.java):

    conv:    out[n] = sum_m f[m] * x[(n-m) mod N]     (:677-690)
    adjoint: out[n] = sum_m f[m] * x[(n+m) mod N]     (:703-716)
    FFT:     irfft(rfft(x) * rfft(wrap(f, N)))        (:752-786)
    FFT adj: irfft(rfft(x) * conj(rfft(wrap(f, N)))) (:798-837)

Filters longer than the signal are wrapped (accumulated modulo N) first
(:729-741). ``conv1d`` is a correlation, so the convolution flips the filter.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import config
from .butterfly import ensure_float, taps


def wrap_filter(f: np.ndarray, n: int) -> np.ndarray:
    """Accumulate filter taps modulo ``n`` (MODWTTransform.java:729-741)."""
    f = np.asarray(f, dtype=np.float64)
    if f.shape[0] <= n:
        return f
    out = np.zeros(n, dtype=np.float64)
    np.add.at(out, np.arange(f.shape[0]) % n, f)
    return out


def _correlate_valid(ext: torch.Tensor, kernel: np.ndarray, n: int) -> torch.Tensor:
    flat = ext.reshape(-1, 1, ext.shape[-1])
    with config.dial():
        out = F.conv1d(flat, taps(kernel[None, None, :], ext))
    return out[:, 0].reshape(ext.shape[:-1] + (n,))


def _conv_valid_bank(flat: torch.Tensor, kernels: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """(B, L) x (K, M) -> (B, K, L-M+1): one ``conv1d`` applies a whole bank
    of same-length kernels (K output channels) to every row, as a
    correlation (``out[b, k, t] = sum_d kernels[k, d] * flat[b, t + d]``)."""
    w = torch.as_tensor(np.ascontiguousarray(kernels, dtype=np.float64), dtype=dtype,
                        device=flat.device)
    with config.dial():
        return F.conv1d(flat[:, None, :].to(dtype), w[:, None, :])


def circular_conv(x: torch.Tensor, f: np.ndarray) -> torch.Tensor:
    """Direct circular convolution, batched over leading dims of ``x``."""
    x = ensure_float(x)
    n = x.shape[-1]
    fw = wrap_filter(f, n)
    pad = fw.shape[0] - 1
    ext = torch.cat([x[..., n - pad:], x], dim=-1) if pad else x
    return _correlate_valid(ext, fw[::-1], n)


def circular_conv_adjoint(x: torch.Tensor, f: np.ndarray) -> torch.Tensor:
    """Direct adjoint circular convolution (transpose of :func:`circular_conv`)."""
    x = ensure_float(x)
    n = x.shape[-1]
    fw = wrap_filter(f, n)
    pad = fw.shape[0] - 1
    ext = torch.cat([x, x[..., :pad]], dim=-1) if pad else x
    return _correlate_valid(ext, fw, n)


def filter_spectrum(f: np.ndarray, n: int) -> np.ndarray:
    """rfft of the length-``n`` wrapped filter (host-side, float64)."""
    fw = wrap_filter(f, n)
    if fw.shape[0] < n:
        fw = np.pad(fw, (0, n - fw.shape[0]))
    return np.fft.rfft(fw)


def complex_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.complex128 if x.dtype == torch.float64 else torch.complex64


def _spectral(x: torch.Tensor, f_hat: np.ndarray) -> torch.Tensor:
    n = x.shape[-1]
    fh = torch.as_tensor(f_hat, dtype=complex_dtype(x), device=x.device)
    return torch.fft.irfft(torch.fft.rfft(x, dim=-1) * fh, n=n, dim=-1).to(x.dtype)


def circular_conv_fft(x: torch.Tensor, f: np.ndarray, f_hat=None) -> torch.Tensor:
    """FFT-path circular convolution. ``f_hat`` may be precomputed."""
    x = ensure_float(x)
    if f_hat is None:
        f_hat = filter_spectrum(f, x.shape[-1])
    return _spectral(x, f_hat)


def circular_conv_adjoint_fft(x: torch.Tensor, f: np.ndarray, f_hat=None) -> torch.Tensor:
    """FFT-path adjoint circular convolution (conjugate filter spectrum)."""
    x = ensure_float(x)
    if f_hat is None:
        f_hat = filter_spectrum(f, x.shape[-1])
    return _spectral(x, np.conj(f_hat))
