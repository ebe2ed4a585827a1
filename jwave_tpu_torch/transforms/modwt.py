"""MODWT — Maximal Overlap Discrete Wavelet Transform, forward and inverse.

Reference: jwave/transforms/MODWTTransform.java, as ``jwave_tpu.transforms.
modwt`` implements it:

  * base filters = unit-L2-normalized analysis filters scaled by 1/sqrt(2)
  * level-j filters = base upsampled with 2^(j-1)-1 zeros between taps,
    wrapped modulo N when longer than the signal
  * forward:  W_j = h_j (*) V_{j-1},  V_j = g_j (*) V_{j-1}
  * inverse:  V_{j-1} = g_j (*)^T V_j + h_j (*)^T W_j
  * AUTO picks, per level, direct convolution while N*M_j stays under the
    threshold and one telescoped FFT cascade for the remaining levels.

Output layout: (..., J+1, N) rows [W_1 .. W_J, V_J].

Routing: a CUDA float32/bfloat16 tensor under AUTO, PALLAS or MXU goes to
the cascade kernels K1/K2 (``ops.cuda_modwt``). PALLAS and MXU on a CPU
tensor take the kernels' plain versions; AUTO on the CPU, float64 anywhere,
and explicit DIRECT/FFT take the direct/FFT path. PALLAS or MXU on float64
raises, as in the JAX package.
"""
from __future__ import annotations

from enum import Enum

import numpy as np
import torch

from ..exceptions import JWaveFailure
from ..filters import get_filter
from ..ops import cuda_modwt
from ..ops.butterfly import as_tensor, ensure_float
from ..ops.circular import (
    circular_conv,
    circular_conv_adjoint,
    complex_dtype,
    filter_spectrum,
    wrap_filter,
)
from ..utils.numerics import exponent_of_two, is_power_of_two

#: maximum supported decomposition level (MODWTTransform.java:111)
MAX_DECOMPOSITION_LEVEL = 13

#: AUTO method threshold on N*M (MODWTTransform.java:144)
DEFAULT_FFT_THRESHOLD = 4096


class ConvolutionMethod(Enum):
    """The JAX package's methods. PALLAS and MXU both name the fused cascade,
    which here is the CUDA kernel pair K1/K2."""

    AUTO = "auto"
    DIRECT = "direct"
    FFT = "fft"
    PALLAS = "pallas"
    MXU = "mxu"


_CASCADE_METHODS = (ConvolutionMethod.PALLAS, ConvolutionMethod.MXU)


def _modwt_base_filters(wavelet):
    """Unit-L2-normalized analysis filters scaled by 1/sqrt(2), float64
    (MODWTTransform.java:469-475)."""
    fb = get_filter(wavelet)
    g = np.asarray(fb.dec_lo, dtype=np.float64).copy()
    h = np.asarray(fb.dec_hi, dtype=np.float64).copy()
    for f in (g, h):
        nrm = np.sqrt(np.sum(f * f))
        if nrm > 1e-12:
            f /= nrm
    return g / np.sqrt(2.0), h / np.sqrt(2.0)


def _upsample(f: np.ndarray, level: int) -> np.ndarray:
    """Insert 2^(j-1)-1 zeros between taps (:618-630)."""
    if level <= 1:
        return f
    gap = (1 << (level - 1)) - 1
    out = np.zeros(f.shape[0] + (f.shape[0] - 1) * gap, dtype=np.float64)
    out[:: gap + 1] = f
    return out


def _upsample_len(wavelet, j: int) -> int:
    m = get_filter(wavelet).length
    return m + (m - 1) * ((1 << (j - 1)) - 1)


def _level_filters(wavelet, level: int, n: int):
    """Per-level wrapped filters [(g_j, h_j)], float64 numpy."""
    g0, h0 = _modwt_base_filters(wavelet)
    return [
        (wrap_filter(_upsample(g0, j), n), wrap_filter(_upsample(h0, j), n))
        for j in range(1, level + 1)
    ]


def _cascade_spectra(wavelet, level: int, n: int, start: int = 0) -> np.ndarray:
    """(J-start+1, n//2+1) complex128: frequency response of rows
    W_{start+1} .. W_J, V_J relative to the level-``start`` smooth V_start.
    The recursion telescopes to W_j_hat = H_j prod_{start<i<j} G_i and
    V_J_hat = prod G_i, so the levels after ``start`` are one rfft and one
    batched irfft."""
    filters = _level_filters(wavelet, level, n)[start:]
    rows = level - start
    out = np.empty((rows + 1, n // 2 + 1), dtype=np.complex128)
    g_acc = np.ones(n // 2 + 1, dtype=np.complex128)
    for j, (gj, hj) in enumerate(filters):
        out[j] = filter_spectrum(hj, n) * g_acc
        g_acc = g_acc * filter_spectrum(gj, n)
    out[rows] = g_acc
    return out


def _direct_prefix_levels(wavelet, level: int, n: int,
                          method: ConvolutionMethod, threshold: int) -> int:
    """Per-level AUTO routing (MODWTTransform.java:640-664): levels 1..k run
    as direct convolutions, k+1..J as one FFT cascade. Returns k."""
    if method is ConvolutionMethod.FFT:
        return 0
    if method is ConvolutionMethod.DIRECT:
        return level
    k = 0
    while k < level and n * _upsample_len(wavelet, k + 1) <= threshold:
        k += 1
    return k


def _validate_level(n: int, level: int, who: str):
    if level < 1:
        raise JWaveFailure(f"{who} - decomposition level must be at least 1, got {level}")
    if level > MAX_DECOMPOSITION_LEVEL:
        raise JWaveFailure(
            f"{who} - maximum supported decomposition level is {MAX_DECOMPOSITION_LEVEL}, got {level}"
        )
    theoretical = n.bit_length() - 1 if n > 0 else 0
    if level > theoretical:
        raise JWaveFailure(
            f"{who} - level {level} exceeds theoretical limit {theoretical} for signal length {n}"
        )


def _use_cascade(x: torch.Tensor, method: ConvolutionMethod, who: str) -> bool:
    """The dtype rule of the cascade kernels: float32 or bfloat16 storage.
    PALLAS/MXU on any other dtype raise; AUTO takes the kernels on CUDA."""
    fits = x.dtype in (torch.float32, torch.bfloat16)
    if method in _CASCADE_METHODS:
        if not fits:
            raise JWaveFailure(
                f"{who} - ConvolutionMethod.{method.name} needs float32/bfloat16 input, "
                f"got {x.dtype}; use AUTO to choose the method automatically"
            )
        return True
    return method is ConvolutionMethod.AUTO and fits and x.device.type == "cuda"


def modwt(
    x,
    wavelet,
    level: int,
    method: ConvolutionMethod = ConvolutionMethod.AUTO,
    fft_threshold: int = DEFAULT_FFT_THRESHOLD,
    boundary: str = "periodic",
    truncate: bool = True,
):
    """Forward MODWT along the last axis (arbitrary length), batched.

    Returns (..., level+1, N): rows [W_1, ..., W_J, V_J].

    ``boundary``: "periodic" (circular) or "reflection" (the signal is
    extended to ``[x, reverse(x)]``). With reflection, ``truncate=True``
    returns the first N columns; ``truncate=False`` returns all 2N, which
    :func:`imodwt` inverts exactly (take the first N samples of its output).
    """
    if boundary == "reflection":
        x = ensure_float(as_tensor(x))
        if x.shape[-1] > 0:
            # validate against the user's length, not the 2N extension
            _validate_level(x.shape[-1], level, "modwt")
        ext = torch.cat([x, torch.flip(x, dims=(-1,))], dim=-1)
        c = modwt(ext, wavelet, level, method, fft_threshold)
        return c[..., : x.shape[-1]] if truncate else c
    if boundary != "periodic":
        raise JWaveFailure(
            f"modwt - boundary must be 'periodic' or 'reflection', got {boundary!r}"
        )
    x = ensure_float(as_tensor(x))
    n = x.shape[-1]
    if n == 0:
        return torch.zeros(x.shape[:-1] + (level + 1, 0), dtype=x.dtype, device=x.device)
    _validate_level(n, level, "modwt")

    if _use_cascade(x, method, "modwt"):
        g0, h0 = _modwt_base_filters(wavelet)
        lead = x.shape[:-1]
        flat = x.reshape(-1, n).contiguous()
        return cuda_modwt.modwt_cascade(flat, g0, h0, level).reshape(lead + (level + 1, n))

    k = _direct_prefix_levels(wavelet, level, n, method, fft_threshold)
    rows = []
    v = x
    for gj, hj in _level_filters(wavelet, level, n)[:k]:
        rows.append(circular_conv(v, hj))
        v = circular_conv(v, gj)
    if k == level:
        rows.append(v)
        return torch.stack(rows, dim=-2)
    fil = torch.as_tensor(_cascade_spectra(wavelet, level, n, start=k),
                          dtype=complex_dtype(x), device=x.device)
    spec = torch.fft.rfft(v, dim=-1)
    tail = torch.fft.irfft(spec[..., None, :] * fil, n=n, dim=-1).to(x.dtype)
    if not rows:
        return tail
    return torch.cat([torch.stack(rows, dim=-2), tail], dim=-2)


def imodwt(
    coeffs,
    wavelet,
    method: ConvolutionMethod = ConvolutionMethod.AUTO,
    fft_threshold: int = DEFAULT_FFT_THRESHOLD,
):
    """Inverse MODWT from a (..., J+1, N) stack (MODWTTransform.java:337-375)."""
    coeffs = ensure_float(as_tensor(coeffs))
    level = coeffs.shape[-2] - 1
    n = coeffs.shape[-1]
    if n == 0:
        return torch.zeros(coeffs.shape[:-2] + (0,), dtype=coeffs.dtype, device=coeffs.device)
    if level < 1:
        raise JWaveFailure("imodwt - need at least level 1 (2 rows)")

    if _use_cascade(coeffs, method, "imodwt"):
        g0, h0 = _modwt_base_filters(wavelet)
        lead = coeffs.shape[:-2]
        flat = coeffs.reshape(-1, level + 1, n).contiguous()
        return cuda_modwt.imodwt_cascade(flat, g0, h0).reshape(lead + (n,))

    k = _direct_prefix_levels(wavelet, level, n, method, fft_threshold)
    if k < level:
        tail = coeffs[..., k:, :]  # rows W_{k+1}..W_J, V_J
        fil = torch.as_tensor(np.conj(_cascade_spectra(wavelet, level, n, start=k)),
                              dtype=complex_dtype(coeffs), device=coeffs.device)
        v_hat = torch.sum(torch.fft.rfft(tail, dim=-1) * fil, dim=-2)
        v = torch.fft.irfft(v_hat, n=n, dim=-1).to(coeffs.dtype)
    else:
        v = coeffs[..., level, :]
    filters = _level_filters(wavelet, level, n)
    for j in range(k, 0, -1):
        gj, hj = filters[j - 1]
        v = circular_conv_adjoint(v, gj) + circular_conv_adjoint(coeffs[..., j - 1, :], hj)
    return v


def modwt_1d(x, wavelet, level: int | None = None, **kw):
    """Flattened 1D facade: (..., N) -> (..., (J+1)*N), power-of-two N
    (MODWTTransform.java:388-417)."""
    x = as_tensor(x)
    n = x.shape[-1]
    if not is_power_of_two(n):
        raise JWaveFailure("modwt_1d - given last-axis length is not 2^p")
    max_level = exponent_of_two(n)
    if level is None:
        level = max_level
    if level < 0 or level > max_level:
        raise JWaveFailure("modwt_1d - given level is out of range for given array")
    c = modwt(x, wavelet, level, **kw)
    return c.reshape(c.shape[:-2] + ((level + 1) * n,))


def imodwt_1d(flat, wavelet, level: int | None = None, **kw):
    """Inverse of :func:`modwt_1d`; infers (N, J) like the reference when
    ``level`` is omitted (MODWTTransform.java:880-912)."""
    flat = as_tensor(flat)
    total = flat.shape[-1]
    if level is None:
        n = 0
        for test_n in range(1, total + 1):
            if total % test_n == 0:
                test_levels = total // test_n - 1
                if test_levels >= 0 and is_power_of_two(test_n) and test_levels <= exponent_of_two(test_n):
                    n, level = test_n, test_levels
                    break
        if n == 0:
            raise JWaveFailure("imodwt_1d - cannot determine original signal dimensions")
    else:
        n = total // (level + 1)
        if not is_power_of_two(n) or total != n * (level + 1):
            raise JWaveFailure("imodwt_1d - invalid coefficient array for given level")
    coeffs = flat.reshape(flat.shape[:-1] + (level + 1, n))
    return imodwt(coeffs, wavelet, **kw)
