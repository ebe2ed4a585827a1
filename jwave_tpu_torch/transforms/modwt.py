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

On top of the transform sit the 2D separable MODWT, the additive
multiresolution analyses (1D and 2D) and the scale statistics: wavelet
variance with confidence intervals, covariance, correlation, the logscale
diagram and the Hurst estimator. They call :func:`modwt`/:func:`imodwt`, so
on CUDA float32/bfloat16 they run on K1/K2, and gradients flow through the
kernels' autograd Functions.

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
from ..ops.butterfly import ensure_float
from ..ops.circular import (
    circular_conv,
    circular_conv_adjoint,
    complex_dtype,
    filter_spectrum,
    wrap_filter,
)
from ..utils.host import as_tensor
from ..utils.numerics import exponent_of_two, is_power_of_two
from ..utils.profiling import span, spanned

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


@spanned("modwt")
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
        with span("taps"):
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


@spanned("imodwt")
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
        with span("taps"):
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


def modwt_2d(mat, wavelet, level: int, **kw):
    """Separable 2D MODWT: rows then columns of each subband.

    Returns (..., J+1, J+1, R, C): entry (jr, jc) filters rows with the
    level-jc row response and columns with the level-jr response (PyWavelets'
    ``swt2`` layout). Perfectly invertible via :func:`imodwt_2d`.
    """
    rows = modwt(mat, wavelet, level, **kw)  # (..., R, J+1, C)
    rows = torch.movedim(rows, -2, -3)  # (..., J+1, R, C)
    cols = modwt(rows.transpose(-1, -2), wavelet, level, **kw)  # (..., J+1, C, J+1, R)
    cols = torch.movedim(cols, -2, -4)  # (..., J+1, J+1, C, R)
    return cols.transpose(-1, -2)  # (..., jr, jc, R, C)


def imodwt_2d(coeffs, wavelet, **kw):
    """Inverse of :func:`modwt_2d`."""
    c = as_tensor(coeffs).transpose(-1, -2)  # (..., J+1, J+1, C, R)
    c = torch.movedim(c, -4, -2)  # (..., J+1, C, J+1, R)
    c = imodwt(c, wavelet, **kw).transpose(-1, -2)  # (..., J+1, R, C)
    return imodwt(torch.movedim(c, -3, -2), wavelet, **kw)  # (..., R, C)


def modwt_mra_2d(mat, wavelet, level: int, **kw):
    """2D MODWT multiresolution analysis: additive subband-image components.

    Returns (..., J+1, J+1, R, C): component (jr, jc) is the inverse 2D MODWT
    of the isolated (jr, jc) subband, and the (J+1)^2 components sum to the
    image. All inverses run as one batched inverse over the flattened band
    axis. ``boundary="reflection"`` analyzes the doubly mirrored extension
    and truncates the components back to (R, C).
    """
    if "truncate" in kw:
        raise JWaveFailure("modwt_mra_2d - 'truncate' is managed internally")
    boundary = kw.pop("boundary", "periodic")
    if boundary == "reflection":
        mat = ensure_float(as_tensor(mat))
        r, c = mat.shape[-2:]
        if min(r, c) > 0:
            # validate against the user's image size, not the 2R x 2C mirror
            _validate_level(min(r, c), level, "modwt_mra_2d")
        ext = torch.cat([mat, torch.flip(mat, dims=(-1,))], dim=-1)
        ext = torch.cat([ext, torch.flip(ext, dims=(-2,))], dim=-2)
        return modwt_mra_2d(ext, wavelet, level, **kw)[..., :r, :c]
    if boundary != "periodic":
        raise JWaveFailure(
            f"modwt_mra_2d - boundary must be 'periodic' or 'reflection', got {boundary!r}"
        )
    coeffs = modwt_2d(mat, wavelet, level, **kw)  # (..., J+1, J+1, R, C)
    rows = level + 1
    # band b isolated in the (jr, jc) grid
    eye = torch.eye(rows * rows, dtype=coeffs.dtype, device=coeffs.device)
    isolated = eye.reshape(rows * rows, rows, rows, 1, 1) * coeffs[..., None, :, :, :, :]
    comp = imodwt_2d(isolated, wavelet, **kw)  # (..., (J+1)^2, R, C)
    return comp.reshape(comp.shape[:-3] + (rows, rows) + comp.shape[-2:])


def modwt_mra(x, wavelet, level: int, boundary: str = "periodic", **kw):
    """MODWT multiresolution analysis: additive detail/smooth decomposition.

    Returns (..., J+1, N): rows [D_1 .. D_J, S_J] with ``sum(rows) == x``
    (each row is the inverse MODWT of one isolated subband, all J+1 inverses
    one batched call). ``boundary="reflection"`` analyzes the reflected
    extension and truncates the components back to N.
    """
    if "truncate" in kw:
        raise JWaveFailure(
            "modwt_mra - truncation is managed internally (the full "
            "coefficient stack is needed for exact additivity); do not pass "
            "'truncate'"
        )
    x = ensure_float(as_tensor(x))
    n = x.shape[-1]
    coeffs = modwt(x, wavelet, level, boundary=boundary, truncate=False, **kw)
    rows = level + 1
    eye = torch.eye(rows, dtype=coeffs.dtype, device=coeffs.device)
    # (..., band b, J+1, N): subband j kept only where j == b
    isolated = eye[:, :, None] * coeffs[..., None, :, :]
    return imodwt(isolated, wavelet, **kw)[..., :n]


def _support(m: int, j: int) -> int:
    """L_j = (M-1)(2^j - 1) + 1, the level-j filter support."""
    return (m - 1) * ((1 << j) - 1) + 1


def _detail_moments(cx, cy, wavelet, level: int, unbiased: bool, name: str):
    """Per-level second moments E[W_jx * W_jy] of two (..., J+1, N) stacks,
    dropping the L_j - 1 circular-boundary coefficients when ``unbiased``."""
    n = cx.shape[-1]
    m = get_filter(wavelet).length
    dx = cx[..., :level, :]
    dy = cy[..., :level, :]
    if not unbiased:
        return torch.mean(dx * dy, dim=-1)
    out = []
    for j in range(1, level + 1):
        l_j = _support(m, j)
        if n - (l_j - 1) <= 0:
            raise JWaveFailure(
                f"{name} - unbiased estimator needs N > L_j - 1 = {l_j - 1} "
                f"at level {j} (N = {n}); pass unbiased=False"
            )
        out.append(torch.mean(dx[..., j - 1, l_j - 1:] * dy[..., j - 1, l_j - 1:], dim=-1))
    return torch.stack(out, dim=-1)


def _reject_truncate(kw, who: str):
    """The statistics take one coefficient column per input sample; a 2N
    reflected stack (truncate=False) would double-count the mirror."""
    if "truncate" in kw:
        raise JWaveFailure(
            f"{who} - 'truncate' is not accepted here; the estimators operate "
            f"on the length-N coefficient columns"
        )


def modwt_variance(x, wavelet, level: int, unbiased: bool = True, **kw):
    """Wavelet variance per level nu_j^2 = E[W_j^2] (Percival & Walden ch. 8),
    (..., J), the V_J row excluded. ``unbiased`` drops each level's L_j - 1
    boundary coefficients."""
    _reject_truncate(kw, "modwt_variance")
    coeffs = modwt(x, wavelet, level, **kw)
    return _detail_moments(coeffs, coeffs, wavelet, level, unbiased, "modwt_variance")


def modwt_variance_ci(x, wavelet, level: int, confidence: float = 0.95,
                      unbiased: bool = True, **kw):
    """Wavelet variance with chi-squared confidence intervals: ``(var, lo,
    hi)``, each (..., J), with the "EDOF 3" degrees of freedom
    eta_j = max(M_j / 2^j, 1) (Percival & Walden eq. 313)."""
    from scipy.stats import chi2

    if not 0.0 < confidence < 1.0:
        raise JWaveFailure(
            f"modwt_variance_ci - confidence must be in (0, 1), got {confidence}"
        )
    x = ensure_float(as_tensor(x))
    var = modwt_variance(x, wavelet, level, unbiased=unbiased, **kw)
    n = x.shape[-1]
    m = get_filter(wavelet).length
    eta, q_hi, q_lo = [], [], []
    for j in range(1, level + 1):
        m_j = (n - _support(m, j) + 1) if unbiased else n
        e = max(m_j / float(1 << j), 1.0)
        eta.append(e)
        q_hi.append(chi2.ppf((1.0 + confidence) / 2.0, e))
        q_lo.append(chi2.ppf((1.0 - confidence) / 2.0, e))
    eta_t = torch.as_tensor(np.array(eta), dtype=var.dtype, device=var.device)
    lo = eta_t * var / torch.as_tensor(np.array(q_hi), dtype=var.dtype, device=var.device)
    hi = eta_t * var / torch.as_tensor(np.array(q_lo), dtype=var.dtype, device=var.device)
    return var, lo, hi


def _pair(x, y, who: str, kw):
    x = ensure_float(as_tensor(x))
    y = ensure_float(as_tensor(y))
    if x.shape[-1] != y.shape[-1]:
        raise JWaveFailure(
            f"{who} - signals must share their last-axis length "
            f"(got {x.shape[-1]} and {y.shape[-1]})"
        )
    _reject_truncate(kw, who)
    return x, y


def modwt_covariance(x, y, wavelet, level: int, unbiased: bool = True, **kw):
    """Wavelet covariance per level nu_jxy = E[W_jx * W_jy] (Whitcher,
    Guttorp & Percival 2000), (..., J); boundary handling as
    :func:`modwt_variance`."""
    x, y = _pair(x, y, "modwt_covariance", kw)
    cx = modwt(x, wavelet, level, **kw)
    cy = modwt(y, wavelet, level, **kw)
    return _detail_moments(cx, cy, wavelet, level, unbiased, "modwt_covariance")


def modwt_correlation(x, y, wavelet, level: int, unbiased: bool = True, **kw):
    """Wavelet correlation per level nu_jxy / (nu_jx nu_jy), in [-1, 1]."""
    x, y = _pair(x, y, "modwt_correlation", kw)
    cx = modwt(x, wavelet, level, **kw)
    cy = modwt(y, wavelet, level, **kw)
    cov = _detail_moments(cx, cy, wavelet, level, unbiased, "modwt_correlation")
    vx = _detail_moments(cx, cx, wavelet, level, unbiased, "modwt_correlation")
    vy = _detail_moments(cy, cy, wavelet, level, unbiased, "modwt_correlation")
    return torch.clamp(cov / torch.sqrt(vx * vy), -1.0, 1.0)


def wavelet_log_spectrum(x, wavelet, level: int, unbiased: bool = True, **kw):
    """Logscale diagram (Abry & Veitch 1998): per-level ``log2`` wavelet
    variance and the weighted least-squares line through it, weights ~ the
    interior coefficient count n_j. Returns ``(log2_var, slope,
    intercept)`` with shapes (..., J), (...), (...)."""
    if level < 2:
        raise JWaveFailure("wavelet_log_spectrum - need level >= 2 to fit a slope")
    x = ensure_float(as_tensor(x))
    var = modwt_variance(x, wavelet, level, unbiased=unbiased, **kw)
    n = x.shape[-1]
    m = get_filter(wavelet).length
    j = np.arange(1, level + 1, dtype=np.float64)
    if unbiased:
        n_j = np.array([n - (m - 1) * ((1 << int(jj)) - 1) for jj in j], dtype=np.float64)
    else:
        n_j = np.full(level, float(n))
    w = n_j / n_j.sum()  # Var[log2 v_j] ~ 2/(n_j ln^2 2) -> weights ~ n_j
    y = torch.log2(var)
    jbar = float((w * j).sum())
    denom = float((w * (j - jbar) ** 2).sum())
    jw = torch.as_tensor(w * (j - jbar) / denom, dtype=y.dtype, device=y.device)
    slope = torch.sum(y * jw, dim=-1)
    intercept = torch.sum(y * torch.as_tensor(w, dtype=y.dtype, device=y.device),
                          dim=-1) - slope * jbar
    return y, slope, intercept


def hurst_exponent(x, wavelet="db4", level: int | None = None,
                   kind: str = "fgn", unbiased: bool = True, **kw):
    """Wavelet-domain Hurst exponent (Abry-Veitch logscale regression):
    ``H = alpha/2 + 1`` for fractional Gaussian noise (``kind="fgn"``) and
    ``H = alpha/2`` for fractional Brownian motion (``"fbm"``), alpha the
    slope of :func:`wavelet_log_spectrum`. ``level=None`` picks the deepest
    level whose unbiased interior keeps at least 16 coefficients. Returns H
    with the leading batch shape of ``x``; differentiable."""
    if kind not in ("fgn", "fbm"):
        raise JWaveFailure(f"hurst_exponent - kind must be 'fgn' or 'fbm', got {kind!r}")
    x = ensure_float(as_tensor(x))
    n = x.shape[-1]
    m = get_filter(wavelet).length
    if level is None:
        level = 0
        while level < MAX_DECOMPOSITION_LEVEL:
            if unbiased:
                # deepest level whose unbiased interior keeps >= 16 coeffs
                if n - (_support(m, level + 1) - 1) < 16:
                    break
            elif (1 << (level + 1)) * 4 > n:
                # biased: keep a few coefficients per effective scale
                break
            level += 1
        if level < 2:
            raise JWaveFailure(
                f"hurst_exponent - signal too short for a level-2 "
                f"{'unbiased ' if unbiased else ''}fit with {m}-tap "
                f"'{wavelet}' (N = {n})"
            )
    _, slope, _ = wavelet_log_spectrum(x, wavelet, level, unbiased=unbiased, **kw)
    return slope / 2.0 + 1.0 if kind == "fgn" else slope / 2.0
