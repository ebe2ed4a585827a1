"""Wavelet denoising (shrinkage) on the MODWT, the JAX package's superset of
the reference's threshold-to-zero compressors (jwave/compressions/*).

Decompose, estimate the noise scale from the finest detail band (MAD),
threshold the detail coefficients (soft or hard; universal, SURE or Bayes
thresholds), reconstruct. Shift-invariant by construction, batched over
leading axes. On CUDA float32 the transforms run on K1/K2. Beside them,
:func:`denoise_dtcwt` shrinks images in the dual-tree complex wavelet domain
(no kernel of this package).
"""
from __future__ import annotations

import math

import torch

from .exceptions import JWaveFailure
from .ops.butterfly import ensure_float
from .transforms.modwt import imodwt, imodwt_2d, modwt, modwt_2d
from .utils.host import as_tensor
from .utils.select import median_abs


def soft_threshold(c, tau):
    """sign(c) * max(|c| - tau, 0)."""
    return torch.sign(c) * torch.clamp(torch.abs(c) - tau, min=0.0)


def hard_threshold(c, tau):
    """c if |c| > tau else 0."""
    return torch.where(torch.abs(c) > tau, c, 0.0)


def mad_sigma(detail):
    """Noise scale estimate: median(|W_1|) / 0.6745 (Donoho-Johnstone)."""
    return median_abs(detail) / 0.6745


def _like(v, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def sure_threshold(band, sigma):
    """Per-band SureShrink threshold (Donoho-Johnstone 'heursure') for soft
    thresholding of ``band`` (..., N) with noise scale ``sigma``
    (broadcastable leading shape); sparse bands (energy test below the log
    term) take the universal threshold. One sort and cumsum per band; the
    risk's argmin takes the first minimum."""
    n = band.shape[-1]
    sigma = _like(sigma, band)[..., None]
    y = band / torch.where(sigma > 0, sigma, 1.0)
    a = torch.sort(torch.abs(y), dim=-1).values  # ascending candidates t = a[k]
    a2 = a * a
    csum = torch.cumsum(a2, dim=-1)
    k = torch.arange(n, dtype=band.dtype, device=band.device)
    # SURE(t=a[k]) = N - 2(k+1) + sum_i min(y_i^2, a[k]^2)
    risk = n - 2.0 * (k + 1.0) + csum + (n - 1.0 - k) * a2
    t_sure = torch.gather(a, -1, torch.argmin(risk, dim=-1, keepdim=True))[..., 0]
    t_univ = math.sqrt(2.0 * math.log(max(n, 2)))
    # hybrid test: is there enough signal energy for SURE to be reliable?
    eta = (torch.sum(a2, dim=-1) - n) / n
    crit = (math.log2(max(n, 2)) ** 1.5) / math.sqrt(n)
    t = torch.where(eta < crit, t_univ, torch.clamp(t_sure, max=t_univ))
    return t * sigma[..., 0]


def bayes_threshold(band, sigma):
    """Per-band BayesShrink threshold tau = sigma^2 / sigma_x with
    sigma_x^2 = max(E[W^2] - sigma^2, 0) (Chang-Yu-Vetterli); an all-noise
    band (sigma_x = 0) gets tau = max|W| + 1, so everything goes."""
    sigma = _like(sigma, band)
    var_y = torch.mean(band * band, dim=-1)
    sigma_x = torch.sqrt(torch.clamp(var_y - sigma * sigma, min=0.0))
    kill_all = torch.amax(torch.abs(band), dim=-1) + 1.0
    return torch.where(sigma_x > 0, sigma * sigma / torch.where(sigma_x > 0, sigma_x, 1.0),
                       kill_all)


def _check(mode: str, method: str, who: str):
    if mode not in ("soft", "hard"):
        raise JWaveFailure(f"{who} - unknown mode {mode!r} (use 'soft' or 'hard')")
    if method not in ("universal", "sure", "bayes"):
        raise JWaveFailure(
            f"{who} - unknown method {method!r} (use 'universal', 'sure' or 'bayes')"
        )


def denoise(x, wavelet="db4", level: int = 4, mode: str = "soft", threshold=None,
            method: str = "universal"):
    """MODWT wavelet shrinkage along the last axis.

    ``method`` selects the threshold rule when ``threshold`` is None:
    'universal' (VisuShrink, sigma*sqrt(2 ln N)), 'sure' (per-band hybrid
    SureShrink) or 'bayes' (per-band BayesShrink); sigma comes from the
    finest detail band by MAD. ``mode`` is 'soft' or 'hard'. Returns the
    denoised signal (same shape and dtype as ``x``).
    """
    _check(mode, method, "denoise")
    coeffs = modwt(x, wavelet, level)  # (..., J+1, N)
    n = coeffs.shape[-1]
    details = coeffs[..., :level, :]
    if threshold is not None:
        tau = _like(threshold, coeffs)[..., None, None]
    else:
        # level-j detail noise scale is sigma/2^(j/2); MAD of band 1
        # estimates sigma/sqrt(2), deeper bands scale down by sqrt(2) a level
        sigma1 = mad_sigma(coeffs[..., 0, :])
        scale_j = _like([2.0 ** (-(j - 1) / 2.0) for j in range(1, level + 1)], coeffs)
        sigma_j = sigma1[..., None] * scale_j  # (..., level)
        if method == "universal":
            tau = (sigma_j * math.sqrt(2.0 * math.log(max(n, 2))))[..., None]
        elif method == "sure":
            tau = sure_threshold(details, sigma_j)[..., None]
        else:
            tau = bayes_threshold(details, sigma_j)[..., None]
    shrink = soft_threshold if mode == "soft" else hard_threshold
    kept = torch.cat([shrink(details, tau), coeffs[..., level:, :]], dim=-2)  # V_J untouched
    return imodwt(kept, wavelet)


def denoise_2d(img, wavelet="db4", level: int = 3, mode: str = "soft",
               method: str = "bayes"):
    """Shift-invariant 2D image denoising via the separable MODWT: threshold
    every band of the (J+1) x (J+1) grid of :func:`modwt_2d` except the pure
    approximation (J, J), and reconstruct. Band (jr, jc) of white noise has
    scale sigma/2^((jr'+jc')/2); sigma is MAD-estimated from the finest
    diagonal band (1, 1), whose scale is sigma/2."""
    _check(mode, method, "denoise_2d")
    img = ensure_float(as_tensor(img))
    r, c = img.shape[-2], img.shape[-1]
    coeffs = modwt_2d(img, wavelet, level)  # (..., J+1, J+1, R, C)
    sigma = 2.0 * mad_sigma(coeffs[..., 0, 0, :, :].reshape(coeffs.shape[:-4] + (r * c,)))
    flat = coeffs.reshape(coeffs.shape[:-2] + (r * c,))  # (..., J+1, J+1, RC)
    # j' = j+1 for detail rows (index < level), j' = level for the approx
    j_eff = _like([min(j + 1, level) for j in range(level + 1)], flat)
    scale = 2.0 ** (-(j_eff[:, None] + j_eff[None, :]) / 2.0)
    sigma_b = sigma[..., None, None] * scale  # (..., J+1, J+1)
    n = r * c
    if method == "universal":
        tau = sigma_b * math.sqrt(2.0 * math.log(max(n, 2)))
    elif method == "sure":
        tau = sure_threshold(flat, sigma_b)
    else:
        tau = bayes_threshold(flat, sigma_b)
    shrink = soft_threshold if mode == "soft" else hard_threshold
    out = shrink(flat, tau[..., None])
    # keep the pure approximation band (J, J) untouched
    out[..., level, level, :] = flat[..., level, level, :]
    return imodwt_2d(out.reshape(coeffs.shape), wavelet)


def _box_mean(a: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """Mean over the window [i-k, i+k] along ``axis``, clamped at the edges
    (a cumulative-sum box filter renormalized by the window's length)."""
    a = a.movedim(axis, -1)
    c = torch.cumsum(a, dim=-1)
    c = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
    n = a.shape[-1]
    i = torch.arange(n, device=a.device)
    hi = torch.clamp(i + k + 1, max=n)
    lo = torch.clamp(i - k, min=0)
    s = (torch.index_select(c, -1, hi) - torch.index_select(c, -1, lo)) / (hi - lo)
    return s.movedim(-1, axis)


def denoise_dtcwt(img, levels: int = 4, sigma=None, window: int = 7):
    """Bivariate-shrinkage image denoising in the dual-tree complex wavelet
    domain (Sendur & Selesnick 2002).

    Each oriented complex coefficient w is shrunk jointly with its parent
    p (same location, next coarser level):

        w <- w * max(0, r - sqrt(3) sigma_n^2 / sigma_local) / r,
        r = sqrt(|w|^2 + |p|^2)

    where ``sigma_local`` is the signal scale estimated from a
    ``window x window`` neighborhood of |w|^2 (marginal variance minus the
    noise floor): the MAP estimator under the bivariate Laplacian
    parent-child prior.

    Args:
      img: (..., H, W) real image(s), H and W divisible by ``2^levels``.
      levels: decomposition depth.
      sigma: noise standard deviation; None = MAD estimate from the
        finest-level oriented bands.
      window: local-variance neighborhood (odd).

    Returns the denoised image(s) (float32 for float32 or half input).
    """
    from .transforms.dtcwt import DTCWT2DResult, dtcwt2d, idtcwt2d

    if window < 1 or window % 2 == 0:
        raise JWaveFailure("denoise_dtcwt - window must be a positive odd int")
    res = dtcwt2d(img, levels)
    highs = res.highpasses
    if sigma is None:
        fine = highs[0]
        sigma = median_abs(fine.real.reshape(fine.shape[:-3] + (-1,))) / 0.6745
    sigma = torch.as_tensor(sigma, dtype=highs[0].real.dtype, device=highs[0].device)
    # noise power PER COMPLEX coefficient: the oriented packing is unitary
    # over the four orthonormal trees, so E|z_noise|^2 = 2 sigma^2
    sig2 = (2.0 * sigma ** 2)[..., None, None, None]
    k = window // 2
    new_highs = []
    for j, w in enumerate(highs):
        mag2 = torch.abs(w) ** 2
        if j + 1 < len(highs):
            # nearest-neighbor upsample the parent magnitude to the child grid
            pm = torch.abs(highs[j + 1]).repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
            pm = pm[..., : w.shape[-2], : w.shape[-1]]
        else:
            pm = torch.zeros_like(mag2)
        r = torch.sqrt(mag2 + pm ** 2) + 1e-30
        local = _box_mean(_box_mean(mag2, k, -1), k, -2)
        sig_local = torch.sqrt(torch.clamp(local - sig2, min=1e-30))
        shrink = torch.clamp(r - math.sqrt(3.0) * sig2 / sig_local, min=0.0) / r
        new_highs.append(w * shrink)
    return idtcwt2d(DTCWT2DResult(tuple(new_highs), res.lowpasses, res.level1_wavelet))
