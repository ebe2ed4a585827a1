"""Lifting-scheme FWT (polyphase; periodic or symmetric boundary).

Reference: the reference *defines* the CDF 5/3, CDF 9/7 and Battle 23 banks
but its builder refuses to create them (WaveletBuilder.java:363-385): odd
filter lengths break the even-stride butterfly (Wavelet.java:236-260). The
JAX package runs them by the lifting scheme (Sweldens; the
Daubechies-Sweldens polyphase factorization), and so does this module: each
analysis level is a short chain of elementwise FMAs between the even and odd
polyphase streams, with no convolution. Perfect reconstruction holds
structurally: the inverse subtracts the identical predictions and updates in
reverse order, for any lifting coefficients.

Normalization is pinned to the reference's constants where they are usable:
one 'CDF 9/7' analysis level reproduces circular cross-correlation with
CDF97.java's ``_scalingDeCom`` (up to a 2-sample output shift and the
12-digit truncation of the stored constants) and 'CDF 5/3' matches
CDF53.java's ``_scalingDeCom`` at scale 1.0. The stored CDF 5/3
``_waveletDeCom`` is the *synthesis* lowpass [1/2, 1, 1/2] (a data quirk of
the never-enabled bank), so the highpass follows the textbook LeGall
convention.

Output layout matches transforms/fwt.py: the in-place pyramid
``[A_L | D_L | D_{L-1} | ... | D_1]`` on a power-of-two last axis, so the
separable 2D/3D drivers, compression and the facade compose with it. No
kernel of this package runs here. A float input keeps its dtype (bf16 stays
bf16): half-precision levels compute in float32 and store in their dtype.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..exceptions import JWaveFailure, JWaveNotKnown
from ..ops.butterfly import ensure_float
from ..utils.host import as_tensor
from ..utils.numerics import exponent_of_two, is_power_of_two

_SQRT2 = math.sqrt(2.0)
# Daubechies-Sweldens factorization constants for CDF 9/7 (the JPEG2000
# irreversible transform). K chosen so the scaled lowpass equals the
# reference CDF97.java _scalingDeCom normalization (DC gain 1).
_ALPHA = -1.586134342059924
_BETA = -0.052980118572961
_GAMMA = 0.882911075530934
_DELTA = 0.443506852043971
_K97 = 1.230174104914001


@dataclass(frozen=True)
class LiftingScheme:
    """A lifting factorization: alternating predict/update FMA steps.

    Step semantics on the even (s) / odd (d) polyphase streams, periodic:

      ('p', c0, c1):  d[n] += c0*s[n] + c1*s[n+1]   (predict odd from even)
      ('u', c0, c1):  s[n] += c0*d[n] + c1*d[n-1]   (update even from odd)

    followed by the output scaling  a = k_s*s,  detail = k_d*d.
    """

    name: str
    steps: tuple
    k_s: float
    k_d: float


_SCHEMES = {
    # d = x_odd - x_even; s = mean  ->  a=(x0+x1)/sqrt2, d=(x0-x1)/sqrt2,
    # i.e. exactly the reference's orthonormal Haar 1 butterfly.
    "Haar lifting": LiftingScheme(
        "Haar lifting", (("p", -1.0, 0.0), ("u", 0.5, 0.0)), _SQRT2, -1.0 / _SQRT2
    ),
    # LeGall 5/3 (JPEG2000 reversible path, here in floating point).
    "CDF 5/3": LiftingScheme(
        "CDF 5/3", (("p", -0.5, -0.5), ("u", 0.25, 0.25)), 1.0, 1.0
    ),
    # Cohen-Daubechies-Feauveau 9/7 (JPEG2000 irreversible).
    "CDF 9/7": LiftingScheme(
        "CDF 9/7",
        (
            ("p", _ALPHA, _ALPHA),
            ("u", _BETA, _BETA),
            ("p", _GAMMA, _GAMMA),
            ("u", _DELTA, _DELTA),
        ),
        1.0 / _K97,
        _K97,
    ),
}

_ALIASES = {
    "haar": "Haar lifting",
    "haarlifting": "Haar lifting",
    "haar1": "Haar lifting",
    "cdf53": "CDF 5/3",
    "cdf5/3": "CDF 5/3",
    "cdf5.3": "CDF 5/3",
    "legall": "CDF 5/3",
    "legall53": "CDF 5/3",
    "cdf97": "CDF 9/7",
    "cdf9/7": "CDF 9/7",
    "cdf9.7": "CDF 9/7",
    "jpeg2000": "CDF 9/7",
}


def get_scheme(name) -> LiftingScheme:
    """Look up a lifting scheme by name or alias ('cdf97', 'legall', ...)."""
    if isinstance(name, LiftingScheme):
        return name
    if name in _SCHEMES:
        return _SCHEMES[name]
    key = str(name).lower().replace(" ", "").replace("_", "").replace("-", "")
    if key in _ALIASES:
        return _SCHEMES[_ALIASES[key]]
    raise JWaveNotKnown(
        f"unknown lifting scheme {name!r}; available: {sorted(_SCHEMES)} "
        f"or aliases like 'cdf97', 'cdf53', 'legall', 'haar'"
    )


def lifting_schemes() -> tuple:
    """Names of the registered lifting schemes."""
    return tuple(sorted(_SCHEMES))


_BOUNDARIES = ("periodic", "symmetric")


def _next(a, boundary: str):
    """a[n+1]: periodic wrap, or clamp (== whole-sample symmetric
    extension of the underlying signal)."""
    if boundary == "periodic":
        return torch.roll(a, -1, dims=-1)
    return torch.cat([a[..., 1:], a[..., -1:]], dim=-1)


def _prev(a, boundary: str):
    """a[n-1]: periodic wrap or clamp."""
    if boundary == "periodic":
        return torch.roll(a, 1, dims=-1)
    return torch.cat([a[..., :1], a[..., :-1]], dim=-1)


def _check_boundary(boundary: str, who: str):
    if boundary not in _BOUNDARIES:
        raise JWaveFailure(f"{who} - unknown boundary {boundary!r}; choose from {_BOUNDARIES}")


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """Half-precision levels compute in float32 and store in their dtype."""
    return torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype


def _analyze(x, sch: LiftingScheme, boundary: str):
    """One analysis level on the full (even) last axis -> (a, d)."""
    s = x[..., 0::2].to(_compute_dtype(x))
    d = x[..., 1::2].to(s.dtype)
    for kind, c0, c1 in sch.steps:
        if kind == "p":
            d = d + c0 * s + (c1 * _next(s, boundary) if c1 else 0.0)
        else:
            s = s + c0 * d + (c1 * _prev(d, boundary) if c1 else 0.0)
    return (sch.k_s * s).to(x.dtype), (sch.k_d * d).to(x.dtype)


def _synthesize(a, d, sch: LiftingScheme, boundary: str):
    """Exact inverse of _analyze: unscale, undo steps in reverse, merge.

    Structurally perfect reconstruction for EITHER boundary: the inverse
    subtracts the identical (boundary-matched) predictions/updates."""
    dtype = torch.promote_types(a.dtype, d.dtype)
    s = a.to(_compute_dtype(a)) / sch.k_s
    d = d.to(s.dtype) / sch.k_d
    for kind, c0, c1 in reversed(sch.steps):
        if kind == "p":
            d = d - c0 * s - (c1 * _next(s, boundary) if c1 else 0.0)
        else:
            s = s - c0 * d - (c1 * _prev(d, boundary) if c1 else 0.0)
    out = torch.stack([s, d], dim=-1).to(dtype)
    return out.reshape(out.shape[:-2] + (2 * s.shape[-1],))


def lifting_dwt(x, scheme="CDF 9/7", boundary: str = "periodic"):
    """Single-level lifting analysis along the last axis -> (approx, detail).

    The last axis must be even; leading axes are batch dimensions.
    ``boundary='symmetric'`` gives JPEG2000's whole-sample symmetric
    extension (in lifting form, edge-clamped neighbor access — bit-exactly
    equal to running periodic lifting on the length-(2N-2) extension).
    """
    sch = get_scheme(scheme)
    _check_boundary(boundary, "lifting_dwt")
    x = ensure_float(as_tensor(x))
    n = x.shape[-1]
    if n < 2 or n % 2:
        raise JWaveFailure(f"lifting_dwt - last-axis length {n} must be even and >= 2")
    return _analyze(x, sch, boundary)


def lifting_idwt(approx, detail, scheme="CDF 9/7", boundary: str = "periodic"):
    """Exact single-level lifting synthesis: inverse of lifting_dwt."""
    sch = get_scheme(scheme)
    _check_boundary(boundary, "lifting_idwt")
    a = ensure_float(as_tensor(approx))
    d = ensure_float(as_tensor(detail))
    if a.shape != d.shape:
        raise JWaveFailure(
            f"lifting_idwt - approx {a.shape} and detail {d.shape} shapes differ"
        )
    return _synthesize(a, d, sch, boundary)


def _check_pow2(n: int, who: str):
    if not is_power_of_two(n):
        raise JWaveFailure(
            f"{who} - given last-axis length {n} is not 2^p; "
            "use the Ancient Egyptian Decomposition for arbitrary lengths"
        )


def _levels_for(n: int, level: int | None, who: str) -> int:
    steps = exponent_of_two(n)
    if level is None:
        level = steps
    if level < 0 or level > steps:
        raise JWaveFailure(f"{who} - level {level} out of range [0, {steps}]")
    return level


def lifting_fwt(x, scheme="CDF 9/7", level: int | None = None, boundary: str = "periodic"):
    """Multi-level lifting FWT along the last axis (length 2^p), batched.

    Produces the same in-place pyramid layout as transforms/fwt.py
    ([A_L | D_L | ... | D_1], FastWaveletTransform.java:71-101), so every
    consumer of FWT output (compression, 2D/3D drivers, decompose bundles)
    works on lifting coefficients unchanged.
    """
    sch = get_scheme(scheme)
    _check_boundary(boundary, "lifting_fwt")
    x = ensure_float(as_tensor(x))
    n = x.shape[-1]
    _check_pow2(n, "lifting_fwt")
    level = _levels_for(n, level, "lifting_fwt")
    h = n
    l = 0
    while h >= 2 and l < level:
        a, d = _analyze(x[..., :h], sch, boundary)
        head = torch.cat([a, d], dim=-1)
        x = torch.cat([head, x[..., h:]], dim=-1) if h < n else head
        h >>= 1
        l += 1
    return x


def lifting_ifwt(y, scheme="CDF 9/7", level: int | None = None, boundary: str = "periodic"):
    """Inverse multi-level lifting FWT (exact reconstruction)."""
    sch = get_scheme(scheme)
    _check_boundary(boundary, "lifting_ifwt")
    y = ensure_float(as_tensor(y))
    n = y.shape[-1]
    _check_pow2(n, "lifting_ifwt")
    level = _levels_for(n, level, "lifting_ifwt")
    steps = exponent_of_two(n)
    levels_done = min(level, steps)
    if levels_done == 0:
        return y
    h = n >> (levels_done - 1)
    while h <= n:
        half = h >> 1
        head = _synthesize(y[..., :half], y[..., half:h], sch, boundary)
        y = torch.cat([head, y[..., h:]], dim=-1) if h < n else head
        h <<= 1
    return y
