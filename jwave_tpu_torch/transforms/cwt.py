"""Continuous Wavelet Transform, batched over scales (and leading dims).

Reference: jwave/transforms/ContinuousWaveletTransform.java. The FFT path
(:183-229) computes one signal FFT and, per scale, multiplies by the
conjugated wavelet spectrum and inverse-transforms; here the whole scale
loop is one batched product and one batched inverse FFT over a
(scales, freq) grid. The direct path (:240-260) is kept for parity as
per-scale correlation kernels over the wavelet's effective support.

The host builds each filter bank in float64 on the signal's device and casts
it to the signal's complex dtype before the product: a float32 signal gives
complex64 coefficients, a float64 signal complex128. The bank and the other
constants of a call (scales, and for ``ssq_cwt`` its bin grid and weights)
stay on the device in a small LRU cache (:func:`_device_constants`), so a
warm call builds nothing on the host and uploads nothing.
"""
from __future__ import annotations

import inspect
import math
import warnings
from collections import OrderedDict
from dataclasses import dataclass
from enum import Enum
from typing import NamedTuple

import numpy as np
import torch

from ..cwavelets import ContinuousWavelet, get_continuous_wavelet
from ..ops.butterfly import ensure_fft_float
from ..ops.circular import _conv_valid_bank
from ..utils.host import as_tensor, host_array
from ..utils.numerics import next_power_of_two
from ..utils.profiling import count, count_upload, span, spanned
from .fft import fft as _fft_any, ifft as _ifft_any


class PaddingType(Enum):
    """Boundary handling (ContinuousWaveletTransform.java:74-79)."""

    ZERO = "zero"
    SYMMETRIC = "symmetric"
    PERIODIC = "periodic"
    CONSTANT = "constant"


@dataclass
class CWTResult:
    """CWT output (reference CWTResult.java). ``coefficients`` has shape
    (..., n_scales, n_time), complex."""

    coefficients: torch.Tensor
    scales: torch.Tensor
    time_axis: torch.Tensor
    sampling_rate: float
    wavelet_name: str

    def magnitude(self):
        """|W(a, b)| (CWTResult.java:getMagnitude)."""
        return torch.abs(self.coefficients)

    def phase(self):
        """Phase in radians (CWTResult.java:getPhase)."""
        return torch.angle(self.coefficients)

    def real(self):
        return self.coefficients.real

    def imaginary(self):
        return self.coefficients.imag

    def scalogram(self):
        """Per-scale energy sum_t |W|^2 (CWTResult.java:getScalogram)."""
        m = torch.abs(self.coefficients)
        return torch.sum(m * m, dim=-1)

    def scale_to_frequency(self, center_freq: float):
        """f_a = fc * fs / a (CWTResult.java:scaleToFrequency)."""
        return center_freq * self.sampling_rate / self.scales

    def coefficients_at_scale(self, scale_index: int):
        """Coefficient row for one scale (CWTResult.java:205-210)."""
        if not 0 <= scale_index < self.n_scales:
            raise IndexError(f"scale index {scale_index} out of bounds [0, {self.n_scales})")
        return self.coefficients[..., scale_index, :]

    def coefficients_at_time(self, time_index: int):
        """Per-scale coefficient column at one time point (CWTResult.java:218-228)."""
        if not 0 <= time_index < self.n_time:
            raise IndexError(f"time index {time_index} out of bounds [0, {self.n_time})")
        return self.coefficients[..., :, time_index]

    @property
    def n_scales(self) -> int:
        return self.coefficients.shape[-2]

    @property
    def n_time(self) -> int:
        return self.coefficients.shape[-1]


def _check_scale_range(min_scale: float, max_scale: float, num: int):
    if min_scale <= 0 or max_scale <= 0:
        raise ValueError("Scales must be positive")
    if min_scale >= max_scale:
        raise ValueError("min_scale must be less than max_scale")
    if num < 2:
        raise ValueError("Need at least 2 scales")


def generate_log_scales(min_scale: float, max_scale: float, num: int) -> np.ndarray:
    """Logarithmically spaced scales (ContinuousWaveletTransform.java:355-380)."""
    _check_scale_range(min_scale, max_scale, num)
    return np.exp(np.linspace(math.log(min_scale), math.log(max_scale), num))


def generate_linear_scales(min_scale: float, max_scale: float, num: int) -> np.ndarray:
    """Linearly spaced scales (ContinuousWaveletTransform.java:385-405)."""
    _check_scale_range(min_scale, max_scale, num)
    return np.linspace(min_scale, max_scale, num)


def pad_signal(x: torch.Tensor, target: int, padding: PaddingType) -> torch.Tensor:
    """Extend the last axis to ``target`` samples (:269-306)."""
    n = x.shape[-1]
    if target <= n:
        return x[..., :target]
    extra = target - n
    if padding is PaddingType.ZERO:
        tail = torch.zeros(x.shape[:-1] + (extra,), dtype=x.dtype, device=x.device)
    elif padding is PaddingType.CONSTANT:
        tail = x[..., n - 1:].expand(x.shape[:-1] + (extra,))
    elif padding is PaddingType.PERIODIC:
        reps = -(-extra // n)
        tail = torch.cat([x] * reps, dim=-1)[..., :extra]
    elif padding is PaddingType.SYMMETRIC:
        # reference mirror: padded[i] = signal[2N - i - 2] while in range,
        # zero beyond (ContinuousWaveletTransform.java:283-291)
        # (indices made where x lies: no copy from the host)
        idx = 2 * n - 2 - torch.arange(n, target, device=x.device)
        tail = torch.where(idx >= 0, x[..., idx.clamp(min=0)], 0.0).to(x.dtype)
    else:
        raise ValueError(f"unknown padding {padding}")
    return torch.cat([x, tail], dim=-1)


def _omega_axis(padded: int, fs: float) -> np.ndarray:
    """Angular frequency axis with negative-frequency fold; index P/2 stays
    positive exactly as the reference builds it (:450-459)."""
    i = np.arange(padded, dtype=np.float64)
    omega = 2.0 * np.pi * i * fs / padded
    omega[i > padded // 2] -= 2.0 * np.pi * fs
    return omega


def _scaled_bank(wav: ContinuousWavelet, scales: np.ndarray, omega: np.ndarray,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """(S, P) ``psi_hat_scaled`` of every scale, in float64 on ``device``, and
    the omega axis there."""
    om = count_upload(torch.as_tensor(omega, dtype=torch.float64, device=device))
    a = count_upload(torch.as_tensor(scales, dtype=torch.float64, device=device))[:, None]
    return wav.psi_hat_scaled(om[None, :], a), om


#: the device constants of recent calls, least recently used first
_CONSTANTS: OrderedDict = OrderedDict()
#: entries kept: an ``ssq_cwt`` entry at 2^20 samples and 64 scales holds a
#: 1 GiB bank, and a caller rarely alternates between more grids than this
CONSTANTS_MAX = 4


def _wavelet_key(wav: ContinuousWavelet) -> tuple:
    """A hashable key of a wavelet by value: its class and every attribute
    (Morlet's ``fb`` and ``fc``, Paul's ``m``, ...), arrays by their bytes, so
    that two wavelets share constants only where every parameter agrees."""
    def coerce(v):
        if isinstance(v, (bool, int, float, complex, str)):
            return v
        if isinstance(v, (np.ndarray, np.generic)):
            a = np.asarray(v)
            return ("nd", a.dtype.str, a.shape, a.tobytes())
        return repr(v)

    return (type(wav).__name__,) + tuple(sorted((k, coerce(v)) for k, v in vars(wav).items()))


def _device_constants(kind: str, key: tuple, build):
    """The constants of ``key`` from the cache, or ``build()`` on a miss (which
    counts ``<kind>.constant_builds``); at most :data:`CONSTANTS_MAX` entries,
    the least recently used dropped first. Span ``<kind>.constants`` with
    ``hit`` 0 or 1. ``key`` holds everything the constants depend on."""
    hit = _CONSTANTS.get(key)
    with span(f"{kind}.constants", hit=int(hit is not None)):
        if hit is not None:
            _CONSTANTS.move_to_end(key)
            return hit
        value = _CONSTANTS[key] = build()
        count(f"{kind}.constant_builds")
        while len(_CONSTANTS) > CONSTANTS_MAX:
            _CONSTANTS.popitem(last=False)
        return value


class _CWTConstants(NamedTuple):
    bank: torch.Tensor  # (S, P) conj(psi_hat_scaled), the spectrum's complex dtype
    scales: torch.Tensor  # (S,) float64


def _cwt_constants(wav: ContinuousWavelet, scales: np.ndarray, padded: int, fs: float,
                   cdtype: torch.dtype, device) -> _CWTConstants:
    def build():
        bank, _ = _scaled_bank(wav, scales, _omega_axis(padded, fs), device)
        return _CWTConstants(torch.conj(bank).to(cdtype),
                             count_upload(torch.as_tensor(scales, device=device)))

    key = ("cwt", _wavelet_key(wav), scales.tobytes(), padded, fs, cdtype, torch.device(device))
    return _device_constants("cwt", key, build)


def _time_axis(n: int, fs: float, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=like.real.dtype, device=like.device) / fs


def _signal(signal) -> torch.Tensor:
    """The signal as a floating tensor the FFT takes: integers become the
    default float, bfloat16 and float16 become float32."""
    return ensure_fft_float(as_tensor(signal))


@spanned("cwt")
def cwt(
    signal,
    scales,
    wavelet: ContinuousWavelet | str = "morlet",
    sampling_rate: float = 1.0,
    padding: PaddingType = PaddingType.SYMMETRIC,
) -> CWTResult:
    """FFT-based CWT (ContinuousWaveletTransform.java:183-229, :511-565),
    batched over the leading dims of ``signal``; the scales are one tensor
    axis of a single product and inverse FFT."""
    wav = get_continuous_wavelet(wavelet)
    scales = np.atleast_1d(host_array(scales, np.float64))
    signal = _signal(signal)
    n = signal.shape[-1]
    padded_len = next_power_of_two(n)
    cdtype = torch.promote_types(signal.dtype, torch.complex64)  # the spectrum's
    if scales.size == 0:  # no FFT of an empty batch: (..., 0, N) in the usual dtype
        res = torch.empty(signal.shape[:-1] + (0, n), dtype=cdtype, device=signal.device)
        return CWTResult(res, torch.as_tensor(scales, device=signal.device),
                         _time_axis(n, sampling_rate, res), float(sampling_rate), wav.name)
    # conj(F[psi_a])(w) = conj(sqrt(a) * psi_hat(a*w)) per scale
    consts = _cwt_constants(wav, scales, padded_len, float(sampling_rate), cdtype,
                            signal.device)
    sig_fft = _fft_any(pad_signal(signal, padded_len, padding))  # (..., P)
    res = _ifft_any(sig_fft[..., None, :] * consts.bank)[..., :n]  # (..., S, N)
    return CWTResult(res, consts.scales.clone(), _time_axis(n, sampling_rate, res),
                     float(sampling_rate), wav.name)


def cwt_direct(
    signal,
    scales,
    wavelet: ContinuousWavelet | str = "morlet",
    sampling_rate: float = 1.0,
) -> CWTResult:
    """Direct-convolution CWT (ContinuousWaveletTransform.java:146-172,
    :240-260): coefficients[a][t] = dt * sum_{i in support} x[i] *
    conj(psi((i-t)dt/a))/sqrt(a), with index clamping at the signal edges
    (== zero padding). Per-scale kernels span the wavelet's effective support.
    """
    wav = get_continuous_wavelet(wavelet)
    scales = np.atleast_1d(host_array(scales, np.float64))
    signal = _signal(signal)
    n = signal.shape[-1]
    fs = float(sampling_rate)
    dt = 1.0 / fs
    sup_lo, sup_hi = wav.effective_support()
    lead = signal.shape[:-1]
    flat = signal.reshape((-1, n))

    # Scales are bucketed by support length (next power of two): each bucket
    # zero-pads its kernels to one shared window and runs ONE conv with a
    # 2*S_b-channel kernel bank (real rows, then imaginary rows).
    windows = []
    for si, a in enumerate(scales):
        lo = max(int(sup_lo * a * fs), -(n - 1))
        hi = min(int(sup_hi * a * fs), n - 1)
        windows.append((si, float(a), lo, hi))
    buckets: dict[int, list] = {}
    for w in windows:
        buckets.setdefault(1 << int(w[3] - w[2]).bit_length(), []).append(w)

    rows: list = [None] * len(scales)
    for group in buckets.values():
        lo_b = min(w[2] for w in group)
        hi_b = max(w[3] for w in group)
        bank = np.zeros((2 * len(group), hi_b - lo_b + 1))
        for r, (si, a, lo, hi) in enumerate(group):
            offsets = np.arange(lo, hi + 1)  # i - t
            psi = wav.psi(torch.as_tensor(offsets * dt / a, dtype=torch.float64)).numpy()
            k = np.conj(psi) / math.sqrt(a) * dt
            bank[r, lo - lo_b: hi - lo_b + 1] = k.real
            bank[len(group) + r, lo - lo_b: hi - lo_b + 1] = k.imag
        # coef[t] = sum_d bank[d] * x[t + lo_b + d] with zero padding at the
        # signal edges (== the reference's index clamping)
        padded = torch.nn.functional.pad(flat, (max(0, -lo_b), max(0, hi_b)))
        start = max(lo_b, 0)  # correlation output offset of coefficient t=0
        cc = _conv_valid_bank(padded, bank, padded.dtype)[:, :, start: start + n]
        for r, (si, _a, _lo, _hi) in enumerate(group):
            rows[si] = torch.complex(cc[:, r], cc[:, len(group) + r]).reshape(lead + (n,))
    res = torch.stack(rows, dim=-2)
    return CWTResult(res, torch.as_tensor(scales, device=signal.device),
                     _time_axis(n, fs, res), fs, wav.name)


def _resolve_wavelet_by_name(name: str, caller: str) -> ContinuousWavelet:
    """Rebuild a wavelet from a result's stored display name, warning when
    that loses constructor parameters (Paul(m), DOG(n, sigma), Morlet(fb,
    fc), MexicanHat(sigma) are rebuilt with their defaults)."""
    try:
        wav = get_continuous_wavelet(name)
    except Exception:
        wav = get_continuous_wavelet(name.split(" ")[0])
    ctor_params = [
        p for p in inspect.signature(type(wav).__init__).parameters.values()
        if p.name != "self" and p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
    ]
    if ctor_params:
        warnings.warn(
            f"{caller}: reconstructing wavelet {name!r} by name uses "
            "default parameters; pass the original wavelet object for exact "
            "inversion of parameterized wavelets (Paul(m), DOG(n, sigma), "
            "Morlet(fb, fc), MexicanHat(sigma))",
            stacklevel=3,
        )
    return wav


def icwt(result: CWTResult, wavelet: ContinuousWavelet | str | None = None, reg: float = 1e-10):
    """Approximate inverse CWT (the reference raises,
    ContinuousWaveletTransform.java:128-132): per-frequency least squares
    over the scale bank,

        X(w) = sum_a psi_hat_a(w) * W_a_hat(w) / (sum_a |psi_hat_a(w)|^2 + reg),

    with each bin pooled with its mirror (a real signal's X(-w) =
    conj(X(w)); analytic wavelets cover positive frequencies only).
    """
    if wavelet is None:
        wav = _resolve_wavelet_by_name(result.wavelet_name, caller="icwt")
    else:
        wav = get_continuous_wavelet(wavelet)
    coeffs = result.coefficients  # (..., S, N)
    n = coeffs.shape[-1]
    bank, _ = _scaled_bank(wav, np.asarray(result.scales.cpu(), dtype=np.float64),
                           _omega_axis(n, result.sampling_rate), coeffs.device)
    w_hat = bank.to(coeffs.dtype)  # (S, N)
    num = torch.sum(w_hat * _fft_any(coeffs), dim=-2)
    den = torch.sum(torch.abs(w_hat) ** 2, dim=0)
    mirror = torch.as_tensor((-np.arange(n)) % n, device=coeffs.device)
    num_h = num + torch.conj(num[..., mirror])
    den_h = den + den[mirror]
    return _ifft_any(num_h / (den_h + reg)).real


def cwt_chunked(
    signal,
    scales,
    wavelet: ContinuousWavelet | str = "morlet",
    sampling_rate: float = 1.0,
    padding: PaddingType = PaddingType.SYMMETRIC,
    scale_chunk: int = 64,
) -> CWTResult:
    """Memory-bounded CWT: scales processed in chunks of ``scale_chunk``, so
    the live (scales, padded_len) grid holds at most that many rows."""
    scales = np.atleast_1d(host_array(scales, np.float64))
    signal = _signal(signal)
    parts = [cwt(signal, scales[start: start + scale_chunk], wavelet, sampling_rate,
                 padding).coefficients
             for start in range(0, scales.shape[0], scale_chunk)]
    coeffs = torch.cat(parts, dim=-2)
    wav = get_continuous_wavelet(wavelet)
    return CWTResult(coeffs, torch.as_tensor(scales, device=signal.device),
                     _time_axis(signal.shape[-1], sampling_rate, coeffs),
                     float(sampling_rate), wav.name)


# --------------------------------------------------------------------------
# Cross-wavelet transform and wavelet coherence
# --------------------------------------------------------------------------

def xwt(signal_a, signal_b, scales, wavelet: ContinuousWavelet | str = "morlet",
        sampling_rate: float = 1.0, padding: PaddingType = PaddingType.SYMMETRIC) -> CWTResult:
    """Cross-wavelet transform W_a * conj(W_b) (Torrence & Compo 1998):
    magnitude = common power per (scale, time), phase = local phase
    difference; batched over leading axes."""
    ra = cwt(signal_a, scales, wavelet, sampling_rate, padding)
    rb = cwt(signal_b, scales, wavelet, sampling_rate, padding)
    cross = ra.coefficients * torch.conj(rb.coefficients)
    return CWTResult(cross, ra.scales, ra.time_axis, ra.sampling_rate, ra.wavelet_name)


def _smooth_time_scale(power: torch.Tensor, scales: np.ndarray, dt: float, boxcar: int = 3):
    """Torrence-Compo smoothing: Gaussian in time with std = scale/dt per
    scale row, then an edge-replicated boxcar over adjacent scales. The time
    part is an FFT product (circular, adequate away from the cone of
    influence); ``power`` may be complex (the operator is linear)."""
    n = power.shape[-1]
    pad = int(next_power_of_two(2 * n))
    dev = power.device
    fr = torch.as_tensor(np.fft.fftfreq(pad), device=dev)  # cycles/sample
    sig = torch.as_tensor(np.atleast_1d(host_array(scales, np.float64)) / dt,
                          device=dev)[:, None]
    ker = torch.exp(-0.5 * (sig * (2 * np.pi * fr[None, :])) ** 2)
    spec = _fft_any(torch.nn.functional.pad(power, (0, pad - n)))
    sm = _ifft_any(spec * ker.to(spec.dtype))[..., :n]
    sm = sm if power.is_complex() else sm.real
    if boxcar > 1:
        sm = torch.movedim(sm, -2, -1)
        pad_s = (boxcar - 1) // 2
        ext = torch.cat([sm[..., :1]] * pad_s + [sm] + [sm[..., -1:]] * (boxcar - 1 - pad_s),
                        dim=-1)
        c = torch.cumsum(torch.cat([torch.zeros_like(ext[..., :1]), ext], dim=-1), dim=-1)
        sm = (c[..., boxcar:] - c[..., :-boxcar]) / boxcar
        sm = torch.movedim(sm, -1, -2)
    return sm


def wavelet_coherence(signal_a, signal_b, scales,
                      wavelet: ContinuousWavelet | str = "morlet",
                      sampling_rate: float = 1.0,
                      padding: PaddingType = PaddingType.SYMMETRIC,
                      boxcar: int = 3):
    """Wavelet coherence R^2 in [0, 1] per (scale, time) (Torrence & Webster
    1999): |S(W_ab / s)|^2 / (S(|W_a|^2 / s) * S(|W_b|^2 / s)) with the
    time-Gaussian + scale-boxcar smoothing S. Returns (R2, xwt_result)."""
    scales = np.atleast_1d(host_array(scales, np.float64))
    ra = cwt(signal_a, scales, wavelet, sampling_rate, padding)
    rb = cwt(signal_b, scales, wavelet, sampling_rate, padding)
    cross = ra.coefficients * torch.conj(rb.coefficients)
    s = ra.scales[:, None].to(cross.real.dtype)
    dt = 1.0 / float(sampling_rate)

    def sm(p):
        return _smooth_time_scale(p, scales, dt, boxcar)

    num = sm(cross / s)  # complex: one smoothing pass for both parts
    den = sm(torch.abs(ra.coefficients) ** 2 / s) * sm(torch.abs(rb.coefficients) ** 2 / s)
    r2 = (num.real ** 2 + num.imag ** 2) / torch.clamp(den, min=1e-30)
    r2 = torch.clamp(r2, 0.0, 1.0)
    xr = CWTResult(cross, ra.scales, ra.time_axis, ra.sampling_rate, ra.wavelet_name)
    return r2, xr


__all__ = [
    "PaddingType", "CWTResult", "generate_log_scales", "generate_linear_scales",
    "pad_signal", "cwt", "cwt_direct", "icwt", "cwt_chunked", "xwt", "wavelet_coherence",
]
