"""Wavelet scattering transform (Mallat 2012; Andén & Mallat 2014; Bruna &
Mallat 2013 for images), order 2, in the spectral form.

The whole network is three rounds of batched power-of-two FFTs (cuFFT on a
card): the signal's spectrum times the first-order bank, ``|ifft|``, the
envelope spectra ``fft(U1)`` shared by the first-order lowpass and the
second-order bank, ``|ifft|`` again and the lowpass of ``fft(U2)``. This is
the JAX package's cross-validation route (``set_mxu_dft('off')``); its
default route reassociates the same linear maps onto matrix units and agrees
with it to ~1e-7 of the largest coefficient (a Gaussian-tail truncation).

Filters are Gaussian (log-)frequency bumps: ``psi_hat_xi(w) =
exp(-(w - xi)^2 / (2 sigma^2)) - kappa exp(-w^2 / (2 sigma^2))`` with the
Morlet zero-mean correction ``kappa`` (exactly zero DC response), and
``phi_hat(w) = exp(-w^2 / (2 sigma_J^2))`` with ``sigma_J`` proportional to
``2^-J``. Frequencies are in cycles/sample; the top center frequency is 0.35.

The banks, the rate and path tables and the output shapes are functions of
the geometry only, built in float64 numpy exactly as the JAX package builds
them. The device constants of a geometry (filters in the signal's complex
dtype, gather indices, the band order) are built once and cached per
``(geometry, dtype, device)``, so a warm call copies nothing from the host.
Each filter that precedes an inverse FFT carries that FFT's 1/m, and the
1/r of a periodization or a truncation, so the inverse FFTs run unscaled
(``norm="forward"``) and no pass over the data only scales it.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..exceptions import JWaveFailure
from ..ops.butterfly import ensure_fft_float
from ..utils.host import as_tensor
from ..utils.numerics import next_power_of_two
from .cwt import PaddingType, pad_signal

XI_MAX = 0.35  # top center frequency, cycles/sample (scattering convention)


def ifft_mag_two_real(Z: torch.Tensor, cdtype: torch.dtype) -> torch.Tensor:
    """|ifft(Z)| along the last axis as TWO real-input forward FFTs with the
    index reversal undone: |ifft(Z)[t]| = |fft(Re Z) + i fft(Im Z)|[-t] / m
    (bin -t == m - t for t >= 1, bin 0 fixed: a flip, then a roll by one)."""
    m = Z.shape[-1]
    A = torch.fft.fft(Z.real.to(cdtype))
    B = torch.fft.fft(Z.imag.to(cdtype))
    mag = torch.sqrt((A.real - B.imag) ** 2 + (A.imag + B.real) ** 2) / m
    return torch.roll(torch.flip(mag, (-1,)), 1, -1)


# --------------------------------------------------------------------------
# Filter-bank design (float64 numpy, a function of the geometry only)
# --------------------------------------------------------------------------

def _xi_grid(J: int, Q: int) -> np.ndarray:
    """Geometric center-frequency grid: Q wavelets per octave spanning J
    octaves below XI_MAX (J*Q + 1 filters, descending)."""
    j = np.arange(J * Q + 1, dtype=np.float64)
    return XI_MAX * 2.0 ** (-j / Q)


def _sigma_for(xi: np.ndarray, Q: int) -> np.ndarray:
    """Bandwidth of the Gaussian bump at center xi for quality factor Q:
    adjacent filters (ratio 2^(1/Q)) cross at half power at the arithmetic
    midpoint of their centers."""
    r = 2.0 ** (1.0 / Q)
    return xi * (1.0 - 1.0 / r) / (2.0 * math.sqrt(math.log(2.0)))


def _gauss_bump(freqs: np.ndarray, xi: float, sigma: float) -> np.ndarray:
    """Zero-mean Gaussian bump on the full FFT frequency axis (analytic: the
    DC-correction term keeps psi_hat(0) == 0 exactly)."""
    g = np.exp(-((freqs - xi) ** 2) / (2.0 * sigma**2))
    kappa = math.exp(-(xi**2) / (2.0 * sigma**2))
    return g - kappa * np.exp(-(freqs**2) / (2.0 * sigma**2))


def _sigma_phi(J: int) -> float:
    """Lowpass width: half power at the bottom of the J-octave ladder."""
    return XI_MAX * 2.0 ** (-float(J)) / math.sqrt(2.0 * math.log(2.0))


def _fold_freqs(m: int) -> np.ndarray:
    """FFT bin frequencies of an m-point grid, folded to [-0.5, 0.5)."""
    i = np.arange(m, dtype=np.float64)
    f = i / m
    f[i > m // 2] -= 1.0
    return f


@dataclass(frozen=True, eq=False)
class ScatteringBank:
    """Filter bank and path table for one (padded_len, J, Q1, Q2), float64."""

    psi1_hat: np.ndarray  # (K1, P)
    psi2_hat: np.ndarray  # (K2, P)
    phi_hat: np.ndarray  # (P,)
    xi1: np.ndarray  # (K1,) cycles/sample
    xi2: np.ndarray  # (K2,)
    paths: np.ndarray  # (P2, 2) int64 — (k1, k2) with xi2 < xi1


_BANK_CACHE: OrderedDict = OrderedDict()
_BANK_CACHE_MAX = 8  # float64 banks run to tens of MB each


def _cache_get(cache: OrderedDict, key):
    if key in cache:
        cache.move_to_end(key)
        return cache[key]
    return None


def _cache_put(cache: OrderedDict, key, value, limit: int):
    cache[key] = value
    while len(cache) > limit:
        cache.popitem(last=False)
    return value


def scattering_filter_bank(padded: int, J: int, Q1: int, Q2: int = 1) -> ScatteringBank:
    """Build (and cache) the frequency-domain bank on a ``padded``-point FFT
    grid; positive and negative bins are evaluated, so the bumps are analytic
    on the discrete grid."""
    key = (padded, J, Q1, Q2)
    hit = _cache_get(_BANK_CACHE, key)
    if hit is not None:
        return hit
    freqs = _fold_freqs(padded)
    xi1 = _xi_grid(J, Q1)
    s1 = _sigma_for(xi1, Q1)
    xi2 = _xi_grid(J, Q2)
    s2 = _sigma_for(xi2, Q2)
    psi1 = np.stack([_gauss_bump(freqs, x, s) for x, s in zip(xi1, s1)])
    psi2 = np.stack([_gauss_bump(freqs, x, s) for x, s in zip(xi2, s2)])
    phi = np.exp(-(freqs**2) / (2.0 * _sigma_phi(J) ** 2))
    # second-order paths: xi2 strictly below xi1 (the envelope |x * psi1| has
    # bandwidth ~ sigma1 < xi1; higher-frequency psi2 see ~no energy)
    paths = np.asarray(
        [(k1, k2) for k1 in range(len(xi1)) for k2 in range(len(xi2)) if xi2[k2] < xi1[k1]],
        dtype=np.int64,
    ).reshape(-1, 2)
    return _cache_put(_BANK_CACHE, key, ScatteringBank(psi1, psi2, phi, xi1, xi2, paths),
                      _BANK_CACHE_MAX)


def _gauss_bump_2d(fy, fx, xi: float, theta: float, sigma: float) -> np.ndarray:
    """Oriented zero-mean Gaussian bump centered at xi*(cos, sin) theta;
    ``fy``/``fx`` are meshgrid frequency planes in cycles/pixel."""
    cy, cx = xi * math.sin(theta), xi * math.cos(theta)
    g = np.exp(-((fx - cx) ** 2 + (fy - cy) ** 2) / (2.0 * sigma**2))
    kappa = math.exp(-(xi**2) / (2.0 * sigma**2))
    return g - kappa * np.exp(-(fx**2 + fy**2) / (2.0 * sigma**2))


@dataclass(frozen=True, eq=False)
class ScatteringBank2D:
    """2D filter bank and path table for one (Py, Px, J, L), float64."""

    psi_hat: np.ndarray  # (J*L, Py, Px) — scale-major: filter j*L + l
    phi_hat: np.ndarray  # (Py, Px)
    xi: np.ndarray  # (J,) center frequencies, cycles/pixel
    thetas: np.ndarray  # (L,)
    paths: np.ndarray  # (P2, 2) — (k1, k2) flat filter indices, j2 > j1


def scattering_filter_bank_2d(py: int, px: int, J: int, L: int) -> ScatteringBank2D:
    """Oriented Morlet-style bank on a (py, px) FFT grid: J dyadic scales x L
    orientations over the upper half-plane (the modulus makes the lower half
    redundant for real images)."""
    key = ("2d", py, px, J, L)
    hit = _cache_get(_BANK_CACHE, key)
    if hit is not None:
        return hit
    fy, fx = np.meshgrid(_fold_freqs(py), _fold_freqs(px), indexing="ij")
    xi = XI_MAX * 2.0 ** (-np.arange(J, dtype=np.float64))
    sig = _sigma_for(xi, 1)
    thetas = np.pi * np.arange(L, dtype=np.float64) / L
    psi = np.stack([_gauss_bump_2d(fy, fx, x, t, s) for x, s in zip(xi, sig) for t in thetas])
    phi = np.exp(-(fx**2 + fy**2) / (2.0 * _sigma_phi(J) ** 2))
    # frequency-decreasing paths: scale j2 strictly coarser than j1, all
    # orientation pairs (Bruna & Mallat 2013, section 3.1)
    paths = np.asarray(
        [(j1 * L + l1, j2 * L + l2)
         for j1 in range(J) for j2 in range(j1 + 1, J) for l1 in range(L) for l2 in range(L)],
        dtype=np.int64,
    ).reshape(-1, 2)
    return _cache_put(_BANK_CACHE, key, ScatteringBank2D(psi, phi, xi, thetas, paths),
                      _BANK_CACHE_MAX)


# --------------------------------------------------------------------------
# Result containers
# --------------------------------------------------------------------------

@dataclass
class ScatteringResult:
    """Order-0/1/2 scattering coefficients.

    ``S0``: (..., T) — lowpass average of the signal itself.
    ``S1``: (..., K1, T) — first-order bands, one per psi1 filter.
    ``S2``: (..., P2, T) — second-order bands, one per (k1, k2) path.
    ``T = ceil(N / 2^(J - oversampling))`` frames.
    """

    S0: torch.Tensor
    S1: torch.Tensor
    S2: torch.Tensor
    xi1: np.ndarray  # cycles/sample
    xi2: np.ndarray
    paths: np.ndarray  # (P2, 2) (k1, k2) indices into xi1/xi2
    sampling_rate: float

    @property
    def frequencies1(self) -> np.ndarray:
        """First-order center frequencies in Hz."""
        return self.xi1 * self.sampling_rate

    @property
    def n_paths(self) -> int:
        return int(self.paths.shape[0])

    def features(self) -> torch.Tensor:
        """All coefficients stacked on one band axis: (..., 1 + K1 + P2, T)."""
        return torch.cat([self.S0[..., None, :], self.S1, self.S2], dim=-2)


@dataclass
class Scattering2DResult:
    """2D scattering coefficients.

    ``S0``: (..., Ty, Tx); ``S1``: (..., J*L, Ty, Tx) scale-major;
    ``S2``: (..., P2, Ty, Tx) — path p is ``paths[p] = (k1, k2)`` flat filter
    indices (scale ``k // L``, orientation ``k % L``).
    """

    S0: torch.Tensor
    S1: torch.Tensor
    S2: torch.Tensor
    xi: np.ndarray
    thetas: np.ndarray
    paths: np.ndarray

    @property
    def n_orientations(self) -> int:
        return int(self.thetas.shape[0])

    @property
    def n_paths(self) -> int:
        return int(self.paths.shape[0])

    def features(self) -> torch.Tensor:
        """(..., 1 + J*L + P2, Ty, Tx) stacked band axis."""
        return torch.cat([self.S0[..., None, :, :], self.S1, self.S2], dim=-3)


# --------------------------------------------------------------------------
# Device constants of a geometry, built once per (geometry, dtype, device)
# --------------------------------------------------------------------------

def _complex_of(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


_CONST_CACHE: OrderedDict = OrderedDict()
_CONST_CACHE_MAX = 8  # as the bank cache: a 256^2 2D entry holds ~30 MB in f32


@dataclass(frozen=True, eq=False)
class _Order1Group:
    r: int  # decimation rate of the group's envelopes
    psi: torch.Tensor  # (Kg, padded) the group's psi1 rows / padded
    phi: torch.Tensor  # (padded / r,) the lowpass on the rate-r grid / (padded / r)


@dataclass(frozen=True, eq=False)
class _Order2Group:
    R: int  # rate of the group's paths
    sources: tuple  # (order-1 group index, rows of that group, truncation q) each
    psi: torch.Tensor  # (Pg, padded / R) psi2 of each path / (q padded / R), sources' order
    phi: torch.Tensor  # (padded / R,) / (padded / R)


@dataclass(frozen=True, eq=False)
class _Plan1D:
    bank: ScatteringBank
    padded: int
    stride: int
    phi: torch.Tensor  # (padded,) / padded
    order1: tuple  # _Order1Group each
    order2: tuple  # _Order2Group each
    inv1: torch.Tensor  # band order of the stacked S1 groups
    inv2: torch.Tensor | None  # of the stacked S2 groups; None without paths


def _rates(bank: ScatteringBank, Q: int, Q2: int, stride: int):
    """Per-filter order-1 rates r1 and per-path rates R (powers of two up to
    the stride), as the JAX package chooses them: a group is decimated while
    its fold boundary 1/(2r) stays above max(32 sigma1, xi2 + 8 sigma2 of the
    filter's highest path) (order 1), or above xi2 + 8 sigma2 (order 2).
    ``oversampling >= J`` makes every rate 1, the exact full-rate transform."""
    sig1 = _sigma_for(bank.xi1, Q)
    cut2 = bank.xi2 + 8.0 * _sigma_for(bank.xi2, Q2)

    def rate_for(cut: float) -> int:
        r = 1
        while r * 2 <= stride and 1.0 / (2.0 * r * 2) >= cut:
            r *= 2
        return r

    r1_of = np.ones(len(bank.xi1), dtype=np.int64)
    for k in range(len(bank.xi1)):
        pk2 = bank.paths[bank.paths[:, 0] == k, 1]
        need = max(cut2[pk2].max() if pk2.size else 0.0, 32.0 * sig1[k])
        r1_of[k] = rate_for(need)
    r_path = np.asarray(
        [max(rate_for(cut2[k2]), r1_of[k1]) for k1, k2 in bank.paths], dtype=np.int64,
    ) if len(bank.paths) else np.zeros(0, dtype=np.int64)
    return r1_of, r_path


def _plan_1d(n: int, J: int, Q: int, Q2: int, oversampling: int, dtype: torch.dtype,
             device: torch.device) -> _Plan1D:
    """The constants of one geometry for signals of real ``dtype``."""
    key = ("1d", n, J, Q, Q2, oversampling, dtype, device)
    hit = _cache_get(_CONST_CACHE, key)
    if hit is not None:
        return hit
    stride = 2 ** max(0, J - oversampling)
    padded = next_power_of_two(2 * n)
    bank = scattering_filter_bank(padded, J, Q, Q2)
    r1_of, r_path = _rates(bank, Q, Q2, stride)
    sig2 = _sigma_for(bank.xi2, Q2)
    sphi = _sigma_phi(J)

    def dev(a, dt=_complex_of(dtype)):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    def grid_freqs(r):
        """Frequency axis of the rate-r grid in ORIGINAL cycles/sample (one
        subsample is r samples, so sub-grid bin f' is f'/r): the bumps are
        evaluated there, never rescaled."""
        return _fold_freqs(padded // r) / r

    phis = {}

    def phi_on(r):
        if r not in phis:
            phis[r] = dev(np.exp(-(grid_freqs(r) ** 2) / (2.0 * sphi**2)) * r / padded)
        return phis[r]

    order1, s1_order, where = [], [], {}  # where: k1 -> (group index, row)
    for r in sorted(set(r1_of.tolist())):
        idxs = np.nonzero(r1_of == r)[0]
        for i, k1 in enumerate(idxs.tolist()):
            where[k1] = (len(order1), i, r)
        order1.append(_Order1Group(r, dev(bank.psi1_hat[idxs] / padded), phi_on(r)))
        s1_order.extend(idxs.tolist())

    order2, s2_order = [], []
    for R in sorted(set(r_path.tolist())):
        pidx = np.nonzero(r_path == R)[0]
        by_src: dict[int, list[int]] = {}
        for p in pidx.tolist():
            by_src.setdefault(where[int(bank.paths[p, 0])][0], []).append(p)
        sources, order, scale = [], [], []
        for g, plist in by_src.items():
            rows = [where[int(bank.paths[p, 0])][1] for p in plist]
            q = R // order1[g].r
            sources.append((g, dev(rows, torch.long), q))
            order.extend(plist)
            scale.extend([R / (q * padded)] * len(plist))
        fR = grid_freqs(R)
        psi2 = np.stack([_gauss_bump(fR, bank.xi2[k2], sig2[k2]) for k2 in bank.paths[order, 1]])
        order2.append(_Order2Group(R, tuple(sources), dev(psi2 * np.asarray(scale)[:, None]),
                                   phi_on(R)))
        s2_order.extend(order)

    inv2 = dev(np.argsort(np.asarray(s2_order)), torch.long) if s2_order else None
    plan = _Plan1D(bank, padded, stride, phi_on(1), tuple(order1), tuple(order2),
                   dev(np.argsort(np.asarray(s1_order)), torch.long), inv2)
    return _cache_put(_CONST_CACHE, key, plan, _CONST_CACHE_MAX)


@dataclass(frozen=True, eq=False)
class _Plan2D:
    bank: ScatteringBank2D
    py: int
    px: int
    stride: int
    psi: torch.Tensor  # (J*L, py, px) / (py px)
    phi: torch.Tensor  # (py, px) / (py px)
    k1_of_path: torch.Tensor  # (P2,)
    k2_of_path: torch.Tensor  # (P2,)


def _plan_2d(h: int, w: int, J: int, L: int, oversampling: int, dtype: torch.dtype,
             device: torch.device) -> _Plan2D:
    key = ("2d", h, w, J, L, oversampling, dtype, device)
    hit = _cache_get(_CONST_CACHE, key)
    if hit is not None:
        return hit
    py, px = next_power_of_two(2 * h), next_power_of_two(2 * w)
    bank = scattering_filter_bank_2d(py, px, J, L)

    def dev(a, dt=_complex_of(dtype)):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    plan = _Plan2D(bank, py, px, 2 ** max(0, J - oversampling), dev(bank.psi_hat / (py * px)),
                   dev(bank.phi_hat / (py * px)), dev(bank.paths[:, 0], torch.long),
                   dev(bank.paths[:, 1], torch.long))
    return _cache_put(_CONST_CACHE, key, plan, _CONST_CACHE_MAX)


# --------------------------------------------------------------------------
# Transforms
# --------------------------------------------------------------------------

def scattering1d(
    signal,
    J: int,
    Q: int = 8,
    sampling_rate: float = 1.0,
    Q2: int = 1,
    padding: PaddingType = PaddingType.SYMMETRIC,
    oversampling: int = 0,
) -> ScatteringResult:
    """Order-2 wavelet scattering of (..., N) real signals.

    Args:
      signal: (..., N); leading axes batch through every stage. numpy input
        goes to the card; a tensor is computed where it lies.
      J: invariance scale — outputs are averaged over ``2^J`` samples and
        subsampled by the same stride (reduce with ``oversampling``).
      Q: first-order wavelets per octave (8-16 for audio, 1 for dyadic).
      sampling_rate: only scales the reported ``frequencies1`` metadata.
      Q2: second-order wavelets per octave (1 is standard).
      padding: boundary handling, as :func:`jwave_tpu_torch.cwt`; the signal
        is extended to ``next_pow2(2 N)``.
      oversampling: subsample by ``2^(J - oversampling)`` instead of ``2^J``.

    Order 1 decimates each band by exact spectral periodization of
    ``X * psi1`` to its rate r1; order 2 truncates the envelope spectra to
    each path's rate R. Float64 input computes in float64; any other real
    input (half precision, integers) in float32.
    """
    x = as_tensor(signal)
    if x.ndim == 0:
        raise JWaveFailure("scattering1d - signal must have at least 1 axis")
    if x.is_complex():
        raise JWaveFailure("scattering1d - expected a real signal")
    x = ensure_fft_float(x)
    n = x.shape[-1]
    if n < 2:
        raise JWaveFailure("scattering1d - need at least 2 samples")
    if J < 1:
        raise JWaveFailure("scattering1d - J must be >= 1")
    if Q < 1 or Q2 < 1:
        raise JWaveFailure("scattering1d - Q and Q2 must be >= 1")
    if 2**J > n:
        raise JWaveFailure(f"scattering1d - invariance scale 2^{J} exceeds signal length {n}")

    plan = _plan_1d(n, J, Q, Q2, oversampling, x.dtype, x.device)
    padded, stride = plan.padded, plan.stride
    cdtype = _complex_of(x.dtype)

    def ifft(z):  # the filters carry the 1/m
        return torch.fft.ifft(z, norm="forward")

    def lowpass(spec, r, phi_r):
        """phi-filter an r-grid spectrum, crop the padding and subsample to
        the output frames (ceil(ceil(n/r)/(stride/r)) == ceil(n/stride))."""
        y = ifft(spec * phi_r).real
        return y[..., : -(-n // r)][..., :: stride // r]

    def truncate(V, q):
        """Ideal-lowpass decimation by q in the spectral domain: keep the
        lowest bins of each sign (the 1/q is in psi2)."""
        if q == 1:
            return V
        h = V.shape[-1] // (2 * q)
        return torch.cat([V[..., :h], V[..., V.shape[-1] - h:]], dim=-1)

    X = torch.fft.fft(pad_signal(x, padded, padding).to(cdtype))
    s0 = lowpass(X, 1, plan.phi).contiguous()

    s1_parts, v1 = [], []
    for g in plan.order1:
        prod = X[..., None, :] * g.psi
        if g.r > 1:  # spectral periodization onto the rate-r grid
            prod = prod.reshape(prod.shape[:-1] + (g.r, padded // g.r)).sum(-2)
        u1 = torch.abs(ifft(prod))
        V1 = torch.fft.fft(u1.to(cdtype))  # shared by S1 and order 2
        s1_parts.append(lowpass(V1, g.r, g.phi))
        v1.append(V1)

    s2_parts = []
    for g in plan.order2:
        Vp = torch.cat([truncate(v1[src], q).index_select(-2, rows)
                        for src, rows, q in g.sources], dim=-2)
        u2 = torch.abs(ifft(Vp * g.psi))
        s2_parts.append(lowpass(torch.fft.fft(u2.to(cdtype)), g.R, g.phi))

    s1 = torch.cat(s1_parts, dim=-2).index_select(-2, plan.inv1)
    if s2_parts:
        s2 = torch.cat(s2_parts, dim=-2).index_select(-2, plan.inv2)
    else:
        s2 = s1.new_zeros(s1.shape[:-2] + (0, s1.shape[-1]))
    bank = plan.bank
    return ScatteringResult(s0, s1, s2, bank.xi1, bank.xi2, bank.paths, float(sampling_rate))


def scattering2d(image, J: int, L: int = 8, oversampling: int = 0) -> Scattering2DResult:
    """Order-2 image scattering (Bruna & Mallat 2013) of (..., H, W) arrays.

    Args:
      image: real (..., H, W); leading axes batch. numpy input goes to the
        card; a tensor is computed where it lies.
      J: invariance scale — outputs average over ``2^J x 2^J`` windows and
        subsample by that stride.
      L: orientations over the half-plane (8 is standard).
      oversampling: subsample by ``2^(J - oversampling)`` instead.

    J*L oriented bumps applied as one batched 2D FFT product, the envelope
    spectra reused for the first-order lowpass and the second-order bank,
    every path gathered at once. Images mirror-extend to the next power of
    two per axis (reflection against wrap).
    """
    x = as_tensor(image)
    if x.ndim < 2:
        raise JWaveFailure("scattering2d - image must have at least 2 axes")
    if x.is_complex():
        raise JWaveFailure("scattering2d - expected a real image")
    x = ensure_fft_float(x)
    h, w = x.shape[-2:]
    if h < 2 or w < 2:
        raise JWaveFailure("scattering2d - need at least 2x2 pixels")
    if J < 1 or L < 1:
        raise JWaveFailure("scattering2d - J and L must be >= 1")
    if 2**J > min(h, w):
        raise JWaveFailure(
            f"scattering2d - invariance scale 2^{J} exceeds image extent {min(h, w)}")

    plan = _plan_2d(h, w, J, L, oversampling, x.dtype, x.device)
    stride = plan.stride
    cdtype = _complex_of(x.dtype)

    def mirror_extend(a, target, axis):
        a = a.transpose(axis, -1)
        ext = torch.cat([a, torch.flip(a, (-1,))], dim=-1)[..., :target]
        return pad_signal(ext, target, PaddingType.PERIODIC).transpose(axis, -1)

    def ifft2(z):  # the filters carry the 1/(py px)
        return torch.fft.ifft2(z, norm="forward")

    def lowpass(spec):
        y = ifft2(spec * plan.phi).real
        return y[..., :h, :w][..., ::stride, ::stride]

    xpad = mirror_extend(mirror_extend(x, plan.px, -1), plan.py, -2)
    X = torch.fft.fft2(xpad.to(cdtype))
    s0 = lowpass(X).contiguous()
    u1 = torch.abs(ifft2(X[..., None, :, :] * plan.psi))  # (..., J*L, Py, Px)
    V1 = torch.fft.fft2(u1.to(cdtype))
    s1 = lowpass(V1).contiguous()
    if plan.k1_of_path.numel():
        Vp = V1.index_select(-3, plan.k1_of_path)
        u2 = torch.abs(ifft2(Vp * plan.psi.index_select(0, plan.k2_of_path)))
        s2 = lowpass(torch.fft.fft2(u2.to(cdtype))).contiguous()
    else:  # J == 1: no path
        s2 = s1.new_zeros(s1.shape[:-3] + (0,) + s1.shape[-2:])
    bank = plan.bank
    return Scattering2DResult(s0, s1, s2, bank.xi, bank.thetas, bank.paths)
