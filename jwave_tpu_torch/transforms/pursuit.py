"""Matching pursuit (Mallat & Zhang 1993) over a multi-scale Gabor
dictionary.

Greedy sparse decomposition: pick the dictionary atom with the largest
projection energy against the residual and subtract the projection. The
search over all atoms at all circular shifts is one batched FFT
correlation ``ifft(fft(r) * conj(G_hat))`` against the stacked (P, N)
dictionary spectra, reduced by a flat argmax (the first maximum). Each
entry is a cosine/sine quadrature pair at one (scale, frequency); the pick
maximizes the residual's projection energy onto the pair's span through the
2x2 Gram inverse, and the whole projection is removed. Atoms are periodized
on the N-grid.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..exceptions import JWaveFailure
from ..utils.host import as_tensor
from .analytic import real_signal


@dataclass(frozen=True, eq=False)
class GaborDictionary:
    """Periodized quadrature-pair dictionary on an N-grid, float64 numpy.

    ``cos_atoms``/``sin_atoms``: (P, N) unit-norm waveforms centered at
    sample 0 (the sine partner of a pure Gaussian is all zero). ``cross``:
    (P,) inner products <g_cos, g_sin>. ``scale``/``freq``: (P,) Gaussian
    width (samples) and frequency (cycles/sample).
    """

    cos_atoms: np.ndarray
    sin_atoms: np.ndarray
    cross: np.ndarray
    scale: np.ndarray
    freq: np.ndarray


_DICT_CACHE: OrderedDict = OrderedDict()
_DICT_CACHE_MAX = 4  # entries are large (hundreds of MB at N ~ 4096)


def gabor_dictionary(n: int, scales=None, freqs_per_scale: int | None = None) -> GaborDictionary:
    """Multi-scale Gabor dictionary: dyadic Gaussian widths from 4 samples up
    to N/2, each with quadrature pairs on a frequency grid of spacing
    ``1/(2 s)``, plus the bare Gaussian (freq 0) per scale;
    ``freqs_per_scale`` takes a fixed-count linear grid instead."""
    key = (n, None if scales is None else tuple(scales), freqs_per_scale)
    if key in _DICT_CACHE:
        _DICT_CACHE.move_to_end(key)
        return _DICT_CACHE[key]
    if scales is None:
        scales, s = [], 4
        while s <= n // 2:
            scales.append(s)
            s *= 2
    scales = [int(s) for s in scales]
    if not scales:
        raise JWaveFailure(f"gabor_dictionary - no valid scales for N = {n}")
    t = np.arange(n, dtype=np.float64)
    d = (t + n // 2) % n - n // 2  # signed circular distance from 0
    gc, gs, sc, fr = [], [], [], []
    for s in scales:
        win = np.exp(-(d**2) / (2.0 * (s / 2.0) ** 2))
        gc.append(win / np.linalg.norm(win))
        gs.append(np.zeros(n))
        sc.append(s)
        fr.append(0.0)
        if freqs_per_scale is None:
            df = 1.0 / (2.0 * s)
            fgrid = np.arange(df, 0.5, df)
        else:
            fgrid = np.linspace(1.0 / (4.0 * s), 0.5, freqs_per_scale, endpoint=False)
        for f in fgrid:
            c = win * np.cos(2 * np.pi * f * d)
            q = win * np.sin(2 * np.pi * f * d)
            nc, nq = np.linalg.norm(c), np.linalg.norm(q)
            if nc < 1e-12 or nq < 1e-12:
                continue
            gc.append(c / nc)
            gs.append(q / nq)
            sc.append(s)
            fr.append(f)
    gc, gs = np.stack(gc), np.stack(gs)
    bank = GaborDictionary(gc, gs, np.sum(gc * gs, axis=-1),
                           np.asarray(sc, dtype=np.float64), np.asarray(fr, dtype=np.float64))
    _DICT_CACHE[key] = bank
    while len(_DICT_CACHE) > _DICT_CACHE_MAX:
        _DICT_CACHE.popitem(last=False)
    return bank


def _atoms_at(table: torch.Tensor, atom: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """table[atom] circularly shifted right by pos: (..., K) -> (..., K, N)."""
    n = table.shape[-1]
    idx = (torch.arange(n, device=table.device) - pos[..., None]) % n
    return torch.gather(table[atom], -1, idx)


@dataclass
class MPResult:
    """Matching-pursuit output. Per pick k (in extraction order):
    ``alphas``/``betas`` (..., K) the cosine/sine projection coefficients,
    ``atom_idx`` (..., K) the pair row, ``positions`` (..., K) the circular
    shift; ``residual`` (..., N); ``energies`` (..., K) the residual energy
    after each pick (non-increasing)."""

    alphas: torch.Tensor
    betas: torch.Tensor
    atom_idx: torch.Tensor
    positions: torch.Tensor
    residual: torch.Tensor
    energies: torch.Tensor
    dictionary: GaborDictionary

    @property
    def n_atoms(self) -> int:
        return self.alphas.shape[-1]

    @property
    def scale(self) -> np.ndarray:
        return self.dictionary.scale

    @property
    def freq(self) -> np.ndarray:
        return self.dictionary.freq

    @property
    def amplitudes(self):
        """Per-pick Gabor amplitude sqrt(alpha^2 + beta^2)."""
        return torch.sqrt(self.alphas**2 + self.betas**2)

    def reconstruct(self, k: int | None = None):
        """Sum of the first ``k`` extracted components (all by default)."""
        k = self.n_atoms if k is None else k
        r = self.residual
        cos_a = torch.as_tensor(self.dictionary.cos_atoms, dtype=r.dtype, device=r.device)
        sin_a = torch.as_tensor(self.dictionary.sin_atoms, dtype=r.dtype, device=r.device)
        a, p = self.atom_idx[..., :k], self.positions[..., :k]
        return torch.sum(self.alphas[..., :k, None] * _atoms_at(cos_a, a, p)
                         + self.betas[..., :k, None] * _atoms_at(sin_a, a, p), dim=-2)

    def atom_frequencies(self, sampling_rate: float = 1.0):
        """Per-pick carrier frequency (Hz for the given rate)."""
        freq = torch.as_tensor(self.freq, device=self.atom_idx.device)
        return freq[self.atom_idx] * sampling_rate


def matching_pursuit(
    signal,
    n_atoms: int = 32,
    dictionary: GaborDictionary | None = None,
    freqs_per_scale: int | None = None,
) -> MPResult:
    """Greedy phase-optimal Gabor decomposition of (..., N) real signals:
    ``n_atoms`` extraction steps over ``dictionary`` (default
    :func:`gabor_dictionary` on the signal length). ``result.reconstruct() +
    result.residual`` equals the input to rounding."""
    x = as_tensor(signal)
    if x.dim() == 0:
        raise JWaveFailure("matching_pursuit - signal must have at least 1 axis")
    x = real_signal(x, "matching_pursuit")
    n = x.shape[-1]
    if n < 16:
        raise JWaveFailure("matching_pursuit - need at least 16 samples")
    if n_atoms < 1:
        raise JWaveFailure("matching_pursuit - n_atoms must be >= 1")
    bank = dictionary if dictionary is not None else gabor_dictionary(
        n, freqs_per_scale=freqs_per_scale)
    if bank.cos_atoms.shape[-1] != n:
        raise JWaveFailure(
            f"matching_pursuit - dictionary grid {bank.cos_atoms.shape[-1]} "
            f"!= signal length {n}"
        )
    dt = x.dtype
    cos_a = torch.as_tensor(bank.cos_atoms, dtype=dt, device=x.device)  # (P, N)
    sin_a = torch.as_tensor(bank.sin_atoms, dtype=dt, device=x.device)
    cross_p = torch.as_tensor(bank.cross, dtype=dt, device=x.device)
    cross = cross_p[:, None]  # (P, 1)
    det = torch.clamp(1.0 - cross**2, min=1e-12)
    p_count = cos_a.shape[0]
    # both correlations are real (real residual, real atoms), so one complex
    # inverse FFT of the packed spectrum gives cc + i*cs
    pair_hat = torch.conj(torch.fft.fft(cos_a, dim=-1)) + 1j * torch.conj(torch.fft.fft(sin_a, dim=-1))

    r = x
    lead = x.shape[:-1]
    out = {k: [] for k in ("alpha", "beta", "atom", "pos", "energy")}
    for _ in range(n_atoms):
        z = torch.fft.ifft(torch.fft.fft(r, dim=-1)[..., None, :] * pair_hat, dim=-1)
        cc, cs = z.real, z.imag  # <r, gc shifted by p>, <r, gs shifted by p>
        # projection energy onto span{gc_p, gs_p}: c^T G^-1 c, G = [[1, x], [x, 1]]
        score = (cc**2 - 2.0 * cross * cc * cs + cs**2) / det
        pick = torch.argmax(score.reshape(lead + (p_count * n,)), dim=-1)
        a_star, p_star = pick // n, pick % n
        cc_k = torch.gather(cc.reshape(lead + (p_count * n,)), -1, pick[..., None])[..., 0]
        cs_k = torch.gather(cs.reshape(lead + (p_count * n,)), -1, pick[..., None])[..., 0]
        x_g = cross_p[a_star]
        d_k = torch.clamp(1.0 - x_g**2, min=1e-12)
        alpha = (cc_k - x_g * cs_k) / d_k
        beta = (cs_k - x_g * cc_k) / d_k
        r = (r - alpha[..., None] * _atoms_at(cos_a, a_star, p_star)
             - beta[..., None] * _atoms_at(sin_a, a_star, p_star))
        for key, v in (("alpha", alpha), ("beta", beta), ("atom", a_star), ("pos", p_star),
                       ("energy", torch.sum(r * r, dim=-1))):
            out[key].append(v)
    st = {k: torch.stack(v, dim=-1) for k, v in out.items()}
    return MPResult(st["alpha"], st["beta"], st["atom"], st["pos"], r, st["energy"], bank)
