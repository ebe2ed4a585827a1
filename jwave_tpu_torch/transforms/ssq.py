"""Synchrosqueezed CWT (Daubechies, Lu & Wu 2011).

The reference library has no time-frequency reassignment; this module is the
JAX package's ``transforms/ssq.py`` in PyTorch:

- The CWT and its exact time derivative come from ONE batched product: the
  filter bank ``[psi_hat(a w), i w psi_hat(a w)]`` is stacked on the scale
  axis, so one (2*scales, freq) multiply and one batched inverse FFT give
  both.
- The phase transform (instantaneous frequency) and the bin index are
  elementwise on the (scales, time) grid.
- The reassignment into log-spaced frequency bins is the K6 kernel
  (``ops/cuda_reassign.py``) on a card; see :func:`_squeeze_plane` for the
  routes.
- The working set is bounded: rows of the leading axes run in chunks whose
  peak (:func:`_row_bytes`) fits :data:`CHUNK_SHARE` of the device's memory,
  each writing its slice of one output. The bank, grids and weights stay on
  the device between calls (``cwt._device_constants``).

Reconstruction (``issq_cwt``) uses the one-integral formula
``x(b) = 2 Re[ (1/C) sum_k Tx(f_k, b) ]`` with the wavelet constant
``C = integral_0^inf conj(psi_hat(u))/u du`` computed numerically from the
same ``psi_hat`` the forward used, so the wavelet normalization quirks (the
reference's Morlet psi_hat scaling, MorletWavelet.java:114-124) cancel.

Synchrosqueezing needs an analytic wavelet (Morlet, Paul, Morse): the
instantaneous-frequency estimate Im[dW/W]/2pi of a real signal is only
meaningful when the wavelet suppresses negative frequencies.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..cwavelets import ContinuousWavelet, get_continuous_wavelet
from ..exceptions import JWaveFailure
from ..ops import cuda_reassign
from ..utils.host import host_array
from ..utils.numerics import next_power_of_two
from ..utils.profiling import count, count_upload, span, spanned
from .cwt import PaddingType, _device_constants, _omega_axis, _resolve_wavelet_by_name, \
    _scaled_bank, _signal, _time_axis, _wavelet_key, pad_signal
from .fft import fft as _fft_any, ifft as _ifft_any

REASSIGN_ROUTES = ("auto", "dense", "scatter", "pallas")

#: the share of the device's total memory that one chunk of ``ssq_cwt``'s
#: rows may take at its peak (:func:`_row_bytes`). The output, (..., K, N)
#: complex, is allocated once beside the chunks, and for a call that fills
#: the card it is the largest tensor (17.2 GB at 32 x 2^20 samples and 64
#: bins); a caller that pipelines its calls holds up to four such outputs at
#: once (the one being written, the previous one and two it keeps), 69 GB of
#: an 80 GB card, so a chunk keeps to an eighth. It is a share of the total
#: and never of the momentary free memory, so that a call's chunks do not
#: depend on what else happens to be allocated.
CHUNK_SHARE = 0.125


@dataclass
class SSQResult:
    """Synchrosqueezed-CWT output. ``Tx`` has shape (..., n_freqs, n_time),
    complex: the CWT energy of each time column reassigned onto the
    ``frequencies`` grid (Hz, increasing)."""

    Tx: torch.Tensor
    frequencies: torch.Tensor
    scales: torch.Tensor
    time_axis: torch.Tensor
    sampling_rate: float
    wavelet_name: str

    def magnitude(self):
        return torch.abs(self.Tx)

    def ridge(self):
        """Dominant instantaneous frequency per time step (Hz): the
        frequency bin with maximal |Tx| in each time column."""
        return self.frequencies[torch.argmax(torch.abs(self.Tx), dim=-2)]

    @property
    def n_freqs(self) -> int:
        return self.Tx.shape[-2]

    @property
    def n_time(self) -> int:
        return self.Tx.shape[-1]


def _log_measure(scales: np.ndarray) -> np.ndarray:
    """d(ln a) per scale for a monotone grid (central differences; exact for
    log-spaced grids): the measure of the one-integral inverse
    ``integral W(a,b) a^{-3/2} da = sum_j W_j a_j^{-1/2} dln(a_j)``."""
    v = np.log(scales)
    if v.shape[0] == 1:
        return np.ones(1)
    return np.abs(np.gradient(v))


_ONE_INTEGRAL_CACHE: dict = {}


def one_integral_constant(wavelet: ContinuousWavelet) -> complex:
    """``C = integral_0^inf conj(psi_hat(u))/u du`` evaluated numerically, in
    float64 on the CPU: with u = e^v it is a trapezoid over
    ``conj(psi_hat(e^v))`` on [1e-4, 50] x the wavelet's peak angular
    frequency. Cached per wavelet configuration."""
    key = (type(wavelet).__name__,
           tuple(sorted((k, v) for k, v in vars(wavelet).items()
                        if isinstance(v, (bool, int, float, str)))))
    hit = _ONE_INTEGRAL_CACHE.get(key)
    if hit is not None:
        return hit
    w_peak = 2.0 * math.pi * max(wavelet.center_frequency, 1e-3)
    v = np.linspace(math.log(w_peak * 1e-4), math.log(w_peak * 50.0), 4096)
    vals = torch.conj(wavelet.psi_hat(torch.as_tensor(np.exp(v)))).resolve_conj().numpy()
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    c = complex(trapezoid(vals, v))
    _ONE_INTEGRAL_CACHE[key] = c
    return c


def _log_uniform(freqs_np: np.ndarray):
    """(ln f_0, d ln f) of a log-uniform grid; None for any other grid."""
    log_f = np.log(freqs_np)
    diffs = np.diff(log_f)
    if np.allclose(diffs, diffs[0], rtol=1e-9, atol=0.0):
        return log_f[0], (log_f[-1] - log_f[0]) / (freqs_np.shape[0] - 1)
    return None


def _bin_edges(freqs_np: np.ndarray) -> np.ndarray:
    """K+1 edges of an increasing grid: the geometric midpoints between
    neighbouring bins, the outer two extrapolating the end spacings, so that
    indices keep the affine path's out-of-range convention (-1 below the
    grid, K above)."""
    log_f = np.log(freqs_np)
    diffs = np.diff(log_f)
    return np.exp(np.concatenate([
        [log_f[0] - diffs[0] / 2.0],
        (log_f[:-1] + log_f[1:]) / 2.0,
        [log_f[-1] + diffs[-1] / 2.0],
    ]))


def _bin_index(f_inst: torch.Tensor, freqs_np: np.ndarray, edges=None) -> torch.Tensor:
    """Nearest-bin index (in log-frequency distance) for positive ``f_inst``,
    int32. Log-uniform grids use the closed-form affine map; other increasing
    grids a search against :func:`_bin_edges` (``edges``, a tensor of them
    in ``f_inst``'s dtype on its device, where the caller holds one). Both
    round half to even and search on the left side, as the JAX package
    does. The caller masks non-positive frequencies first."""
    affine = _log_uniform(freqs_np)
    if affine is not None:
        log_f0, dlf = affine
        return torch.round((torch.log(f_inst) - log_f0) / dlf).to(torch.int32)
    if edges is None:
        edges = torch.as_tensor(_bin_edges(freqs_np), dtype=f_inst.dtype, device=f_inst.device)
    return (torch.searchsorted(edges, f_inst.contiguous()) - 1).to(torch.int32)


def _reassign_inputs(W, dW, wgt, freqs_np: np.ndarray, gamma_abs, out_of_range: str,
                     edges=None):
    """Phase transform and bin index of a (..., S, N) coefficient block:
    the contributions ``W * wgt`` and their bin indices, n_bins where a
    coefficient is not reassigned. ``wgt`` is the per-scale measure
    ``a^{-1/2} dln(a)`` (shape (S,), an array or a tensor); ``gamma_abs``
    the absolute |W| threshold (broadcastable); ``edges`` as in
    :func:`_bin_index`."""
    if out_of_range not in ("clip", "drop"):
        raise JWaveFailure(f"ssq_cwt - out_of_range must be 'clip' or 'drop', got {out_of_range!r}")
    n_bins = freqs_np.shape[0]
    mag2 = W.real ** 2 + W.imag ** 2
    f_inst = (dW * torch.conj(W)).imag / torch.where(mag2 > 0, mag2, 1.0) / (2.0 * math.pi)
    keep = mag2 > gamma_abs * gamma_abs
    if out_of_range == "drop":
        keep = keep & (f_inst > 0)
    contrib = W * torch.as_tensor(wgt, dtype=W.real.dtype, device=W.device)[:, None]
    safe_f = torch.where(keep & (f_inst > 0), f_inst, float(freqs_np[0]))
    k_idx = _bin_index(safe_f, freqs_np, edges)
    if out_of_range == "clip":
        k_idx = torch.where(keep, k_idx.clamp(0, n_bins - 1), n_bins)
    else:
        k_idx = torch.where(keep & (k_idx >= 0) & (k_idx < n_bins), k_idx, n_bins)
    return contrib, k_idx


def _route(reassign: str, device: torch.device, cdtype: torch.dtype) -> str:
    """The reassignment route of ``reassign`` for coefficients of complex
    dtype ``cdtype`` on ``device``: "auto" is K6 ("pallas") on a CUDA
    complex64 block, the scatter form otherwise."""
    if reassign not in REASSIGN_ROUTES:
        raise JWaveFailure(
            f"ssq_cwt - reassign must be 'auto', 'dense', 'scatter' or 'pallas', got {reassign!r}"
        )
    if reassign == "auto":
        return "pallas" if device.type == "cuda" and cdtype == torch.complex64 else "scatter"
    return reassign


def _reassign(contrib, k_idx, n_bins: int, route: str, out=None):
    """The (..., K, N) plane of the contributions by ``route`` (resolved by
    :func:`_route`), written into ``out`` where given."""
    if route == "pallas":
        return cuda_reassign.reassign(contrib.to(torch.complex64), k_idx, n_bins, out=out)
    plain = cuda_reassign.reassign_dense_torch if route == "dense" else cuda_reassign.reassign_torch
    tx = plain(contrib, k_idx, n_bins)
    return tx if out is None else out.copy_(tx)


def _squeeze_plane(W, dW, wgt, freqs_np: np.ndarray, gamma_abs, out_of_range: str,
                   reassign: str = "auto"):
    """Phase transform and weighted reassignment of a (..., S, N) coefficient
    block into the (..., K, N) bin grid.

    ``reassign``: "auto" (K6 on a CUDA complex64 block, which a float32
    signal gives; the scatter form otherwise, as on the CPU), "pallas" (the
    kernel's route by its JAX name: K6 on CUDA, its plain version on the
    CPU; the block is cast to complex64 first, as in the JAX package),
    "scatter" (one ``scatter_add_``) or "dense" (a masked sum per bin row;
    no (K, S, N) mask is built).
    """
    route = _route(reassign, W.device, W.dtype)
    contrib, k_idx = _reassign_inputs(W, dW, wgt, freqs_np, gamma_abs, out_of_range)
    return _reassign(contrib, k_idx, freqs_np.shape[0], route)


def _default_bins(scales_np: np.ndarray, fc: float, frequencies) -> np.ndarray:
    """Resolve the frequencies argument into an increasing Hz grid."""
    if frequencies is None or isinstance(frequencies, int):
        k = scales_np.shape[0] if frequencies is None else int(frequencies)
        if k < 2:
            raise JWaveFailure(f"ssq_cwt - need at least 2 frequency bins, got {k}")
        f_lo = fc / scales_np.max()
        f_hi = fc / scales_np.min()
        return np.exp(np.linspace(math.log(f_lo), math.log(f_hi), k))
    freqs_np = host_array(frequencies, np.float64)
    if freqs_np.ndim != 1 or freqs_np.shape[0] < 2 or np.any(np.diff(freqs_np) <= 0):
        raise JWaveFailure("ssq_cwt - frequencies must be a 1D increasing grid")
    return freqs_np


def _stacked_bank(wav: ContinuousWavelet, scales_np: np.ndarray, padded: int, fs: float,
                  cdtype: torch.dtype, device) -> torch.Tensor:
    """(2S, P) ``[conj(psi_hat_a), i w conj(psi_hat_a)]``, built in float64 and
    cast to the spectrum's complex dtype ``cdtype``."""
    bank, omega = _scaled_bank(wav, scales_np, _omega_axis(padded, fs), device)
    w_hat = torch.conj(bank)  # (S, P)
    return torch.cat([w_hat, w_hat * (1j * omega)[None, :]], dim=0).to(cdtype)


def _cwt_and_derivative(signal: torch.Tensor, scales_np: np.ndarray, wav: ContinuousWavelet,
                        fs: float, padding: PaddingType, stacked: torch.Tensor | None = None):
    """W and dW/db (each (..., S, N)) from one product with the stacked bank
    (:func:`_stacked_bank`, built here unless given) and one inverse FFT."""
    n = signal.shape[-1]
    n_scales = scales_np.shape[0]
    padded_len = next_power_of_two(n)
    sig_fft = _fft_any(pad_signal(signal, padded_len, padding))  # (..., P)
    if stacked is None:
        stacked = _stacked_bank(wav, scales_np, padded_len, fs, sig_fft.dtype, signal.device)
    out = _ifft_any(sig_fft[..., None, :] * stacked)[..., :n]  # (..., 2S, N)
    return out[..., :n_scales, :], out[..., n_scales:, :]


class _SSQConstants(NamedTuple):
    stacked: torch.Tensor  # (2S, P) from _stacked_bank, the spectrum's complex dtype
    scales: torch.Tensor  # (S,) float64
    freqs: torch.Tensor  # (K,) float64, Hz
    wgt: torch.Tensor  # (S,) a^{-1/2} dln(a), in the real dtype
    edges: torch.Tensor | None  # (K+1,) bin edges where the grid is not log-uniform


def _ssq_constants(wav: ContinuousWavelet, scales_np: np.ndarray, freqs_np: np.ndarray,
                   padded: int, fs: float, cdtype: torch.dtype, device) -> _SSQConstants:
    rdtype = torch.float64 if cdtype == torch.complex128 else torch.float32

    def build():
        def up(a, dtype=None):
            return count_upload(torch.as_tensor(a, dtype=dtype, device=device))

        edges = None if _log_uniform(freqs_np) is not None else up(_bin_edges(freqs_np), rdtype)
        return _SSQConstants(_stacked_bank(wav, scales_np, padded, fs, cdtype, device),
                             up(scales_np), up(freqs_np),
                             up(scales_np ** -0.5 * _log_measure(scales_np)).to(rdtype), edges)

    key = ("ssq", _wavelet_key(wav), scales_np.tobytes(), freqs_np.tobytes(), padded, fs,
           cdtype, torch.device(device))
    return _device_constants("ssq", key, build)


def _row_bytes(n_scales: int, padded: int, n: int, n_bins: int, itemsize: int) -> int:
    """Bytes that one row of the leading axes takes at the peak of a chunk,
    for a real dtype of ``itemsize`` bytes: while the inverse FFT runs, the
    spectrum, the product with the stacked bank, its transform and cuFFT's
    work area (three (2S, P) complex planes); or while the phase transform
    runs, W and dW with at most eight real (S, N) temporaries and a plain
    route's (K, N) plane and its copy."""
    c = 2 * itemsize
    fft = c * padded + 3 * 2 * n_scales * padded * c
    squeeze = 2 * n_scales * padded * c + 8 * n_scales * n * itemsize + 2 * n_bins * n * c
    return max(fft, squeeze)


def _memory_budget(device: torch.device) -> int:
    """Bytes a chunk may take: :data:`CHUNK_SHARE` of the device's total
    memory (the host's on the CPU)."""
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return int(CHUNK_SHARE * total)


def _chunk_rows(rows: int, row_bytes: int, budget: int) -> int:
    """Rows a chunk: as many as ``budget`` holds (one at least), spread
    evenly over the fewest chunks that take all ``rows``."""
    most = max(1, budget // row_bytes)
    chunks = max(1, -(-rows // most))
    return max(1, -(-rows // chunks))


@spanned("ssq_cwt")
def ssq_cwt(
    signal,
    scales,
    wavelet: ContinuousWavelet | str = "morlet",
    sampling_rate: float = 1.0,
    padding: PaddingType = PaddingType.SYMMETRIC,
    frequencies=None,
    gamma: float | None = None,
    out_of_range: str = "clip",
    reassign: str = "auto",
) -> SSQResult:
    """Synchrosqueezed CWT of a real signal.

    Args:
      signal: (..., N) real; batched over leading axes. A float32 signal
        gives a complex64 ``Tx``, a float64 one complex128.
      scales: monotone scale grid in seconds (log-spaced recommended; see
        :func:`generate_log_scales`).
      wavelet: an *analytic* continuous wavelet (Morlet, Paul, or Morse).
      frequencies: target bin grid: None (log-spaced, one bin per scale,
        spanning the scale grid's own frequency range), an int (that many
        log-spaced bins over the same range), or an increasing array in Hz.
      gamma: |W| threshold below which coefficients are not reassigned.
        Default: 10*sqrt(eps(dtype)) * max|W| per signal.
      out_of_range: "clip" (default) reassigns above-threshold coefficients
        whose instantaneous frequency falls outside the grid to the nearest
        edge bin (non-positive estimates to the lowest bin), keeping the
        coefficient sum; "drop" discards them.
      reassign: "auto", "pallas" (K6), "scatter" or "dense"; see
        :func:`_squeeze_plane`.

    Returns an :class:`SSQResult`; ``sum_k Tx[k, b]`` over bins equals the
    weighted scale sum ``sum_j W(a_j, b) a_j^{-1/2} dln(a_j)`` of the kept
    coefficients, which is what :func:`issq_cwt` inverts.

    Signals of the leading axes run in chunks of rows whose working set
    fits :data:`CHUNK_SHARE` of the device's memory; the result does not
    depend on the chunks (the threshold is per signal).
    """
    wav = get_continuous_wavelet(wavelet)
    if not wav.is_analytic:
        raise JWaveFailure(
            f"ssq_cwt - synchrosqueezing needs an analytic wavelet (Morlet, "
            f"Paul, Morse); {wav.name!r} has negative-frequency support, so the "
            f"instantaneous-frequency estimate of a real signal is meaningless"
        )
    scales_np = np.atleast_1d(host_array(scales, np.float64))
    if scales_np.ndim != 1 or scales_np.shape[0] < 2:
        raise JWaveFailure("ssq_cwt - need a 1D grid of at least 2 scales")
    fs = float(sampling_rate)
    signal = _signal(signal)
    freqs_np = _default_bins(scales_np, wav.center_frequency, frequencies)
    n = signal.shape[-1]
    padded = next_power_of_two(n)
    cdtype = torch.promote_types(signal.dtype, torch.complex64)  # the spectrum's
    dev = signal.device
    route = _route(reassign, dev, cdtype)
    # built once and kept on the device: a copy from pageable host memory
    # waits for the stream, and mid-call it would idle the card
    consts = _ssq_constants(wav, scales_np, freqs_np, padded, fs, cdtype, dev)
    n_bins = freqs_np.shape[0]

    def squeeze(x, out=None):
        with span("ssq.chunk", rows=math.prod(x.shape[:-1]), n=n, scales=scales_np.shape[0]):
            count("ssq.chunks")
            with span("ssq.cwt"):
                W, dW = _cwt_and_derivative(x, scales_np, wav, fs, padding, consts.stacked)
            with span("ssq.phase"):
                if gamma is None:
                    mag2 = W.real ** 2 + W.imag ** 2
                    eps = torch.finfo(W.real.dtype).eps
                    gamma_abs = 10.0 * math.sqrt(eps) * torch.sqrt(
                        torch.amax(mag2, dim=(-2, -1), keepdim=True))
                else:
                    gamma_abs = torch.as_tensor(gamma, dtype=W.real.dtype, device=W.device)
                contrib, k_idx = _reassign_inputs(W, dW, consts.wgt, freqs_np, gamma_abs,
                                                  out_of_range, consts.edges)
            return _reassign(contrib, k_idx, n_bins, route, out)

    rows = math.prod(signal.shape[:-1])
    per_chunk = _chunk_rows(rows, _row_bytes(scales_np.shape[0], padded, n, n_bins,
                                             signal.element_size()), _memory_budget(dev))
    if per_chunk >= rows:
        tx = squeeze(signal)
    else:
        flat = signal.reshape(rows, n)
        out = torch.empty((rows, n_bins, n), dtype=torch.complex64 if route == "pallas" else cdtype,
                          device=dev)
        for r0 in range(0, rows, per_chunk):
            squeeze(flat[r0:r0 + per_chunk], out[r0:r0 + per_chunk])
        tx = out.reshape(signal.shape[:-1] + (n_bins, n))
    return SSQResult(tx, consts.freqs.clone(), consts.scales.clone(), _time_axis(n, fs, tx), fs,
                     wav.name)


def _ridge_dp(energy: torch.Tensor, penalty: float) -> torch.Tensor:
    """Viterbi ridge on (..., K, N) log-energy planes: per plane the path
    k(t) maximizing sum_t E[k(t), t] - penalty * (k(t) - k(t-1))^2, as a
    Python loop over time (forward scores, then backtracking through the
    stored argmax pointers). Returns (..., N) int64."""
    k_bins, n = energy.shape[-2:]
    ar = torch.arange(k_bins, device=energy.device)
    pen = penalty * (ar[:, None] - ar[None, :]).to(energy.dtype) ** 2  # (to, from)
    score = energy[..., :, 0]
    ptrs = []
    for t in range(1, n):
        cand = score[..., None, :] - pen  # (..., K_to, K_from)
        best = torch.argmax(cand, dim=-1)
        score = energy[..., :, t] + torch.gather(cand, -1, best[..., None])[..., 0]
        ptrs.append(best)
    k = torch.argmax(score, dim=-1)
    path = [k]
    for best in reversed(ptrs):
        k = torch.gather(best, -1, k[..., None])[..., 0]
        path.append(k)
    return torch.stack(path[::-1], dim=-1)


def extract_ridge(result: SSQResult, n_ridges: int = 1, penalty: float = 2.0,
                  tube_width: int = 2):
    """Penalized multi-ridge extraction from the squeezed plane (Carmona et
    al. 1999-style dynamic programming).

    Returns ``(indices, frequencies)`` of shape (..., n_ridges, N), the
    indices int32: per ridge, the frequency-bin path through ``|Tx|^2`` that maximizes energy
    minus ``penalty * (bin step)^2``. Ridges are peeled greedily: after each
    extraction a ``tube_width``-bin tube around the ridge is suppressed. Use
    :func:`ridge_tube_mask` + ``issq_cwt(..., band=mask)`` to reconstruct
    the mode under a ridge.
    """
    if n_ridges < 1:
        raise JWaveFailure(f"extract_ridge - n_ridges must be >= 1, got {n_ridges}")
    tx = result.Tx
    k_bins = tx.shape[-2]
    mag2 = tx.real ** 2 + tx.imag ** 2
    energy = torch.log(mag2 + torch.finfo(mag2.dtype).tiny)
    ar = torch.arange(k_bins, device=tx.device)[:, None]
    ridges = []
    floor = torch.min(energy) - 1.0
    for _ in range(n_ridges):
        idx = _ridge_dp(energy, penalty)  # (..., N)
        ridges.append(idx)
        dist = torch.abs(ar - idx[..., None, :])  # (..., K, N)
        energy = torch.where(dist <= tube_width, floor, energy)
    indices = torch.stack(ridges, dim=-2).to(torch.int32)  # (..., R, N), int32 as in JAX
    return indices, result.frequencies[indices]


def ridge_tube_mask(result: SSQResult, indices, tube_width: int = 2):
    """Boolean (..., K, N) mask selecting a ``tube_width``-bin tube around a
    ridge index path (..., N); feed it to ``issq_cwt(..., band=mask)`` to
    reconstruct that mode alone."""
    k_bins = result.Tx.shape[-2]
    idx = torch.as_tensor(indices, device=result.Tx.device)
    dist = torch.abs(torch.arange(k_bins, device=idx.device)[:, None] - idx[..., None, :])
    return dist <= tube_width


def issq_cwt(result: SSQResult, wavelet: ContinuousWavelet | str | None = None,
             band=None):
    """Reconstruct the real signal from its synchrosqueezed transform:
    ``x(b) = 2 Re[ (1/C) sum_k Tx(f_k, b) ]`` (Daubechies-Lu-Wu eq. 2.5,
    discretized over the forward's log-scale measure).

    ``band`` restricts the sum: a ``(f_lo, f_hi)`` tuple in Hz keeps only
    bins inside the band, a boolean array broadcastable to ``Tx``'s
    (..., K, N) selects per (bin, time), e.g. a ridge tube from
    :func:`ridge_tube_mask`. None (default) reconstructs the full signal.
    """
    if wavelet is None:
        wav = _resolve_wavelet_by_name(result.wavelet_name, caller="issq_cwt")
    else:
        wav = get_continuous_wavelet(wavelet)
    c = one_integral_constant(wav)
    tx = result.Tx
    if band is not None:
        if isinstance(band, tuple) and len(band) == 2:
            f_lo, f_hi = band
            sel = (result.frequencies >= f_lo) & (result.frequencies <= f_hi)
            if not bool(torch.any(sel)):
                freqs = result.frequencies.cpu().numpy()
                raise JWaveFailure(
                    f"issq_cwt - band ({f_lo}, {f_hi}) Hz contains no frequency "
                    f"bins (grid spans {freqs[0]:g}..{freqs[-1]:g} Hz)"
                )
            tx = tx * sel[:, None].to(tx.real.dtype)
        else:
            mask = torch.as_tensor(band if isinstance(band, torch.Tensor) else np.asarray(band),
                                   device=tx.device)
            tx = tx * mask.to(tx.real.dtype)
    total = torch.sum(tx, dim=-2)
    return 2.0 * (total / c).real
