"""The synchrosqueezed continuous wavelet transform with a Morlet wavelet, by
its definition (I. Daubechies, J. Lu and H.-T. Wu, "Synchrosqueezed wavelet
transforms: an empirical mode decomposition-like tool", Applied and
Computational Harmonic Analysis 30 (2011) 243-261).

For a real signal x of N samples at rate fs, scales a_j (seconds) and the
Morlet spectrum psi_hat:

    X        = fft(x)
    W(a, b)  = ifft(X . conj(sqrt(a) psi_hat(a w)))             (the CWT)
    dW(a, b) = ifft(X . i w . conj(sqrt(a) psi_hat(a w)))       (its d/db)
    f_inst   = Im(dW . conj W) / |W|^2 / 2 pi                    (Hz)
    Tx[k, b] = sum over j with |W(a_j, b)| > gamma binned to k of
               W(a_j, b) . a_j^(-1/2) . dln a_j

Departures from the paper, each as JWave and the port compute:

- the signal is extended to P, the next power of two, by JWave's symmetric
  rule (``ContinuousWaveletTransform.java:283-291``): padded[i] =
  x[2N - i - 2] while that index is in range, zero beyond; the transform's
  first N columns are kept;
- the Morlet spectrum is JWave's, psi_hat(w) = sqrt(2 pi fb)
  exp(-2 pi^2 fb (w / 2 pi - fc)^2) (``MorletWavelet.java:114-124``), and
  the scaled wavelet's spectrum is sqrt(a) psi_hat(a w);
- the angular frequency of FFT index i is 2 pi i fs / P, less 2 pi fs above
  P/2 (index P/2 stays positive, ``ContinuousWaveletTransform.java:450-459``);
- the paper's continuous frequency axis is a grid of K bins, log-spaced from
  fc / max(a) to fc / min(a); a coefficient goes to the nearest bin in
  log-frequency (ties to the even index); with the "clip" rule a frequency
  outside the grid goes to the nearest end bin and a non-positive one to the
  lowest bin;
- the threshold is relative: gamma = 10 sqrt(eps) max |W| per signal, with
  eps that of the signal's dtype (the paper's gamma is a fixed number);
- the measure a^(-3/2) da of the one-integral inverse is discretised as
  a^(-1/2) dln a, dln a by central differences of ln a (exact on a
  log-spaced grid).

Plain torch in float64 on any device. ``prec`` (:mod:`.precision`) rounds
each step's operands and results, for a copy in a lower precision; by
default nothing is rounded.

Two decisions of the definition are discontinuous: whether |W| exceeds
gamma, and which bin f_inst rounds to. A program that computes W and dW with
an error of ``delta`` times the signal's largest |W| (and |dW|) may take
either side of each where the reference lies within that error of the
threshold or of a bin edge. :func:`ssq` lists those coefficients as slack:
their |contribution| at each bin they may land in, and at their column where
the threshold may go either way.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .precision import FLOAT64, Precision

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _to_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float64)


#: bfloat16 operands and results (8 mantissa bits), float64 storage
BF16 = Precision("bf16", _to_bf16, _to_bf16)


def _complex(prec: Precision, step, z: torch.Tensor) -> torch.Tensor:
    """``step`` (one of ``prec``'s roundings) on both parts of ``z``."""
    if prec is FLOAT64:
        return z
    return torch.complex(step(z.real.contiguous()), step(z.imag.contiguous()))


def morlet_hat(omega: torch.Tensor, fb: float, fc: float) -> torch.Tensor:
    """JWave's Morlet spectrum at angular frequency ``omega``, real."""
    f = omega / (2.0 * math.pi)
    return math.sqrt(2.0 * math.pi * fb) * torch.exp(-2.0 * math.pi ** 2 * fb * (f - fc) ** 2)


def log_scales(lo: float, hi: float, num: int) -> torch.Tensor:
    """``num`` scales log-spaced from ``lo`` to ``hi``, float64 on the CPU."""
    return torch.exp(torch.linspace(math.log(lo), math.log(hi), num, dtype=torch.float64))


def bins(scales, fc: float, n_bins: int) -> torch.Tensor:
    """The K log-spaced bin frequencies (Hz) from fc / max(a) to fc / min(a),
    float64 on the CPU."""
    a = torch.as_tensor(scales, dtype=torch.float64)
    lo, hi = math.log(fc / float(a.max())), math.log(fc / float(a.min()))
    return torch.exp(torch.linspace(lo, hi, n_bins, dtype=torch.float64))


def weights(scales) -> torch.Tensor:
    """a^(-1/2) dln a per scale (dln a by central differences, one-sided at
    the ends), float64 on the CPU."""
    v = torch.log(torch.as_tensor(scales, dtype=torch.float64))
    return torch.exp(-0.5 * v) * torch.gradient(v)[0].abs()


def pad_symmetric(x: torch.Tensor, target: int) -> torch.Tensor:
    n = x.shape[-1]
    if target <= n:
        return x[..., :target]
    idx = 2 * n - 2 - torch.arange(n, target, device=x.device)
    tail = torch.where(idx >= 0, x[..., idx.clamp(min=0)], torch.zeros((), dtype=x.dtype,
                                                                      device=x.device))
    return torch.cat([x, tail], dim=-1)


def omega_axis(padded: int, fs: float, device) -> torch.Tensor:
    i = torch.arange(padded, dtype=torch.float64, device=device)
    return 2.0 * math.pi * fs * (i - padded * (i > padded // 2).to(torch.float64)) / padded


#: bins of rounding in a program's float32 bin index: the logarithm and the
#: affine map to the index (up to 63) each round to ~1e-6 of a bin; ten times
#: their sum
INDEX_ROUNDING = 1e-4


class Squeezed(NamedTuple):
    tx: torch.Tensor  # (rows, K, N) complex128
    mass: torch.Tensor  # (rows, N): sum of |contribution| over the kept coefficients
    slack: torch.Tensor  # (rows, K, N): |contribution| of the undecided that may land in the bin
    slack_sum: torch.Tensor  # (rows, N): |contribution| of those whose threshold test is undecided


def ssq(x: torch.Tensor, scales, fb: float, fc: float, fs: float, n_bins: int,
        prec: Precision = FLOAT64, delta: float = 0.0) -> Squeezed:
    """The synchrosqueezed plane of the rows of ``x`` (rows, N), with the
    kept coefficients' |contribution| by column and the slack of a program
    whose W and dW err by ``delta`` of their largest magnitude (none at 0).
    The threshold's eps is that of ``x``'s dtype; ``x`` is read exactly in
    float64."""
    eps = torch.finfo(x.dtype).eps
    xd = x.to(torch.float64)
    dev = xd.device
    n = xd.shape[-1]
    padded = 1 << max(0, (n - 1).bit_length())
    a = torch.as_tensor(scales, dtype=torch.float64).to(dev)[:, None]  # (S, 1)
    om = omega_axis(padded, fs, dev)
    bank = prec.operand(torch.sqrt(a) * morlet_hat(a * om, fb, fc))  # (S, P), real: its own conj
    dbank = _complex(prec, prec.operand, 1j * om * bank)
    wgt = prec.operand(weights(scales).to(dev))[:, None]  # (S, 1)
    freqs = bins(scales, fc, n_bins)
    log_f0 = math.log(float(freqs[0]))
    dlf = (math.log(float(freqs[-1])) - log_f0) / (n_bins - 1)
    tx = torch.zeros((xd.shape[0], n_bins, n), dtype=torch.complex128, device=dev)
    slack = torch.zeros((xd.shape[0], n_bins, n), dtype=torch.float64, device=dev)
    mass = torch.zeros((xd.shape[0], n), dtype=torch.float64, device=dev)
    slack_sum = torch.zeros_like(mass)
    for r in range(xd.shape[0]):
        spec = _complex(prec, prec.result, torch.fft.fft(prec.operand(pad_symmetric(xd[r], padded))))
        spec = _complex(prec, prec.operand, spec)
        w = _complex(prec, prec.result, torch.fft.ifft(spec * bank)[:, :n])  # (S, N)
        dw = _complex(prec, prec.result, torch.fft.ifft(spec * dbank)[:, :n])
        w_op, dw_op = _complex(prec, prec.operand, w), _complex(prec, prec.operand, dw)
        mag2 = prec.result(w_op.real ** 2 + w_op.imag ** 2)
        gamma = 10.0 * math.sqrt(eps) * torch.sqrt(mag2.max())
        keep = mag2 > gamma * gamma
        f_inst = prec.result((dw_op * torch.conj(w_op)).imag / torch.where(mag2 > 0, mag2, 1.0)
                             / (2.0 * math.pi))
        u = (torch.log(torch.where(f_inst > 0, f_inst, float(freqs[0]))) - log_f0) / dlf
        at = torch.round(u).clamp(0, n_bins - 1)
        k = torch.where(keep, at, n_bins).to(torch.int64)
        c = _complex(prec, prec.result, w_op * wgt)
        plane = torch.zeros((n_bins + 1, n, 2), dtype=torch.float64, device=dev)
        plane.scatter_add_(0, k[..., None].expand(-1, -1, 2), torch.view_as_real(c))
        tx[r] = torch.view_as_complex(plane[:n_bins])
        mass[r] = torch.where(keep, c.abs(), 0).sum(dim=0)
        if delta > 0:
            _slack(slack[r], slack_sum[r], w, dw, f_inst, u, at, c.abs(), gamma, delta, dlf)
    return Squeezed(tx, mass, slack, slack_sum)


def _slack(slack, slack_sum, w, dw, f_inst, u, at, size, gamma, delta: float, dlf: float):
    """Adds to ``slack`` (K, N) and ``slack_sum`` (N) the |contribution|
    ``size`` of each coefficient whose threshold test or bin the program's
    error can turn: ``delta`` times the scale's root mean square in W and in
    dW (an FFT's rounding error is relative to the norm of what it
    transforms). To first order f_inst = Im(dW conj W) / 2 pi |W|^2 then errs
    by

        |df| / f <= e_dW / |dW| + 3 e_W / |W|,   |dW| ~ 2 pi f |W|,

    which is turned into bins over d ln f, plus :data:`INDEX_ROUNDING`."""
    n_bins = slack.shape[0]
    mag = w.abs()
    err_w = delta * mag.pow(2).mean(dim=-1, keepdim=True).sqrt()  # (S, 1)
    err_dw = delta * dw.abs().pow(2).mean(dim=-1, keepdim=True).sqrt()
    undecided_keep = (mag - gamma).abs() <= err_w
    safe = torch.where(mag > 0, mag, 1.0)
    f_abs = f_inst.abs().clamp(min=torch.finfo(torch.float64).tiny)
    rel_f = err_dw / (2.0 * math.pi * f_abs * safe) + 3.0 * err_w / safe
    near = torch.round(u)
    margin = 0.5 - (u - near).abs()  # bins to the nearer edge
    other = near + torch.sign(u - near)  # the bin across it
    undecided_bin = ((margin <= rel_f / dlf + INDEX_ROUNDING) & (f_inst > 0)
                     & (near >= 0) & (near < n_bins) & (other >= 0) & (other < n_bins))
    maybe_kept = mag > gamma - err_w
    undecided = maybe_kept & (undecided_keep | undecided_bin)
    slack.scatter_add_(0, at.to(torch.int64), torch.where(undecided, size, 0))
    slack.scatter_add_(0, other.clamp(0, n_bins - 1).to(torch.int64),
                       torch.where(maybe_kept & undecided_bin, size, 0))
    slack_sum += torch.where(undecided_keep, size, 0).sum(dim=0)
