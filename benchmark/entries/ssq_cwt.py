"""A request is ``ssq_cwt(x, scales, MorletWavelet(fb, fc), fs, frequencies=K)``
on one (channels, samples) float32 array: the synchrosqueezed CWT of every
channel, into K log-spaced bins.

The configuration gives the wavelet, the scale grid and the bins; the scale
grid (a host array) and the wavelet are made once in set-up, as a caller
holds them. The mix gives ``channels``, ``samples``, ``snr_db``,
``chirp_band`` and ``distinct_inputs``: that many arrays are made on the
device from the seed in set-up, each channel a linear chirp of unit
amplitude and random phase whose start and end frequencies are drawn
log-uniformly between fc / chirp_band[0] and fc / chirp_band[1] cycles a
sample, plus white Gaussian noise at ``snr_db``; request i takes array i mod
distinct_inputs. The check compares the sampled requests' Tx with the
reference (``benchmark/reference/ssq.py``), computed on the device a block of
channels at a time:

- ``conserve_err``: max over columns of |sum_k Tx - sum_k Tx_ref| over
  max |sum_k Tx_ref|; the column sum does not depend on the binning;
- ``tx_err``: max |Tx - Tx_ref| over max |Tx_ref|;
- ``flip_share``: sum |Tx - Tx_ref| over twice the kept coefficients' total
  |contribution|: the share of the kept weight that the program put in
  another bin than the reference (a coefficient moved to a neighbouring bin
  adds its |contribution| twice to the sum), rounding included. Which
  coefficient went where cannot be read from Tx, so each is weighed by its
  |contribution|.

A coefficient whose threshold test or bin lies within float32's reach of the
reference's (:data:`DELTA`) may go either way: the first two leave its
|contribution| out where it may land (the reference's slack).
"""
from __future__ import annotations

import math

import torch

from .. import reassign_work
from ..reference import ssq as ref

#: channels the reference takes at once: ~8 GB of float64 work a channel at
#: 2^20 samples and 64 scales
BLOCK = 1
#: the error, as a share of each scale's root mean square, that float32 W
#: and dW may have: the FFTs' rounding, which cuFFT at 2^20 samples was
#: measured to take up to 9.5e-6 of the rms on an H100 (80 eps of float32);
#: four times that
DELTA = 4e-5


class Cell:
    def __init__(self, api, cfg, mix, seed, device, span):
        self.api, self.span = api, span
        self.fb, self.fc, self.fs = cfg["fb"], cfg["fc"], cfg["sampling_rate"]
        self.bins = cfg["bins"]
        lo, hi = cfg["scale_range_samples"]
        self.scales = ref.log_scales(lo / self.fs, hi / self.fs, cfg["scales"]).numpy()
        self.wavelet = api.MorletWavelet(self.fb, self.fc)
        self.channels, self.samples = mix["channels"], mix["samples"]
        gen = torch.Generator(device=device).manual_seed(seed)
        shape = (mix["distinct_inputs"], self.channels)
        f_lo, f_hi = (math.log(self.fc / d) for d in mix["chirp_band"])
        f = torch.exp(f_lo + (f_hi - f_lo) * torch.rand(shape + (2,), generator=gen, device=device,
                                                         dtype=torch.float64))
        f0, f1 = f[..., :1], f[..., 1:]
        phase = 2 * math.pi * torch.rand(shape + (1,), generator=gen, device=device,
                                         dtype=torch.float64)
        t = torch.arange(self.samples, device=device, dtype=torch.float64)
        x = torch.cos(2 * math.pi * (f0 * t + (f1 - f0) * t * t / (2 * self.samples)) + phase)
        sigma = math.sqrt(0.5 * 10 ** (-mix["snr_db"] / 10))  # a unit cosine's power is 1/2
        x += sigma * torch.randn(x.shape, generator=gen, device=device, dtype=torch.float64)
        self.x = x.to(getattr(torch, cfg["dtype"]))

    def call(self, i):
        with self.span("ssq_cwt"):
            return self.api.ssq_cwt(self.x[i % self.x.shape[0]], self.scales, self.wavelet,
                                    self.fs, frequencies=self.bins)

    def result(self, i, out):
        return None

    def record(self, i, res):
        pass

    def units(self, i):
        return self.channels * self.samples

    def kernel_work(self, i):
        return [("K6", *reassign_work.reassign(self.channels, len(self.scales), self.samples,
                                               self.bins))]

    def check(self, kept):
        errs = {"conserve_err": [], "tx_err": [], "flip_share": []}
        for i, out, _ in kept:
            x = self.x[i % self.x.shape[0]]
            err = SSQErr()
            for r0 in range(0, self.channels, BLOCK):
                want = ref.ssq(x[r0:r0 + BLOCK], self.scales, self.fb, self.fc, self.fs,
                               self.bins, delta=DELTA)
                err.add(out.Tx[r0:r0 + BLOCK], want)
            for k, v in err.values().items():
                errs[k].append(v)
        return errs


class SSQErr:
    """The three numbers of the check over the blocks of one answer, each
    largest error over largest reference magnitude (or sum over sum); a NaN
    in the answer reads as an infinite error."""

    def __init__(self):
        self.col_err = self.col_scale = self.tx_err = self.tx_scale = 0.0
        self.moved = self.mass = 0.0

    def add(self, tx: torch.Tensor, want: ref.Squeezed) -> "SSQErr":
        d = tx.to(device=want.tx.device, dtype=torch.complex128) - want.tx
        size = torch.nan_to_num(d.abs(), nan=math.inf)
        col = torch.nan_to_num(d.sum(dim=-2).abs(), nan=math.inf)
        self.tx_err = max(self.tx_err, float((size - want.slack).clamp(min=0).max()))
        self.tx_scale = max(self.tx_scale, float(want.tx.abs().max()))
        self.col_err = max(self.col_err, float((col - want.slack_sum).clamp(min=0).max()))
        self.col_scale = max(self.col_scale, float(want.tx.sum(dim=-2).abs().max()))
        self.moved += float(size.sum())
        self.mass += float(want.mass.sum())
        return self

    def values(self) -> dict:
        def ratio(a, b):
            return a / b if b > 0 else math.inf

        return {"conserve_err": ratio(self.col_err, self.col_scale),
                "tx_err": ratio(self.tx_err, self.tx_scale),
                "flip_share": ratio(self.moved, 2 * self.mass)}
