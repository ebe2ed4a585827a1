"""A request is ``modwt(x, wavelet, level)`` then ``imodwt`` on one batch of
signals of one length.

The mix gives ``lengths`` (the signal lengths), ``samples`` (a request's
samples: a batch of ``samples // length`` signals) and ``distinct_inputs``:
that many buffers of ``samples`` values are made on the device from the
seed in set-up, and request i takes buffer i mod distinct_inputs, viewed as
its batch. Request i has length ``order[i mod len(lengths)]``, where
``order`` is ``lengths`` shuffled by the seed: every seed runs the same
lengths equally often, in another order. The check compares the forward
coefficients and the reconstruction of the sampled requests with the
reference, in blocks of rows.
"""
from __future__ import annotations

import random

import torch

from .. import roofline
from ..compare import RelErr
from ..reference import modwt as ref
from ..reference import taps

#: samples of a request that the reference takes at once
BLOCK_SAMPLES = 1 << 22


class Cell:
    def __init__(self, api, cfg, mix, seed, device, span):
        self.api, self.span = api, span
        self.wavelet, self.level = cfg["wavelet"], cfg["level"]
        self.order = list(mix["lengths"])
        random.Random(seed).shuffle(self.order)
        self.samples = mix["samples"]
        gen = torch.Generator(device=device).manual_seed(seed)
        self.x = torch.randn((mix["distinct_inputs"], self.samples), generator=gen,
                             device=device, dtype=getattr(torch, cfg["dtype"]))

    def _shape(self, i):
        n = self.order[i % len(self.order)]
        return self.samples // n, n

    def _batch(self, i):
        rows, n = self._shape(i)
        return self.x[i % self.x.shape[0], :rows * n].view(rows, n)

    def units(self, i):
        rows, n = self._shape(i)
        return rows * n

    def call(self, i):
        x = self._batch(i)
        with self.span("modwt"):
            c = self.api.modwt(x, self.wavelet, self.level)
        with self.span("imodwt"):
            r = self.api.imodwt(c, self.wavelet)
        return c, r

    def result(self, i, out):
        return None

    def record(self, i, res):
        pass

    def kernel_work(self, i):
        m = len(taps.SCALING[self.wavelet])
        work = roofline.modwt_cascade(*self._shape(i), self.level, m)
        return [("K1", *work), ("K2", *work)]

    def check(self, kept):
        g, h = taps.modwt_filters(self.wavelet)
        errs = {"coeffs_err": [], "recon_err": []}
        for i, (c, r), _ in kept:
            x = self._batch(i)
            block = max(1, BLOCK_SAMPLES // x.shape[1])
            ec, er = RelErr(), RelErr()
            for r0 in range(0, x.shape[0], block):
                rc = ref.modwt(x[r0:r0 + block], g, h, self.level)
                ec.add(c[r0:r0 + block], rc)
                er.add(r[r0:r0 + block], ref.imodwt(rc, g, h))
            errs["coeffs_err"].append(ec.value)
            errs["recon_err"].append(er.value)
        return errs
