"""A request is the facade's 3D round trip on one volume:
``Transform(FastWaveletTransform(wavelet)).forward(v, level, level, level)``
then ``.reverse(y, level, level, level)``; the rank-3 input dispatches to
the separable 3D transform.

The mix gives ``shape`` (three extents) and ``distinct_inputs``: that many
volumes are made on the device from the seed in set-up, and request i
takes volume i mod distinct_inputs. The facade object is built once in
set-up, as a caller holds it. The check compares the coefficients and the
reconstruction of the sampled requests with the reference.
"""
from __future__ import annotations

import math

import torch

from .. import roofline
from ..compare import RelErr
from ..reference import fwt as ref
from ..reference import taps


class Cell:
    def __init__(self, api, cfg, mix, seed, device, span):
        self.span = span
        self.wavelet, self.level = cfg["wavelet"], cfg["level"]
        self.shape = tuple(mix["shape"])
        self.transform = api.Transform(api.FastWaveletTransform(self.wavelet))
        gen = torch.Generator(device=device).manual_seed(seed)
        self.x = torch.randn((mix["distinct_inputs"], *self.shape), generator=gen,
                             device=device, dtype=getattr(torch, cfg["dtype"]))

    def call(self, i):
        v = self.x[i % self.x.shape[0]]
        lv = (self.level,) * 3
        with self.span("forward"):
            y = self.transform.forward(v, *lv)
        with self.span("reverse"):
            r = self.transform.reverse(y, *lv)
        return y, r

    def result(self, i, out):
        return None

    def record(self, i, res):
        pass

    def units(self, i):
        return math.prod(self.shape)

    def kernel_work(self, i):
        """One pyramid along each axis forward (K3), one back (K7)."""
        m = len(taps.SCALING[self.wavelet])
        n = math.prod(self.shape)
        work = [roofline.pyramid_rows(n // e, e, self.level, m) for e in self.shape]
        return [("K3", *w) for w in work] + [("K7", *w) for w in work]

    def check(self, kept):
        lo, hi = taps.fwt_bank(self.wavelet)
        levels = (self.level,) * 3
        errs = {"coeffs_err": [], "recon_err": []}
        for i, (y, r), _ in kept:
            ry = ref.fwt_nd(self.x[i % self.x.shape[0]], lo, hi, levels)
            errs["coeffs_err"].append(RelErr().add(y, ry).value)
            errs["recon_err"].append(RelErr().add(r, ref.ifwt_nd(ry, lo, hi, levels)).value)
        return errs
