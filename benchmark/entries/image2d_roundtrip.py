"""A request is ``fwt2d(m, wavelet, level, level)`` then ``ifwt2d`` on one
image.

The mix gives ``shape`` (two extents) and ``distinct_inputs``: that many
images are made on the device from the seed in set-up, and request i takes
image i mod distinct_inputs. The check compares the coefficients and the
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
        self.api, self.span = api, span
        self.wavelet, self.level = cfg["wavelet"], cfg["level"]
        self.shape = tuple(mix["shape"])
        gen = torch.Generator(device=device).manual_seed(seed)
        self.x = torch.randn((mix["distinct_inputs"], *self.shape), generator=gen,
                             device=device, dtype=getattr(torch, cfg["dtype"]))

    def units(self, i):
        return math.prod(self.shape)

    def call(self, i):
        m = self.x[i % self.x.shape[0]]
        with self.span("fwt2d"):
            y = self.api.fwt2d(m, self.wavelet, self.level, self.level)
        with self.span("ifwt2d"):
            r = self.api.ifwt2d(y, self.wavelet, self.level, self.level)
        return y, r

    def result(self, i, out):
        return None

    def record(self, i, res):
        pass

    def kernel_work(self, i):
        """A pyramid along each axis forward (K4), one back (K5)."""
        m = len(taps.SCALING[self.wavelet])
        n = math.prod(self.shape)
        work = [roofline.pyramid_rows(n // e, e, self.level, m) for e in self.shape]
        return [("K4", *w) for w in work] + [("K5", *w) for w in work]

    def check(self, kept):
        lo, hi = taps.fwt_bank(self.wavelet)
        levels = (self.level,) * 2
        errs = {"coeffs_err": [], "recon_err": []}
        for i, (y, r), _ in kept:
            ry = ref.fwt_nd(self.x[i % self.x.shape[0]], lo, hi, levels)
            errs["coeffs_err"].append(RelErr().add(y, ry).value)
            errs["recon_err"].append(RelErr().add(r, ref.ifwt_nd(ry, lo, hi, levels)).value)
        return errs
