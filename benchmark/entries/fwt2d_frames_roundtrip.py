"""A request is the fast wavelet transform facade's 2D round trip on a stack
of frames: ``FastWaveletTransform(wavelet).forward_2d(stack, level, level)``
then ``.reverse_2d(y, level, level)``, the pyramid along each of the last
two axes of every frame (the leading axis is a batch axis).

The mix gives ``shape`` (frames, height, width) and ``distinct_inputs``:
that many stacks of N(0, 1) frames are made on the device from the seed in
set-up, and request i takes stack i mod distinct_inputs. The facade object
is built once in set-up, as a caller holds it. The check compares the
coefficients and the reconstruction of the sampled requests with the
reference (``benchmark/reference/fwt.py``), computed on the device a frame
at a time.
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
        self.transform = api.FastWaveletTransform(self.wavelet)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.x = torch.randn((mix["distinct_inputs"], *self.shape), generator=gen,
                             device=device, dtype=getattr(torch, cfg["dtype"]))

    def call(self, i):
        stack = self.x[i % self.x.shape[0]]
        with self.span("forward"):
            y = self.transform.forward_2d(stack, self.level, self.level)
        with self.span("reverse"):
            r = self.transform.reverse_2d(y, self.level, self.level)
        return y, r

    def result(self, i, out):
        return None

    def record(self, i, res):
        pass

    def units(self, i):
        return math.prod(self.shape)

    def kernel_work(self, i):
        """A pyramid along each axis of every frame forward (K4), and back
        (K5): each pass takes the frames' rows of one axis."""
        m = len(taps.SCALING[self.wavelet])
        frames, height, width = self.shape
        work = [roofline.pyramid_rows(frames * height, width, self.level, m),
                roofline.pyramid_rows(frames * width, height, self.level, m)]
        return [("K4", *w) for w in work] + [("K5", *w) for w in work]

    def check(self, kept):
        lo, hi = taps.fwt_bank(self.wavelet)
        levels = (self.level,) * 2
        errs = {"coeffs_err": [], "recon_err": []}
        for i, (y, r), _ in kept:
            stack = self.x[i % self.x.shape[0]]
            coeffs, recon = RelErr(), RelErr()
            for f in range(stack.shape[0]):
                ry = ref.fwt_nd(stack[f], lo, hi, levels)
                coeffs.add(y[f], ry)
                recon.add(r[f], ref.ifwt_nd(ry, lo, hi, levels))
            errs["coeffs_err"].append(coeffs.value)
            errs["recon_err"].append(recon.value)
        return errs
