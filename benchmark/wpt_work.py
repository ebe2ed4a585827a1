"""The work of K8 and K9, the fused wavelet packet transform and its
inverse, counted from their shapes as ``benchmark/roofline.py`` counts the
other kernels' (each input byte read once, each output byte written once),
for ``roofline.bound_s``."""
from __future__ import annotations


def wpt_rows(rows: int, n: int, levels: int, taps: int, itemsize: int = 4):
    """K8 (or K9, the same counts): ``levels`` packet levels along rows of
    ``n``; (rows, n) in and out; a level makes n outputs a row, each of
    ``taps`` multiply-adds, as ``roofline.pyramid_rows`` counts a step.
    Returns (bytes, flops)."""
    return 2 * itemsize * rows * n, 2 * taps * n * levels * rows
