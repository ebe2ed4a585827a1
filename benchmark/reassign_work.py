"""The work of K6, the synchrosqueezing reassignment, counted from its shapes
as ``benchmark/roofline.py`` counts the other kernels' (each input byte read
once, each output byte written once), for ``roofline.bound_s``."""
from __future__ import annotations


def reassign(rows: int, scales: int, n: int, bins: int, itemsize: int = 4):
    """K6 on (rows, scales, n) complex contributions (two reals of
    ``itemsize`` bytes) and their int32 bin indices into the (rows, bins, n)
    complex plane; each contribution is one compare and a complex add (two
    flops). Returns (bytes, flops)."""
    c = 2 * itemsize
    return rows * n * (scales * (c + 4) + bins * c), 2 * rows * scales * n
