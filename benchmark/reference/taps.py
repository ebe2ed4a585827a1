"""A frozen copy of the published Daubechies 4 filters.

The eight scaling coefficients of Daubechies' extremal-phase wavelet with
four vanishing moments (I. Daubechies, "Ten Lectures on Wavelets", SIAM
1992, Table 6.1, N = 4), normalised to sum sqrt(2), in the order in which
JWave's ``Daubechies4`` and PyWavelets' ``db4`` list them. The wavelet
filter is the quadrature mirror of the scaling filter, and synthesis uses
the analysis filters (an orthonormal bank).
"""
from __future__ import annotations

import math

DB4_SCALING = (
    -0.010597401784997278,
    0.032883011666982945,
    0.030841381835986965,
    -0.18703481171888114,
    -0.02798376941698385,
    0.6308807679295904,
    0.7148465705525415,
    0.23037781330885523,
)

#: wavelet names as the port's configurations give them -> scaling filter
SCALING = {"Daubechies 4": DB4_SCALING}


def qmf(lo):
    """The wavelet filter of an orthonormal bank: hi[i] = (-1)^i lo[M-1-i]."""
    m = len(lo)
    return tuple((1.0 if i % 2 == 0 else -1.0) * lo[m - 1 - i] for i in range(m))


def fwt_bank(wavelet: str):
    """(lo, hi) of the FWT butterfly: out[i] = sum_j x[(2i+j) mod h] lo[j]."""
    lo = SCALING[wavelet]
    return lo, qmf(lo)


def modwt_filters(wavelet: str):
    """(g, h): the FWT filters at unit L2 norm, divided by sqrt(2)."""
    lo, hi = fwt_bank(wavelet)
    out = []
    for f in (lo, hi):
        nrm = math.sqrt(sum(v * v for v in f))
        out.append(tuple(v / nrm / math.sqrt(2.0) for v in f))
    return out[0], out[1]
