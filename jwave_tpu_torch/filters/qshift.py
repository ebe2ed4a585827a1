"""Q-shift filters for the dual-tree complex wavelet transform.

A copy of ``jwave_tpu.filters.qshift``. Designed by ``tools/design_qshift.py``
(this repository), NOT transcribed
from published tables: an orthonormal length-14 lowpass parametrized by 7
paraunitary-lattice rotations (perfect reconstruction is structural — it
holds for any angles, to machine precision) with the angles optimized for
quarter-sample group-delay flatness (target tau = 6.25 samples) across
pass + transition bands, stopband energy above 0.6 pi, a second vanishing
moment by penalty, and the first vanishing moment pinned EXACTLY by the
angle-sum constraint sum(thetas) = pi/4 (for this lattice |H(pi)| =
sqrt(2)|sin(sum - pi/4)|, so H(pi) = 0 to machine precision). Tree A uses
``QSHIFT_14`` (delay K - 3/4), tree B its time reverse (delay K - 1/4):
the half-sample delay split makes the two trees' wavelets an approximate
Hilbert pair.

Achieved analyticity of the cascaded complex wavelet psi_a + i psi_b:
-30.7 dB negative-frequency energy (tests/test_dtcwt.py verifies it along
with orthonormality and the delay split).
"""
import numpy as np

# lattice angles (provenance: tools/design_qshift.py; the last angle is
# pi/4 - sum(rest), which pins H(pi) = 0 EXACTLY: for this lattice
# |H(pi)| = sqrt(2) |sin(sum(thetas) - pi/4)|)
QSHIFT_14_THETAS = np.asarray([
    2.93175232197684199, 2.05726270642287812, -2.22663121420853605,
    2.03975484169796806, 1.69125442201421983, 0.81084799728099688,
    -6.51884291178692088,
])

QSHIFT_14 = np.asarray([
    -1.01440790321456267e-02, 2.43578727200433444e-03,
    2.77979887087247864e-02, -1.79642722248771966e-02,
    -1.01901761222457699e-01, 2.45033895662674833e-01,
    7.86371679321052119e-01, 5.49534763151901640e-01,
    3.47547880624731950e-03, -8.82246815678426194e-02,
    9.88711524806390810e-04, 1.41308483048680038e-02,
    5.18763080320397245e-04, 2.16044058781831704e-03,
])


def altflip(h: np.ndarray) -> np.ndarray:
    """CQF highpass partner: g[n] = (-1)^n h[L-1-n]."""
    g = h[::-1].copy()
    g[1::2] *= -1.0
    return g


def qshift_filters():
    """((h0a, h1a), (h0b, h1b)): the level->=2 dual-tree analysis pairs.
    Tree B is the time reverse of tree A (half-sample delay split)."""
    h0a = QSHIFT_14
    h0b = QSHIFT_14[::-1].copy()
    return (h0a, altflip(h0a)), (h0b, altflip(h0b))
