"""Dual-tree complex wavelet transform (Kingsbury 1998-2001; Selesnick,
Baraniuk & Kingsbury 2005), as ``jwave_tpu.transforms.dtcwt`` computes it.

Two parallel orthonormal DWT trees whose wavelets form an approximate
Hilbert pair: complex coefficients ``w = (d_a + i d_b)/sqrt(2)`` whose
MAGNITUDE is nearly shift-invariant, at 2x (1D) / 4x (2D) redundancy, with
perfect reconstruction and, in 2D, six direction-selective oriented subbands
(+-15, +-45, +-75 degrees), which a separable real DWT cannot produce.

Tree construction:
- Level 1: one orthonormal bank (default sym4) for tree A; tree B is the
  SAME bank applied to the signal advanced by one sample.
- Levels >= 2: the q-shift pair from :mod:`jwave_tpu_torch.filters.qshift`:
  one designed length-14 orthonormal lowpass for tree A and its time
  reverse for tree B, so the trees stay half a sample apart at every scale.

Each tree level is the batched stride-2 circular-convolution butterfly the
FWT uses (``ops.butterfly``: one cuDNN ``conv1d`` under ``config.dial``); no
kernel of this package runs here. Inverse = each tree's exact adjoint
synthesis, averaged. Real float32/float64 input gives complex64/complex128
highpasses; bfloat16 and float16 give complex64 (the JAX package raises for
bfloat16 in 1D, and gives complex64 in 2D), with the lowpasses in the input's
dtype and the inverse in float32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..exceptions import JWaveFailure
from ..filters import get_filter
from ..filters.qshift import qshift_filters
from ..ops.butterfly import butterfly_forward, butterfly_reverse, ensure_float
from ..utils.host import as_tensor, copy_to_device

_SQRT2 = math.sqrt(2.0)


def _check_args(n: int, levels: int, who: str, axis: str = "last-axis"):
    if levels < 1:
        raise JWaveFailure(f"{who} - levels must be >= 1")
    if n % (1 << levels) != 0:
        raise JWaveFailure(
            f"{who} - {axis} length {n} must be divisible by 2^levels = "
            f"{1 << levels}"
        )
    if n >> levels < 1:
        raise JWaveFailure(f"{who} - {levels} levels exhaust {axis} length {n}")


def _complex(re_: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """re + i im; half-precision parts become complex64."""
    if re_.dtype not in (torch.float32, torch.float64):
        re_, im = re_.float(), im.float()
    return torch.complex(re_, im)


# --------------------------------------------------------------------------
# 1D
# --------------------------------------------------------------------------

@dataclass
class DTCWTResult:
    """1D dual-tree coefficients.

    ``highpasses``: tuple over levels 1..J of complex (..., N/2^j) tensors
    ``(d_a + i d_b)/sqrt(2)``; ``lowpasses``: (..., 2, N/2^J), both trees'
    final smooth bands (needed for inversion).
    """

    highpasses: tuple
    lowpasses: torch.Tensor
    level1_wavelet: str

    @classmethod
    def from_numpy(cls, highpasses, lowpasses, level1_wavelet="sym4",
                   device=None) -> "DTCWTResult":
        """A result from numpy arrays (e.g. a JAX package result's fields as
        ``np.asarray``), copied into tensors on ``device`` ("cuda" by
        default)."""
        return cls(tuple(copy_to_device(h, device) for h in highpasses),
                   copy_to_device(lowpasses, device),
                   str(level1_wavelet))

    @property
    def levels(self) -> int:
        return len(self.highpasses)

    def magnitudes(self):
        """Per-level |w| — the (nearly) shift-invariant envelopes."""
        return tuple(torch.abs(h) for h in self.highpasses)


def dtcwt(signal, levels: int, level1_wavelet: str = "sym4") -> DTCWTResult:
    """Forward 1D DTCWT of (..., N) real signals (N divisible by 2^levels).

    Returns a :class:`DTCWTResult`; ``idtcwt`` inverts it exactly.
    """
    x = ensure_float(as_tensor(signal))
    if x.is_complex():
        raise JWaveFailure("dtcwt - expected a real signal")
    _check_args(x.shape[-1], levels, "dtcwt")
    fb = get_filter(level1_wavelet)
    (h0a, h1a), (h0b, h1b) = qshift_filters()

    # level 1: tree B sees the signal advanced one sample
    ya = butterfly_forward(x, fb.dec_lo, fb.dec_hi)
    yb = butterfly_forward(torch.roll(x, -1, -1), fb.dec_lo, fb.dec_hi)
    half = x.shape[-1] // 2
    la, da = ya[..., :half], ya[..., half:]
    lb, db = yb[..., :half], yb[..., half:]
    highs = [_complex(da, db) / _SQRT2]
    for _ in range(1, levels):
        # q-shift levels: one butterfly per tree
        ya = butterfly_forward(la, h0a, h1a)
        yb = butterfly_forward(lb, h0b, h1b)
        half //= 2
        la, da = ya[..., :half], ya[..., half:]
        lb, db = yb[..., :half], yb[..., half:]
        highs.append(_complex(da, db) / _SQRT2)
    low = torch.stack([la, lb], dim=-2)
    return DTCWTResult(tuple(highs), low, level1_wavelet)


def idtcwt(result: DTCWTResult) -> torch.Tensor:
    """Inverse 1D DTCWT (exact; each tree reconstructs independently and
    the two reconstructions are averaged)."""
    fb = get_filter(result.level1_wavelet)
    (h0a, h1a), (h0b, h1b) = qshift_filters()
    la = result.lowpasses[..., 0, :]
    lb = result.lowpasses[..., 1, :]
    for j in range(result.levels - 1, 0, -1):
        w = result.highpasses[j] * _SQRT2
        la = butterfly_reverse(torch.cat([la, w.real], dim=-1), h0a, h1a, 1.0)
        lb = butterfly_reverse(torch.cat([lb, w.imag], dim=-1), h0b, h1b, 1.0)
    w = result.highpasses[0] * _SQRT2
    xa = butterfly_reverse(torch.cat([la, w.real], dim=-1),
                           fb.rec_lo, fb.rec_hi, fb.recon_gain)
    xb = butterfly_reverse(torch.cat([lb, w.imag], dim=-1),
                           fb.rec_lo, fb.rec_hi, fb.recon_gain)
    return 0.5 * (xa + torch.roll(xb, 1, -1))


# --------------------------------------------------------------------------
# 2D
# --------------------------------------------------------------------------

def _butterfly_axis(x, lo, hi, axis):
    """Analysis butterfly along ``axis`` (batched everywhere else)."""
    x = x.transpose(axis, -1)
    y = butterfly_forward(x, lo, hi)
    return y.transpose(axis, -1)



def _ibutterfly_axis(y, lo, hi, axis):
    y = y.transpose(axis, -1)
    x = butterfly_reverse(y, lo, hi, 1.0)
    return x.transpose(axis, -1)


@dataclass
class DTCWT2DResult:
    """2D dual-tree coefficients.

    ``highpasses``: tuple over levels of complex (..., 6, H/2^j, W/2^j)
    oriented subbands, ordered [+15, +45, +75, -75, -45, -15] degrees
    (angle measured from the horizontal axis of the image).
    ``lowpasses``: (..., 2, 2, H/2^J, W/2^J): [row-tree, col-tree] final
    smooth bands.
    """

    highpasses: tuple
    lowpasses: torch.Tensor
    level1_wavelet: str

    @classmethod
    def from_numpy(cls, highpasses, lowpasses, level1_wavelet="sym4",
                   device=None) -> "DTCWT2DResult":
        """A result from numpy arrays (e.g. a JAX package result's fields as
        ``np.asarray``), copied into tensors on ``device`` ("cuda" by
        default)."""
        return cls(tuple(copy_to_device(h, device) for h in highpasses),
                   copy_to_device(lowpasses, device),
                   str(level1_wavelet))

    @property
    def levels(self) -> int:
        return len(self.highpasses)


_INV_SQRT2 = 1.0 / _SQRT2


def _combine(s_aa, s_ab, s_ba, s_bb):
    """Four real tree subbands -> two oriented complex subbands
    (Kingsbury's q2c: p = (s_aa + i s_ab)/sqrt2, q = (s_bb - i s_ba)/sqrt2,
    z = p -+ q). Unitary: |z_p|^2 + |z_m|^2 == sum of the tree energies.

    z_p responds to one diagonal direction, z_m to its mirror: the
    quadrature (Hilbert) structure across trees suppresses the opposite
    orientation that a separable real transform would mix in.
    """
    z_p = ((s_aa - s_bb) + 1j * (s_ab + s_ba)) * _INV_SQRT2
    z_m = ((s_aa + s_bb) + 1j * (s_ab - s_ba)) * _INV_SQRT2
    return z_p, z_m


def _split_quads(y2, h, w):
    """[[LL, LH], [HL, HH]] quadrants of a row+col butterflied image whose
    layout is [L | H] along each transformed axis."""
    return (y2[..., :h, :w], y2[..., :h, w:],
            y2[..., h:, :w], y2[..., h:, w:])


def dtcwt2d(image, levels: int, level1_wavelet: str = "sym4") -> DTCWT2DResult:
    """Forward 2D DTCWT of (..., H, W) real images (H, W divisible by
    2^levels). Six oriented complex subbands per level."""
    x = ensure_float(as_tensor(image))
    if x.dim() < 2:
        raise JWaveFailure("dtcwt2d - image must have at least 2 axes")
    if x.is_complex():
        raise JWaveFailure("dtcwt2d - expected a real image")
    _check_args(x.shape[-1], levels, "dtcwt2d", "width")
    _check_args(x.shape[-2], levels, "dtcwt2d", "height")
    fb = get_filter(level1_wavelet)
    (h0a, h1a), (h0b, h1b) = qshift_filters()
    qa, qb = (h0a, h1a), (h0b, h1b)

    # ll[r][c]: lowpass image of (row-tree r, col-tree c).
    # Level 1: every tree product shares the SAME bank, so the whole level
    # is TWO batched butterflies (rows: 2 trees stacked; cols: 4 products
    # stacked) instead of six.
    highs = []
    h, w = x.shape[-2] // 2, x.shape[-1] // 2
    rows = torch.stack([x, torch.roll(x, -1, -2)], dim=0)  # (2, ..., H, W)
    rowt = _butterfly_axis(rows, fb.dec_lo, fb.dec_hi, -2)
    cols = torch.stack([rowt[0], torch.roll(rowt[0], -1, -1),
                        rowt[1], torch.roll(rowt[1], -1, -1)], dim=0)
    y4 = _butterfly_axis(cols, fb.dec_lo, fb.dec_hi, -1)
    subs = {rc: _split_quads(y4[i], h, w)
            for i, rc in enumerate(("aa", "ab", "ba", "bb"))}
    highs.append(_orient_stack(subs))
    ll = {rc: q[0] for rc, q in subs.items()}

    for _ in range(1, levels):
        # q-shift levels: the row bank depends only on rc[0] and the col
        # bank only on rc[1], so products sharing a bank batch together
        # (2 stacked butterflies per axis)
        h, w = h // 2, w // 2
        rowA = torch.stack([ll["aa"], ll["ab"]], dim=0)  # row-tree a
        rowB = torch.stack([ll["ba"], ll["bb"]], dim=0)  # row-tree b
        ytA = _butterfly_axis(rowA, qa[0], qa[1], -2)
        ytB = _butterfly_axis(rowB, qb[0], qb[1], -2)
        rAlo, rAhi = ytA[..., :h, :], ytA[..., h:, :]
        rBlo, rBhi = ytB[..., :h, :], ytB[..., h:, :]
        # col groups by col tree: index 0 of each stack is col-tree a
        colA = torch.stack([rAlo[0], rAhi[0], rBlo[0], rBhi[0]], dim=0)
        colB = torch.stack([rAlo[1], rAhi[1], rBlo[1], rBhi[1]], dim=0)
        ycA = _butterfly_axis(colA, qa[0], qa[1], -1)
        ycB = _butterfly_axis(colB, qb[0], qb[1], -1)
        cAlo, cAhi = ycA[..., :w], ycA[..., w:]
        cBlo, cBhi = ycB[..., :w], ycB[..., w:]
        subs = {  # (LL, LH, HL, HH) per tree product
            "aa": (cAlo[0], cAhi[0], cAlo[1], cAhi[1]),
            "ba": (cAlo[2], cAhi[2], cAlo[3], cAhi[3]),
            "ab": (cBlo[0], cBhi[0], cBlo[1], cBhi[1]),
            "bb": (cBlo[2], cBhi[2], cBlo[3], cBhi[3]),
        }
        highs.append(_orient_stack(subs))
        ll = {rc: q[0] for rc, q in subs.items()}

    low = torch.stack([
        torch.stack([ll["aa"], ll["ab"]], dim=-3),
        torch.stack([ll["ba"], ll["bb"]], dim=-3),
    ], dim=-4)
    return DTCWT2DResult(tuple(highs), low, level1_wavelet)


def _orient_stack(subs):
    """(LH, HL, HH) x 4 trees -> (..., 6, h, w) oriented complex stack."""
    bands = []
    for qi in (1, 2, 3):  # LH (horizontal-ish), HL (vertical-ish), HH (diag)
        z_p, z_m = _combine(subs["aa"][qi], subs["ab"][qi],
                            subs["ba"][qi], subs["bb"][qi])
        bands.append((z_p, z_m))
    (lh_p, lh_m), (hl_p, hl_m), (hh_p, hh_m) = bands
    return torch.stack([lh_p, hh_p, hl_p, hl_m, hh_m, lh_m], dim=-3)


def _unorient(stack):
    """Inverse of :func:`_orient_stack`."""
    lh_p, hh_p, hl_p, hl_m, hh_m, lh_m = (stack[..., i, :, :] for i in range(6))
    out = {}
    for name, (z_p, z_m) in (("lh", (lh_p, lh_m)), ("hl", (hl_p, hl_m)),
                             ("hh", (hh_p, hh_m))):
        out[name] = {
            "aa": (z_p.real + z_m.real) * _INV_SQRT2,
            "bb": (z_m.real - z_p.real) * _INV_SQRT2,
            "ab": (z_p.imag + z_m.imag) * _INV_SQRT2,
            "ba": (z_p.imag - z_m.imag) * _INV_SQRT2,
        }
    return out


def idtcwt2d(result: DTCWT2DResult) -> torch.Tensor:
    """Inverse 2D DTCWT (exact; the four tree reconstructions averaged)."""
    fb = get_filter(result.level1_wavelet)
    (h0a, h1a), (h0b, h1b) = qshift_filters()
    qa, qb = (h0a, h1a), (h0b, h1b)
    ll = {
        "aa": result.lowpasses[..., 0, 0, :, :],
        "ab": result.lowpasses[..., 0, 1, :, :],
        "ba": result.lowpasses[..., 1, 0, :, :],
        "bb": result.lowpasses[..., 1, 1, :, :],
    }
    for j in range(result.levels - 1, 0, -1):
        # adjoint of the fused forward: one dual round per axis for all
        # four tree products (cols first — reverse of the analysis order)
        quads = _unorient(result.highpasses[j])

        def col_parts(rc):
            a = torch.cat([ll[rc], quads["hl"][rc]], dim=-2)  # L cols
            d = torch.cat([quads["lh"][rc], quads["hh"][rc]], dim=-2)
            return a, d

        aA, dA = col_parts("aa")
        aB, dB = col_parts("ba")
        a2, d2 = col_parts("ab")
        b2, e2 = col_parts("bb")
        colA = torch.cat([torch.stack([aA, aB], dim=0),
                          torch.stack([dA, dB], dim=0)], dim=-1)
        colB = torch.cat([torch.stack([a2, b2], dim=0),
                          torch.stack([d2, e2], dim=0)], dim=-1)
        yA = _ibutterfly_axis(colA, qa[0], qa[1], -1)  # col-tree a
        yB = _ibutterfly_axis(colB, qb[0], qb[1], -1)  # col-tree b
        # row inverse: group by row tree — yA holds (aa, ba), yB (ab, bb)
        hh = yA.shape[-2] // 2
        rowA = torch.cat([
            torch.stack([yA[0, ..., :hh, :], yB[0, ..., :hh, :]], dim=0),
            torch.stack([yA[0, ..., hh:, :], yB[0, ..., hh:, :]], dim=0),
        ], dim=-2)
        rowB = torch.cat([
            torch.stack([yA[1, ..., :hh, :], yB[1, ..., :hh, :]], dim=0),
            torch.stack([yA[1, ..., hh:, :], yB[1, ..., hh:, :]], dim=0),
        ], dim=-2)
        xA = _ibutterfly_axis(rowA, qa[0], qa[1], -2)
        xB = _ibutterfly_axis(rowB, qb[0], qb[1], -2)
        ll = {"aa": xA[0], "ab": xA[1], "ba": xB[0], "bb": xB[1]}
    # level 1: same bank everywhere — one batched synthesis per axis
    quads = _unorient(result.highpasses[0])
    y4 = []
    for rc in ("aa", "ab", "ba", "bb"):
        top = torch.cat([ll[rc], quads["lh"][rc]], dim=-1)
        bot = torch.cat([quads["hl"][rc], quads["hh"][rc]], dim=-1)
        y4.append(torch.cat([top, bot], dim=-2))
    y4 = torch.stack(y4, dim=0)
    img4 = _ibutterfly_axis(
        _ibutterfly_axis(y4, fb.rec_lo, fb.rec_hi, -1),
        fb.rec_lo, fb.rec_hi, -2)
    recons = [img4[0],
              torch.roll(img4[1], 1, -1),
              torch.roll(img4[2], 1, -2),
              torch.roll(img4[3], (1, 1), (-1, -2))]
    return 0.25 * sum(recons)
