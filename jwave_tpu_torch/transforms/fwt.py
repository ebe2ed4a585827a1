"""Fast Wavelet Transform (Mallat pyramid), batched over leading axes.

Reference: jwave/transforms/FastWaveletTransform.java:71-153, as
``jwave_tpu.transforms.fwt`` implements it: per level the analysis butterfly
rewrites the shrinking head ``h = N, N/2, ..`` of one array, producing the
in-place layout ``[A_L | D_L | D_{L-1} | ... | D_1]``.

Routing: a CUDA float32 tensor goes to the fused pyramid kernels, K3 for
``fwt`` (``ops.cuda_pyramid.pyramid_rows``), K7 for ``ifwt``
(``ipyramid_rows``; each the other's backward), K4 twice for ``fwt2d``
(``pyramid_rows_transposed``) and K5 twice for ``ifwt2d``
(``ipyramid_rows_transposed``) on a matrix or a stack of frames (leading
axes), each pass storing every frame transposed within itself, and the
rotated forms of K3 and K7 three times each for a 3D ``fwt3d`` and
``ifwt3d`` (``pyramid_rows_rotated``, ``ipyramid_rows_rotated``).
Everything else (the CPU, float64, bf16, f16) runs the level loop over the
torch butterfly.
"""
from __future__ import annotations

import torch

from ..exceptions import JWaveFailure
from ..filters import get_filter
from ..ops import cuda_pyramid
from ..ops.butterfly import butterfly_forward, ensure_float, synthesis_levels
from ..utils.host import as_tensor
from ..utils.numerics import exponent_of_two, is_power_of_two
from ..utils.profiling import spanned
from .ndim import forward_2d, forward_3d, reverse_2d, reverse_3d


def fwt_max_level(n: int) -> int:
    """Maximum decomposition level for a length-``n`` (power-of-two) signal."""
    return exponent_of_two(n)


def _check_pow2(n: int, who: str):
    if not is_power_of_two(n):
        raise JWaveFailure(
            f"{who} - given last-axis length {n} is not 2^p; "
            "use the Ancient Egyptian Decomposition for arbitrary lengths"
        )


def _on_kernel(x: torch.Tensor) -> bool:
    return x.device.type == "cuda" and x.dtype == torch.float32


@spanned("fwt")
def fwt(x, wavelet, level: int | None = None):
    """Forward FWT along the last axis (length 2^p), batched over the rest.
    ``level`` defaults to the maximum (FastWaveletTransform.java:71-101)."""
    fb = get_filter(wavelet)
    x = as_tensor(x)
    n = x.shape[-1]
    _check_pow2(n, "fwt")
    steps = exponent_of_two(n)
    if level is None:
        level = steps
    if level < 0 or level > steps:
        raise JWaveFailure(f"fwt - level {level} out of range [0, {steps}]")
    x = ensure_float(x)
    if level > 0 and _on_kernel(x):
        done = cuda_pyramid.levels_done(n, fb.transform_wavelength, level)
        flat = x.reshape(-1, n).contiguous()
        return cuda_pyramid.pyramid_rows(flat, fb.dec_lo, fb.dec_hi, done).reshape(x.shape)
    return _butterfly_levels(x, fb, level)


def _butterfly_levels(x: torch.Tensor, fb, level: int) -> torch.Tensor:
    """fwt's route where no kernel applies: the level loop over the torch
    butterfly (cuDNN convolutions on the card)."""
    n = x.shape[-1]
    h = n
    l = 0
    while h >= fb.transform_wavelength and l < level:
        head = butterfly_forward(x[..., :h], fb.dec_lo, fb.dec_hi)
        x = torch.cat([head, x[..., h:]], dim=-1) if h < n else head
        h >>= 1
        l += 1
    return x


@spanned("ifwt")
def ifwt(y, wavelet, level: int | None = None):
    """Inverse FWT along the last axis (FastWaveletTransform.java:119-153)."""
    fb = get_filter(wavelet)
    y = as_tensor(y)
    n = y.shape[-1]
    _check_pow2(n, "ifwt")
    steps = exponent_of_two(n)
    if level is None:
        level = steps
    if level < 0 or level > steps:
        raise JWaveFailure(f"ifwt - level {level} out of range [0, {steps}]")
    y = ensure_float(y)
    # the number of levels the forward actually performed: it stops at
    # `level` or when the head drops below transform_wavelength (the
    # reference's h = tw << (steps - level) is right only for tw == 2; for
    # Battle 23, tw = 8, its partial-level inverse would do nothing)
    done = cuda_pyramid.levels_done(n, fb.transform_wavelength, level)
    if done > 0 and _on_kernel(y):
        flat = y.reshape(-1, n).contiguous()
        return cuda_pyramid.ipyramid_rows(flat, fb.rec_lo, fb.rec_hi, fb.recon_gain,
                                          done).reshape(y.shape)
    return synthesis_levels(y, fb.rec_lo, fb.rec_hi, done, fb.recon_gain)


def fwt_decompose(x, wavelet):
    """All-level decomposition matrix (WaveletTransform.java:136-146):
    (..., p+1, N), row 0 the input and row l the forward at level l."""
    fb = get_filter(wavelet)
    x = as_tensor(x)
    n = x.shape[-1]
    _check_pow2(n, "fwt_decompose")
    steps = exponent_of_two(n)
    cur = ensure_float(x)
    rows = [cur]
    h = n
    l = 0
    while h >= fb.transform_wavelength and l < steps:
        head = butterfly_forward(cur[..., :h], fb.dec_lo, fb.dec_hi)
        cur = torch.cat([head, cur[..., h:]], dim=-1) if h < n else head
        rows.append(cur)
        h >>= 1
        l += 1
    return torch.stack(rows, dim=-2)


def decompose_row(mat: torch.Tensor, level: int) -> torch.Tensor:
    """Row ``level`` of a decompose matrix (..., rows, N). A level past the
    last row reads the last row, as JAX's clamped index does: the inverse
    then rejects a level the length cannot hold, or stops where the forward
    stopped."""
    rows = mat.shape[-2]
    return mat[..., max(min(level, rows - 1), -rows), :]


def fwt_recompose(mat, wavelet, level: int | None = None):
    """Reconstruct from one row of a decompose matrix (highest by default)."""
    mat = as_tensor(mat)
    if level is None:
        level = mat.shape[-2] - 1
    return ifwt(decompose_row(mat, level), wavelet, level)


def fwt_split(y, level: int | None = None):
    """Split an in-place pyramid array into named views
    ``{"aL": ..., "dL": ..., ..., "d1": ...}``. Inverse of :func:`fwt_merge`."""
    n = y.shape[-1]
    steps = exponent_of_two(n)
    if level is None:
        level = steps
    parts = {f"a{level}": y[..., : n >> level]}
    for l in range(level, 0, -1):
        parts[f"d{l}"] = y[..., n >> l: n >> (l - 1)]
    return parts


def fwt_merge(parts: dict):
    """Reassemble :func:`fwt_split` views into the pyramid array."""
    details = [int(k[1:]) for k in parts if k.startswith("d")]
    level = max(details) if details else 0
    order = [f"a{level}"] + [f"d{l}" for l in range(level, 0, -1)]
    return torch.cat([as_tensor(parts[k]) for k in order], dim=-1)


def _check_2d_levels(shape, level_rows, level_cols, who: str):
    """The level-range contract of fwt()/ifwt(), checked before routing."""
    for n, lvl, axis in ((shape[-2], level_rows, "rows"), (shape[-1], level_cols, "cols")):
        _check_pow2(n, who)
        steps = exponent_of_two(n)
        if lvl is not None and (lvl < 0 or lvl > steps):
            raise JWaveFailure(f"{who} - {axis} level {lvl} out of range [0, {steps}]")


def _frame_levels(x: torch.Tensor, fb, levels, rows_per_block) -> tuple | None:
    """The levels done by each of the two grouped passes of a 2D transform
    of ``x``, given ``levels`` as (level_cols, level_rows), the passes'
    order; None where ``x`` keeps the separable path: not a CUDA float32
    tensor of rank >= 2 with 1 to 2^31 - 1 elements, an extent that is not
    a power of two or that ``rows_per_block`` (K4's or K5's) refuses, or a
    level out of its range (the separable path raises for those). Leading
    axes are frames."""
    if x.dim() < 2 or not _on_kernel(x) or not 0 < x.numel() < 2**31:
        return None
    height, width = x.shape[-2:]
    level_cols, level_rows = levels
    if height & (height - 1) or width & (width - 1) or not (
            rows_per_block(width) and rows_per_block(height)):
        return None
    steps_w, steps_h = width.bit_length() - 1, height.bit_length() - 1
    level_cols = steps_w if level_cols is None else level_cols
    level_rows = steps_h if level_rows is None else level_rows
    if not (0 <= level_cols <= steps_w and 0 <= level_rows <= steps_h):
        return None
    tw = fb.transform_wavelength
    return (cuda_pyramid.levels_done(width, tw, level_cols),
            cuda_pyramid.levels_done(height, tw, level_rows))


def _frame_passes(x: torch.Tensor, done, axis_pass, *filters) -> torch.Tensor:
    """Two grouped passes, ``axis_pass(rows, *filters, levels, group=...)``,
    over a stack (..., H, W): the first takes the frames as (F H, W) rows
    and stores each frame as (W, H), (F W, H) rows, the second transforms H
    the same way and leaves (F H, W), the stack's layout."""
    shape = x.shape
    height, width = shape[-2:]
    rows = x.contiguous()
    if len(shape) > 2:
        rows = rows.view(-1, width)
    rows = axis_pass(rows, *filters, done[0], group=height)
    rows = axis_pass(rows, *filters, done[1], group=width)
    return rows if len(shape) == 2 else rows.view(shape)


@spanned("fwt2d")
def fwt2d(mat, wavelet, level_rows: int | None = None, level_cols: int | None = None):
    """2D FWT (standard decomposition: the full 1D pyramid along each axis —
    BasicTransform.java:361-399) of a real matrix, or of each frame of a
    stack (leading axes), laid out as ``ndim.forward_2d`` over :func:`fwt`
    lays it out.

    A CUDA float32 input whose extents fit a K4 block runs as two K4
    passes, each transforming the last axis and storing every frame
    transposed within itself (``group``: the frame's rows), so no
    transposing copy is left; any other input takes the separable path
    over :func:`fwt`."""
    x = ensure_float(as_tensor(mat))
    fb = get_filter(wavelet)
    if x.dim() == 2:
        _check_2d_levels(x.shape, level_rows, level_cols, "fwt2d")
    done = _frame_levels(x, fb, (level_cols, level_rows), cuda_pyramid.k4_rows_per_block)
    if done is None:
        return forward_2d(lambda v, lvl: fwt(v, fb, lvl), x, level_rows, level_cols)
    return _frame_passes(x, done, cuda_pyramid.pyramid_rows_transposed, fb.dec_lo, fb.dec_hi)


@spanned("ifwt2d")
def ifwt2d(coeffs, wavelet, level_rows: int | None = None, level_cols: int | None = None):
    """Inverse of :func:`fwt2d`.

    A CUDA float32 input whose extents fit a K5 block runs as two K5
    passes: the first inverts the last axis (``level_cols``) and stores
    every frame transposed within itself, the second inverts the other
    (``level_rows``); the two axes' operators commute. Any other input takes
    the separable synthesis path over :func:`ifwt`."""
    y = ensure_float(as_tensor(coeffs))
    fb = get_filter(wavelet)
    if y.dim() == 2:
        _check_2d_levels(y.shape, level_rows, level_cols, "ifwt2d")
    done = _frame_levels(y, fb, (level_cols, level_rows), cuda_pyramid.k5_rows_per_block)
    if done is None:
        return reverse_2d(lambda v, lvl: ifwt(v, fb, lvl), y, level_rows, level_cols)
    return _frame_passes(y, done, cuda_pyramid.ipyramid_rows_transposed, fb.rec_lo, fb.rec_hi,
                         fb.recon_gain)


def _rotated_levels(x: torch.Tensor, fb, levels) -> tuple | None:
    """The levels done on each axis of a volume by the rotated route, given
    ``levels`` as (level_r, level_q, level_p), in that order; None where the
    volume keeps the separable path: another rank, dtype or device, more
    than 2^31 voxels, an extent that the rotated forms do not take
    (``cuda_pyramid.rotated_rows``) or a level out of its range (the
    separable path raises for it)."""
    if not (x.dim() == 3 and _on_kernel(x) and x.numel() < 2**31):
        return None
    done = []
    for n, level in zip(reversed(x.shape), levels):
        if not cuda_pyramid.rotated_rows(n):
            return None
        steps = exponent_of_two(n)
        level = steps if level is None else level
        if not 0 <= level <= steps:
            return None
        done.append(cuda_pyramid.levels_done(n, fb.transform_wavelength, level))
    return tuple(done)


def _rotated_passes(x: torch.Tensor, done, rotated_pass) -> torch.Tensor:
    """Three rotated passes over (P, Q, R): each takes the volume (a, b, c)
    as (a b, c) rows and stores (c, a b), so R, Q and P take their turn
    last, ``done`` levels each, and the third pass leaves (P, Q, R)."""
    y = x.contiguous()
    for lv in done:
        a, b, c = y.shape
        y = rotated_pass(y.reshape(a * b, c), lv).view(c, a, b)
    return y


@spanned("fwt3d")
def _fwt3d_rotated(x: torch.Tensor, fb, done) -> torch.Tensor:
    return _rotated_passes(
        x, done, lambda rows, lv: cuda_pyramid.pyramid_rows_rotated(rows, fb.dec_lo, fb.dec_hi,
                                                                    lv))


@spanned("ifwt3d")
def _ifwt3d_rotated(y: torch.Tensor, fb, done) -> torch.Tensor:
    return _rotated_passes(
        y, done, lambda rows, lv: cuda_pyramid.ipyramid_rows_rotated(rows, fb.rec_lo, fb.rec_hi,
                                                                     fb.recon_gain, lv))


def fwt3d(spc, wavelet, level_p: int | None = None, level_q: int | None = None,
          level_r: int | None = None):
    """3D FWT over the last three axes (BasicTransform.java:487-566), laid
    out as ``ndim.forward_3d`` over :func:`fwt` lays it out: the last axis
    at ``level_r``, then the columns at ``level_q``, then the pillars at
    ``level_p``.

    A rank-3 CUDA float32 volume whose extents the rotated forms take runs
    as three rotated K3 passes (one ``fwt3d`` span), each transforming the
    last axis and storing it first, so no transposing copy is left; any
    other input takes the separable path."""
    x = as_tensor(spc)
    fb = get_filter(wavelet)
    done = _rotated_levels(x, fb, (level_r, level_q, level_p))
    if done is None:
        return forward_3d(lambda v, lvl: fwt(v, fb, lvl), x, level_p, level_q, level_r)
    return _fwt3d_rotated(x, fb, done)


def ifwt3d(coeffs, wavelet, level_p: int | None = None, level_q: int | None = None,
           level_r: int | None = None):
    """Inverse of :func:`fwt3d`, as ``ndim.reverse_3d`` over :func:`ifwt`:
    three rotated K7 passes (one ``ifwt3d`` span) where :func:`fwt3d` takes
    three rotated K3 passes, else the separable path."""
    y = as_tensor(coeffs)
    fb = get_filter(wavelet)
    done = _rotated_levels(y, fb, (level_r, level_q, level_p))
    if done is None:
        return reverse_3d(lambda v, lvl: ifwt(v, fb, lvl), y, level_p, level_q, level_r)
    return _ifwt3d_rotated(y, fb, done)
