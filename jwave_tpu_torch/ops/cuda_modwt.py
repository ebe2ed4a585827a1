"""K1/K2: the fused MODWT cascade (``csrc/modwt.cu``), with plain versions.

Replaces ``jwave_tpu/ops/pallas_modwt.py`` (``_modwt_kernel``,
``_imodwt_kernel``). For levels j with gap 2^(j-1):

    forward  W_j[t] = sum_m h0[m] V_{j-1}[(t - m*gap) mod N],  V_j likewise with g0
    inverse  V_{j-1}[t] = sum_m g0[m] V_j[(t + m*gap) mod N] + h0[m] W_j[(t + m*gap) mod N]

``g0, h0`` are the MODWT base filters (unit L2 norm, then / sqrt(2)).
Storage is float32 or bfloat16; the kernels accumulate in float32.

:func:`modwt_cascade` and :func:`imodwt_cascade` launch the kernels for a
CUDA tensor and take the plain versions only for a tensor on the CPU. The
plain versions are public so that tests and ``chip_smoke.py`` can call them
by name.

Plans. A row of at most ``WHOLE_ROW_MAX`` samples runs whole
(:func:`rows_per_block`): a block holds ``ROW_SAMPLES // n`` rows (at least
one) in shared memory, reads each level circularly within its rows, and
runs every level in one launch, with no halo and no scratch row
(:func:`whole_row_smem_bytes`). Longer rows take the tiles: both kernels
tile time by ``TILE`` outputs and split the levels into groups that pass V
through f32 scratch rows, each group's staged block within
``SMEM_BYTES``, a third of an SM. K1 stages a group's V
segment (the tile and its halo, :func:`segment_length`), two f32 V buffers
and the shared stages its W rows and V leave from (:func:`k1_smem_bytes`,
:func:`level_groups`). K2 prefetches the V segment and every W segment of
a group at once, each in its own buffer (:func:`k2_smem_bytes`,
:func:`inverse_level_groups`). How a segment is cut into copies (where it
wraps, where it is unaligned) is the kernel's own affair. The groups do
not change the arithmetic (f32 in shared memory or in scratch alike), so
K2 stays K1's exact adjoint.

Gradients: K2's recursion is term for term the transpose of K1's (level j
of K1 maps V_{j-1} to (W_j, V_j) by the taps at t - m*gap; K2 maps them
back by the same taps at t + m*gap), so K1's adjoint is K2 with the same
filters and K2's is K1, in bf16 storage too. Each wrapper runs through a
``torch.autograd.Function`` whose backward calls the other wrapper: on the
card the backward of K1 launches K2 and counts as a K2 launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..exceptions import JWaveFailure
from ..utils.profiling import count, span
from . import cuda_build
from .cuda_build import MAX_TAPS

# the launches that take whole rows, listed (at 0) from the start
count("K1.whole_row_launches", 0)
count("K2.whole_row_launches", 0)

#: outputs of one row per block
TILE = 2048
#: shared bytes a staged K1 or K2 block may use: a third of an SM's 228 KB
#: less the 1 KB the card reserves per block, so that three blocks share an SM
SMEM_BYTES = 233472 // 3 - 1024
#: shared bytes one block may have on the card (227 KB)
BLOCK_SMEM_MAX = 232448
#: the longest row that K1 and K2 keep whole in a block; longer rows take
#: the tiles
WHOLE_ROW_MAX = TILE
#: samples of whole rows a block takes: max(1, ROW_SAMPLES // n) rows
ROW_SAMPLES = 1024
#: the shared head of a staged block (``csrc/modwt.cu`` kHeadBytes): the
#: taps and 16 mbarriers
_HEAD_BYTES = 2 * MAX_TAPS * 4 + 16 * 8

_STORAGE = (torch.float32, torch.bfloat16)


# ----------------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------------

def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def modwt_cascade_torch(x: torch.Tensor, g0, h0, level: int) -> torch.Tensor:
    """(B, N) -> (B, level+1, N) rows [W_1..W_J, V_J] by rolls and FMAs."""
    v = x.to(_acc_dtype(x))
    rows = []
    for j in range(1, level + 1):
        gap = 1 << (j - 1)
        w = torch.zeros_like(v)
        vn = torch.zeros_like(v)
        for m in range(len(g0)):
            r = torch.roll(v, m * gap, dims=-1)  # r[t] = v[(t - m*gap) mod N]
            w = w + float(h0[m]) * r
            vn = vn + float(g0[m]) * r
        rows.append(w)
        v = vn
    rows.append(v)
    return torch.stack(rows, dim=-2).to(x.dtype)


def imodwt_cascade_torch(coeffs: torch.Tensor, g0, h0) -> torch.Tensor:
    """(B, J+1, N) -> (B, N) by rolls and FMAs."""
    c = coeffs.to(_acc_dtype(coeffs))
    level = c.shape[-2] - 1
    v = c[..., level, :]
    for j in range(level, 0, -1):
        gap = 1 << (j - 1)
        w = c[..., j - 1, :]
        acc = torch.zeros_like(v)
        for m in range(len(g0)):
            # roll by -m*gap: r[t] = v[(t + m*gap) mod N]
            acc = acc + float(g0[m]) * torch.roll(v, -m * gap, dims=-1)
            acc = acc + float(h0[m]) * torch.roll(w, -m * gap, dims=-1)
        v = acc
    return v.to(coeffs.dtype)


# ----------------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------------

def _groups(level: int, fits) -> list[tuple[int, int, bool]]:
    """Split levels 1..level greedily into runs (j0, j1, staged) for which
    ``fits(j0, j1)``; a level that does not fit alone runs unstaged."""
    groups = []
    j = 1
    while j <= level:
        if not fits(j, j):
            groups.append((j, j, False))
            j += 1
            continue
        k = j
        while k < level and fits(j, k + 1):
            k += 1
        groups.append((j, k, True))
        j = k + 1
    return groups


def segment_length(tl: int, m: int, j0: int, j: int) -> int:
    """Samples of the level-j signal that a group j0..j1 keeps for a tile
    of ``tl`` outputs: the tile and the halo of levels j0..j,
    (M-1)(2^j - 2^(j0-1)) (``csrc/modwt.cu`` seg_len). K1 stages V_{j0-1}'s
    (j = j1), K2 V_j1's (j = j1) and W_j's."""
    return tl + (m - 1) * ((1 << j) - (1 << (j0 - 1)))


def _r16(b: int) -> int:
    return (b + 15) & ~15


def k1_smem_bytes(tl: int, m: int, j0: int, j1: int, itemsize_x: int = 4,
                  itemsize_out: int = 4, itemsize_v: int = 4) -> int:
    """Shared bytes of a staged K1 block (``csrc/modwt.cu`` fwd_layout): the
    head; the V_{j0-1} segment (``itemsize_x``, and 16 bytes for its offset
    mod 16 in device memory); two f32 buffers of V_j0's samples and 16
    bytes (none for a single level); the stages of W (two, one for a single
    level; ``tl`` samples of ``itemsize_out`` and 16 bytes for the row's
    offset mod 16); for a single level the stage of V_j1 (``itemsize_v``:
    the output's, or 4 for a scratch row), which otherwise takes the V
    buffer the last level does not read. Each is rounded up to 16 bytes."""
    total = _HEAD_BYTES + _r16(segment_length(tl, m, j0, j1) * itemsize_x) + 16
    if j1 == j0:
        return total + _r16(tl * itemsize_out) + 16 + _r16(tl * itemsize_v) + 16
    total += 2 * (_r16(4 * segment_length(tl, m, j0 + 1, j1)) + 16)
    return total + 2 * (_r16(tl * itemsize_out) + 16)


@functools.lru_cache(maxsize=256)
def level_groups(n: int, m: int, level: int) -> tuple[tuple[int, int, bool], ...]:
    """K1's plan: runs (j0, j1, staged) whose staged block fits
    ``SMEM_BYTES`` in float32 (bf16 storage takes less); a level that does
    not fit alone runs unstaged, straight from device memory. Cached: the
    wrappers ask on every call."""
    tl = min(TILE, n)
    return tuple(_groups(level, lambda j0, j1: k1_smem_bytes(tl, m, j0, j1) <= SMEM_BYTES))


def k2_smem_bytes(tl: int, m: int, j0: int, j1: int, itemsize_v: int = 4,
                  itemsize_c: int = 4) -> int:
    """Shared bytes of a staged K2 block (``csrc/modwt.cu`` inv_layout): the
    head, the V_j1 segment, the W_j segments for j = j1..j0 and the f32 V
    buffers (two, one for a single level), each rounded up to 16 bytes (a
    segment is copied in whole 16 bytes)."""
    total = _HEAD_BYTES + _r16(segment_length(tl, m, j0, j1) * itemsize_v)
    total += sum(_r16(segment_length(tl, m, j0, j) * itemsize_c) for j in range(j0, j1 + 1))
    return total + _r16(4 * segment_length(tl, m, j0, j1 - 1)) * (2 if j1 > j0 else 1)


@functools.lru_cache(maxsize=256)
def inverse_level_groups(n: int, m: int, level: int) -> tuple[tuple[int, int, bool], ...]:
    """K2's plan: runs (j0, j1, staged) whose prefetched segments fit
    ``SMEM_BYTES`` in float32 (bf16 storage takes less); a level that does
    not fit alone runs unstaged, straight from device memory. K2 runs the
    groups from the last to the first."""
    tl = min(TILE, n)
    return tuple(_groups(level, lambda j0, j1: k2_smem_bytes(tl, m, j0, j1) <= SMEM_BYTES))


def whole_row_smem_bytes(rows: int, n: int, level: int, itemsize: int = 4) -> int:
    """Shared bytes of a whole-row K1 or K2 block of ``rows`` rows
    (``csrc/modwt.cu`` row_layout), the same for both: the head; the input
    stage and 16 bytes for its offset mod 16 (K1: V_0, ``n`` samples a row;
    K2: the coefficients, ``(level + 1) n``); f32 V buffers of ``rows * n``
    samples, two (one at level 2, none at level 1); the output stage and 16
    bytes (K1: ``(level + 1) n`` a row; K2: ``n``). Each is rounded up to 16
    bytes. No halo: the filter length changes nothing."""
    return (_HEAD_BYTES + _r16(rows * n * itemsize) + 16 + min(level - 1, 2) * _r16(4 * rows * n)
            + _r16(rows * (level + 1) * n * itemsize) + 16)


@functools.lru_cache(maxsize=256)
def rows_per_block(n: int, level: int, itemsize: int = 4) -> int:
    """The whole-row plan of K1 and K2: rows a block, or 0 where the rows
    take the tiles (:func:`level_groups`). A row of at most
    ``WHOLE_ROW_MAX`` samples whose block fits ``BLOCK_SMEM_MAX`` runs
    whole, ``ROW_SAMPLES // n`` rows a block (at least one): a block of
    several rows stays within ``SMEM_BYTES`` (68 bytes a sample at most, f32
    at level 13). Cached: the wrappers ask on every call."""
    if n > WHOLE_ROW_MAX or whole_row_smem_bytes(1, n, level, itemsize) > BLOCK_SMEM_MAX:
        return 0
    return max(1, ROW_SAMPLES // n)


def _check_cuda(t: torch.Tensor, ndim: int, what: str):
    if t.device.type != "cuda":
        raise JWaveFailure(f"{what} - tensor on {t.device}; the kernel runs on CUDA tensors")
    if t.dtype not in _STORAGE:
        raise JWaveFailure(f"{what} - dtype {t.dtype}; the kernel takes float32 or bfloat16")
    if t.dim() != ndim:
        raise JWaveFailure(f"{what} - expected a {ndim}-D tensor, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise JWaveFailure(f"{what} - tensor must be contiguous")


def _check_filters(g0, h0, level: int, what: str):
    cuda_build.check_filters(g0, h0, what)
    if not 1 <= level <= 13:
        raise JWaveFailure(f"{what} - level must be in [1, 13], got {level}")


_P, _I = ctypes.c_void_p, ctypes.c_int
_K1_ARGS = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
_K2_ARGS = [_P, _P, _I, ctypes.c_longlong, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
#: ``csrc/modwt.cu``'s entries (library, symbol, signature) by storage dtype
_K1 = {torch.float32: ("modwt", "jw_modwt_fwd_f32", _K1_ARGS),
       torch.bfloat16: ("modwt", "jw_modwt_fwd_bf16", _K1_ARGS)}
_K2 = {torch.float32: ("modwt", "jw_imodwt_f32", _K2_ARGS),
       torch.bfloat16: ("modwt", "jw_imodwt_bf16", _K2_ARGS)}


def _k1(x: torch.Tensor, g0, h0, level: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return modwt_cascade_torch(x, g0, h0, level)
    _check_cuda(x, 2, "modwt_cascade")
    _check_filters(g0, h0, level, "modwt_cascade")
    b, n = x.shape
    m = len(g0)
    out = torch.empty((b, level + 1, n), dtype=x.dtype, device=x.device)
    if b == 0 or n == 0:
        return out
    rpb = min(rows_per_block(n, level, x.element_size()), b)
    with span("launch.K1", rows=b, n=n, levels=level, rows_per_block=rpb):
        taps = cuda_build.device_taps(g0, h0, x.device)
        if rpb:
            cuda_build.launch(_K1[x.dtype], (x.data_ptr(), 0, out.data_ptr(), None,
                                             taps.data_ptr(), b, n, m, level, 1, level, TILE, 1,
                                             rpb),
                              x.device, "modwt_cascade", "K1")
            count("K1.whole_row_launches")
            return out
        groups = level_groups(n, m, level)
        scratch = [torch.empty((b, n), dtype=torch.float32, device=x.device)
                   for _ in range(min(len(groups) - 1, 2))]
        src, src_f32 = x, 0
        for gi, (j0, j1, staged) in enumerate(groups):
            vnext = scratch[gi % 2] if j1 < level else None
            cuda_build.launch(_K1[x.dtype], (src.data_ptr(), src_f32, out.data_ptr(),
                                             vnext.data_ptr() if vnext is not None else None,
                                             taps.data_ptr(), b, n, m, level, j0, j1, TILE,
                                             int(staged), 0),
                              x.device, "modwt_cascade", "K1")
            src, src_f32 = vnext, 1
    return out


def _k2(coeffs: torch.Tensor, g0, h0) -> torch.Tensor:
    if coeffs.device.type == "cpu":
        return imodwt_cascade_torch(coeffs, g0, h0)
    _check_cuda(coeffs, 3, "imodwt_cascade")
    b, jp1, n = coeffs.shape
    level = jp1 - 1
    _check_filters(g0, h0, level, "imodwt_cascade")
    m = len(g0)
    out = torch.empty((b, n), dtype=coeffs.dtype, device=coeffs.device)
    if b == 0 or n == 0:
        return out
    rpb = min(rows_per_block(n, level, coeffs.element_size()), b)
    with span("launch.K2", rows=b, n=n, levels=level, rows_per_block=rpb):
        taps = cuda_build.device_taps(g0, h0, coeffs.device)
        # V_J is row `level` of the coefficients; later groups read f32 scratch
        vsrc_ptr, vsrc_f32, vstride = (coeffs.data_ptr() + level * n * coeffs.element_size(), 0,
                                       jp1 * n)
        if rpb:
            cuda_build.launch(_K2[coeffs.dtype], (coeffs.data_ptr(), vsrc_ptr, vsrc_f32, vstride,
                                                  out.data_ptr(), None, taps.data_ptr(), b, n, m,
                                                  level, 1, level, TILE, 1, rpb),
                              coeffs.device, "imodwt_cascade", "K2")
            count("K2.whole_row_launches")
            return out
        groups = inverse_level_groups(n, m, level)[::-1]
        scratch = [torch.empty((b, n), dtype=torch.float32, device=coeffs.device)
                   for _ in range(min(len(groups) - 1, 2))]
        for gi, (j0, j1, staged) in enumerate(groups):
            vnext = scratch[gi % 2] if j0 > 1 else None
            cuda_build.launch(_K2[coeffs.dtype], (coeffs.data_ptr(), vsrc_ptr, vsrc_f32, vstride,
                                                  out.data_ptr(),
                                                  vnext.data_ptr() if vnext is not None else None,
                                                  taps.data_ptr(), b, n, m, level, j0, j1, TILE,
                                                  int(staged), 0),
                              coeffs.device, "imodwt_cascade", "K2")
            if vnext is not None:
                vsrc_ptr, vsrc_f32, vstride = vnext.data_ptr(), 1, n
    return out


class _ModwtCascade(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g0, h0, level):
        ctx.filters = (g0, h0)
        return _k1(x, g0, h0, level)

    @staticmethod
    def backward(ctx, g):
        return imodwt_cascade(g.contiguous(), *ctx.filters), None, None, None


class _ImodwtCascade(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coeffs, g0, h0):
        ctx.filters, ctx.level = (g0, h0), coeffs.shape[-2] - 1
        return _k2(coeffs, g0, h0)

    @staticmethod
    def backward(ctx, g):
        return modwt_cascade(g.contiguous(), *ctx.filters, ctx.level), None, None


def modwt_cascade(x: torch.Tensor, g0, h0, level: int) -> torch.Tensor:
    """K1: forward MODWT cascade (B, N) -> (B, level+1, N); its backward is K2."""
    return _ModwtCascade.apply(x, g0, h0, level)


def imodwt_cascade(coeffs: torch.Tensor, g0, h0) -> torch.Tensor:
    """K2: inverse MODWT cascade (B, J+1, N) -> (B, N); its backward is K1."""
    return _ImodwtCascade.apply(coeffs, g0, h0)
