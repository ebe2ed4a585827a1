"""K3/K4/K5/K7: the fused FWT pyramid and its inverse (``csrc/pyramid.cu``),
with plain versions.

Replaces ``jwave_tpu/ops/pallas_pyramid.py`` ``_pyramid_rows_kernel_flat``
(K3: the pyramid along each row, in place, output (R, N)),
``_pyramid_rows_kernel`` (K4: the same with each row stored transposed,
output (N, R)) and ``_ipyramid_rows_kernel`` (K5: the inverse pyramid of
each row, stored transposed, output (N, R)); and, with no ``pallas_call``
behind it, ``jwave_tpu/ops/mxu_pyramid.py`` ``fwt_inverse_fused`` (K7: the
inverse pyramid of each row, in place, output (R, N)). K3 and K7 also have
a rotated form (no TPU kernel): whole rows of at most ``ROT_MAX`` samples,
output (N, R), the volume's axis passes (``transforms/fwt.py`` ``fwt3d``,
``ifwt3d``), with K4's and K5's plain versions. K4 and K5 take a
``group``: rows (F group, N), each group of rows (a frame of a stack)
stored transposed on its own, output (F N, group); one group (the default)
is the plain (N, R) transpose. Two grouped passes are the 2D transform of
a stack of frames (``transforms/fwt.py`` ``fwt2d``, ``ifwt2d``). Every
rotated K3 or K7 launch and every K4 or K5 launch adds one to the counter
``ndim.rotated_passes``: each stores an axis pass rotated, so no
transposing copy follows it. Per row, for each of ``levels`` levels on the
head h:

    a[i] = sum_j x[(2i+j) mod h] dec_lo[j],  d[i] = sum_j x[(2i+j) mod h] dec_hi[j]

``d`` goes to ``out[h/2:h]``, the head becomes ``a``, and the last ``a``
goes to ``out[:h]``: the layout ``[A_L | D_L | ... | D_1]``. ``levels`` is
the number of levels actually done (:func:`levels_done`). K5 and K7 undo
them from the smallest head up, each level the synthesis butterfly of
``ops/butterfly.py`` scaled by the bank's ``recon_gain``. K3 and K7 take a
``gain`` folded into the taps on the host (the float64 product, then
float32): K3 scales each level's a and d by it, K7 each level's outputs.

The wrappers launch the kernels for CUDA tensors and take the plain
versions only for tensors on the CPU. Each wrapper goes through a
``torch.autograd.Function`` whose backward is the operator's exact
adjoint (for K4 and K5 the other wrapper, so a backward on the card
launches a kernel and counts as its launch):

* K3 with a pair of filters and a gain and K7 with the same pair and gain
  are each other's adjoint (a synthesis level is the transpose of the
  analysis level with the same filters), so K3's backward is K7 and K7's
  is K3, on rows of any length;
* one K4 pass is T P (P the pyramid, T the transpose within each group),
  so its adjoint P^T T^T is K5 with the same filters, gain and group on
  the gradient transposed back within each group, the result transposed
  back so too; one K5 pass likewise takes K4 with K5's filters as the
  analysis pair and ``recon_gain`` as K4's per-level ``gain``;
* a rotated pass is T P too: its adjoint is K7 (K3 for K7's) in place on
  the gradient transposed.

The backward of a transposing pass of one group returns a transposed view
and reads its incoming gradient through one, so in ``fwt2d``/``ifwt2d`` of
a matrix (two passes) only the first backward pass copies its gradient.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..exceptions import JWaveFailure
from ..utils.profiling import count, span
from . import cuda_build
from .cuda_build import MAX_TAPS

#: K3's plan (``csrc/pyramid.cu``): level-0 samples a tile block owns (two
#: 93 KB blocks an SM at db4, 512 blocks at 64 x 65536) and its threads;
#: heads up to ``K3_TAIL_HEAD`` run whole in one block a row (the tail),
#: whose shared memory holds a head of ``K3_TAIL_MAX_HEAD`` at most
K3_TILE = 8192
K3_TILE_THREADS = 256
K3_TAIL_HEAD = 4096
K3_TAIL_MAX_HEAD = 32768
K3_TAIL_THREADS = 1024
K4_THREADS = 512
K5_THREADS = 512
#: K4's and K5's plan (``csrc/pyramid.cu`` kMaxRows, kK5Pairs): at most 8
#: rows a block, rb*n <= 16384 staged floats (64 KB), 8 output pairs a K5
#: thread per level
K5_MAX_ROWS_PER_BLOCK = 8
K5_ROW_FLOATS = 16384
K5_PAIRS = 8
#: K7's plan (``csrc/pyramid.cu`` kK7*): output samples a work item (rows
#: longer than that), or floats of an item's whole rows (rows of at most
#: that), and the same for one level (no chain of levels to spread an item's
#: set-up over: smaller items, more blocks an SM); threads a block (64
#: compute, one producer warp); the most levels; the ints of each cone table;
#: the shared floats before the two stage sets (taps, each set's two
#: mbarriers, stage offsets, both sets' cone tables)
K7_TILE = 4096
K7_TILE_ONE_LEVEL = 2048
K7_THREADS = 64 + 32
K7_MAX_LEVELS = 31
K7_META = 36
K7_HEAD = 2 * MAX_TAPS + 8 + 7 * K7_META
SMEM_LIMIT = 227 * 1024
#: the rotated forms' plan (``csrc/pyramid.cu`` k3_rotated_layout, k7_layout
#: with rot): rows of at most ROT_MAX samples (at 2048 and 8 rows an item a
#: K3 block's two stage sets and buffer take 165 KB, the most one SM holds),
#: ROT_ITEM // n of them an item and at least ROT_MIN_ROWS (a 32-byte sector
#: a column piece); K3's threads a block (compute, one producer warp)
ROT_MAX = 2048
ROT_ITEM = 4096
ROT_MIN_ROWS = 8
K3_ROT_THREADS = 128 + 32
#: the counter of rotated launches (``profiling.counts()``), one an axis
#: pass of ``fwt3d``/``ifwt3d`` (the rotated K3, K7) and of ``fwt2d``/
#: ``ifwt2d`` (K4, K5)
ROTATED_PASSES = "ndim.rotated_passes"
count(ROTATED_PASSES, 0)  # listed (at 0) from the start


def levels_done(n: int, tw: int, level: int) -> int:
    """How many levels the reference forward performs: it stops at ``level``
    or when the head drops below ``transform_wavelength``
    (jwave_tpu/ops/mxu_pyramid.py::_levels_done)."""
    done = 0
    h = n
    while h >= tw and done < level:
        done += 1
        h >>= 1
    return done


# ----------------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------------

def pyramid_rows_torch(x: torch.Tensor, dec_lo, dec_hi, levels: int,
                       gain: float = 1.0) -> torch.Tensor:
    """(R, N) -> (R, N): ``levels`` analysis butterflies, by gathers and FMAs;
    each level's a and d are scaled by ``gain``."""
    out = x.clone()
    h = x.shape[-1]
    for _ in range(levels):
        half = h // 2
        i2 = 2 * torch.arange(half, device=x.device)
        head = out[..., :h]
        a = torch.zeros_like(head[..., :half])
        d = torch.zeros_like(a)
        for j in range(len(dec_lo)):
            v = head[..., (i2 + j) % h]
            a = a + float(dec_lo[j]) * v
            d = d + float(dec_hi[j]) * v
        if gain != 1.0:
            a, d = a * gain, d * gain
        out[..., :half] = a
        out[..., half:h] = d
        h = half
    return out


def pyramid_rows_tiled_torch(x: torch.Tensor, dec_lo, dec_hi, levels: int,
                             plan: "K3Plan") -> torch.Tensor:
    """:func:`pyramid_rows_torch` computed as K3's tile blocks partition it
    (for the tests: the halo arithmetic has no other CPU check). Each tile of
    ``plan.tile`` samples runs ``plan.levels`` levels on its own from the
    tile and ``plan.halo`` samples to its right (mod N), level l keeping
    ``tile/2^l + (2^(Lt-l) - 1)(M - 1)`` approximations and the tile's
    ``tile/2^l`` details; the levels left run on the gathered approximations
    of level Lt. An index outside a staged segment raises."""
    n = x.shape[-1]
    m = len(dec_lo)
    t, lt = plan.tile, plan.levels
    if lt == 0:
        return pyramid_rows_torch(x, dec_lo, dec_hi, levels)
    out = torch.empty_like(x)
    approx = x.new_empty(x.shape[:-1] + (n >> lt,))
    for ti in range(n // t):
        cur = x[..., (ti * t + torch.arange(t + plan.halo, device=x.device)) % n]
        for l in range(1, lt + 1):
            nd = t >> l
            na = nd + ((1 << (lt - l)) - 1) * (m - 1)
            i2 = 2 * torch.arange(na, device=x.device)
            a = torch.zeros_like(cur[..., :na])
            d = torch.zeros_like(cur[..., :nd])
            for j in range(m):
                a = a + float(dec_lo[j]) * cur[..., i2 + j]
                d = d + float(dec_hi[j]) * cur[..., i2[:nd] + j]
            out[..., (n >> l) + ti * nd:(n >> l) + (ti + 1) * nd] = d
            cur = a
        approx[..., ti * (t >> lt):(ti + 1) * (t >> lt)] = cur
    out[..., :n >> lt] = pyramid_rows_torch(approx, dec_lo, dec_hi, levels - lt)
    return out


def rotate_groups(y: torch.Tensor, group: int | None = None) -> torch.Tensor:
    """(F group, N) rows as (F N, group): each group of ``group`` rows
    (default all of them) transposed, contiguous."""
    r, n = y.shape
    group = r if group is None else group
    f = r // group if group else 1
    return y.reshape(f, group, n).transpose(1, 2).reshape(f * n, group).contiguous()


def pyramid_rows_transposed_torch(x: torch.Tensor, dec_lo, dec_hi, levels: int,
                                  gain: float = 1.0, group: int | None = None) -> torch.Tensor:
    """(F group, N) -> (F N, group): :func:`pyramid_rows_torch` of each row,
    each group of rows transposed; one group (the default): (R, N) -> (N, R)."""
    return rotate_groups(pyramid_rows_torch(x, dec_lo, dec_hi, levels, gain), group)


def ipyramid_rows_torch(y: torch.Tensor, rec_lo, rec_hi, recon_gain: float,
                        levels: int) -> torch.Tensor:
    """(R, N) -> (R, N): ``levels`` synthesis butterflies from the smallest
    head up, by gathers and FMAs: on head h, with a = y[:h/2], d = y[h/2:h],
    x[k] = gain * sum over taps j of k's parity of
    rec_lo[j] a[m/2] + rec_hi[j] d[m/2], m = (k - j) mod h."""
    out = y.clone()
    n = y.shape[-1]
    if levels == 0:
        return out
    h = n >> (levels - 1)
    while h <= n:
        half = h // 2
        k = torch.arange(h, device=y.device)
        head = out[..., :h]
        x = torch.zeros_like(head)
        for j in range(len(rec_lo)):
            m = (k - j) % h
            even = (m % 2 == 0).to(y.dtype)
            i = m // 2
            x = x + even * (float(rec_lo[j]) * head[..., i]
                            + float(rec_hi[j]) * head[..., half + i])
        out[..., :h] = x * recon_gain if recon_gain != 1.0 else x
        h *= 2
    return out


def ipyramid_rows_transposed_torch(y: torch.Tensor, rec_lo, rec_hi, recon_gain: float,
                                   levels: int, group: int | None = None) -> torch.Tensor:
    """(F group, N) -> (F N, group): :func:`ipyramid_rows_torch` of each
    row, each group of rows transposed; one group (the default): (R, N) ->
    (N, R)."""
    return rotate_groups(ipyramid_rows_torch(y, rec_lo, rec_hi, recon_gain, levels), group)


def k7_cones(n: int, levels: int, m: int, tile: int, t0: int) -> list:
    """The dependency cones of K7's work item that owns output samples
    [t0, t0 + tile) of a row longer than the tile (``csrc/pyramid.cu``
    ipyramid_tile_kernel): entry l - 1 is (start, count, whole) of R_l, the
    outputs of level l (head n >> (l-1)) the item makes, for l = 1 ..
    levels + 1; R_1 is the tile, R_{levels+1} the part of A_L it reads. The
    pairs (2c, 2c+1) of R_l read the samples c - t, t < ceil(m/2), of
    R_{l+1}; its ends are rounded out to multiples of 8, so that each
    level's pairs start and end on groups of four, and a cone that would
    cover its head is the whole head. A row of at most the tile is one
    item's whole rows: every cone its whole head."""
    if tile >= n:
        return [(0, n >> l, True) for l in range(levels + 1)]
    mh = (m + 1) // 2
    s, cnt = t0, tile
    out = [(s, cnt, False)]
    for l in range(1, levels + 1):
        half = n >> l
        u = s >> 1
        st, en = (u - (mh - 1)) & ~7, (u + cnt // 2 + 7) & ~7
        s, cnt = (0, half) if en - st >= half else (st, en - st)
        out.append((s, cnt, cnt == half))
    return out


def k7_items(rows: int, n: int, plan: "K7Plan") -> int:
    """K7's work items: (row, tile) pairs, or groups of ``plan.rows`` whole
    rows, the last one shorter where they do not divide ``rows``."""
    if n <= plan.tile:
        return -(-rows // plan.rows)
    return rows * (n // plan.tile)


def _synthesis_pairs(a, d, c, mh, lo, hi, wrap, c_in):
    """(x[2c], x[2c+1]) of one synthesis level from a and d (last axis), the
    pairs c read at i = c - t (``wrap``: mod the head; else inside the
    ``c_in`` staged samples, or IndexError)."""
    i = c[None, :] - torch.arange(mh, device=c.device)[:, None]  # (t, pair)
    i = i % wrap if wrap else i
    if int(i.min()) < 0 or int(i.max()) >= c_in:
        raise IndexError("a level reads outside its staged cone")
    av, dv = a[..., i], d[..., i]  # (..., t, pair)
    x0 = (av * lo[0::2, None]).sum(-2) + (dv * hi[0::2, None]).sum(-2)
    x1 = (av * lo[1::2, None]).sum(-2) + (dv * hi[1::2, None]).sum(-2)
    return torch.stack([x0, x1], dim=-1).flatten(-2)


def ipyramid_rows_tiled_torch(y: torch.Tensor, rec_lo, rec_hi, recon_gain: float,
                              levels: int, plan: "K7Plan", grid: int | None = None
                              ) -> torch.Tensor:
    """:func:`ipyramid_rows_torch` of (R, N) computed as K7 partitions it
    (for the tests: the cone arithmetic has no other CPU check). ``grid``
    persistent blocks (default: one an item) take the work items
    (:func:`k7_items`) in K7's order, block b items b, b + grid, ...: an
    item of a row longer than ``plan.tile`` stages its cones
    (:func:`k7_cones`: A_L and each level's details, mod their heads, each
    within its bound in ``plan.cone``) and runs the levels from the coarsest
    up on them alone, a whole-head cone read circularly; an item of
    ``plan.rows`` whole rows (fewer in the last) runs each level over all
    its rows at once. An index outside a staged cone, or an output written
    other than once, raises."""
    if levels == 0:
        return y.clone()
    rows, n = y.shape
    m = len(rec_lo)
    mh = (m + 1) // 2
    lo = torch.zeros(2 * mh, dtype=y.dtype)
    hi = torch.zeros(2 * mh, dtype=y.dtype)
    lo[:m] = torch.as_tensor(np.asarray(rec_lo, np.float64) * recon_gain, dtype=y.dtype)
    hi[:m] = torch.as_tensor(np.asarray(rec_hi, np.float64) * recon_gain, dtype=y.dtype)
    lo, hi = lo.to(y.device), hi.to(y.device)
    out = torch.empty_like(y)
    written = torch.zeros((rows, n), dtype=torch.int32)
    items = k7_items(rows, n, plan)
    grid = items if grid is None else min(grid, items)
    tiles = max(n // plan.tile, 1)
    ar = functools.partial(torch.arange, device=y.device)
    for b in range(grid):
        for item in range(b, items, grid):
            if n <= plan.tile:
                r0 = item * plan.rows
                blk = y[r0:r0 + plan.rows]
                a = blk[:, :n >> levels]
                for l in range(levels, 0, -1):
                    half = n >> l
                    a = _synthesis_pairs(a, blk[:, half:2 * half], ar(half), mh, lo, hi,
                                         half, half)
                out[r0:r0 + plan.rows] = a
                written[r0:r0 + plan.rows] += 1
                continue
            r, ti = divmod(item, tiles)
            cones = k7_cones(n, levels, m, plan.tile, ti * plan.tile)
            if any(c[1] > bnd for c, bnd in zip(cones[1:], plan.cone)):
                raise IndexError(f"a cone outgrows its bound: {cones} {plan.cone}")

            def stage(base, half, s, cnt):
                return y[r, base + (s + ar(cnt)) % half]

            a = stage(0, n >> levels, *cones[levels][:2])
            for l in range(levels, 0, -1):
                half = n >> l
                s_in, c_in, whole = cones[l]
                d = stage(half, half, s_in, c_in)
                s_out, c_out, _ = cones[l - 1]
                c = s_out // 2 + ar(c_out // 2)
                a = _synthesis_pairs(a, d, c if whole else c - s_in, mh, lo, hi,
                                     half if whole else 0, c_in)
            out[r, ti * plan.tile:(ti + 1) * plan.tile] = a
            written[r, ti * plan.tile:(ti + 1) * plan.tile] += 1
    if not bool((written == 1).all()):
        raise IndexError("the work items do not cover each output once")
    return out


# ----------------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------------

def _check(x: torch.Tensor, dec_lo, dec_hi, levels: int, what: str):
    if x.device.type != "cuda":
        raise JWaveFailure(f"{what} - tensor on {x.device}; the kernel runs on CUDA tensors")
    if x.dtype != torch.float32:
        raise JWaveFailure(f"{what} - dtype {x.dtype}; the kernel takes float32")
    if x.dim() != 2 or not x.is_contiguous():
        raise JWaveFailure(f"{what} - expected a contiguous (R, N) tensor, got {tuple(x.shape)}")
    n = x.shape[1]
    if n & (n - 1) or n == 0:
        raise JWaveFailure(f"{what} - row length {n} is not a power of two")
    if not 0 <= levels <= n.bit_length() - 1:
        raise JWaveFailure(f"{what} - {levels} levels do not fit rows of {n}")
    cuda_build.check_filters(dec_lo, dec_hi, what)


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: ``csrc/pyramid.cu``'s entries (library, symbol, signature)
_K3_TILE = ("pyramid", "jw_pyramid_tile",
            [_P, _LL, _P, _LL, _P, _LL, _P, _I, _I, _I, _I, _I, _P, _I, _I, _P])
_K3_TAIL = ("pyramid", "jw_pyramid_tail", [_P, _LL, _P, _LL, _P, _I, _I, _I, _I, _I, _P])
_K4 = ("pyramid", "jw_pyramid_rows_t",
       [_P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P])
_K5 = ("pyramid", "jw_ipyramid_rows_t", _K4[2])
_K7 = ("pyramid", "jw_ipyramid_tile", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P])
_K3_ROT = ("pyramid", "jw_pyramid_rows_rotated",
           [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P])


class K3Plan(NamedTuple):
    """One tiled pass of K3 over a head: ``tile`` samples a block, the
    ``levels`` it runs there, its right ``halo``, the ``tail_levels`` that
    the last block of each row runs after them in the same launch, and the
    block's shared bytes."""

    tile: int
    levels: int
    halo: int
    tail_levels: int
    smem_bytes: int


def _round4(v: int) -> int:
    return (v + 3) & ~3


def k3_smem_bytes(tile: int, lt: int, m: int) -> int:
    """Shared bytes of a K3 tile block (``csrc/pyramid.cu`` k3_layout): the
    taps and the mbarrier padded to 16 bytes, then, each rounded up to 16
    bytes with 16 more for a stage's offset, the segment (tile + halo), the
    odd levels' approximations (tile/2 + (2^(lt-1) - 1)(m - 1)), and a stage
    for everything that leaves: each level's details (tile >> l) and the
    last approximation (tile >> lt)."""
    halo = ((1 << lt) - 1) * (m - 1)
    v1 = (tile >> 1) + ((1 << (lt - 1)) - 1) * (m - 1) if lt else 0
    stages = [tile >> l for l in range(1, lt + 1)] + [tile >> lt]
    return 4 * (2 * MAX_TAPS + 4 + sum(_round4(v) + 4 for v in [tile + halo, v1] + stages))


def k3_tail_smem_bytes(h: int) -> int:
    """Shared bytes of a K3 tail block: the taps, the mbarrier padded to 16
    bytes, the staged head and half of it."""
    return 4 * (2 * MAX_TAPS + 4 + h + h // 2)


@functools.lru_cache(maxsize=None)
def k3_plan(n: int, levels: int, m: int, tile: int = K3_TILE) -> K3Plan:
    """How K3's tile blocks take the head ``n``: ``t = min(n, tile)`` samples
    a block and the most levels Lt <= ``levels`` whose right halo
    ``(2^Lt - 1)(m - 1)`` stays within a quarter of the tile (a halo is
    loaded and filtered twice; 2^Lt never exceeds the tile). A head of at
    most ``t`` samples is what a block's shared memory holds, so where the
    tiled levels get down to one, the levels left run as the launch's tail
    (``tail_levels``); else they are left to a further pass. Lt = 0 means
    no tiled pass."""
    t = min(n, tile)
    lt = 0
    while lt < levels and (t >> (lt + 1)) >= 1 and ((2 << lt) - 1) * (m - 1) <= t // 4:
        lt += 1
    tail = levels - lt if lt and (n >> lt) <= t else 0
    return K3Plan(t, lt, ((1 << lt) - 1) * (m - 1), tail, k3_smem_bytes(t, lt, m))


#: (device index, stream) -> K3's per-row counters, zero between launches
_K3_COUNTERS: dict = {}


def _k3_counters(device, stream: int, rows: int) -> torch.Tensor:
    """Zeroed int32 counters, one a row, for a launch on ``stream``: each
    launch leaves them zero again, and launches of one stream run in order,
    so a stream keeps one buffer."""
    key = (device.index, stream)
    buf = _K3_COUNTERS.get(key)
    if buf is None or buf.numel() < rows:
        buf = _K3_COUNTERS[key] = torch.zeros(max(rows, 1024), dtype=torch.int32, device=device)
    return buf


def _k3(x: torch.Tensor, dec_lo, dec_hi, levels: int, gain: float = 1.0,
        plan: K3Plan | None = None) -> torch.Tensor:
    """K3 on the card. Heads longer than ``K3_TAIL_HEAD`` lose their leading
    levels to tiled passes (:func:`k3_plan`; ``plan`` overrides the first
    one's), each passing the approximation on through a scratch row; a pass
    that gets down to a head of one tile runs the levels left as its tail,
    in the same launch. Shorter rows run in the tail kernel, one block a
    row. One launch at 64 x 65536."""
    if x.device.type == "cpu":
        return pyramid_rows_torch(x, dec_lo, dec_hi, levels, gain)
    _check(x, dec_lo, dec_hi, levels, "pyramid_rows")
    r, n = x.shape
    out = torch.empty_like(x)
    if r == 0:
        return out
    with span("launch.K3", rows=r, n=n, levels=levels):
        taps = cuda_build.device_taps(dec_lo, dec_hi, x.device, gain)
        m = len(dec_lo)
        src, head, left = x, n, levels
        while left > 0 and (plan is not None or head > K3_TAIL_HEAD):
            pl = plan or k3_plan(head, left, m)
            plan = None
            if pl.levels == 0:
                break
            if r * (head // pl.tile) >= 2**31:
                raise JWaveFailure(f"pyramid_rows - {r} rows of {head} exceed one launch")
            done = pl.levels + pl.tail_levels
            dst = out if pl.levels == left else torch.empty(
                (r, head >> pl.levels), dtype=torch.float32, device=x.device)
            counters = (_k3_counters(x.device, cuda_build.stream_handle(x.device).value or 0,
                                     r).data_ptr() if pl.tail_levels else None)
            cuda_build.launch(_K3_TILE, (src.data_ptr(), src.shape[1], out.data_ptr(), n,
                                         dst.data_ptr(), dst.shape[1], taps.data_ptr(), r, head,
                                         pl.tile, pl.levels, pl.tail_levels, counters, m,
                                         K3_TILE_THREADS),
                              x.device, "pyramid_rows", "K3")
            src, head, left = dst, head >> pl.levels, left - done
        if left > 0 or levels == 0:
            if left > 0 and head > K3_TAIL_MAX_HEAD:
                raise JWaveFailure(f"pyramid_rows - a head of {head} with {m} taps exceeds one "
                                   "block's shared memory")
            threads = min(K3_TAIL_THREADS, max(32, head // 2))
            cuda_build.launch(_K3_TAIL, (src.data_ptr(), src.shape[1], out.data_ptr(), n,
                                         taps.data_ptr(), r, head, left, m, threads),
                              x.device, "pyramid_rows", "K3")
    return out


class _PyramidRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dec_lo, dec_hi, levels, gain):
        ctx.args = (dec_lo, dec_hi, gain, levels)
        return _k3(x, dec_lo, dec_hi, levels, gain)

    @staticmethod
    def backward(ctx, g):
        return ipyramid_rows(g.contiguous(), *ctx.args), None, None, None, None


def pyramid_rows(x: torch.Tensor, dec_lo, dec_hi, levels: int,
                 gain: float = 1.0) -> torch.Tensor:
    """K3: the pyramid along each row of (R, N) f32, output (R, N); each
    level's a and d scaled by ``gain``."""
    return cuda_build.apply(_PyramidRows, _k3, x, dec_lo, dec_hi, levels, gain)


class K7Plan(NamedTuple):
    """K7's plan: ``tile`` output samples an item of a row longer than it,
    else ``rows`` = tile // n whole rows an item (1 for longer rows);
    ``cone`` the bounds B_2 .. B_{L+1} of the cones R_2 .. R_{L+1} of every
    item (:func:`k7_cones`; a whole row's are its heads); the bytes of a
    stage set and of a block, with ``sets`` stage sets; the ``threads`` of a
    block, its last warp the producer."""

    tile: int
    rows: int
    cone: tuple
    set_bytes: int
    smem_bytes: int
    sets: int
    threads: int


def _k7_bound_next(b: int, half: int, mh: int) -> int:
    """``csrc/pyramid.cu`` k7_bound_next: B_{l+1} from B_l on a head of 2 half."""
    return min(half, (b // 2 + mh + (13 if b < 8 else 10)) & ~7)


def _k7_layout(n: int, tile: int, levels: int, m: int, rotated: bool = False) -> tuple:
    """(the bounds B_2 .. B_{L+1}, a stage set's floats, a K7 block's shared
    floats), as ``csrc/pyramid.cu`` k7_layout counts them: the head (taps,
    both sets' mbarriers, the stage offsets and both sets' cone tables); two
    stage sets, each a stage of round4(B_{l+1}) + 4 floats for each level's
    details and one for A_L (B_{L+1}), or, for rows of at most the tile, one
    of round4(tile) + 4 for its whole rows (``rotated``: round4 of its rows
    at a stride of n + 4, and 4); the buffers of the even and of the odd
    levels' outputs, round4 of the largest of each (l = 2 .. L; tile >> (l -
    1) for whole rows, 4 floats more a row rotated); level 1 stores to the
    output."""
    mh = (m + 1) // 2
    whole = n <= tile
    pad = 4 * (tile // n) if rotated else 0
    b, stages, even, odd, bounds = tile, 0, 0, 0, []
    for l in range(1, levels + 1):
        if l >= 2:
            if l & 1:
                odd = max(odd, b + pad)
            else:
                even = max(even, b + pad)
        b = b // 2 if whole else _k7_bound_next(b, n >> l, mh)
        bounds.append(n >> l if whole else b)
        stages += _round4(b) + 4
    if rotated:
        set_floats = _round4(tile // n * (n + 4)) + 4
    else:
        set_floats = _round4(tile) + 4 if whole else stages + _round4(b) + 4
    return tuple(bounds), set_floats, K7_HEAD + 2 * set_floats + _round4(even) + _round4(odd)


@functools.lru_cache(maxsize=None)
def k7_plan(n: int, levels: int, m: int, tile: int | None = None,
            threads: int = K7_THREADS, rotated: bool = False) -> K7Plan:
    """K7's plan for rows of ``n``: items of ``tile`` output samples
    (``K7_TILE``, ``K7_TILE_ONE_LEVEL`` for one level), or of tile // n
    whole rows where a row is at most the tile. A cone R_{l+1}
    holds at most half of R_l and ceil(m/2) + 10 samples (B_{l+1}, a
    multiple of 8; + 13 from a tile of 2 or 4), and at most its head, so a
    stage set sums to about the tile and ``levels`` halos of ceil(m/2) + 10
    whatever the row length. ``rotated``: K7's rotated form, whose items are
    whole rows, at least ``ROT_MIN_ROWS`` of them (the tile at least that
    many rows)."""
    tile = tile or (K7_TILE_ONE_LEVEL if levels == 1 else K7_TILE)
    if rotated:
        tile = max(tile, ROT_MIN_ROWS * n)
    cone, set_floats, floats = _k7_layout(n, tile, levels, m, rotated)
    return K7Plan(tile, tile // n if n <= tile else 1, cone, 4 * set_floats, 4 * floats, 2,
                  threads)


def _blocks_per_sm(kernel: tuple, args: tuple, device_index: int, what: str,
                   smem_bytes: int) -> int:
    """The blocks of ``kernel`` (an entry whose C function, given a non-null
    last pointer before the stream, writes the occupancy calculator's count
    there and launches nothing) that one SM of the card holds."""
    got = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = cuda_build.entry(*kernel)(*args, ctypes.byref(got), None)
    cuda_build.check(cuda_build.library(kernel[0]), err, what)
    if got.value < 1:
        raise JWaveFailure(f"{what} - a block of {smem_bytes} shared bytes does not fit an SM")
    return got.value


@functools.lru_cache(maxsize=None)
def k7_blocks_per_sm(device_index: int, n: int, levels: int, m: int, plan: K7Plan,
                     rotated: bool = False) -> int:
    """The K7 blocks one SM of the card holds at ``plan``
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), asked once a plan."""
    return _blocks_per_sm(_K7, (None, None, None, 0, n, plan.tile, levels, m, plan.threads - 32,
                                0, int(rotated)), device_index, "ipyramid_rows", plan.smem_bytes)


def _device_index(device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


@functools.lru_cache(maxsize=256)
def k7_grid(device, rows: int, n: int, levels: int, m: int, plan: K7Plan,
            rotated: bool = False) -> int:
    """K7's persistent blocks: one wave, min(items, SMs x blocks an SM)."""
    index = _device_index(device)
    return min(k7_items(rows, n, plan),
               cuda_build.sm_count(index) * k7_blocks_per_sm(index, n, levels, m, plan, rotated))


def _k7(y: torch.Tensor, rec_lo, rec_hi, recon_gain: float, levels: int,
        plan: K7Plan | None = None) -> torch.Tensor:
    """K7 on the card: one launch of one wave of persistent blocks over the
    work items (:func:`k7_plan`; ``plan`` overrides it). With no level it
    copies."""
    if y.device.type == "cpu":
        return ipyramid_rows_torch(y, rec_lo, rec_hi, recon_gain, levels)
    _check(y, rec_lo, rec_hi, levels, "ipyramid_rows")
    r, n = y.shape
    if levels == 0:
        return y.clone()
    if levels > K7_MAX_LEVELS:
        raise JWaveFailure(f"ipyramid_rows - {levels} levels exceed the kernel's {K7_MAX_LEVELS}")
    plan = plan or k7_plan(n, levels, len(rec_lo))
    if plan.smem_bytes > SMEM_LIMIT:
        raise JWaveFailure(f"ipyramid_rows - a block of {plan.smem_bytes} shared bytes exceeds "
                           f"the card's {SMEM_LIMIT}")
    if k7_items(r, n, plan) >= 2**31:
        raise JWaveFailure(f"ipyramid_rows - {r} rows of {n} exceed one launch")
    out = torch.empty_like(y)
    if r == 0:
        return out
    with span("launch.K7", rows=r, n=n, levels=levels):
        m = len(rec_lo)
        taps = cuda_build.device_taps(rec_lo, rec_hi, y.device, recon_gain)
        cuda_build.launch(_K7, (y.data_ptr(), out.data_ptr(), taps.data_ptr(), r, n, plan.tile,
                                levels, m, plan.threads - 32,
                                k7_grid(y.device, r, n, levels, m, plan), 0, None),
                          y.device, "ipyramid_rows", "K7")
    return out


class _IPyramidRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, rec_lo, rec_hi, recon_gain, levels):
        ctx.args = (rec_lo, rec_hi, levels, recon_gain)
        return _k7(y, rec_lo, rec_hi, recon_gain, levels)

    @staticmethod
    def backward(ctx, g):
        return pyramid_rows(g.contiguous(), *ctx.args), None, None, None, None


def ipyramid_rows(y: torch.Tensor, rec_lo, rec_hi, recon_gain: float,
                  levels: int) -> torch.Tensor:
    """K7: the inverse pyramid along each row of (R, N) f32, output (R, N);
    each level's outputs scaled by ``recon_gain``."""
    return cuda_build.apply(_IPyramidRows, _k7, y, rec_lo, rec_hi, recon_gain, levels)


def rotated_rows(n: int) -> bool:
    """Whether the rotated forms of K3 and K7 take rows of ``n``: a power of
    two from 2 to ``ROT_MAX``."""
    return 2 <= n <= ROT_MAX and n & (n - 1) == 0


class K3RotPlan(NamedTuple):
    """The rotated K3's plan: ``rows`` whole rows an item, a block's shared
    bytes and its ``threads``, the last warp the producer."""

    rows: int
    smem_bytes: int
    threads: int


def k3_rotated_smem_bytes(n: int, rb: int) -> int:
    """Shared bytes of a rotated K3 block (``csrc/pyramid.cu``
    k3_rotated_layout): the taps and both sets' two mbarriers, two stage sets
    of rb rows at a stride of n + 4 floats, and rb rows of the odd levels'
    approximations at a stride of n/2 + 4."""
    return 4 * (2 * MAX_TAPS + 8 + 2 * _round4(rb * (n + 4)) + _round4(rb * (n // 2 + 4)))


@functools.lru_cache(maxsize=None)
def k3_rotated_plan(n: int, item: int = ROT_ITEM, threads: int = K3_ROT_THREADS) -> K3RotPlan:
    """The rotated K3's plan for rows of ``n``: ``item // n`` rows an item,
    at least ``ROT_MIN_ROWS``."""
    rb = max(ROT_MIN_ROWS, item // n)
    return K3RotPlan(rb, k3_rotated_smem_bytes(n, rb), threads)


@functools.lru_cache(maxsize=None)
def k3_rotated_blocks_per_sm(device_index: int, n: int, levels: int, m: int,
                             plan: K3RotPlan) -> int:
    """The rotated K3 blocks one SM of the card holds at ``plan``, asked once
    a plan."""
    return _blocks_per_sm(_K3_ROT, (None, None, None, 0, n, levels, m, plan.rows,
                                    plan.threads - 32, 0), device_index, "pyramid_rows_rotated",
                          plan.smem_bytes)


@functools.lru_cache(maxsize=256)
def k3_rotated_grid(device, rows: int, n: int, levels: int, m: int, plan: K3RotPlan) -> int:
    """The rotated K3's persistent blocks: one wave, min(items, SMs x blocks
    an SM)."""
    index = _device_index(device)
    return min(-(-rows // plan.rows),
               cuda_build.sm_count(index) * k3_rotated_blocks_per_sm(index, n, levels, m, plan))


def _check_rotated(x: torch.Tensor, filters, levels: int, what: str):
    _check(x, *filters, levels, what)
    if not rotated_rows(x.shape[1]):
        raise JWaveFailure(f"{what} - rows of {x.shape[1]} are longer than the rotated form's "
                           f"{ROT_MAX}")
    if x.shape[0] >= 2**31:
        raise JWaveFailure(f"{what} - {x.shape[0]} rows exceed one launch")


def _k3_rotated(x: torch.Tensor, dec_lo, dec_hi, levels: int,
                plan: K3RotPlan | None = None) -> torch.Tensor:
    """The rotated K3 on the card: one launch of one wave of persistent
    blocks over items of whole rows (:func:`k3_rotated_plan`; ``plan``
    overrides it), each counted as ``launch.K3`` and as a rotated pass."""
    if x.device.type == "cpu":
        return pyramid_rows_transposed_torch(x, dec_lo, dec_hi, levels)
    _check_rotated(x, (dec_lo, dec_hi), levels, "pyramid_rows_rotated")
    r, n = x.shape
    plan = plan or k3_rotated_plan(n)
    out = x.new_empty((n, r))
    if r == 0:
        return out
    with span("launch.K3", rows=r, n=n, levels=levels, rotated=1):
        m = len(dec_lo)
        taps = cuda_build.device_taps(dec_lo, dec_hi, x.device)
        cuda_build.launch(_K3_ROT, (x.data_ptr(), out.data_ptr(), taps.data_ptr(), r, n, levels,
                                    m, plan.rows, plan.threads - 32,
                                    k3_rotated_grid(x.device, r, n, levels, m, plan), None),
                          x.device, "pyramid_rows_rotated", "K3")
        count(ROTATED_PASSES)
    return out


class _PyramidRowsRotated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dec_lo, dec_hi, levels):
        ctx.args = (dec_lo, dec_hi, 1.0, levels)
        return _k3_rotated(x, dec_lo, dec_hi, levels)

    @staticmethod
    def backward(ctx, g):
        return ipyramid_rows(g.transpose(0, 1).contiguous(), *ctx.args), None, None, None


def pyramid_rows_rotated(x: torch.Tensor, dec_lo, dec_hi, levels: int) -> torch.Tensor:
    """K3's rotated form: the pyramid along each row of (R, N) f32, N a power
    of two up to ``ROT_MAX``, output (N, R), K4's function at gain 1
    (:func:`pyramid_rows_transposed_torch`) in one launch over whole rows."""
    return cuda_build.apply(_PyramidRowsRotated, _k3_rotated, x, dec_lo, dec_hi, levels)


def _k7_rotated(y: torch.Tensor, rec_lo, rec_hi, recon_gain: float, levels: int,
                plan: K7Plan | None = None) -> torch.Tensor:
    """K7's rotated form on the card: one launch of K7 over items of whole
    rows (``k7_plan(..., rotated=True)``; ``plan`` overrides it), level 1
    stored to the columns of (N, R); counted as ``launch.K7`` and as a
    rotated pass."""
    if y.device.type == "cpu":
        return ipyramid_rows_transposed_torch(y, rec_lo, rec_hi, recon_gain, levels)
    _check_rotated(y, (rec_lo, rec_hi), levels, "ipyramid_rows_rotated")
    r, n = y.shape
    m = len(rec_lo)
    plan = plan or k7_plan(n, levels, m, rotated=True)
    if plan.smem_bytes > SMEM_LIMIT:
        raise JWaveFailure(f"ipyramid_rows_rotated - a block of {plan.smem_bytes} shared bytes "
                           f"exceeds the card's {SMEM_LIMIT}")
    out = y.new_empty((n, r))
    if r == 0:
        return out
    with span("launch.K7", rows=r, n=n, levels=levels, rotated=1):
        taps = cuda_build.device_taps(rec_lo, rec_hi, y.device, recon_gain)
        cuda_build.launch(_K7, (y.data_ptr(), out.data_ptr(), taps.data_ptr(), r, n, plan.tile,
                                levels, m, plan.threads - 32,
                                k7_grid(y.device, r, n, levels, m, plan, True), 1, None),
                          y.device, "ipyramid_rows_rotated", "K7")
        count(ROTATED_PASSES)
    return out


class _IPyramidRowsRotated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, rec_lo, rec_hi, recon_gain, levels):
        ctx.args = (rec_lo, rec_hi, levels, recon_gain)
        return _k7_rotated(y, rec_lo, rec_hi, recon_gain, levels)

    @staticmethod
    def backward(ctx, g):
        return pyramid_rows(g.transpose(0, 1).contiguous(), *ctx.args), None, None, None, None


def ipyramid_rows_rotated(y: torch.Tensor, rec_lo, rec_hi, recon_gain: float,
                          levels: int) -> torch.Tensor:
    """K7's rotated form: the inverse pyramid along each row of (R, N) f32, N
    a power of two up to ``ROT_MAX``, output (N, R), K5's function
    (:func:`ipyramid_rows_transposed_torch`) in one launch over whole rows."""
    return cuda_build.apply(_IPyramidRowsRotated, _k7_rotated, y, rec_lo, rec_hi, recon_gain,
                            levels)


def k4_rows_per_block(n: int) -> int:
    """Rows a K4 block stages: K5's rule (:func:`k5_rows_per_block`), so K4
    and K5, each the other's backward, take the same row lengths."""
    return k5_rows_per_block(n)


def k4_smem_bytes(n: int, rb: int) -> int:
    """Shared bytes of a K4 block (``csrc/pyramid.cu``): the taps, the
    mbarrier padded to 16 bytes, the rb staged rows at a stride of n + 4
    floats and rb rows of level 1's approximations at a stride of
    n/2 + 4."""
    return 4 * (2 * MAX_TAPS + 4 + rb * (n + 4) + rb * (n // 2 + 4))


def _unrotate(g: torch.Tensor, group: int, n: int) -> torch.Tensor:
    """(F n, group) as the (F group, n) rows it was stored from: each group
    transposed back; a view where F is 1 (a transposed view of one group is
    then contiguous), else a copy."""
    f = g.shape[0] // n
    return g.reshape(f, n, group).transpose(1, 2).reshape(f * group, n)


#: K4's (K5's) entry, wrapper name, K-name, span and threads a block
_K4_LAUNCH = (_K4, "pyramid_rows_transposed", "K4", "launch.K4", K4_THREADS)
_K5_LAUNCH = (_K5, "ipyramid_rows_transposed", "K5", "launch.K5", K5_THREADS)


def _launch_transposed(x: torch.Tensor, f1, f2, levels: int, gain: float,
                       group: int | None, which: tuple) -> torch.Tensor:
    """One launch of K4 (K5, ``gain`` its ``recon_gain``; ``which`` is
    ``_K4_LAUNCH`` or ``_K5_LAUNCH``) on (F group, N) rows, output (F N,
    group), counted as ``launch.K4`` (``K5``) and as a rotated pass. The
    group (default all rows) divides the rows, and a block's rows lie in one
    group: a group of fewer rows than :func:`k4_rows_per_block` gives takes
    blocks of the largest power of two dividing it."""
    kernel, what, name, span_name, threads = which
    _check(x, f1, f2, levels, what)
    r, n = x.shape
    rb = k4_rows_per_block(n)
    if rb == 0:
        raise JWaveFailure(f"{what} - rows of {n} exceed one block's shared memory")
    if group is None or group == r:
        group, frames = r, 1
    elif group < 1 or r % group:
        raise JWaveFailure(f"{what} - {r} rows do not make groups of {group}")
    else:
        rb, frames = math.gcd(rb, group), r // group
    out = torch.empty((frames * n, group), dtype=x.dtype, device=x.device)
    if r == 0:
        return out
    with span(span_name, rows=r, n=n, levels=levels, group=group):
        taps = cuda_build.device_taps(f1, f2, x.device)
        cuda_build.launch(kernel, (x.data_ptr(), out.data_ptr(), taps.data_ptr(), r, n, levels,
                                   len(f1), rb, float(gain), group, threads),
                          x.device, what, name)
        count(ROTATED_PASSES)
    return out


def _k4(x: torch.Tensor, dec_lo, dec_hi, levels: int, gain: float,
        group: int | None = None) -> torch.Tensor:
    if x.device.type == "cpu":
        return pyramid_rows_transposed_torch(x, dec_lo, dec_hi, levels, gain, group)
    return _launch_transposed(x, dec_lo, dec_hi, levels, gain, group, _K4_LAUNCH)


class _PyramidRowsT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dec_lo, dec_hi, levels, gain, group):
        ctx.args, ctx.shape = (dec_lo, dec_hi, gain, levels), (group or x.shape[0], x.shape[1])
        return _k4(x, dec_lo, dec_hi, levels, gain, group)

    @staticmethod
    def backward(ctx, g):
        group, n = ctx.shape
        gt = _unrotate(g, group, n).contiguous()  # free when g is a transposed view
        back = ipyramid_rows_transposed(gt, *ctx.args, group=group)
        return _unrotate(back, group, n), None, None, None, None, None


def pyramid_rows_transposed(x: torch.Tensor, dec_lo, dec_hi, levels: int,
                            gain: float = 1.0, group: int | None = None) -> torch.Tensor:
    """K4: the pyramid along each row of (F group, N) f32, each group of
    ``group`` rows (default all: output (N, R)) stored transposed, output
    (F N, group); each level's a and d scaled by ``gain``."""
    return cuda_build.apply(_PyramidRowsT, _k4, x, dec_lo, dec_hi, levels, gain, group)


def k5_rows_per_block(n: int) -> int:
    """Rows a K5 block stages: the most (up to 8) whose rb*n floats stay
    within ``K5_ROW_FLOATS``, so that three blocks share an SM and a level's
    rb*n/4 output pairs fit ``K5_PAIRS`` pairs of registers of each of
    ``K5_THREADS`` threads; 0 when one row is longer than that."""
    if n > K5_ROW_FLOATS:
        return 0
    return min(K5_MAX_ROWS_PER_BLOCK, K5_ROW_FLOATS // n)


def k5_smem_bytes(n: int, rb: int) -> int:
    """Shared bytes of a K5 block (``csrc/pyramid.cu``): the taps, the
    mbarrier padded to 16 bytes, and the rb staged rows at a stride of n + 4
    floats."""
    return 4 * (2 * MAX_TAPS + 4 + rb * (n + 4))


def _k5(y: torch.Tensor, rec_lo, rec_hi, recon_gain: float, levels: int,
        group: int | None = None) -> torch.Tensor:
    if y.device.type == "cpu":
        return ipyramid_rows_transposed_torch(y, rec_lo, rec_hi, recon_gain, levels, group)
    return _launch_transposed(y, rec_lo, rec_hi, levels, recon_gain, group, _K5_LAUNCH)


class _IPyramidRowsT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, rec_lo, rec_hi, recon_gain, levels, group):
        ctx.args, ctx.shape = (rec_lo, rec_hi, levels, recon_gain), (group or y.shape[0],
                                                                     y.shape[1])
        return _k5(y, rec_lo, rec_hi, recon_gain, levels, group)

    @staticmethod
    def backward(ctx, g):
        group, n = ctx.shape
        gt = _unrotate(g, group, n).contiguous()  # free when g is a transposed view
        back = pyramid_rows_transposed(gt, *ctx.args, group=group)
        return _unrotate(back, group, n), None, None, None, None, None


def ipyramid_rows_transposed(y: torch.Tensor, rec_lo, rec_hi, recon_gain: float,
                             levels: int, group: int | None = None) -> torch.Tensor:
    """K5: the inverse pyramid along each row of (F group, N) f32, each
    group of ``group`` rows (default all: output (N, R)) stored transposed,
    output (F N, group)."""
    return cuda_build.apply(_IPyramidRowsT, _k5, y, rec_lo, rec_hi, recon_gain, levels, group)
