"""K8/K9: the fused wavelet packet transform and its adjoint
(``csrc/wpt.cu``), with plain versions.

Replaces, with no ``pallas_call`` behind either,
``jwave_tpu/ops/mxu_wpt.py`` ``wpt_fused_forward_mxu`` (``:87``, K8) and
``wpt_fused_inverse_mxu`` (``:125``, K9), the tile matmuls that
``jwave_tpu/ops/composite.py`` routes its fused WPT to on the TPU. On rows
(R, h), with S = 2^c and ``bank = composite_filters(lo, hi, c)``, K8 is

    out[s, i] = sum_m bank[s, m] x[(S i + m) mod h]

subband-major (S runs of h/S), or with ``interleaved`` at ``i S + s`` (the
JAX package's tile layout); it computes this as c levels of the packet
butterfly. K9 is its adjoint, the synthesis butterflies from the coarsest
level, reading either layout. Each takes a ``gain`` folded into the taps on
the host (the float64 product, then float32) that scales every level's
outputs, so K9 with the synthesis pair and ``recon_gain`` is
``wpt_fused_inverse``.

Bound on an H100: bytes (64 x 65536 f32 read and written once: 10 us at
3.35 TB/s), beside ~10 us of the levels' shared-memory traffic and 7 us of
FMAs at the float32 rate. The first design ran one item a block: its staging,
levels and stores one after another, in two waves (a ``%globaltimer``
probe: 4-5.5 us of copies, then 7-13 us of levels an item). The design now
(``csrc/wpt.cu``'s header has the detail and the variants left out,
each with its measured time): one wave of persistent blocks,
:func:`wpt_grid` = min(items, SMs x the occupancy calculator's blocks an
SM), over work items of ``WPT_TILE`` output samples with their window (K8)
or dependency cones (K9), or tile // h whole rows; a producer warp stages
item k + 1 into the second of two stage sets while ``WPT_THREADS`` - 32
compute threads run item k's levels in shared memory (the set, then one
level buffer, in turns: three buffers, four blocks an SM); the taps go by
value as a kernel parameter. The levels are bound by instruction throughput
(~1.4 us a level a block), not by shared-memory banks. Left out: another
read order, two-phase packets, staggered stores (no bank conflict, no
gain or slower), two groups a pass (96 registers), warps owning subtrees
(a race in tiled items), 256 compute threads, tiles of 2048 (slower).

The wrappers launch the kernels for CUDA float32 tensors and take the plain
versions only for tensors on the CPU. Each goes through a
``torch.autograd.Function`` whose backward is the other kernel with the same
pair, gain and layout: a level of either is the transpose of the other's
level with the same filters, as for K3 and K7 (``ops/cuda_pyramid.py``).

Beside the plain cascade (:func:`wpt_analysis_torch`,
:func:`wpt_synthesis_torch`), :func:`wpt_analysis_tiled_torch` and
:func:`wpt_synthesis_tiled_torch` compute the same as the kernels partition
it (windows, cones, whole-row items, taken in the kernels' persistent order)
for the tests; the conv form (``ops/composite.py`` ``wpt_conv_forward``,
``wpt_conv_inverse``) is the one-library-call comparison.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..exceptions import JWaveFailure
from ..utils.profiling import span
from . import cuda_build

#: ``csrc/wpt.cu``: the most levels, a block's threads (the compute
#: threads, at most 256, and the producer warp), output samples a work item
#: (rows longer than it; else tile // h whole rows an item), the ints of each
#: cone table, the floats past a tiled K8 buffer that a group's reads reach,
#: and the shared floats before the stage sets (each set's two mbarriers and
#: three cone tables)
MAX_LEVELS = 12
WPT_THREADS = 128 + 32
WPT_TILE = 4096
META = 16
SLACK = 16
HEAD = 2 * 2 * 2 + 2 * 3 * META
SMEM_LIMIT = 227 * 1024
#: an SM's shared memory, what the card keeps of it for each block, and the
#: blocks an SM that the default plans are sized for (tools/ab_times.py
#: --wpt-plans): three window-sized buffers a block, four blocks an SM
SM_SMEM = 228 * 1024
BLOCK_RESERVED = 1024
WPT_BLOCKS_PER_SM = 4


def _round4(v: int) -> int:
    return (v + 3) & ~3


def _gained(f, gain: float) -> list:
    return [float(v) for v in np.asarray(f, np.float64) * gain]


def _packets(y: torch.Tensor, levels: int, interleaved: bool) -> torch.Tensor:
    """(R, h) coefficients as (R, S, h/S) packets, from either layout."""
    r, h = y.shape
    s = 1 << levels
    return y.reshape(r, h // s, s).transpose(1, 2) if interleaved else y.reshape(r, s, h // s)


def _unpack(p: torch.Tensor, interleaved: bool) -> torch.Tensor:
    """(R, S, h/S) packets as (R, h) coefficients in the layout."""
    r = p.shape[0]
    return (p.transpose(1, 2) if interleaved else p).reshape(r, -1)


# ----------------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------------

def _analysis_level(cur: torch.Tensor, lo, hi, n_out: int, wrap: int | None) -> torch.Tensor:
    """(..., nb, n_in) packets -> (..., 2 nb, n_out): a and d of packet b as
    packets 2b and 2b + 1, a[u] = sum_j lo[j] x[2u + j] (mod ``wrap``, or
    inside the packet: else IndexError)."""
    n_in = cur.shape[-1]
    idx = 2 * torch.arange(n_out, device=cur.device)[:, None] + torch.arange(len(lo),
                                                                             device=cur.device)
    if wrap:
        idx = idx % wrap
    elif n_out and int(idx.max()) >= n_in:
        raise IndexError("a level reads outside its staged window")
    v = cur[..., idx]  # (..., nb, n_out, m)
    a = (v * torch.as_tensor(lo, dtype=cur.dtype, device=cur.device)).sum(-1)
    d = (v * torch.as_tensor(hi, dtype=cur.dtype, device=cur.device)).sum(-1)
    return torch.stack([a, d], dim=-2).flatten(-3, -2)


def _synthesis_level(cur: torch.Tensor, lo, hi, c: torch.Tensor, wrap: int | None,
                     shift: int) -> torch.Tensor:
    """(..., 2 nb, n_in) packets -> (..., nb, 2 len(c)): from a = packet 2b
    and d = 2b + 1, x[2c + q] = sum_t lo[2t + q] a[c - t] + hi[2t + q] d[c - t],
    read at (c - t) mod ``wrap``, or at c - t - ``shift`` inside the staged
    packet (else IndexError)."""
    mh = (len(lo) + 1) // 2
    n_in = cur.shape[-1]
    i = c[None, :] - torch.arange(mh, device=cur.device)[:, None]  # (t, pair)
    i = i % wrap if wrap else i - shift
    if c.numel() and (int(i.min()) < 0 or int(i.max()) >= n_in):
        raise IndexError("a level reads outside its staged cone")
    lo2 = torch.zeros(2 * mh, dtype=cur.dtype, device=cur.device)
    hi2 = torch.zeros_like(lo2)
    lo2[:len(lo)] = torch.as_tensor(lo, dtype=cur.dtype, device=cur.device)
    hi2[:len(hi)] = torch.as_tensor(hi, dtype=cur.dtype, device=cur.device)
    av, dv = cur[..., 0::2, :][..., i], cur[..., 1::2, :][..., i]  # (..., nb, t, pair)
    x0 = (av * lo2[0::2, None]).sum(-2) + (dv * hi2[0::2, None]).sum(-2)
    x1 = (av * lo2[1::2, None]).sum(-2) + (dv * hi2[1::2, None]).sum(-2)
    return torch.stack([x0, x1], dim=-1).flatten(-2)


def wpt_analysis_torch(x: torch.Tensor, lo, hi, levels: int, gain: float = 1.0,
                       interleaved: bool = False) -> torch.Tensor:
    """(R, h) -> (R, h): ``levels`` analysis butterflies on every packet, by
    gathers and FMAs, each level's outputs scaled by ``gain``."""
    lo, hi = _gained(lo, gain), _gained(hi, gain)
    cur = x.reshape(x.shape[0], 1, x.shape[1])
    for _ in range(levels):
        n_in = cur.shape[-1]
        cur = _analysis_level(cur, lo, hi, n_in // 2, n_in)
    return _unpack(cur, interleaved)


def wpt_synthesis_torch(y: torch.Tensor, lo, hi, levels: int, gain: float = 1.0,
                        interleaved: bool = False) -> torch.Tensor:
    """(R, h) -> (R, h): the adjoint of :func:`wpt_analysis_torch`, the
    synthesis butterflies from the coarsest level, each level's outputs
    scaled by ``gain``."""
    lo, hi = _gained(lo, gain), _gained(hi, gain)
    cur = _packets(y, levels, interleaved)
    for _ in range(levels):
        half = cur.shape[-1]
        cur = _synthesis_level(cur, lo, hi, torch.arange(half, device=y.device), half, 0)
    return cur.reshape(y.shape)


class WptPlan(NamedTuple):
    """A launch of K8 or K9: ``tile`` output samples an item of a row longer
    than it, else ``rows`` = tile // h whole rows an item (1 for longer
    rows); the bytes of a stage set and of the level buffer, of a block with
    ``sets`` stage sets; the ``threads`` of a block, its last warp the
    producer."""

    tile: int
    rows: int
    set_bytes: int
    buf_bytes: int
    smem_bytes: int
    sets: int
    threads: int


def k8_count(tile: int, levels: int, m: int, l: int) -> int:
    """Outputs of each of the 2^l packets that a K8 item of a long row keeps
    at level l (``csrc/wpt.cu`` k8_count; l = 0: the staged window), all
    that the later levels read: the last level keeps the item's tile >> levels."""
    return (tile >> l) + (m - 1) * ((1 << (levels - l)) - 1)


def k9_cones(h: int, levels: int, m: int, tile: int, t0: int) -> list:
    """The dependency cones of the K9 item that owns output samples [t0, t0 +
    tile) of a row longer than the tile (``csrc/wpt.cu`` k9_cone_next): entry
    l - 1 is (start, count, whole) of R_l, l = 1 .. levels + 1, the samples
    of each packet of level l - 1 (h >> (l-1) samples) that the item makes
    (R_1 the tile; R_{levels+1} the staged part of each subband). The pairs
    of R_l read back ceil(m/2) - 1 samples of R_{l+1}; its ends are rounded
    out to multiples of 8, and a cone that would cover its packet is the
    whole packet (read circularly): ``ops.cuda_pyramid.k7_cones`` for every
    branch at once."""
    mh = (m + 1) // 2
    s, cnt = t0, tile
    out = [(s, cnt, False)]
    for l in range(1, levels + 1):
        half = h >> l
        u = s >> 1
        st, en = (u - (mh - 1)) & ~7, (u + cnt // 2 + 7) & ~7
        whole = en - st >= half
        s, cnt = (0, half) if whole else (st, en - st)
        out.append((s, cnt, whole))
    return out


def wpt_layout(h: int, tile: int, levels: int, m: int, inverse: bool) -> tuple:
    """(a stage set, the level buffer) floats of a K8 (or, ``inverse``, K9)
    block, as ``csrc/wpt.cu`` k8_layout / k9_layout count them; a block
    holds ``HEAD``, two sets and the buffer, and level l reads the set (l
    odd) or the buffer and writes the other, the set being released only
    after the item's last level. Whole rows: the tile and a rounded run
    each. K8's tiled items: in a set the window and the even levels' 2^l
    packets, in the buffer the odd levels', each at a stride of
    round4(k8_count), with ``SLACK`` behind. K9's: either holds the S
    staged cones (or the interleaved raw run), their transpose, and each
    level's 2^(l-1) cones (l >= 2; level 1 stores to the output)."""
    if h <= tile:
        return tile + 4, tile + 4
    if not inverse:
        st, bf = _round4(k8_count(tile, levels, m, 0)), 0
        for l in range(1, levels + 1):
            f = (1 << l) * _round4(k8_count(tile, levels, m, l))
            if l & 1:
                bf = max(bf, f)
            else:
                st = max(st, f)
        return st + SLACK, bf + SLACK
    cones = k9_cones(h, levels, m, tile, 0)
    f = max([(1 << (l - 1)) * _round4(cones[l - 1][1]) for l in range(2, levels + 1)], default=0)
    cnt = cones[levels][1]
    f = max(f, (1 << levels) * _round4(cnt), _round4(cnt << levels) + 4)
    return f, f


@functools.lru_cache(maxsize=None)
def wpt_plan(h: int, levels: int, m: int, inverse: bool = False, tile: int | None = None,
             threads: int = WPT_THREADS) -> WptPlan:
    """The plan of K8 (K9 with ``inverse``) on rows of ``h``: items of
    ``WPT_TILE`` output samples (at least 8 positions of each of the 2^levels
    subbands) or tile // h whole rows; blocks of ``threads`` (the compute
    threads and the producer warp) holding two stage sets and a buffer."""
    tile = tile or max(WPT_TILE, 8 << levels)
    st, bf = wpt_layout(h, tile, levels, m, inverse)
    return WptPlan(tile, tile // h if h <= tile else 1, 4 * st, 4 * bf,
                   4 * (HEAD + 2 * st + bf), 2, threads)


def wpt_items(rows: int, h: int, plan: WptPlan) -> int:
    """The work items of a launch: (row, tile) pairs, or groups of
    ``plan.rows`` whole rows, the last one shorter."""
    if h <= plan.tile:
        return -(-rows // plan.rows)
    return rows * (h // plan.tile)


def _persistent_order(rows: int, h: int, plan: WptPlan, grid: int | None) -> list:
    """The work items in the kernels' order: ``grid`` persistent blocks
    (default: one an item), block b taking items b, b + grid, ...."""
    items = wpt_items(rows, h, plan)
    grid = items if grid is None else min(grid, items)
    return [item for b in range(grid) for item in range(b, items, grid)]


def _covered_once(written: torch.Tensor):
    if not bool((written == 1).all()):
        raise IndexError("the work items do not cover each output once")


def wpt_analysis_tiled_torch(x: torch.Tensor, lo, hi, levels: int, plan: WptPlan,
                             gain: float = 1.0, interleaved: bool = False,
                             grid: int | None = None) -> torch.Tensor:
    """:func:`wpt_analysis_torch` computed as K8 partitions it (for the tests:
    the window and item arithmetic has no other CPU check), the items taken
    in the kernel's persistent order by ``grid`` blocks (default: one an
    item). An item of a row longer than ``plan.tile`` stages the window
    x[(j tile + k) mod h], k < k8_count(0), and runs the levels on it
    unwrapped, level l keeping :func:`k8_count` outputs of each packet; an
    item of ``plan.rows`` whole rows (fewer in the last) runs the levels
    circularly within its packets. An index outside the staged window, or
    an output written other than once, raises."""
    r, h = x.shape
    m = len(lo)
    order = _persistent_order(r, h, plan, grid)
    if h <= plan.tile:
        out = torch.empty_like(x)
        written = torch.zeros((r, h), dtype=torch.int32)
        for item in order:
            rows = slice(item * plan.rows, (item + 1) * plan.rows)
            out[rows] = wpt_analysis_torch(x[rows], lo, hi, levels, gain, interleaved)
            written[rows] += 1
        _covered_once(written)
        return out
    lo_g, hi_g = _gained(lo, gain), _gained(hi, gain)
    tiles = h // plan.tile
    p = plan.tile >> levels
    k = torch.arange(k8_count(plan.tile, levels, m, 0), device=x.device)
    starts = plan.tile * torch.arange(tiles, device=x.device)
    cur = x[:, (starts[:, None] + k) % h][:, :, None, :]  # (R, tiles, 1, window)
    for l in range(1, levels + 1):
        cur = _analysis_level(cur, lo_g, hi_g, k8_count(plan.tile, levels, m, l), None)
    # (R, tiles, S, P): item (row, j) holds positions j P .. j P + P - 1 of every subband
    sub = torch.empty((r, 1 << levels, h >> levels), dtype=x.dtype, device=x.device)
    written = torch.zeros(sub.shape, dtype=torch.int32)
    for item in order:
        row, j = divmod(item, tiles)
        sub[row, :, j * p:(j + 1) * p] = cur[row, j]
        written[row, :, j * p:(j + 1) * p] += 1
    _covered_once(written)
    return _unpack(sub, interleaved)


def wpt_synthesis_tiled_torch(y: torch.Tensor, lo, hi, levels: int, plan: WptPlan,
                              gain: float = 1.0, interleaved: bool = False,
                              grid: int | None = None) -> torch.Tensor:
    """:func:`wpt_synthesis_torch` computed as K9 partitions it (for the
    tests: the cone and item arithmetic has no other CPU check), the items
    taken in the kernel's persistent order by ``grid`` blocks (default: one
    an item). An item of a row longer than ``plan.tile`` stages the cone
    R_{levels+1} of every subband (:func:`k9_cones`, mod the subband's
    length, each within the block's buffer bounds) and runs the levels from
    the coarsest on its cones alone, a whole-packet cone read circularly; an
    item of ``plan.rows`` whole rows (fewer in the last) runs each level
    over all its rows' packets. An index outside a staged cone, or an output
    written other than once, raises."""
    r, h = y.shape
    m = len(lo)
    order = _persistent_order(r, h, plan, grid)
    out = torch.empty_like(y)
    written = torch.zeros((r, h), dtype=torch.int32)
    if h <= plan.tile:
        for item in order:
            rows = slice(item * plan.rows, (item + 1) * plan.rows)
            out[rows] = wpt_synthesis_torch(y[rows], lo, hi, levels, gain, interleaved)
            written[rows] += 1
        _covered_once(written)
        return out
    lo_g, hi_g = _gained(lo, gain), _gained(hi, gain)
    sub = _packets(y, levels, interleaved)  # (R, S, h/S)
    hc = h >> levels
    tiles = h // plan.tile
    bounds = k9_cones(h, levels, m, plan.tile, 0)
    ar = functools.partial(torch.arange, device=y.device)
    made = {}  # tile j -> its outputs of every row, made at the first item that needs them

    def tile_of(j):
        cones = k9_cones(h, levels, m, plan.tile, j * plan.tile)
        if [c[1] for c in cones] != [c[1] for c in bounds]:
            raise IndexError(f"a cone outgrows the block's buffers: {cones} {bounds}")
        s_c, n_c, _ = cones[levels]
        cur = sub[:, :, (s_c + ar(n_c)) % hc]
        for l in range(levels, 0, -1):
            s_in, _, whole = cones[l]
            s_out, n_out, _ = cones[l - 1]
            c = s_out // 2 + ar(n_out // 2)
            cur = _synthesis_level(cur, lo_g, hi_g, c, (h >> l) if whole else None, s_in)
        return cur[:, 0]

    for item in order:
        row, j = divmod(item, tiles)
        if j not in made:
            made[j] = tile_of(j)
        cols = slice(j * plan.tile, (j + 1) * plan.tile)
        out[row, cols] = made[j][row]
        written[row, cols] += 1
    _covered_once(written)
    return out


# ----------------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------------

def _check(x: torch.Tensor, lo, hi, levels: int, what: str):
    if x.device.type != "cuda":
        raise JWaveFailure(f"{what} - tensor on {x.device}; the kernel runs on CUDA tensors")
    if x.dtype != torch.float32:
        raise JWaveFailure(f"{what} - dtype {x.dtype}; the kernel takes float32")
    if x.dim() != 2 or not x.is_contiguous():
        raise JWaveFailure(f"{what} - expected a contiguous (R, h) tensor, got {tuple(x.shape)}")
    h = x.shape[1]
    if h & (h - 1) or h == 0:
        raise JWaveFailure(f"{what} - row length {h} is not a power of two")
    if not 1 <= levels <= min(MAX_LEVELS, h.bit_length() - 1):
        raise JWaveFailure(f"{what} - {levels} levels do not fit rows of {h}")
    cuda_build.check_filters(lo, hi, what)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P]
#: inverse -> (``csrc/wpt.cu``'s entry: library, symbol, signature), the
#: wrapper's name and the kernel's K-name
_SYMBOLS = {False: (("wpt", "jw_wpt_analysis", _ARGTYPES), "wpt_rows", "K8"),
            True: (("wpt", "jw_wpt_synthesis", _ARGTYPES), "iwpt_rows", "K9")}


@functools.lru_cache(maxsize=None)
def wpt_blocks_per_sm(device_index: int, h: int, levels: int, m: int, inverse: bool,
                      plan: WptPlan) -> int:
    """The K8 (K9) blocks one SM of the card holds at ``plan``
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), asked once a plan."""
    kernel, key, _ = _SYMBOLS[inverse]
    fn = cuda_build.entry(*kernel)
    got = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(None, None, None, 1, h, plan.tile, levels, m, 0, plan.threads - 32, 0,
                 ctypes.byref(got), None)
    cuda_build.check(cuda_build.library("wpt"), err, key)
    if got.value < 1:
        raise JWaveFailure(f"{key} - a block of {plan.smem_bytes} shared bytes does not fit an SM")
    return got.value


def wpt_grid(device, rows: int, h: int, levels: int, m: int, inverse: bool,
             plan: WptPlan) -> int:
    """K8's (K9's) persistent blocks: one wave, min(items, SMs x blocks an SM)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return min(wpt_items(rows, h, plan),
               cuda_build.sm_count(index) * wpt_blocks_per_sm(index, h, levels, m, inverse, plan))


def _launch(x: torch.Tensor, lo, hi, levels: int, gain: float, interleaved: bool,
            inverse: bool, plan: WptPlan | None, grid: int | None) -> torch.Tensor:
    """One launch of K8 (K9 with ``inverse``) on the card: one wave of
    persistent blocks over the work items (``plan`` overrides
    :func:`wpt_plan`, ``grid`` :func:`wpt_grid`)."""
    kernel, key, name = _SYMBOLS[inverse]
    _check(x, lo, hi, levels, key)
    r, h = x.shape
    m = len(lo)
    plan = plan or wpt_plan(h, levels, m, inverse)
    if plan.smem_bytes > SMEM_LIMIT:
        raise JWaveFailure(f"{key} - a block of {plan.smem_bytes} shared bytes exceeds the "
                           f"card's {SMEM_LIMIT}")
    if wpt_items(r, h, plan) >= 2**31:
        raise JWaveFailure(f"{key} - {r} rows of {h} exceed one launch")
    out = torch.empty_like(x)
    if r == 0:
        return out
    with span(f"launch.{name}", rows=r, n=h, levels=levels):
        # the taps go by value, as a kernel parameter: host floats [lo | hi]
        taps = (np.concatenate([np.asarray(lo, np.float64), np.asarray(hi, np.float64)])
                * gain).astype(np.float32)
        grid = grid or wpt_grid(x.device, r, h, levels, m, inverse, plan)
        cuda_build.launch(kernel, (x.data_ptr(), out.data_ptr(),
                                   taps.ctypes.data_as(ctypes.c_void_p), r, h, plan.tile, levels, m,
                                   int(interleaved), plan.threads - 32, grid, None),
                          x.device, key, name)
    return out


def _k8(x: torch.Tensor, lo, hi, levels: int, gain: float = 1.0, interleaved: bool = False,
        plan: WptPlan | None = None, grid: int | None = None) -> torch.Tensor:
    if x.device.type == "cpu":
        return wpt_analysis_torch(x, lo, hi, levels, gain, interleaved)
    return _launch(x, lo, hi, levels, gain, interleaved, False, plan, grid)


def _k9(y: torch.Tensor, lo, hi, levels: int, gain: float = 1.0, interleaved: bool = False,
        plan: WptPlan | None = None, grid: int | None = None) -> torch.Tensor:
    if y.device.type == "cpu":
        return wpt_synthesis_torch(y, lo, hi, levels, gain, interleaved)
    return _launch(y, lo, hi, levels, gain, interleaved, True, plan, grid)


class _WptRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi, levels, gain, interleaved):
        ctx.args = (lo, hi, levels, gain, interleaved)
        return _k8(x, lo, hi, levels, gain, interleaved)

    @staticmethod
    def backward(ctx, g):
        return iwpt_rows(g.contiguous(), *ctx.args), None, None, None, None, None


class _IWptRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, lo, hi, levels, gain, interleaved):
        ctx.args = (lo, hi, levels, gain, interleaved)
        return _k9(y, lo, hi, levels, gain, interleaved)

    @staticmethod
    def backward(ctx, g):
        return wpt_rows(g.contiguous(), *ctx.args), None, None, None, None, None


def wpt_rows(x: torch.Tensor, lo, hi, levels: int, gain: float = 1.0,
             interleaved: bool = False) -> torch.Tensor:
    """K8: ``levels`` fused WPT analysis levels of each row of (R, h) f32,
    output (R, h) subband-major or ``interleaved``; each level's outputs
    scaled by ``gain``."""
    return cuda_build.apply(_WptRows, _k8, x, lo, hi, levels, gain, interleaved)


def iwpt_rows(y: torch.Tensor, lo, hi, levels: int, gain: float = 1.0,
              interleaved: bool = False) -> torch.Tensor:
    """K9: the adjoint of :func:`wpt_rows` on (R, h) f32 in its layout, the
    synthesis levels from the coarsest; each level's outputs scaled by
    ``gain``."""
    return cuda_build.apply(_IWptRows, _k9, y, lo, hi, levels, gain, interleaved)
