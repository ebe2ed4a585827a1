"""Wavelet Packet Transform: packets as a batch axis, levels fused.

Reference: jwave/transforms/WaveletPacketTransform.java:96-189, as
``jwave_tpu.transforms.wpt`` implements it: at level l the butterfly is
applied to all ``g = N/h`` packets of length ``h``, so the packet axis is a
reshape into a leading batch dimension; up to 6 consecutive levels are fused
into ONE strided circular convolution with a composite (noble-identity)
filter bank (``ops.composite``), which reads the input once per chunk of
levels instead of once per level. On a CUDA float32 tensor a fused chunk is
one launch of K8 (K9 for the inverse), the cascade in shared memory
(``ops.cuda_wpt``); elsewhere it is one cuDNN convolution under
``config.dial``. Chunks of one level run the torch butterfly. Each call is
one ``wpt`` (``iwpt``) span with its ``n``, ``levels`` and ``chunks``; the
counters ``wpt.fused_chunks`` and ``wpt.butterfly_levels`` count the chunks
that fused and the levels the butterfly ran.

In 2D (:func:`wpt2d`, :func:`iwpt2d`, the facade's ``forward_2d`` and
``reverse_2d``) a CUDA float32 stack of frames runs each axis pass with its
last chunk by the rotated K8 (K9), which stores each frame's (rows, n) as
(n, rows): two passes leave the frame as ``ndim.forward_2d`` leaves it, with
no transposing copy. Anything else takes the separable ``ndim`` path.

Best basis (Coifman-Wickerhauser) sits on top: the full packet tree, an
additive cost per node summed in float64 on the host, and the bottom-up
dynamic program over the tree (1D) or the quadtree (2D).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import config
from ..exceptions import JWaveFailure
from ..filters import get_filter
from ..ops import cuda_wpt
from ..ops.butterfly import butterfly_forward, butterfly_reverse
from ..ops.composite import _on_kernel, wpt_fused_forward, wpt_fused_inverse
from ..utils.host import as_tensor, copy_to_device
from ..utils.numerics import exponent_of_two, is_power_of_two
from ..utils.profiling import count, span
from . import ndim

#: max levels fused into one composite conv (2^6 = 64 output channels)
FUSE_MAX_LEVELS = 6
#: cap on composite filter length (keeps the conv arithmetic reasonable)
FUSE_MAX_TAPS = 512
#: the interleaved layout's tile width: lane ``p*S + s`` of a 128-lane tile
#: holds position ``p`` of subband ``s`` (the JAX package's MXU tile layout)
LANES = 128

# listed from import on: chunks of one level (the torch butterfly) read 0
# where every chunk fused
count("wpt.fused_chunks", 0)
count("wpt.butterfly_levels", 0)


def _chunk_schedule(n: int, level: int, fb) -> list[tuple[int, int]]:
    """[(packet_size_h, fused_levels_c), ...] covering ``level`` levels.

    Mirrors the sequential loop's stopping rule: the c-th fused level
    operates on blocks of size h >> (c-1), which must be >= the bank's
    transform wavelength (WaveletPacketTransform.java:100).
    """
    m = fb.length
    sched = []
    h = n
    l = 0
    while h >= fb.transform_wavelength and l < level:
        c = min(FUSE_MAX_LEVELS, level - l)
        while c > 1 and (h >> (c - 1)) < fb.transform_wavelength:
            c -= 1
        while c > 1 and (m - 1) * ((1 << c) - 1) + 1 > FUSE_MAX_TAPS:
            c -= 1
        sched.append((h, c))
        h >>= c
        l += c
    return sched


def _interleaved_ok(n: int, level: int, fb, fused: bool, who: str):
    """layout='interleaved' is defined where the JAX package runs the whole
    transform as ONE fused chunk of its tile kernel: raise elsewhere, and
    whenever the butterfly dial is 'off', which in JAX turns that kernel off.
    'auto' keeps the layout, as JAX does on its TPU."""
    sched = _chunk_schedule(n, level, fb)
    if not (fused and config.mxu_butterfly() != "off" and n % LANES == 0 and 1 <= level
            and (1 << level) <= LANES and len(sched) == 1 and sched[0][1] == level):
        raise JWaveFailure(
            f"{who} - layout='interleaved' requires the single-chunk MXU path "
            f"(N % 128 == 0, 1 <= level <= {FUSE_MAX_LEVELS}, composite bank "
            f"<= {FUSE_MAX_TAPS} taps, fused=True, and the MXU butterfly dial "
            f"enabled); use layout='subband' otherwise"
        )


def _check(x: torch.Tensor, level, layout: str, who: str) -> int:
    n = x.shape[-1]
    if not is_power_of_two(n):
        raise JWaveFailure(f"{who} - length {n} is not 2^p; use AED for arbitrary lengths")
    steps = exponent_of_two(n)
    if level is None:
        level = steps
    if level < 0 or level > steps:
        raise JWaveFailure(f"{who} - level {level} out of range [0, {steps}]")
    if layout not in ("subband", "interleaved"):
        raise JWaveFailure(f"{who} - unknown layout {layout!r}")
    return level


def wpt(x, wavelet, level: int | None = None, fused: bool = True,
        layout: str = "subband") -> torch.Tensor:
    """Forward WPT along the last axis (length 2^p), batched over the rest.

    ``layout='subband'`` (default) returns the reference's subband-major
    order; ``layout='interleaved'`` the JAX package's tile layout (lane
    ``p*S+s`` of tile j = position ``j*P+p`` of subband s), what
    :func:`wpt_subband_to_interleaved` makes of the subband result, stored
    so by the fused chunk itself. ``fused=False``
    runs one butterfly per level. A float input keeps its dtype (bf16
    stays bf16); integers become torch's default float at the first level.
    """
    fb = get_filter(wavelet)
    x = as_tensor(x)
    n = x.shape[-1]
    level = _check(x, level, layout, "wpt")
    # interleaved: one fused chunk of `level` levels, which stores the layout
    # itself; one level (the butterfly) is permuted after
    inter = layout == "interleaved"
    if inter:
        _interleaved_ok(n, level, fb, fused, "wpt")
    sched = _chunk_schedule(n, level, fb)
    with span("wpt", n=n, levels=level, chunks=len(sched)):
        for h, c in sched:
            x = _forward_chunk(x, fb, h, c, fused, inter)
        if inter and level == 1:
            return wpt_subband_to_interleaved(x, level)
        return x


def iwpt(y, wavelet, level: int | None = None, fused: bool = True,
         layout: str = "subband") -> torch.Tensor:
    """Inverse WPT along the last axis (WaveletPacketTransform.java:141-189).

    ``layout='interleaved'`` takes the layout ``wpt(..., layout=
    'interleaved')`` gives: the fused chunk reads it directly (one level is
    permuted back to subbands first)."""
    fb = get_filter(wavelet)
    y = as_tensor(y)
    n = y.shape[-1]
    level = _check(y, level, layout, "iwpt")
    inter = layout == "interleaved"
    if inter:
        _interleaved_ok(n, level, fb, fused, "iwpt")
        if level == 1:
            y = wpt_interleaved_to_subband(y, level)
    sched = _chunk_schedule(n, level, fb)
    with span("iwpt", n=n, levels=level, chunks=len(sched)):
        for h, c in reversed(sched):
            y = _inverse_chunk(y, fb, h, c, fused, inter)
        return y


def _forward_chunk(x: torch.Tensor, fb, h: int, c: int, fused: bool,
                   inter: bool) -> torch.Tensor:
    """One chunk of :func:`wpt` on (..., n): ``c`` levels of every packet of
    ``h`` samples, fused (K8 or the conv form) or by the butterfly."""
    lead, n = x.shape[:-1], x.shape[-1]
    packets = x.reshape(lead + (n // h, h))
    if fused and c > 1:
        count("wpt.fused_chunks")
        packets = wpt_fused_forward(packets, fb.dec_lo, fb.dec_hi, c, interleaved=inter)
    else:
        count("wpt.butterfly_levels", c)
        for l in range(c):
            hh = h >> l
            sub = packets.reshape(lead + (n // hh, hh))
            packets = butterfly_forward(sub, fb.dec_lo, fb.dec_hi)
    return packets.reshape(lead + (n,))


def _inverse_chunk(y: torch.Tensor, fb, h: int, c: int, fused: bool,
                   inter: bool) -> torch.Tensor:
    """One chunk of :func:`iwpt` on (..., n), the adjoint of
    :func:`_forward_chunk` with the synthesis pair."""
    lead, n = y.shape[:-1], y.shape[-1]
    packets = y.reshape(lead + (n // h, h))
    if fused and c > 1:
        count("wpt.fused_chunks")
        packets = wpt_fused_inverse(packets, fb.rec_lo, fb.rec_hi, c, fb.recon_gain,
                                    interleaved=inter)
    else:
        count("wpt.butterfly_levels", c)
        for l in range(c - 1, -1, -1):
            hh = h >> l
            sub = packets.reshape(lead + (n // hh, hh))
            packets = butterfly_reverse(sub, fb.rec_lo, fb.rec_hi, fb.recon_gain)
    return packets.reshape(lead + (n,))


def _rotated_passes(x: torch.Tensor, fb, levels, inverse: bool) -> list | None:
    """The rotated route's axis passes of a 2D transform of ``x``, given
    ``levels`` as (level_cols, level_rows), the passes' order: for each pass
    (n, group, level, schedule), the rows of n being (F group, n); None where
    ``x`` keeps the separable ``ndim`` path: not a CUDA float32 tensor of
    rank >= 2 under 2^31 elements, an extent not a power of two or a level
    out of its range (the separable path raises for those), or a pass whose
    last chunk executed (the finest forward, the first inverse) is not a
    fused chunk that the rotated K8 (K9) takes in whole items of each
    group."""
    if not (x.dim() >= 2 and _on_kernel(x) and x.numel() < 2**31):
        return None
    height, width = x.shape[-2:]
    passes = []
    for n, group, level in ((width, height, levels[0]), (height, width, levels[1])):
        if not is_power_of_two(n):
            return None
        steps = exponent_of_two(n)
        level = steps if level is None else level
        if not 0 <= level <= steps:
            return None
        sched = _chunk_schedule(n, level, fb)
        if not sched:
            return None
        h, c = sched[0] if inverse else sched[-1]
        plan = cuda_wpt.wpt_rotated_plan(n, h, c, fb.length, inverse) if c > 1 else None
        if plan is None or group % plan.full_rows:
            return None
        passes.append((n, group, level, sched))
    return passes


def wpt2d(mat, wavelet, level_rows: int | None = None,
          level_cols: int | None = None) -> torch.Tensor:
    """2D WPT over the last two axes (leading axes are frames), laid out as
    ``ndim.forward_2d`` over :func:`wpt` lays it out: each row (the last
    axis) at ``level_cols``, then each column at ``level_rows``.

    Where :func:`_rotated_passes` allows, two passes, each in its ``wpt``
    span: the chunks before the last in place, the last one rotated K8
    launch storing each frame's (H, W) rows as (W, H), then the same along
    H, which leaves (H, W); no transposing copy. Else the separable path."""
    fb = get_filter(wavelet)
    x = as_tensor(mat)
    passes = _rotated_passes(x, fb, (level_cols, level_rows), False)
    if passes is None:
        return ndim.forward_2d(lambda v, lvl: wpt(v, fb, lvl), x, level_rows, level_cols)
    y = x.contiguous()
    for n, group, level, sched in passes:
        with span("wpt", n=n, levels=level, chunks=len(sched)):
            rows = y.reshape(-1, n)
            for h, c in sched[:-1]:
                rows = _forward_chunk(rows, fb, h, c, True, False)
            h, c = sched[-1]
            count("wpt.fused_chunks")
            y = cuda_wpt.wpt_rows_rotated(rows, fb.dec_lo, fb.dec_hi, c, group, h)
    return y.reshape(x.shape)


def iwpt2d(coeffs, wavelet, level_rows: int | None = None,
           level_cols: int | None = None) -> torch.Tensor:
    """Inverse of :func:`wpt2d`, as ``ndim.reverse_2d`` over :func:`iwpt`:
    where :func:`wpt2d` takes the rotated route, two passes, each ending in
    one rotated K9 launch (its first chunk, the last executed), else the
    separable path."""
    fb = get_filter(wavelet)
    y = as_tensor(coeffs)
    passes = _rotated_passes(y, fb, (level_cols, level_rows), True)
    if passes is None:
        return ndim.reverse_2d(lambda v, lvl: iwpt(v, fb, lvl), y, level_rows, level_cols)
    x = y.contiguous()
    for n, group, level, sched in passes:
        with span("iwpt", n=n, levels=level, chunks=len(sched)):
            rows = x.reshape(-1, n)
            for h, c in reversed(sched[1:]):
                rows = _inverse_chunk(rows, fb, h, c, True, False)
            h, c = sched[0]
            count("wpt.fused_chunks")
            x = cuda_wpt.iwpt_rows_rotated(rows, fb.rec_lo, fb.rec_hi, c, group, h,
                                           fb.recon_gain)
    return x.reshape(y.shape)


def wpt_interleaved_to_subband(y, level: int) -> torch.Tensor:
    """A ``layout='interleaved'`` coefficient row (..., N) in the reference's
    subband-major order."""
    y = as_tensor(y)
    n = y.shape[-1]
    s = 1 << level
    out = y.reshape(-1, n // LANES, LANES // s, s)
    return out.movedim(-1, 1).reshape(y.shape)


def wpt_subband_to_interleaved(y, level: int) -> torch.Tensor:
    """Inverse of :func:`wpt_interleaved_to_subband`."""
    y = as_tensor(y)
    n = y.shape[-1]
    s = 1 << level
    blocks = y.reshape(-1, s, n // LANES, LANES // s)
    return blocks.movedim(1, -1).reshape(y.shape)


# --------------------------------------------------------------------------
# Best-basis selection (Coifman-Wickerhauser)
# --------------------------------------------------------------------------

def _block_costs(blocks: torch.Tensor, cost: str, threshold: float, who: str) -> np.ndarray:
    """Additive per-block cost of a (B, nodes, block_len) stack, computed and
    summed over the leading batch axis in float64: (nodes,) host floats."""
    b = blocks.to(torch.float64)
    if cost == "shannon":
        c2 = b * b
        vals = -torch.sum(torch.where(c2 > 0, c2 * torch.log(torch.clamp(c2, min=1e-300)), 0.0),
                          dim=-1)
    elif cost == "threshold":
        vals = torch.sum((torch.abs(b) > threshold).to(torch.float64), dim=-1)
    elif cost == "l1":
        vals = torch.sum(torch.abs(b), dim=-1)
    else:
        raise JWaveFailure(f"{who} - unknown cost {cost!r} (use 'shannon', 'threshold' or 'l1')")
    return torch.sum(vals, dim=0).cpu().numpy()


def _node_costs(row: torch.Tensor, level: int, cost: str, threshold: float) -> np.ndarray:
    """Additive cost of every packet node at ``level`` from the full WPT row
    (..., N): (2^level,) host floats (summed over leading axes)."""
    n = row.shape[-1]
    blocks = row.reshape(-1, 1 << level, n >> level)
    return _block_costs(blocks, cost, threshold, "best_basis")


@dataclass
class BestBasis:
    """A chosen wavelet-packet basis: disjoint dyadic nodes covering [0, N).

    ``nodes`` are (level, position) pairs in Paley order; ``coefficients[i]``
    holds node i's packet coefficients (leading axes = input batch). The
    reference has no best-basis machinery; this follows Coifman &
    Wickerhauser (1992), the algorithm PyWavelets exposes via its
    WaveletPacket tree.
    """

    nodes: list
    coefficients: list
    cost: float
    n: int
    wavelet: str

    @classmethod
    def from_numpy(cls, nodes, coefficients, cost, n, wavelet, device=None) -> "BestBasis":
        """A basis from numpy arrays (e.g. a JAX package result's fields, the
        coefficients as ``np.asarray``), copied into tensors on ``device``
        ("cuda" by default)."""
        return cls([tuple(int(v) for v in nd) for nd in nodes],
                   [copy_to_device(c, device) for c in coefficients], float(cost), int(n),
                   str(wavelet))


def best_basis(x, wavelet, max_level: int | None = None, cost: str = "shannon",
               threshold: float = 0.0) -> BestBasis:
    """Coifman-Wickerhauser best wavelet-packet basis along the last axis.

    Computes the full packet tree to ``max_level`` (one batched butterfly
    pass per level), scores every node with an additive cost ('shannon'
    entropy, 'threshold' count above ``threshold``, or 'l1'), and selects the
    minimal-cost disjoint cover by the classic bottom-up dynamic program. For
    batched input one shared basis is chosen from the summed costs. Returns
    a :class:`BestBasis`; invert with :func:`best_basis_reconstruct`.
    """
    fb = get_filter(wavelet)
    x = as_tensor(x)
    n = x.shape[-1]
    if not is_power_of_two(n):
        raise JWaveFailure(f"best_basis - length {n} is not 2^p")
    steps = exponent_of_two(n)
    if max_level is None:
        max_level = steps
    if max_level < 0:
        raise JWaveFailure(f"best_basis - max_level {max_level} out of range [0, {steps}]")
    max_level = min(max_level, steps)
    lead = x.shape[:-1]

    # full packet tree: rows[l] = depth-l WPT of x (one butterfly pass each)
    rows = [x]
    cur = x
    for l in range(max_level):
        h = n >> l
        if h < fb.transform_wavelength:
            max_level = l
            break
        sub = cur.reshape(lead + (n // h, h))
        cur = butterfly_forward(sub, fb.dec_lo, fb.dec_hi).reshape(lead + (n,))
        rows.append(cur)

    costs = [_node_costs(rows[l], l, cost, threshold) for l in range(max_level + 1)]

    # bottom-up DP: keep a node iff its cost beats its best children cover
    best = costs[max_level].copy()
    keep = [None] * (max_level + 1)
    keep[max_level] = [True] * (1 << max_level)
    for l in range(max_level - 1, -1, -1):
        keep_l = []
        nxt = best
        best = costs[l].copy()
        for p in range(1 << l):
            children = nxt[2 * p] + nxt[2 * p + 1]
            if costs[l][p] <= children:
                keep_l.append(True)
            else:
                keep_l.append(False)
                best[p] = children
        keep[l] = keep_l

    # walk down from the root collecting the chosen cover
    nodes = []

    def _collect(l, p):
        if keep[l][p] or l == max_level:
            nodes.append((l, p))
        else:
            _collect(l + 1, 2 * p)
            _collect(l + 1, 2 * p + 1)

    _collect(0, 0)
    coefficients = [rows[l].reshape(lead + (1 << l, n >> l))[..., p, :] for l, p in nodes]
    return BestBasis(nodes=nodes, coefficients=coefficients, cost=float(best[0]),
                     n=n, wavelet=fb.name)


def best_basis_reconstruct(bb: BestBasis, wavelet=None) -> torch.Tensor:
    """Invert a :class:`BestBasis` back to the signal (exact: the chosen
    nodes form a disjoint dyadic cover, so reconstruction is the inverse
    butterfly cascade over the cover tree)."""
    fb = get_filter(wavelet if wavelet is not None else bb.wavelet)
    table = {node: as_tensor(c) for node, c in zip(bb.nodes, bb.coefficients)}
    max_level = max(l for l, _ in bb.nodes) if bb.nodes else 0

    def _rebuild(l, p):
        if (l, p) in table:
            return table[(l, p)]
        merged = torch.cat([_rebuild(l + 1, 2 * p), _rebuild(l + 1, 2 * p + 1)], dim=-1)
        return butterfly_reverse(merged, fb.rec_lo, fb.rec_hi, fb.recon_gain)

    if max_level == 0:
        return table[(0, 0)]
    return _rebuild(0, 0)


def _butterfly2_fwd(block: torch.Tensor, fb) -> torch.Tensor:
    """Separable 2D analysis butterfly on the last two axes: each (h, w)
    block becomes the quadrant layout [[LL, LH], [HL, HH]] ([L|H] per axis)."""
    y = butterfly_forward(block, fb.dec_lo, fb.dec_hi)
    y = butterfly_forward(y.transpose(-1, -2), fb.dec_lo, fb.dec_hi)
    return y.transpose(-1, -2)


def _butterfly2_rev(block: torch.Tensor, fb) -> torch.Tensor:
    y = butterfly_reverse(block.transpose(-1, -2), fb.rec_lo, fb.rec_hi, fb.recon_gain)
    return butterfly_reverse(y.transpose(-1, -2), fb.rec_lo, fb.rec_hi, fb.recon_gain)


def _node_costs_2d(tree: torch.Tensor, cost: str, threshold: float) -> np.ndarray:
    """(..., B, B, h, w) packet grid -> (B, B) host cost matrix (summed over
    leading axes; the same additive costs as the 1D best basis)."""
    b1, b2, h, w = tree.shape[-4:]
    blocks = tree.reshape(-1, b1 * b2, h * w)
    return _block_costs(blocks, cost, threshold, "best_basis_2d").reshape(b1, b2)


@dataclass
class BestBasis2D:
    """A chosen 2D wavelet-packet basis: disjoint quadtree nodes covering the
    image plane. ``nodes`` are (level, py, px) triples; ``coefficients[i]`` is
    node i's (..., H/2^l, W/2^l) packet block."""

    nodes: list
    coefficients: list
    cost: float
    shape: tuple
    wavelet: str

    @classmethod
    def from_numpy(cls, nodes, coefficients, cost, shape, wavelet,
                   device=None) -> "BestBasis2D":
        """A basis from numpy arrays (e.g. a JAX package result's fields),
        copied into tensors on ``device`` ("cuda" by default)."""
        return cls([tuple(int(v) for v in nd) for nd in nodes],
                   [copy_to_device(c, device) for c in coefficients], float(cost),
                   tuple(int(v) for v in shape), str(wavelet))


def best_basis_2d(img, wavelet, max_level: int | None = None, cost: str = "shannon",
                  threshold: float = 0.0) -> BestBasis2D:
    """Coifman-Wickerhauser best basis over the 2D wavelet-packet QUADTREE.

    The 2D analog of :func:`best_basis`: the full packet quadtree is one
    separable batched butterfly pass per level, each node scored with an
    additive cost, and the minimal disjoint cover picked by the bottom-up
    dynamic program (a node survives iff its cost beats its four children's
    best covers). For batched images one shared basis is chosen from summed
    costs.
    """
    fb = get_filter(wavelet)
    x = as_tensor(img)
    if x.dim() < 2:
        raise JWaveFailure("best_basis_2d - image must have at least 2 axes")
    h, w = x.shape[-2:]
    if not (is_power_of_two(h) and is_power_of_two(w)):
        raise JWaveFailure(f"best_basis_2d - shape {h}x{w} is not 2^p x 2^q")
    steps = min(exponent_of_two(h), exponent_of_two(w))
    if max_level is None:
        max_level = steps
    if max_level < 0:
        raise JWaveFailure(f"best_basis_2d - max_level {max_level} out of range")
    max_level = min(max_level, steps)
    lead = x.shape[:-2]

    # full quadtree: tree[l] has shape lead + (2^l, 2^l, h/2^l, w/2^l)
    tree = [x[..., None, None, :, :]]
    cur = tree[0]
    for l in range(max_level):
        hh, ww = cur.shape[-2], cur.shape[-1]
        if min(hh, ww) < fb.transform_wavelength:
            max_level = l
            break
        y = _butterfly2_fwd(cur, fb)
        b = cur.shape[-4]
        h2, w2 = hh // 2, ww // 2
        y = y.reshape(lead + (b, b, 2, h2, 2, w2))
        y = y.movedim(-4, -5)  # (..., b_y, q_y, b_x, h2, q_x, w2)
        y = y.movedim(-2, -3)  # (..., b_y, q_y, b_x, q_x, h2, w2)
        cur = y.reshape(lead + (2 * b, 2 * b, h2, w2))
        tree.append(cur)

    costs = [_node_costs_2d(tree[l], cost, threshold) for l in range(max_level + 1)]

    best = costs[max_level].copy()
    keep = [None] * (max_level + 1)
    keep[max_level] = np.ones((1 << max_level, 1 << max_level), dtype=bool)
    for l in range(max_level - 1, -1, -1):
        nxt = best
        best = costs[l].copy()
        keep_l = np.ones((1 << l, 1 << l), dtype=bool)
        for py in range(1 << l):
            for px in range(1 << l):
                children = (nxt[2 * py, 2 * px] + nxt[2 * py, 2 * px + 1]
                            + nxt[2 * py + 1, 2 * px] + nxt[2 * py + 1, 2 * px + 1])
                if costs[l][py, px] > children:
                    keep_l[py, px] = False
                    best[py, px] = children
        keep[l] = keep_l

    nodes = []

    def _collect(l, py, px):
        if l == max_level or keep[l][py, px]:
            nodes.append((l, py, px))
        else:
            for dy in (0, 1):
                for dx in (0, 1):
                    _collect(l + 1, 2 * py + dy, 2 * px + dx)

    _collect(0, 0, 0)
    coefficients = [tree[l][..., py, px, :, :] for l, py, px in nodes]
    return BestBasis2D(nodes=nodes, coefficients=coefficients,
                       cost=float(best[0, 0]), shape=(h, w), wavelet=fb.name)


def best_basis_2d_reconstruct(bb: BestBasis2D, wavelet=None) -> torch.Tensor:
    """Invert a :class:`BestBasis2D` back to the image (exact)."""
    fb = get_filter(wavelet if wavelet is not None else bb.wavelet)
    table = {node: as_tensor(c) for node, c in zip(bb.nodes, bb.coefficients)}
    max_level = max((l for l, _, _ in bb.nodes), default=0)

    def _rebuild(l, py, px):
        if (l, py, px) in table:
            return table[(l, py, px)]
        if l >= max_level:
            raise JWaveFailure("best_basis_2d_reconstruct - node cover is not disjoint/complete")
        ll = _rebuild(l + 1, 2 * py, 2 * px)
        lh = _rebuild(l + 1, 2 * py, 2 * px + 1)
        hl = _rebuild(l + 1, 2 * py + 1, 2 * px)
        hh = _rebuild(l + 1, 2 * py + 1, 2 * px + 1)
        top = torch.cat([ll, lh], dim=-1)
        bot = torch.cat([hl, hh], dim=-1)
        return _butterfly2_rev(torch.cat([top, bot], dim=-2), fb)

    return _rebuild(0, 0, 0)
