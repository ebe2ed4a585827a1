"""K8 and K9, the fused WPT kernels of jwave_tpu_torch (``ops/cuda_wpt.py``
``wpt_rows``, ``iwpt_rows``), on the CPU.

The wrappers on a CPU tensor run the kernels' plain versions (the level
cascade by gathers); the kernels' partition of the work (windows of long
rows, their dependency cones, items of several whole rows) runs in plain
torch (``wpt_analysis_tiled_torch``, ``wpt_synthesis_tiled_torch``). Both
are held in float64 against the JAX package's fused WPT
(``jwave_tpu.ops.composite.wpt_fused_forward``/``_inverse``, the functions
the kernels replace on their path; with JAX's butterfly dial on, its MXU tile
form ``mxu_wpt``), in both layouts, and the port's ``wpt``/``iwpt`` routed
through the kernels' autograd Functions (as on the card) against JAX's
``wpt``/``iwpt`` and ``jax.vjp``. Tolerance 1e-10 of max|ref|: the cascade
and the composite convolution sum in another order. The card's tests of the
kernels themselves are in tests/test_torch_kernels.py (marked ``cuda``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import jwave_tpu as jw  # noqa: E402
from jwave_tpu import config as jw_config  # noqa: E402
from jwave_tpu.ops import composite as jw_composite  # noqa: E402

import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch.ops import composite, cuda_wpt  # noqa: E402
from jwave_tpu_torch.transforms.wpt import FUSE_MAX_TAPS, _chunk_schedule  # noqa: E402

TOL = 1e-10
BANKS = ("Daubechies 4", "Haar orthogonal", "Daubechies 2", "Discrete Meyer")


def _cases():
    """(bank, h, c): packets of 8, 16, 1024 and 4096 samples, c = 1 .. 6
    where the composite bank stays within the tap cap (62 taps: c <= 3)."""
    out = []
    for bank in BANKS:
        m = len(jt.get_filter(bank).dec_lo)
        for h in (8, 16, 1024, 4096):
            out += [(bank, h, c) for c in range(1, 7)
                    if h >> c >= 1 and (m - 1) * ((1 << c) - 1) + 1 <= FUSE_MAX_TAPS]
    return out


CASES = _cases()


def _input(shape, seed=0):
    return np.random.default_rng([seed, *shape]).standard_normal(shape)


def _err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / max(float(np.abs(want).max()), 1e-300)


def _to_interleaved(a, c):
    r, h = a.shape
    return a.reshape(r, 1 << c, h >> c).transpose(0, 2, 1).reshape(r, h)


@functools.lru_cache(maxsize=None)
def _jax_fused(bank, h, c, rows=2):
    """JAX's fused forward and inverse (rec pair, recon_gain) of one input
    of ``rows`` rows, once a case."""
    fb = jw.get_filter(bank)
    both = jax.jit(lambda v: (
        jw_composite.wpt_fused_forward(v, fb.dec_lo, fb.dec_hi, c),
        jw_composite.wpt_fused_inverse(v, fb.rec_lo, fb.rec_hi, c, fb.recon_gain)))
    fwd, inv = both(jnp.asarray(_input((rows, h))))
    return np.asarray(fwd), np.asarray(inv)


def _plans(h, c, m, inverse):
    """The default plan (whole rows up to 4096) and the smallest tile (8
    positions a subband), which cuts longer packets into windows and
    cones."""
    return [cuda_wpt.wpt_plan(h, c, m, inverse, tile) for tile in (None, 8 << c)]


@pytest.mark.parametrize("layout", ["subband", "interleaved"])
@pytest.mark.parametrize("bank,h,c", CASES, ids=lambda v: str(v))
def test_k8_k9_plain_and_tiled_match_jax(bank, h, c, layout):
    """The wrappers on CPU tensors (the plain cascade) and the kernels'
    partition under two plans against JAX's fused forward and inverse
    (their interleaved layout: the same coefficients at i * 2^c + s)."""
    fb = jt.get_filter(bank)
    m = len(fb.dec_lo)
    inter = layout == "interleaved"
    want_y, want_x = _jax_fused(bank, h, c)
    x = _input((2, h))
    if inter:
        want_y = _to_interleaved(want_y, c)
    y_in = torch.tensor(_to_interleaved(x, c) if inter else x)
    xt = torch.tensor(x)
    assert _err(cuda_wpt.wpt_rows(xt, fb.dec_lo, fb.dec_hi, c, interleaved=inter), want_y) <= TOL
    assert _err(cuda_wpt.iwpt_rows(y_in, fb.rec_lo, fb.rec_hi, c, fb.recon_gain, inter),
                want_x) <= TOL
    for plan in _plans(h, c, m, False):
        got = cuda_wpt.wpt_analysis_tiled_torch(xt, fb.dec_lo, fb.dec_hi, c, plan, 1.0, inter)
        assert _err(got, want_y) <= TOL, plan
    for plan in _plans(h, c, m, True):
        got = cuda_wpt.wpt_synthesis_tiled_torch(y_in, fb.rec_lo, fb.rec_hi, c, plan,
                                                 fb.recon_gain, inter)
        assert _err(got, want_x) <= TOL, plan


@pytest.mark.parametrize("layout", ["subband", "interleaved"])
@pytest.mark.parametrize("bank,h,c,gain", [
    ("Daubechies 4", 4096, 6, 1.0), ("Haar orthogonal", 1024, 6, 0.5),
    ("Discrete Meyer", 2048, 3, 1.0), ("Symlet 8", 16, 4, 2.0),
    ("Battle 23", 2048, 4, 1.0),  # 23 taps: an odd bank
])
def test_k8_k9_adjoint_and_backward(bank, h, c, gain, layout):
    """<K8 x, y> = <x, K9 y> with one pair and gain (the plain versions and
    the tiled partition), and the backward of each autograd Function is the
    other: the gradient of <K8 x, w> is K9 w, and both equal jax.vjp of
    JAX's fused forward (subband layout)."""
    fb = jt.get_filter(bank)
    lo, hi = fb.dec_lo, fb.dec_hi
    inter = layout == "interleaved"
    x, w = torch.tensor(_input((3, h), 1)), torch.tensor(_input((3, h), 2))
    k8 = cuda_wpt.wpt_analysis_torch(x, lo, hi, c, gain, inter)
    k9 = cuda_wpt.wpt_synthesis_torch(w, lo, hi, c, gain, inter)
    lhs, rhs = float((k8 * w).sum()), float((x * k9).sum())
    assert abs(lhs - rhs) <= TOL * abs(lhs)
    tile = 8 << c
    k8t = cuda_wpt.wpt_analysis_tiled_torch(x, lo, hi, c, cuda_wpt.wpt_plan(h, c, len(lo), False,
                                                                            tile), gain, inter)
    k9t = cuda_wpt.wpt_synthesis_tiled_torch(w, lo, hi, c, cuda_wpt.wpt_plan(h, c, len(lo), True,
                                                                             tile), gain, inter)
    assert _err(k8t, k8) <= TOL and _err(k9t, k9) <= TOL

    xg = x.clone().requires_grad_()
    (g8,) = torch.autograd.grad((cuda_wpt.wpt_rows(xg, lo, hi, c, gain, inter) * w).sum(), xg)
    assert _err(g8, k9) <= TOL
    wg = w.clone().requires_grad_()
    (g9,) = torch.autograd.grad((cuda_wpt.iwpt_rows(wg, lo, hi, c, gain, inter) * x).sum(), wg)
    assert _err(g9, k8) <= TOL
    if not inter:
        jfb = jw.get_filter(bank)
        _, vjp = jax.vjp(lambda v: jw_composite.wpt_fused_forward(v, jfb.dec_lo, jfb.dec_hi, c),
                         jnp.asarray(x.numpy()))
        assert _err(g8, np.asarray(vjp(jnp.asarray(w.numpy()))[0]) * gain ** c) <= TOL


@pytest.fixture
def kernel_route(monkeypatch):
    """Route ops.composite to the kernels' autograd Functions for CPU
    tensors, as it routes CUDA float32 tensors, with the kernels' partition
    (plans of 8 positions a subband, tiled wherever a packet is longer) in
    place of the launches; yields the calls made, (kernel, h, c, layout)."""
    calls = []
    monkeypatch.setattr(composite, "_on_kernel", lambda x: True)

    def k8(x, lo, hi, levels, gain=1.0, interleaved=False, plan=None):
        calls.append(("K8", x.shape[1], levels, interleaved))
        plan = cuda_wpt.wpt_plan(x.shape[1], levels, len(lo), False, 8 << levels)
        return cuda_wpt.wpt_analysis_tiled_torch(x, lo, hi, levels, plan, gain, interleaved)

    def k9(y, lo, hi, levels, gain=1.0, interleaved=False, plan=None):
        calls.append(("K9", y.shape[1], levels, interleaved))
        plan = cuda_wpt.wpt_plan(y.shape[1], levels, len(lo), True, 8 << levels)
        return cuda_wpt.wpt_synthesis_tiled_torch(y, lo, hi, levels, plan, gain, interleaved)

    monkeypatch.setattr(cuda_wpt, "_k8", k8)
    monkeypatch.setattr(cuda_wpt, "_k9", k9)
    jw_config.set_mxu_butterfly("on")
    yield calls
    jw_config.set_mxu_butterfly("auto")


@pytest.mark.parametrize("bank,level,layout", [
    ("Daubechies 4", None, "subband"), ("Haar orthogonal", None, "subband"),
    ("Discrete Meyer", None, "subband"), ("Battle 23", None, "subband"),
    ("CDF 9/7", None, "subband"), ("Daubechies 4", 6, "interleaved"),
    ("Daubechies 2", 3, "interleaved"), ("Haar orthogonal", 6, "interleaved"),
])
def test_wpt_iwpt_through_the_kernels_match_jax(kernel_route, bank, level, layout):
    """The port's wpt and iwpt on (2, 3, 512) through K8's and K9's
    Functions (full depth: chunks (512, 6) and (8, 3) for db4; the 62-tap
    bank's chunks of 3 levels; Battle 23 (23 taps, transform wavelength 8:
    chunks (512, 4) and (32, 3)) and CDF 9/7, callable outside the builder;
    one chunk in the interleaved layout, which
    JAX computes with its tile kernel), their chunks as transforms/wpt.py
    schedules them, and wpt's gradient (K9 in the backward) against
    jax.vjp of JAX's wpt."""
    x = _input((2, 3, 512), 3)
    w = _input((2, 3, 512), 4)
    want_y = np.asarray(jw.wpt(jnp.asarray(x), bank, level, layout=layout))
    want_x = np.asarray(jw.iwpt(jnp.asarray(x), bank, level, layout=layout))
    got_y = jt.wpt(torch.tensor(x), bank, level, layout=layout)
    got_x = jt.iwpt(torch.tensor(x), bank, level, layout=layout)
    assert _err(got_y, want_y) <= TOL and _err(got_x, want_x) <= TOL
    fb = jt.get_filter(bank)
    fused = [(h, c) for h, c in _chunk_schedule(512, level or 9, fb) if c > 1]
    inter = layout == "interleaved"
    assert kernel_route == ([("K8", h, c, inter) for h, c in fused]
                            + [("K9", h, c, inter) for h, c in fused[::-1]])
    _, vjp = jax.vjp(lambda v: jw.wpt(v, bank, level, layout=layout), jnp.asarray(x))
    xg = torch.tensor(x, requires_grad=True)
    (g,) = torch.autograd.grad((jt.wpt(xg, bank, level, layout=layout) * torch.tensor(w)).sum(),
                               xg)
    assert _err(g, np.asarray(vjp(jnp.asarray(w))[0])) <= TOL
    assert [k for k, *_ in kernel_route].count("K9") == 2 * len(fused)


def test_wpt_plan():
    """The plans worked out by hand from ``csrc/wpt.cu``'s layouts: a head of
    2 x 2 mbarriers (8 floats) and 2 x 3 cone tables of 16 ints (104 floats;
    the taps go as a kernel parameter), two stage sets and one level buffer,
    level l reading the
    set (l odd) or the buffer and writing the other; 128 compute threads and
    the producer warp (160). db4 L6 on rows of 65536: items of 4096 samples,
    64 positions a subband; K8's window 4096 + 7 * 63 = 4537 floats (4540),
    levels 1-6 keep 2265, 1129, 561, 277, 135, 64 a packet: a set holds the
    window and the even levels (4 x 1132 = 4528, 16 x 280 = 4480, 64 x 64 =
    4096), 4540 + 16 of slack = 4556 floats, the buffer the odd (2 x 2268 =
    4536, 8 x 564, 32 x 136), 4536 + 16 = 4552: 4 x (104 + 2 x 4556 + 4552)
    = 55,072 bytes. K9's cones 2056, 1032, 520, 264, 136 and 72: levels 2-6
    make 2 x 2056 = 4112, 4 x 1032 = 4128, 8 x 520 = 4160, 16 x 264 = 4224
    and 32 x 136 = 4352, the staged cones 64 x 72 = 4608 and the raw
    interleaved run 4612, so a set and the buffer hold 4612 each: 4 x (104 +
    3 x 4612) = 55,760 bytes. Four blocks an SM: 4 x (55,072 + 1024) =
    224,384 and 4 x (55,760 + 1024) = 227,136 of the SM's 233,472. Rows of
    at most the tile: tile // h whole rows an item, 4100 floats a set and
    the buffer (4 x (104 + 3 x 4100) = 49,616 bytes)."""
    assert [cuda_wpt.k8_count(4096, 6, 8, l) for l in range(7)] == [
        4537, 2265, 1129, 561, 277, 135, 64]
    assert [c[1] for c in cuda_wpt.k9_cones(65536, 6, 8, 4096, 0)] == [
        4096, 2056, 1032, 520, 264, 136, 72]
    assert cuda_wpt.HEAD == 104 and cuda_wpt.WPT_THREADS == 160
    assert cuda_wpt.wpt_plan(65536, 6, 8) == (4096, 1, 4 * 4556, 4 * 4552, 55072, 2, 160)
    assert cuda_wpt.wpt_plan(65536, 6, 8, True) == (4096, 1, 4 * 4612, 4 * 4612, 55760, 2, 160)
    assert cuda_wpt.wpt_plan(1024, 6, 8) == (4096, 4, 4 * 4100, 4 * 4100, 49616, 2, 160)
    assert cuda_wpt.wpt_plan(16, 4, 8, True) == (4096, 256, 4 * 4100, 4 * 4100, 49616, 2, 160)
    # tiles of 2048, 256 compute threads: the window 2048 + 441 = 2489
    # (2492), level 1's 2 x 1244 floats
    assert cuda_wpt.wpt_plan(65536, 6, 8, False, 2048, 288) == (
        2048, 1, 4 * (2492 + 16), 4 * (2 * 1244 + 16), 4 * (104 + 2 * 2508 + 2504), 2, 288)
    for plan in (cuda_wpt.wpt_plan(65536, 6, 8), cuda_wpt.wpt_plan(65536, 6, 8, True)):
        assert 4 * (plan.smem_bytes + cuda_wpt.BLOCK_RESERVED) <= cuda_wpt.SM_SMEM
    assert cuda_wpt.wpt_items(64, 65536, cuda_wpt.wpt_plan(65536, 6, 8)) == 1024
    assert cuda_wpt.wpt_items(4096, 1024, cuda_wpt.wpt_plan(1024, 6, 8)) == 1024
    assert cuda_wpt.wpt_items(1000, 16, cuda_wpt.wpt_plan(16, 4, 8)) == 4


def test_wpt_plan_fits_every_row_length_and_filter():
    """Every plan of K8 and K9 (power-of-two rows of 2 to 2^20, 1 to 6
    levels where the composite bank stays within the tap cap, db4, Haar,
    Symlet 8 and the 62-tap Discrete Meyer) fits a block and leaves room
    for the blocks an SM the plans are sized for; its items are whole rows
    up to the tile and tiles of P >= 8 positions of every subband past it."""
    for bank in ("Daubechies 4", "Haar", "Symlet 8", "Discrete Meyer"):
        m = len(jt.get_filter(bank).dec_lo)
        for lg in range(1, 21):
            h = 1 << lg
            for c in range(1, min(6, lg) + 1):
                if (m - 1) * ((1 << c) - 1) + 1 > FUSE_MAX_TAPS:
                    continue
                for inverse in (False, True):
                    plan = cuda_wpt.wpt_plan(h, c, m, inverse)
                    assert plan.smem_bytes <= cuda_wpt.SMEM_LIMIT, (bank, h, c, inverse)
                    per_sm = cuda_wpt.WPT_BLOCKS_PER_SM * (plan.smem_bytes
                                                           + cuda_wpt.BLOCK_RESERVED)
                    assert per_sm <= cuda_wpt.SM_SMEM, (bank, h, c, inverse, plan)
                    assert plan.smem_bytes == 4 * cuda_wpt.HEAD + 2 * plan.set_bytes + \
                        plan.buf_bytes
                    if h <= plan.tile:
                        assert plan.rows == plan.tile // h
                    else:
                        assert plan.rows == 1 and plan.tile >> c >= 8
                        assert cuda_wpt.wpt_items(3, h, plan) == 3 * h // plan.tile


#: (bank, h, c, tile, grid): rows of 2 cut into more items than blocks, some
#: blocks taking one item more than others, and forced grids of 1 and 2
ORDER = [("Daubechies 4", 4096, 5, 256, 5),    # 32 items over 5 blocks: 7 or 6 each
         ("Daubechies 4", 4096, 3, 1024, 3),   # 8 items over 3 blocks: 3 or 2 each
         ("Discrete Meyer", 512, 3, 64, 2),    # 62 taps: cones that cover their packets
         ("Haar orthogonal", 1024, 6, 512, 1),
         ("Symlet 8", 2048, 5, 256, 7)]        # 16 items over 7 blocks


@pytest.mark.parametrize("layout", ["subband", "interleaved"])
@pytest.mark.parametrize("bank,h,c,tile,grid", ORDER, ids=lambda v: str(v))
def test_k8_k9_persistent_order(bank, h, c, tile, grid, layout, monkeypatch):
    """K8's and K9's tiled items taken by ``grid`` persistent blocks, block b
    items b, b + grid, ...; against JAX's fused forward and inverse. An item
    count that leaves an item out raises."""
    fb = jt.get_filter(bank)
    m = len(fb.dec_lo)
    inter = layout == "interleaved"
    want_y, want_x = _jax_fused(bank, h, c)
    x = _input((2, h))
    if inter:
        want_y = _to_interleaved(want_y, c)
    xt = torch.tensor(x)
    y_in = torch.tensor(_to_interleaved(x, c) if inter else x)
    p8, p9 = cuda_wpt.wpt_plan(h, c, m, False, tile), cuda_wpt.wpt_plan(h, c, m, True, tile)
    items = cuda_wpt.wpt_items(2, h, p8)
    assert items == 2 * h // tile > grid and items == cuda_wpt.wpt_items(2, h, p9)
    got_y = cuda_wpt.wpt_analysis_tiled_torch(xt, fb.dec_lo, fb.dec_hi, c, p8, 1.0, inter, grid)
    got_x = cuda_wpt.wpt_synthesis_tiled_torch(y_in, fb.rec_lo, fb.rec_hi, c, p9, fb.recon_gain,
                                               inter, grid)
    assert _err(got_y, want_y) <= TOL and _err(got_x, want_x) <= TOL
    monkeypatch.setattr(cuda_wpt, "wpt_items", lambda rows, h_, plan: items - 1)
    with pytest.raises(IndexError, match="once"):
        cuda_wpt.wpt_analysis_tiled_torch(xt, fb.dec_lo, fb.dec_hi, c, p8, 1.0, inter, grid)
    with pytest.raises(IndexError, match="once"):
        cuda_wpt.wpt_synthesis_tiled_torch(y_in, fb.rec_lo, fb.rec_hi, c, p9, fb.recon_gain,
                                           inter, grid)


#: (bank, h, c): rows that K8 and K9 take several to an item
MULTI = [("Daubechies 4", 16, 4), ("Haar", 8, 3), ("Discrete Meyer", 16, 3),
         ("Symlet 8", 64, 5), ("Daubechies 4", 512, 6), ("Haar orthogonal", 1024, 6)]


@pytest.mark.parametrize("layout", ["subband", "interleaved"])
@pytest.mark.parametrize("bank,h,c", MULTI, ids=lambda v: str(v))
def test_k8_k9_multi_row_items(bank, h, c, layout):
    """Items of several whole rows of a batch of 3: 2 rows an item (an item
    of 2 and a short one of 1), 4 (one short item) and the default tile's
    4096 // h, each taken by 1 block, by 2 and by one block an item; against
    JAX's fused forward and inverse."""
    fb = jt.get_filter(bank)
    m = len(fb.dec_lo)
    inter = layout == "interleaved"
    want_y, want_x = _jax_fused(bank, h, c, 3)
    x = _input((3, h))
    if inter:
        want_y = _to_interleaved(want_y, c)
    xt = torch.tensor(x)
    y_in = torch.tensor(_to_interleaved(x, c) if inter else x)
    for tile in (2 * h, 4 * h, None):
        p8, p9 = cuda_wpt.wpt_plan(h, c, m, False, tile), cuda_wpt.wpt_plan(h, c, m, True, tile)
        assert p8.rows == p9.rows == p8.tile // h
        assert cuda_wpt.wpt_items(3, h, p8) == -(-3 // p8.rows)
        for grid in (1, 2, None):
            got_y = cuda_wpt.wpt_analysis_tiled_torch(xt, fb.dec_lo, fb.dec_hi, c, p8, 1.0, inter,
                                                      grid)
            got_x = cuda_wpt.wpt_synthesis_tiled_torch(y_in, fb.rec_lo, fb.rec_hi, c, p9,
                                                       fb.recon_gain, inter, grid)
            assert _err(got_y, want_y) <= TOL, (tile, grid)
            assert _err(got_x, want_x) <= TOL, (tile, grid)


def test_k9_cones_wrap_and_cover():
    """A cone that reaches left of 0 starts there (read mod the packet); a
    cone that would cover its packet is the whole packet; every item's
    cones have the first item's counts (the block's buffers)."""
    cones = cuda_wpt.k9_cones(1024, 6, 8, 512, 0)
    assert cones[1] == (-8, 264, False)
    assert cones[5] == (-8, 24, False) and cones[6] == (0, 16, True)  # 1024 >> 6 = 16
    for t0 in (0, 512):
        assert [c[1] for c in cuda_wpt.k9_cones(1024, 6, 8, 512, t0)] == [c[1] for c in cones]
    assert cuda_wpt.k9_cones(1024, 6, 8, 512, 512)[1] == (248, 264, False)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Off the CPU the wrapper launches or raises (no fallback): a tensor on
    another device than the card raises before any build."""
    fb = jt.get_filter("db4")
    x = torch.zeros(2, 64, dtype=torch.float32, device="meta")
    with pytest.raises(jt.JWaveFailure, match="CUDA"):
        cuda_wpt._k8(x, fb.dec_lo, fb.dec_hi, 3)
    with pytest.raises(jt.JWaveFailure, match="CUDA"):
        cuda_wpt._k9(x, fb.rec_lo, fb.rec_hi, 3)
