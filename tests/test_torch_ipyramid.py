"""K7, the inverse FWT pyramid of jwave_tpu_torch (``ops/cuda_pyramid.py``
``ipyramid_rows``), on the CPU.

The wrapper on a CPU tensor runs K7's plain version; K7's partition of the
work into items (tiles with their dependency cones, or several whole rows)
taken by persistent blocks runs in plain torch
(``ipyramid_rows_tiled_torch``). Both are held in float64 against the JAX
package's ``ifwt`` and its fused inverse pyramid
(``jwave_tpu.ops.mxu_pyramid.fwt_inverse_fused``, the function K7 replaces,
with JAX's butterfly dial forced on), and the gradients through K3 and K7
against ``jax.vjp`` of ``fwt`` and ``ifwt``. Tolerance 1e-10 of max|ref|:
the fused form folds the coarse levels into one dense matrix and so sums in
another order. The card's tests of the kernel itself are in
tests/test_torch_kernels.py (marked ``cuda``).
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
from jwave_tpu.ops.mxu_pyramid import fwt_inverse_fused  # noqa: E402

import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch.ops import cuda_pyramid  # noqa: E402

TOL = 1e-10

#: (bank, N, level): levels 0, 1, partial and max; N from 1 to 4096;
#: Battle 23 (transform wavelength 8) stops before its level
CASES = [
    ("Daubechies 4", 1, 0), ("Haar", 2, 1), ("Daubechies 4", 4, 2),
    ("Haar orthogonal", 8, 3), ("Daubechies 4", 64, 0), ("Daubechies 4", 64, 1),
    ("Daubechies 4", 64, 6), ("Symlet 8", 256, 3), ("Symlet 8", 256, 8),
    ("Battle 23", 256, 8), ("Battle 23", 64, 2), ("Haar orthogonal", 4096, 12),
    ("Daubechies 4", 4096, 5), ("Discrete Meyer", 512, 9),
]


@pytest.fixture
def force_mxu():
    jw_config.set_mxu_butterfly("on")
    yield
    jw_config.set_mxu_butterfly("auto")


def _levels(bank, n, level):
    return cuda_pyramid.levels_done(n, jt.get_filter(bank).transform_wavelength, level)


def _input(n, seed=0):
    return np.random.default_rng([seed, n]).standard_normal((3, n))


@functools.lru_cache(maxsize=None)
def _jax_ifwt(bank, n, level):
    """``jw.ifwt`` and ``fwt_inverse_fused`` of ``_input(n)``, once a case
    (JAX compiles each shape)."""
    y = jnp.asarray(_input(n))
    want = np.asarray(jax.jit(lambda v: jw.ifwt(v, bank, level))(y))
    fused = (np.asarray(jax.jit(lambda v: fwt_inverse_fused(v, jw.get_filter(bank), level))(y))
             if n >= 4 else want)
    return want, fused


def _err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / max(float(np.abs(want).max()), 1e-300)


@pytest.mark.parametrize("bank,n,level", CASES, ids=lambda v: str(v))
def test_k7_plain_and_tiled_match_jax_ifwt(bank, n, level, force_mxu):
    """The wrapper on a CPU tensor (the plain version) and K7's partition at
    its own plan (several whole rows an item up to rows of the tile), at a
    quarter-row tile and at tiles of 2 samples (every cone wraps; 1/64 of
    the row above 64 samples), against ``jw.ifwt`` and
    ``fwt_inverse_fused``."""
    fb = jt.get_filter(bank)
    y = _input(n)
    done = _levels(bank, n, level)
    want, fused = _jax_ifwt(bank, n, level)
    args = (fb.rec_lo, fb.rec_hi, fb.recon_gain, done)
    yt = torch.tensor(y)
    got = [cuda_pyramid.ipyramid_rows(yt, *args)]
    for tile in {cuda_pyramid.K7_TILE, max(2, n // 4), 2 if n <= 64 else n // 64}:
        if n >= 2:
            plan = cuda_pyramid.k7_plan(n, done, len(fb.rec_lo), tile)
            got.append(cuda_pyramid.ipyramid_rows_tiled_torch(yt, *args, plan))
    for g in got:
        assert g.dtype == torch.float64 and tuple(g.shape) == y.shape
        assert _err(g.numpy(), want) <= TOL
        assert _err(g.numpy(), fused) <= TOL


@pytest.mark.parametrize("bank,n,level", [("Daubechies 4", 64, 6), ("Battle 23", 64, 4),
                                          ("Haar orthogonal", 32, 5)])
def test_ifwt_on_the_cpu_matches_jax(bank, n, level):
    """``jt.ifwt`` on a CPU tensor (the butterfly route) agrees with K7's plain
    version and with JAX: the two routes of one function."""
    fb = jt.get_filter(bank)
    y = _input(n, 1)
    got = jt.ifwt(torch.tensor(y), bank, level)
    want = np.asarray(jax.jit(lambda v: jw.ifwt(v, bank, level))(jnp.asarray(y)))
    assert _err(got.numpy(), want) <= TOL
    k7 = cuda_pyramid.ipyramid_rows(torch.tensor(y), fb.rec_lo, fb.rec_hi, fb.recon_gain,
                                    _levels(bank, n, level))
    assert _err(k7.numpy(), want) <= TOL


@pytest.mark.parametrize("bank,n,level", [("Daubechies 4", 64, 6), ("Battle 23", 64, 4),
                                          ("Haar orthogonal", 32, 5), ("Symlet 8", 128, 7)])
def test_gradients_match_jax_vjp(bank, n, level):
    """torch.autograd.grad through K3 (``pyramid_rows``, backward K7) and K7
    (``ipyramid_rows``, backward K3) on CPU tensors against ``jax.vjp`` of
    ``fwt`` and ``ifwt`` with the same cotangent."""
    fb = jt.get_filter(bank)
    done = _levels(bank, n, level)
    x, w = _input(n, 2), _input(n, 3)
    for entry, port in ((jw.fwt, lambda a: cuda_pyramid.pyramid_rows(
                            a, fb.dec_lo, fb.dec_hi, done)),
                        (jw.ifwt, lambda a: cuda_pyramid.ipyramid_rows(
                            a, fb.rec_lo, fb.rec_hi, fb.recon_gain, done))):
        want = jax.jit(lambda v, ct: jax.vjp(lambda u: entry(u, bank, level), v)[1](ct)[0])(
            jnp.asarray(x), jnp.asarray(w))
        xt = torch.tensor(x, requires_grad=True)
        (got,) = torch.autograd.grad((port(xt) * torch.tensor(w)).sum(), xt)
        assert _err(got.numpy(), want) <= TOL


@pytest.mark.parametrize("bank", ["Daubechies 4", "Haar orthogonal", "Battle 23"])
def test_k3_k7_gradcheck_and_adjoint(bank, rng):
    """gradcheck of K7's Function and of K3's with a gain, and <K7 y, x> =
    <y, K3 x> with K7's filters and gain: each is the other's backward."""
    fb = jt.get_filter(bank)
    done = _levels(bank, 16, 3)
    args = (fb.rec_lo, fb.rec_hi, fb.recon_gain, done)
    y = torch.tensor(rng.standard_normal((2, 16)), requires_grad=True)
    assert torch.autograd.gradcheck(lambda v: cuda_pyramid.ipyramid_rows(v, *args), (y,))
    assert torch.autograd.gradcheck(
        lambda v: cuda_pyramid.pyramid_rows(v, fb.rec_lo, fb.rec_hi, done, fb.recon_gain), (y,))
    x = torch.tensor(rng.standard_normal((2, 16)))
    lhs = float((cuda_pyramid.ipyramid_rows(y.detach(), *args) * x).sum())
    rhs = float((y.detach() * cuda_pyramid.pyramid_rows(x, fb.rec_lo, fb.rec_hi, done,
                                                        fb.recon_gain)).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


@pytest.mark.parametrize("n,levels,m,plan", [
    # tile 4096: B_2 = (2048 + 4 + 10) & ~7 = 2056, then 1040, 528, 272, 144, 80, 48 and
    # A_8's 32. A stage set: stages B + 4: 2060 + 1044 + 532 + 276 + 148 + 84 + 52 + 36 =
    # 4232 and A_8's 36: 4268 floats. Head 388 (taps 128, four mbarriers 8, stage offsets
    # 36, two sets' cone tables 216); two sets; the even levels' buffer B_2 = 2056, the odd
    # levels' B_3 = 1040: 388 + 2 * 4268 + 2056 + 1040 = 12020 floats
    (65536, 8, 8, (4096, 1, (2056, 1040, 528, 272, 144, 80, 48, 32), 17072, 48080)),
    # 62 taps: each cone half the finer one and 31 + 10 more, to a multiple of 8; a set
    # 4632 + 92 = 4724 floats: 388 + 2 * 4724 + 2088 + 1080 = 13004 floats
    (65536, 8, 62, (4096, 1, (2088, 1080, 576, 328, 200, 136, 104, 88), 18896, 52016)),
    # rows of 4, at most the tile: 1024 whole rows an item, every cone its whole head;
    # one stage of round4(4096) + 4 = 4100 floats a set; level 2's buffer 4096 / 2:
    # 388 + 2 * 4100 + 2048 = 10636 floats
    (4, 2, 8, (4096, 1024, (2, 1), 16400, 42544)),
    # rows of 256 (ifwt3d's): 16 an item; the even buffer 2048, the odd 1024
    (256, 8, 8, (4096, 16, (128, 64, 32, 16, 8, 4, 2, 1), 16400, 46640)),
    # rows of 8192, two tiles: the cones are whole heads from level 9 on (16, 8, .. 1);
    # a set of 4288 + A_13's 8 floats: 388 + 2 * 4296 + 2056 + 1040 = 12076 floats
    (8192, 13, 8, (4096, 1, (2056, 1040, 528, 272, 144, 80, 48, 32, 16, 8, 4, 2, 1), 17184,
                   48304)),
    # one level: tiles of 2048; B_2 = (1024 + 4 + 10) & ~7 = 1032; a set of D_1's and A_1's
    # stages, 1036 each: 388 + 2 * 2072 = 4532 floats (no level writes a buffer)
    (65536, 1, 8, (2048, 1, (1032,), 8288, 18128)),
])
def test_k7_plan(n, levels, m, plan):
    """``csrc/pyramid.cu`` k7_layout's arithmetic, worked out by hand: tile,
    rows an item, the cone bounds, a stage set's and a block's shared bytes;
    two sets, 64 compute threads and one producer warp."""
    got = cuda_pyramid.k7_plan(n, levels, m)
    assert got[:5] == plan
    assert got[5:] == (2, 96)


def test_k7_plan_fits_every_row_length_and_filter():
    """Every row length up to 2^30 and filter length fits a block's shared
    memory at the default tile, with room for three blocks an SM; the cones
    stay within their bounds and end on multiples of 8; and the work items
    of the rows of any length are tiles or groups of whole rows."""
    for lg in range(1, 31):
        n = 1 << lg
        for m in (2, 8, 16, 24, 62, 64):
            plan = cuda_pyramid.k7_plan(n, lg, m)
            assert plan.smem_bytes <= cuda_pyramid.SMEM_LIMIT
            assert 3 * (plan.smem_bytes + 1024) <= 228 * 1024
            assert all(b <= n >> l for l, b in enumerate(plan.cone, 1))
            rows = 3 * plan.rows + 1  # a short last item
            assert cuda_pyramid.k7_items(rows, n, plan) == (
                4 if n <= plan.tile else rows * (n // plan.tile))
    for n, m, tile in ((64, 8, 16), (1 << 20, 62, 8192), (256, 24, 2)):
        plan = cuda_pyramid.k7_plan(n, n.bit_length() - 1, m, tile)
        for t0 in range(0, n, tile):
            cones = cuda_pyramid.k7_cones(n, n.bit_length() - 1, m, tile, t0)
            assert all(c <= b for (_, c, _), b in zip(cones[1:], plan.cone))
            assert all(st % 8 == 0 and c % 8 == 0 for st, c, w in cones[1:] if not w)


#: cases of CASES whose rows K7 takes several to an item, N = 1, 2 and 4 among them
MULTI = [("Daubechies 4", 1, 0), ("Haar", 2, 1), ("Daubechies 4", 4, 2),
         ("Haar orthogonal", 8, 3), ("Daubechies 4", 64, 6), ("Symlet 8", 256, 8),
         ("Battle 23", 256, 8)]


@pytest.mark.parametrize("bank,n,level", MULTI, ids=lambda v: str(v))
def test_k7_multi_row_items(bank, n, level, force_mxu):
    """Items of several whole rows: 2 rows an item (the 3 rows make an item
    of 2 and a short one of 1), 4 (one short item) and the default tile's
    4096 / n, each taken by 1 block, by 2 and by one block an item; against
    ``jw.ifwt`` and ``fwt_inverse_fused``."""
    fb = jt.get_filter(bank)
    y = torch.tensor(_input(n))
    done = _levels(bank, n, level)
    want, fused = _jax_ifwt(bank, n, level)
    args = (fb.rec_lo, fb.rec_hi, fb.recon_gain, done)
    for tile in (2 * n, 4 * n, cuda_pyramid.K7_TILE):
        plan = cuda_pyramid.k7_plan(n, done, len(fb.rec_lo), tile)
        assert plan.rows == tile // n
        assert cuda_pyramid.k7_items(3, n, plan) == -(-3 // plan.rows)
        for grid in (1, 2, None):
            got = cuda_pyramid.ipyramid_rows_tiled_torch(y, *args, plan, grid)
            assert _err(got.numpy(), want) <= TOL
            assert _err(got.numpy(), fused) <= TOL


@pytest.mark.parametrize("bank,n,level,tile,grid", [
    ("Daubechies 4", 4096, 5, 256, 5),   # 48 items over 5 blocks: 10 or 9 each
    ("Daubechies 4", 4096, 5, 1024, 7),  # 12 items over 7 blocks: 2 or 1 each
    ("Discrete Meyer", 512, 9, 64, 3),   # 62 taps: cones that cover their heads
])
def test_k7_persistent_order(bank, n, level, tile, grid, force_mxu, monkeypatch):
    """More items than blocks, each block taking items b, b + grid, ...;
    an item count that leaves some blocks one item more than others. A
    partition that misses an item raises."""
    fb = jt.get_filter(bank)
    y = torch.tensor(_input(n))
    done = _levels(bank, n, level)
    want, fused = _jax_ifwt(bank, n, level)
    args = (fb.rec_lo, fb.rec_hi, fb.recon_gain, done)
    plan = cuda_pyramid.k7_plan(n, done, len(fb.rec_lo), tile)
    assert cuda_pyramid.k7_items(3, n, plan) == 3 * n // tile > grid
    got = cuda_pyramid.ipyramid_rows_tiled_torch(y, *args, plan, grid)
    assert _err(got.numpy(), want) <= TOL
    assert _err(got.numpy(), fused) <= TOL
    monkeypatch.setattr(cuda_pyramid, "k7_items", lambda rows, n_, p: 3 * n // tile - 1)
    with pytest.raises(IndexError, match="once"):
        cuda_pyramid.ipyramid_rows_tiled_torch(y, *args, plan, grid)


def test_k7_wrapper_refuses_what_the_kernel_does_not_take():
    """Off the CPU the wrapper launches or raises, before any launch: a
    tensor on another device, float64 or a non-contiguous one on the card
    would raise here with no card too (the device check comes first)."""
    fb = jt.get_filter("db4")
    y = torch.zeros(2, 64, device="meta")
    with pytest.raises(jt.JWaveFailure, match="CUDA"):
        cuda_pyramid.ipyramid_rows(y, fb.rec_lo, fb.rec_hi, 1.0, 3)
    jt.ops.reset_launch_counts()
    x = torch.zeros(2, 64, dtype=torch.float32)
    assert torch.equal(cuda_pyramid.ipyramid_rows(x, fb.rec_lo, fb.rec_hi, 1.0, 3), x)
    assert jt.ops.launch_counts()["K7"] == 0
