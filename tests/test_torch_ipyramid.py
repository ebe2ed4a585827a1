"""K7, the inverse FWT pyramid of jwave_tpu_torch (``ops/cuda_pyramid.py``
``ipyramid_rows``), on the CPU.

The wrapper on a CPU tensor runs K7's plain version; K7's partition of the
work into tiles and dependency cones runs in plain torch
(``ipyramid_rows_tiled_torch``). Both are held in float64 against the JAX
package's ``ifwt`` and its fused inverse pyramid
(``jwave_tpu.ops.mxu_pyramid.fwt_inverse_fused``, the function K7 replaces,
with JAX's butterfly dial forced on), and the gradients through K3 and K7
against ``jax.vjp`` of ``fwt`` and ``ifwt``. Tolerance 1e-10 of max|ref|:
the fused form folds the coarse levels into one dense matrix and so sums in
another order. The card's tests of the kernel itself are in
tests/test_torch_kernels.py (marked ``cuda``).
"""
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


def _err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / max(float(np.abs(want).max()), 1e-300)


@pytest.mark.parametrize("bank,n,level", CASES, ids=lambda v: str(v))
def test_k7_plain_and_tiled_match_jax_ifwt(bank, n, level, force_mxu):
    """The wrapper on a CPU tensor (the plain version) and K7's partition at
    its own plan, at a quarter-row tile and at tiles of 2 samples (every
    cone wraps; 1/64 of the row above 64 samples), against ``jw.ifwt`` and
    ``fwt_inverse_fused``."""
    fb = jt.get_filter(bank)
    y = _input(n)
    done = _levels(bank, n, level)
    want = np.asarray(jax.jit(lambda v: jw.ifwt(v, bank, level))(jnp.asarray(y)))
    fused = (np.asarray(jax.jit(lambda v: fwt_inverse_fused(v, jw.get_filter(bank), level))(
        jnp.asarray(y))) if n >= 4 else want)
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


@pytest.mark.parametrize("n,levels,m,cone,smem", [
    # tile 8192: B_2 = (4096 + 4 + 5) & ~3 = 4104, then 2060, 1036, 524, 268, 140, 76 and
    # A_8's 44. Floats: head 336 (taps 128, mbarriers 64, cone tables 144); stages B + 4:
    # 4108 + 2064 + 1040 + 528 + 272 + 144 + 80 + 48 = 8284, A_8's 48; the even levels'
    # buffer B_2 = 4104, the odd levels' B_3 = 2060: 336 + 8284 + 48 + 4104 + 2060 = 14832
    (65536, 8, 8, (4104, 2060, 1036, 524, 268, 140, 76, 44), 59328),
    # 62 taps: each cone half the finer one and 31 + 5 more, to a multiple of 4
    (65536, 8, 62, (4132, 2100, 1084, 576, 324, 196, 132, 100), 61392),
    # a row of 4, one tile: every cone its whole head (2, then 1), staged as the row,
    # round4(4) + 4 = 8 floats; level 2's buffer round4(2) = 4: 336 + 8 + 4 = 348 floats
    (4, 2, 8, (2, 1), 1392),
    # a row of 8192, one tile: the row's stage 8196, level 2's buffer 4096 (B_2), level 3's
    # 2048 (B_3): 336 + 8196 + 4096 + 2048 = 14676 floats
    (8192, 13, 8, (4096, 2048, 1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1), 58704),
])
def test_k7_plan(n, levels, m, cone, smem):
    """``csrc/pyramid.cu`` k7_floats' arithmetic, worked out by hand."""
    plan = cuda_pyramid.k7_plan(n, levels, m)
    assert plan == (min(n, cuda_pyramid.K7_TILE), cone, smem)


def test_k7_plan_fits_every_row_length_and_filter():
    """Every row length up to 2^30 and filter length fits a block's shared
    memory at the default tile, with room for three blocks an SM where a
    row holds a whole tile; and the cones stay within their bounds."""
    for lg in range(1, 31):
        n = 1 << lg
        for m in (2, 8, 16, 24, 62, 64):
            plan = cuda_pyramid.k7_plan(n, lg, m)
            assert plan.smem_bytes <= cuda_pyramid.SMEM_LIMIT
            assert 3 * (plan.smem_bytes + 1024) <= 228 * 1024
            assert all(b <= n >> l for l, b in enumerate(plan.cone, 1))
    for n, m, tile in ((64, 8, 16), (1 << 20, 62, 8192), (256, 24, 2)):
        plan = cuda_pyramid.k7_plan(n, n.bit_length() - 1, m, tile)
        for t0 in range(0, n, tile):
            cones = cuda_pyramid.k7_cones(n, n.bit_length() - 1, m, tile, t0)
            assert all(c <= b for (_, c, _), b in zip(cones[1:], plan.cone))


def test_k7_wrapper_refuses_what_the_kernel_does_not_take():
    """Off the CPU the wrapper launches or raises, before any launch: a
    tensor on another device, float64 or a non-contiguous one on the card
    would raise here with no card too (the device check comes first)."""
    fb = jt.get_filter("db4")
    y = torch.zeros(2, 64, device="meta")
    with pytest.raises(jt.JWaveFailure, match="CUDA"):
        cuda_pyramid.ipyramid_rows(y, fb.rec_lo, fb.rec_hi, 1.0, 3)
    cuda_pyramid.reset_launch_counts()
    x = torch.zeros(2, 64, dtype=torch.float32)
    assert torch.equal(cuda_pyramid.ipyramid_rows(x, fb.rec_lo, fb.rec_hi, 1.0, 3), x)
    assert cuda_pyramid.launch_counts["ipyramid_rows"] == 0
