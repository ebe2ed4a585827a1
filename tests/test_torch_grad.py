"""Gradients through the kernel wrappers of jwave_tpu_torch (K1-K5).

Each wrapper runs through a ``torch.autograd.Function``; on the CPU the
Function runs the kernels' plain versions in both directions, so these
tests exercise the same Functions a CUDA tensor takes, with the kernels
swapped for their plain versions:

* ``torch.autograd.gradcheck`` of each Function in float64;
* the dot-product adjoint identities <K1 x, y> = <x, K2 y> and the pyramid
  pairs, to 1e-12 relative;
* gradients of the public functions and of the Functions against
  ``jax.grad`` of the JAX package on the CPU (its XLA forms), to 1e-12 of
  max|ref| in float64; and K3's backward against ``jax.grad`` of the fused
  Pallas pyramid in interpret mode at tests/test_pallas.py's 8 x 2048.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

jax = pytest.importorskip("jax")  # the card's machine has none: the file skips there
import jax.numpy as jnp  # noqa: E402

import jwave_tpu as jw  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch.ops import cuda_modwt, cuda_pyramid  # noqa: E402
from jwave_tpu_torch.transforms.modwt import _modwt_base_filters  # noqa: E402

from torch_parity import assert_close  # noqa: E402

WAVELETS = ["db4", "Haar orthogonal", "Battle 23"]


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


def _kernel_fn(which, wavelet, shape, levels):
    """The Function under test as a map of one float64 tensor."""
    fb = jt.get_filter(wavelet)
    g0, h0 = _modwt_base_filters(wavelet)
    if which == "K1":
        return lambda x: cuda_modwt.modwt_cascade(x, g0, h0, levels)
    if which == "K2":
        return lambda c: cuda_modwt.imodwt_cascade(c, g0, h0)
    done = cuda_pyramid.levels_done(shape[-1], fb.transform_wavelength, levels)
    if which == "K3":
        return lambda x: cuda_pyramid.pyramid_rows(x, fb.dec_lo, fb.dec_hi, done)
    if which == "K4":
        return lambda x: cuda_pyramid.pyramid_rows_transposed(x, fb.rec_lo, fb.rec_hi, done,
                                                              fb.recon_gain)
    return lambda y: cuda_pyramid.ipyramid_rows_transposed(y, fb.rec_lo, fb.rec_hi,
                                                           fb.recon_gain, done)


def _shape(which):
    return {"K1": (2, 48), "K2": (2, 4, 48), "K3": (3, 64), "K4": (3, 32), "K5": (3, 32)}[which]


@pytest.mark.parametrize("wavelet", WAVELETS)
@pytest.mark.parametrize("which", ["K1", "K2", "K3", "K4", "K5"])
def test_gradcheck(which, wavelet, rng):
    shape = _shape(which)
    fn = _kernel_fn(which, wavelet, shape, 3)
    x = _t(rng.standard_normal(shape), grad=True)
    assert torch.autograd.gradcheck(fn, (x,))


@pytest.mark.parametrize("wavelet", WAVELETS)
@pytest.mark.parametrize("shape,levels", [((16, 64), (2, 4)), ((32, 16), (3, 1))])
def test_gradcheck_two_passes_non_square(wavelet, shape, levels):
    """fwt2d's and ifwt2d's kernel routes: two transposing passes, the first
    along the last axis with ``level_cols``, on non-square inputs with
    unequal levels. ``fast_mode`` checks the Jacobian along random
    directions (the full Jacobian of 1024 inputs takes a minute for
    Battle 23's 24 taps; the single-pass checks above are full)."""
    fb = jt.get_filter(wavelet)
    lr, lc = levels
    d_rows = cuda_pyramid.levels_done(shape[0], fb.transform_wavelength, lr)
    d_cols = cuda_pyramid.levels_done(shape[1], fb.transform_wavelength, lc)
    rng = np.random.default_rng(0)

    def fwd(x):
        y = cuda_pyramid.pyramid_rows_transposed(x, fb.dec_lo, fb.dec_hi, d_cols)
        return cuda_pyramid.pyramid_rows_transposed(y, fb.dec_lo, fb.dec_hi, d_rows)

    def inv(y):
        args = (fb.rec_lo, fb.rec_hi, fb.recon_gain)
        return cuda_pyramid.ipyramid_rows_transposed(
            cuda_pyramid.ipyramid_rows_transposed(y, *args, d_cols), *args, d_rows)

    for fn in (fwd, inv):
        assert torch.autograd.gradcheck(fn, (_t(rng.standard_normal(shape), grad=True),),
                                        fast_mode=True)


def _dot(a, b):
    return float((a * b).sum())


@pytest.mark.parametrize("wavelet,n,level", [("db4", 300, 4), ("Haar", 64, 6),
                                             ("Discrete Meyer", 128, 3), ("sym8", 777, 5)])
def test_k1_k2_adjoint_identity(wavelet, n, level, rng):
    """<K1 x, y> = <x, K2 y>: K2 is K1's transpose term for term."""
    g0, h0 = _modwt_base_filters(wavelet)
    x = _t(rng.standard_normal((3, n)))
    y = _t(rng.standard_normal((3, level + 1, n)))
    lhs = _dot(cuda_modwt.modwt_cascade(x, g0, h0, level), y)
    rhs = _dot(x, cuda_modwt.imodwt_cascade(y, g0, h0))
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


@pytest.mark.parametrize("wavelet", WAVELETS + ["sym8"])
@pytest.mark.parametrize("which", ["K3", "K4", "K5"])
def test_pyramid_adjoint_identities(which, wavelet, rng):
    """<P x, y> = <x, P^T y> for each pyramid operator and the backward route
    its Function takes (K3: K7 with the analysis filters, gain 1; K4: K5; K5: K4)."""
    fb = jt.get_filter(wavelet)
    r, n = 5, 64
    done = cuda_pyramid.levels_done(n, fb.transform_wavelength, 4)
    x = _t(rng.standard_normal((r, n)))
    if which == "K3":
        y = _t(rng.standard_normal((r, n)))
        lhs = _dot(cuda_pyramid.pyramid_rows(x, fb.dec_lo, fb.dec_hi, done), y)
        rhs = _dot(x, cuda_pyramid.ipyramid_rows(y, fb.dec_lo, fb.dec_hi, 1.0, done))
    elif which == "K4":
        y = _t(rng.standard_normal((n, r)))
        lhs = _dot(cuda_pyramid.pyramid_rows_transposed(x, fb.dec_lo, fb.dec_hi, done), y)
        back = cuda_pyramid.ipyramid_rows_transposed(y.t().contiguous(), fb.dec_lo, fb.dec_hi,
                                                     1.0, done)
        rhs = _dot(x, back.t())
    else:
        y = _t(rng.standard_normal((n, r)))
        args = (fb.rec_lo, fb.rec_hi)
        lhs = _dot(cuda_pyramid.ipyramid_rows_transposed(x, *args, fb.recon_gain, done), y)
        back = cuda_pyramid.pyramid_rows_transposed(y.t().contiguous(), *args, done,
                                                    fb.recon_gain)
        rhs = _dot(x, back.t())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


@pytest.mark.parametrize("gain,levels", [(0.5, 1), (0.5, 3), (0.5, 5), (1.0, 3), (2.0, 2)])
def test_k4_gain_per_level(gain, levels, rng):
    """K4's gain scales each level's a and d as they are made: the level-l
    details carry gain^l, the final approximation gain^levels."""
    fb = jt.get_filter("Haar orthogonal")
    x = _t(rng.standard_normal((4, 64)))
    got = cuda_pyramid.pyramid_rows_transposed(x, fb.rec_lo, fb.rec_hi, levels, gain).t()
    plain = cuda_pyramid.pyramid_rows_torch(x, fb.rec_lo, fb.rec_hi, levels)
    want = plain.clone()
    n = 64
    for lvl in range(1, levels + 1):
        want[:, n >> lvl: n >> (lvl - 1)] *= gain ** lvl
    want[:, : n >> levels] *= gain ** levels
    assert_close(got, want, 1e-14, "K4 gain")


# --------------------------------------------------------------------------
# against jax.grad
# --------------------------------------------------------------------------

def _tgrad(fn, x, w):
    """d/dx sum(fn(x) * w) through torch autograd, float64."""
    xt = _t(x, grad=True)
    (fn(xt) * _t(w)).sum().backward()
    return xt.grad


def _grads(t_fn, j_fn, x, w):
    return _tgrad(t_fn, x, w), jax.grad(lambda a: jnp.sum(j_fn(a) * w))(jnp.asarray(x))


@pytest.mark.parametrize("wavelet,level", [("db4", 5), ("Haar orthogonal", 3), ("Battle 23", 4)])
def test_fwt_grad_matches_jax(wavelet, level, rng):
    x = rng.standard_normal((3, 256))
    w = rng.standard_normal((3, 256))
    got, want = _grads(lambda a: jt.fwt(a, wavelet, level), lambda a: jw.fwt(a, wavelet, level),
                       x, w)
    assert_close(got, want, 1e-12, "fwt grad")
    fb = jt.get_filter(wavelet)
    done = cuda_pyramid.levels_done(256, fb.transform_wavelength, level)
    k3 = _tgrad(lambda a: cuda_pyramid.pyramid_rows(a, fb.dec_lo, fb.dec_hi, done), x, w)
    assert_close(k3, want, 1e-12, "K3 Function grad")


@pytest.mark.parametrize("wavelet", ["db4", "Haar orthogonal"])
@pytest.mark.parametrize("shape,levels", [((16, 64), (2, 4)), ((64, 32), (4, 1))])
def test_fwt2d_ifwt2d_grads_match_jax(wavelet, shape, levels, rng):
    """The public 2D functions and the two-pass kernel routes (run plain),
    non-square with unequal levels."""
    lr, lc = levels
    fb = jt.get_filter(wavelet)
    d_rows = cuda_pyramid.levels_done(shape[0], fb.transform_wavelength, lr)
    d_cols = cuda_pyramid.levels_done(shape[1], fb.transform_wavelength, lc)
    x = rng.standard_normal(shape)
    w = rng.standard_normal(shape)
    got, want = _grads(lambda a: jt.fwt2d(a, wavelet, lr, lc),
                       lambda a: jw.fwt2d(a, wavelet, lr, lc), x, w)
    assert_close(got, want, 1e-12, "fwt2d grad")
    k4 = _tgrad(lambda a: cuda_pyramid.pyramid_rows_transposed(
        cuda_pyramid.pyramid_rows_transposed(a, fb.dec_lo, fb.dec_hi, d_cols),
        fb.dec_lo, fb.dec_hi, d_rows), x, w)
    assert_close(k4, want, 1e-12, "K4 x2 grad")
    got, want = _grads(lambda a: jt.ifwt2d(a, wavelet, lr, lc),
                       lambda a: jw.ifwt2d(a, wavelet, lr, lc), x, w)
    assert_close(got, want, 1e-12, "ifwt2d grad")
    args = (fb.rec_lo, fb.rec_hi, fb.recon_gain)
    k5 = _tgrad(lambda a: cuda_pyramid.ipyramid_rows_transposed(
        cuda_pyramid.ipyramid_rows_transposed(a, *args, d_cols), *args, d_rows), x, w)
    assert_close(k5, want, 1e-12, "K5 x2 grad")


@pytest.mark.parametrize("wavelet,n,level", [("db4", 300, 4), ("Haar", 128, 6), ("sym8", 777, 3),
                                             ("db4", 181, 5)])
def test_modwt_imodwt_grads_match_jax(wavelet, n, level, rng):
    g0, h0 = _modwt_base_filters(wavelet)
    x = rng.standard_normal((2, n))
    w = rng.standard_normal((2, level + 1, n))
    got, want = _grads(lambda a: jt.modwt(a, wavelet, level), lambda a: jw.modwt(a, wavelet, level),
                       x, w)
    assert_close(got, want, 1e-12, "modwt grad")
    k1 = _tgrad(lambda a: cuda_modwt.modwt_cascade(a, g0, h0, level), x, w)
    assert_close(k1, want, 1e-12, "K1 Function grad")
    c = rng.standard_normal((2, level + 1, n))
    w2 = rng.standard_normal((2, n))
    got, want = _grads(lambda a: jt.imodwt(a, wavelet), lambda a: jw.imodwt(a, wavelet), c, w2)
    assert_close(got, want, 1e-12, "imodwt grad")
    k2 = _tgrad(lambda a: cuda_modwt.imodwt_cascade(a, g0, h0), c, w2)
    assert_close(k2, want, 1e-12, "K2 Function grad")


def test_modwt_variance_and_hurst_grads_match_jax(rng):
    x = rng.standard_normal((2, 1024))
    w = rng.standard_normal((2, 5))
    got, want = _grads(lambda a: jt.modwt_variance(a, "db4", 5),
                       lambda a: jw.modwt_variance(a, "db4", 5), x, w)
    assert_close(got, want, 1e-12, "modwt_variance grad")
    xt = _t(x, grad=True)
    jt.hurst_exponent(xt).sum().backward()
    g_j = jax.grad(lambda a: jnp.sum(jw.hurst_exponent(a)))(jnp.asarray(x))
    assert_close(xt.grad, g_j, 1e-12, "hurst_exponent grad")


def test_hurst_grad_through_the_cascade_functions(rng):
    """float32 ``method=PALLAS`` on the CPU runs the K1 Function plain: its
    gradient (K2 plain) against the float64 direct route."""
    x = rng.standard_normal((2, 2048))
    xt = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    jt.hurst_exponent(xt, method=jt.ConvolutionMethod.PALLAS).sum().backward()
    x64 = _t(x, grad=True)
    jt.hurst_exponent(x64).sum().backward()
    assert_close(xt.grad, x64.grad, 1e-4, "f32 cascade against f64")


def test_k3_grad_matches_pallas_interpret(rng):
    """K3's backward against jax.grad through fwt1d_fused's custom VJP in
    interpret mode, tests/test_pallas.py's 8 x 2048 db4 L4, f32: bound 2e-6
    of max|ref|."""
    from jax.experimental.pallas import tpu as pltpu

    from jwave_tpu.ops.pallas_pyramid import fwt1d_fused

    x = rng.standard_normal((8, 2048)).astype(np.float32)
    w = rng.standard_normal((8, 2048)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        g_j = np.asarray(jax.grad(lambda m: jnp.sum(fwt1d_fused(m, "db4", 4) * w))(jnp.asarray(x)))
    fb = jt.get_filter("db4")
    xt = torch.tensor(x, requires_grad=True)
    (cuda_pyramid.pyramid_rows(xt, fb.dec_lo, fb.dec_hi, 4) * torch.tensor(w)).sum().backward()
    assert xt.grad.dtype == torch.float32
    assert float(np.max(np.abs(xt.grad.numpy() - g_j))) < 2e-6 * float(np.max(np.abs(g_j)))
