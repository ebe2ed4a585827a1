"""jwave_tpu_torch FWT against jwave_tpu: fwt/ifwt/fwt2d/ifwt2d and the
decompose/split helpers in float64 at 1e-12, and the plain versions of the
pyramid kernels K3/K4 against the Pallas kernels they replace."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import jwave_tpu as jw  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu.filters import get_filter  # noqa: E402
from jwave_tpu.ops.mxu_pyramid import _levels_done, fwt_forward_fused  # noqa: E402
from jwave_tpu.ops.pallas_pyramid import fwt1d_fused, fwt2d_fused  # noqa: E402
from jwave_tpu_torch.ops import cuda_pyramid  # noqa: E402

from torch_parity import assert_close  # noqa: E402

BANKS = ["Haar", "Daubechies 4", "Symlet 8", "Discrete Meyer", "Battle 23",
         "Haar orthogonal", "BiOrthogonal 3/5"]


@pytest.mark.parametrize("name", BANKS)
@pytest.mark.parametrize("level", [None, 1, 3])
def test_fwt_ifwt_match_jax(name, level, rng):
    x = rng.standard_normal((3, 64))
    got = jt.fwt(torch.tensor(x), name, level)
    want = jw.fwt(x, name, level)
    assert_close(got, want, 1e-12, "fwt")
    assert_close(jt.ifwt(got, name, level), jw.ifwt(want, name, level), 1e-12, "ifwt")


@pytest.mark.parametrize("n,level", [(64, 2), (64, 3), (64, 6), (32, 2)])
def test_battle23_partial_levels(n, level, rng):
    """Battle 23 (transform wavelength 8) stops early; the inverse must undo
    exactly the levels the forward did."""
    x = rng.standard_normal((2, n))
    got = jt.fwt(torch.tensor(x), "Battle 23", level)
    assert_close(got, jw.fwt(x, "Battle 23", level), 1e-12, "fwt")
    assert_close(jt.ifwt(got, "Battle 23", level),
                 jw.ifwt(np.asarray(got), "Battle 23", level), 1e-12, "ifwt")


def test_levels_done_matches():
    for n in (1, 2, 8, 64, 1024):
        for tw in (2, 8):
            for level in (0, 1, 3, 20):
                assert cuda_pyramid.levels_done(n, tw, level) == _levels_done(n, tw, level)


def test_decompose_recompose_split_merge(rng):
    x = rng.standard_normal((2, 64))
    got = jt.fwt_decompose(torch.tensor(x), "db4")
    want = jw.fwt_decompose(x, "db4")
    assert_close(got, want, 1e-12, "decompose")
    for level in (None, 2):
        assert_close(jt.fwt_recompose(got, "db4", level), jw.fwt_recompose(want, "db4", level),
                     1e-12, "recompose")
    y = jt.fwt(torch.tensor(x), "db4", 3)
    parts = jt.fwt_split(y, 3)
    want_parts = jw.fwt_split(jnp.asarray(np.asarray(y)), 3)
    assert list(parts) == list(want_parts)
    for k in parts:
        assert_close(parts[k], want_parts[k], 0, k)
    assert_close(jt.fwt_merge(parts), y, 0, "merge")
    assert jt.fwt_max_level(64) == jw.fwt_max_level(64)


@pytest.mark.parametrize("shape,lr,lc", [((16, 32), None, None), ((32, 64), 2, 3),
                                         ((16, 16), 0, 4)])
@pytest.mark.parametrize("name", ["Haar", "db4"])
def test_fwt2d_ifwt2d_match_jax(shape, lr, lc, name, rng):
    x = rng.standard_normal(shape)
    got = jt.fwt2d(torch.tensor(x), name, lr, lc)
    want = jw.fwt2d(x, name, lr, lc)
    assert_close(got, want, 1e-12, "fwt2d")
    assert_close(jt.ifwt2d(got, name, lr, lc), jw.ifwt2d(want, name, lr, lc), 1e-12, "ifwt2d")


def test_fwt2d_batched_and_errors(rng):
    x = rng.standard_normal((2, 16, 32))
    assert_close(jt.fwt2d(torch.tensor(x), "db4", 2, 2), jw.fwt2d(x, "db4", 2, 2), 1e-12, "3D")
    for bad in ((24, 32), (32, 24)):
        with pytest.raises(jt.JWaveFailure):
            jt.fwt2d(torch.zeros(bad), "db4")
    with pytest.raises(jt.JWaveFailure):
        jt.fwt2d(torch.zeros((16, 16)), "db4", 5, 1)
    with pytest.raises(jt.JWaveFailure):
        jt.fwt(torch.zeros(24), "db4")
    with pytest.raises(jt.JWaveFailure):
        jt.ifwt(torch.zeros(16), "db4", 5)


def test_fwt_f32_on_cpu_matches_jax(rng):
    x = rng.standard_normal((4, 512)).astype(np.float32)
    got = jt.fwt(torch.tensor(x), "sym8")
    assert got.dtype == torch.float32
    assert_close(got, jw.fwt(x.astype(np.float64), "sym8"), 1e-5, "f32")


# --------------------------------------------------------------------------
# plain versions of K3/K4 against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------

def test_plain_k3_matches_fwt1d_fused(rng):
    """(16, 4096) db4 L6 f32: both accumulate in f32 in another order, so the
    bound is 2e-6 of the largest reference value, as for the Pallas tests."""
    fb = get_filter("db4")
    x = rng.standard_normal((16, 4096)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fwt1d_fused(jnp.asarray(x), "db4", 6))
    got = cuda_pyramid.pyramid_rows_torch(torch.tensor(x), fb.dec_lo, fb.dec_hi, 6)
    assert float(np.max(np.abs(got.numpy() - want))) < 2e-6 * float(np.max(np.abs(want)))


def test_plain_k4_two_passes_match_fwt2d_fused(rng):
    """(512, 1024) db4 L3: two plain transposed passes = the fused 2D kernel."""
    fb = get_filter("db4")
    x = rng.standard_normal((512, 1024)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fwt2d_fused(jnp.asarray(x), "db4", 3, 3))
    y = cuda_pyramid.pyramid_rows_transposed_torch(torch.tensor(x), fb.dec_lo, fb.dec_hi, 3)
    assert tuple(y.shape) == (1024, 512)
    got = cuda_pyramid.pyramid_rows_transposed_torch(y, fb.dec_lo, fb.dec_hi, 3)
    assert float(np.max(np.abs(got.numpy() - want))) < 2e-6 * float(np.max(np.abs(want)))


@pytest.mark.parametrize("name,n,level", [("Haar", 64, 6), ("Discrete Meyer", 32, 5),
                                          ("Battle 23", 64, 6), ("Symlet 8", 128, 4)])
def test_plain_pyramid_matches_jax_f64(name, n, level, rng):
    fb = get_filter(name)
    x = rng.standard_normal((3, n))
    done = cuda_pyramid.levels_done(n, fb.transform_wavelength, level)
    got = cuda_pyramid.pyramid_rows_torch(torch.tensor(x), fb.dec_lo, fb.dec_hi, done)
    assert_close(got, fwt_forward_fused(jnp.asarray(x), fb, level), 1e-12, "K3 plain")
    assert_close(cuda_pyramid.pyramid_rows_transposed_torch(torch.tensor(x), fb.dec_lo,
                                                            fb.dec_hi, done),
                 np.asarray(jw.fwt(x, name, level)).T, 1e-12, "K4 plain")
