"""jwave_tpu_torch's dual-tree complex wavelet transform and its denoiser
against jwave_tpu, on the same seeded float64 input: dtcwt/idtcwt in 1D
and 2D, results carried across from JAX by ``from_numpy``, denoise_dtcwt,
the q-shift filters, the errors and half precision. Bounds (of max|ref|,
absolute below 1): 1e-10 (the same butterflies summed in another order);
bf16 1e-2 (each stored value rounds to 2^-9)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import jwave_tpu as jw  # noqa: E402
from jwave_tpu.filters import qshift as jq  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch.filters import qshift as tq  # noqa: E402

from torch_parity import assert_close  # noqa: E402


def _hold_result(got, want, what):
    assert got.level1_wavelet == want.level1_wavelet and got.levels == want.levels
    for j, (g, w) in enumerate(zip(got.highpasses, want.highpasses)):
        assert g.dtype == (torch.complex128 if w.dtype == jnp.complex128 else torch.complex64)
        assert_close(g, w, 1e-10, f"{what} highpass {j + 1}")
    assert_close(got.lowpasses, want.lowpasses, 1e-10, f"{what} lowpasses")


def test_qshift_filters_match_jax():
    np.testing.assert_array_equal(tq.QSHIFT_14, jq.QSHIFT_14)
    for (a, b), (c, d) in zip(tq.qshift_filters(), jq.qshift_filters()):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


@pytest.mark.parametrize("levels", [1, 3, 6])
@pytest.mark.parametrize("wavelet", ["sym4", "db4", "Haar"])
def test_dtcwt_matches_jax(wavelet, levels, rng):
    x = rng.standard_normal((2, 128))
    res = jt.dtcwt(torch.tensor(x), levels, wavelet)
    want = jax.jit(lambda a: jw.dtcwt(a, levels, wavelet))(x)
    _hold_result(res, want, "dtcwt")
    assert_close(jt.idtcwt(res), x, 1e-10, "round trip")
    mags = res.magnitudes()
    assert_close(mags[0], jnp.abs(want.highpasses[0]), 1e-10, "magnitudes")


@pytest.mark.parametrize("levels", [1, 2, 4])
def test_dtcwt2d_matches_jax(levels, rng):
    img = rng.standard_normal((2, 32, 48))
    res = jt.dtcwt2d(torch.tensor(img), levels)
    want = jax.jit(lambda a: jw.dtcwt2d(a, levels))(img)
    _hold_result(res, want, "dtcwt2d")
    assert tuple(res.highpasses[0].shape) == (2, 6, 16, 24)
    assert_close(jt.idtcwt2d(res), img, 1e-10, "round trip")


def test_carried_results_invert_like_jax(rng):
    """JAX's coefficients, carried across by from_numpy, invert as JAX's do."""
    x = rng.standard_normal((2, 128))
    rj = jax.jit(lambda a: jw.dtcwt(a, 3))(x)
    res = jt.DTCWTResult.from_numpy([np.asarray(h) for h in rj.highpasses],
                                    np.asarray(rj.lowpasses), rj.level1_wavelet, device="cpu")
    assert res.lowpasses.device.type == "cpu" and res.highpasses[0].dtype == torch.complex128
    assert_close(jt.idtcwt(res), jax.jit(jw.idtcwt)(rj), 1e-10, "idtcwt")
    img = rng.standard_normal((2, 32, 48))
    rj2 = jax.jit(lambda a: jw.dtcwt2d(a, 2))(img)
    res2 = jt.DTCWT2DResult.from_numpy([np.asarray(h) for h in rj2.highpasses],
                                       np.asarray(rj2.lowpasses), rj2.level1_wavelet,
                                       device="cpu")
    assert_close(jt.idtcwt2d(res2), jax.jit(jw.idtcwt2d)(rj2), 1e-10, "idtcwt2d")


@pytest.mark.parametrize("sigma, window", [(None, 7), (0.3, 3), (None, 1)])
def test_denoise_dtcwt_matches_jax(sigma, window, rng):
    yy, xx = np.mgrid[0:64, 0:64]
    clean = np.sin(2 * np.pi * xx / 16.0) * np.cos(2 * np.pi * yy / 32.0)
    noisy = clean + 0.3 * rng.standard_normal((2, 64, 64))
    got = jt.denoise_dtcwt(torch.tensor(noisy), 3, sigma, window)
    want = jax.jit(lambda a: jw.denoise_dtcwt(a, 3, sigma, window))(noisy)
    assert got.dtype == torch.float64
    assert_close(got, want, 1e-10, "denoised")
    assert np.mean((got.numpy() - clean) ** 2) < np.mean((noisy - clean) ** 2)


@pytest.mark.parametrize("case", ["levels 0", "indivisible", "complex", "1 axis", "window"])
def test_errors_match_jax(case):
    calls = {
        "levels 0": lambda m, a: m.dtcwt(a(np.ones(16)), 0),
        "indivisible": lambda m, a: m.dtcwt2d(a(np.ones((12, 16))), 3),
        "complex": lambda m, a: m.dtcwt(a(np.ones(16) + 1j), 2),
        "1 axis": lambda m, a: m.dtcwt2d(a(np.ones(16)), 2),
        "window": lambda m, a: m.denoise_dtcwt(a(np.ones((16, 16))), 2, None, 4),
    }
    msgs = []
    for m, a in ((jw, np.asarray), (jt, torch.tensor)):
        with pytest.raises(m.JWaveFailure) as e:
            calls[case](m, a)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_dtcwt_half_precision(rng):
    """bf16 in: complex64 highpasses, bf16 lowpasses, float32 inverse, as the
    JAX package gives in 2D. In 1D the JAX package raises for bf16
    (``lax.complex`` takes no bf16); the port gives complex64 there too,
    held against the float64 transform of the same bf16 values."""
    img = rng.standard_normal((2, 32, 48)).astype(np.float32)
    res = jt.dtcwt2d(torch.tensor(img).to(torch.bfloat16), 2)
    want = jax.jit(lambda a: jw.dtcwt2d(a, 2))(jnp.asarray(img, jnp.bfloat16))
    assert res.highpasses[0].dtype == torch.complex64 and want.highpasses[0].dtype == jnp.complex64
    assert res.lowpasses.dtype == torch.bfloat16 and want.lowpasses.dtype == jnp.bfloat16
    for g, w in zip(res.highpasses, want.highpasses):
        assert_close(g, np.asarray(w, np.complex128), 1e-2, "bf16 highpasses")
    assert_close(res.lowpasses.float(), np.asarray(want.lowpasses, np.float64), 1e-2, "bf16 low")
    back = jt.idtcwt2d(res)
    assert back.dtype == torch.float32 and jax.eval_shape(jw.idtcwt2d, want).dtype == jnp.float32
    assert_close(back, img, 1e-2, "bf16 2D round trip")

    x = torch.tensor(rng.standard_normal((2, 128)).astype(np.float32)).to(torch.bfloat16)
    with pytest.raises(TypeError):
        jax.eval_shape(lambda a: jw.dtcwt(a, 3), jax.ShapeDtypeStruct((2, 128), jnp.bfloat16))
    r1 = jt.dtcwt(x, 3)
    exact = jt.dtcwt(x.double(), 3)
    assert r1.highpasses[0].dtype == torch.complex64 and r1.lowpasses.dtype == torch.bfloat16
    for g, w in zip(r1.highpasses, exact.highpasses):
        assert_close(g, w, 1e-2, "bf16 1D highpasses")
    assert jt.idtcwt(r1).dtype == torch.float32
    assert_close(jt.idtcwt(r1), x.double(), 1e-2, "bf16 1D round trip")
