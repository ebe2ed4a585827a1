"""jwave_tpu_torch's MODWT analysis layer against jwave_tpu: the 2D MODWT,
the multiresolution analyses, the scale statistics, the logscale diagram
and the Hurst estimator, on the same seeded float64 input. Bounds: 1e-12
of max|ref| for the direct-convolution levels, 1e-10 where FFT levels
round (AUTO takes the FFT cascade beyond the threshold)."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jwave_tpu as jw  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402
# the packages re-export the function `modwt` under the module's name
jm = importlib.import_module("jwave_tpu.transforms.modwt")
from jwave_tpu_torch.ops import cuda_modwt  # noqa: E402

from torch_parity import assert_close  # noqa: E402


@pytest.mark.parametrize("shape,wavelet,level", [((32, 48), "db4", 3), ((2, 16, 64), "Haar", 4),
                                                 ((24, 40), "sym8", 2)])
def test_modwt_2d_roundtrip_matches_jax(shape, wavelet, level, rng):
    x = rng.standard_normal(shape)
    got = jt.modwt_2d(torch.tensor(x), wavelet, level)
    want = jm.modwt_2d(x, wavelet, level)
    assert tuple(got.shape) == shape[:-2] + (level + 1, level + 1) + shape[-2:]
    assert_close(got, want, 1e-10, "modwt_2d")
    assert_close(jt.imodwt_2d(got, wavelet), jm.imodwt_2d(np.asarray(want), wavelet), 1e-10,
                 "imodwt_2d")
    assert_close(jt.imodwt_2d(got, wavelet), x, 1e-10, "round trip")


def test_modwt_2d_facade(rng):
    x = rng.standard_normal((32, 32))
    t = jt.MODWTTransform("db4", device="cpu")
    got = t.forward_modwt_2d(x, 2)
    assert_close(got, jw.MODWTTransform("db4").forward_modwt_2d(x, 2), 1e-10, "facade")
    assert_close(t.inverse_modwt_2d(got), x, 1e-10, "facade inverse")


@pytest.mark.parametrize("boundary", ["periodic", "reflection"])
@pytest.mark.parametrize("method", ["AUTO", "DIRECT"])
@pytest.mark.parametrize("n,level", [(300, 4), (777, 6)])
def test_modwt_mra_matches_jax(boundary, method, n, level, rng):
    x = rng.standard_normal((2, n))
    got = jt.modwt_mra(torch.tensor(x), "db4", level, boundary=boundary,
                       method=getattr(jt.ConvolutionMethod, method))
    want = jw.modwt_mra(x, "db4", level, boundary=boundary,
                        method=getattr(jw.ConvolutionMethod, method))
    assert_close(got, want, 1e-10, "modwt_mra")
    assert_close(got.sum(dim=-2), x, 1e-10, "additivity")


@pytest.mark.parametrize("boundary", ["periodic", "reflection"])
def test_modwt_mra_2d_matches_jax(boundary, rng):
    x = rng.standard_normal((16, 24))
    got = jt.modwt_mra_2d(torch.tensor(x), "db4", 2, boundary=boundary)
    want = jm.modwt_mra_2d(x, "db4", 2, boundary=boundary)
    assert tuple(got.shape) == (3, 3, 16, 24)
    assert_close(got, want, 1e-10, "modwt_mra_2d")
    assert_close(got.sum(dim=(-4, -3)), x, 1e-10, "additivity")


@pytest.mark.parametrize("call", ["mra", "mra_2d", "variance", "covariance", "correlation"])
def test_truncate_refused_as_in_jax(call):
    x = np.zeros((64,))
    fns = {
        "mra": lambda m, a: m.modwt_mra(a, "db4", 2, truncate=True),
        "mra_2d": lambda m, a: m.modwt_mra_2d(np.zeros((16, 16)), "db4", 2, truncate=True),
        "variance": lambda m, a: m.modwt_variance(a, "db4", 2, truncate=True),
        "covariance": lambda m, a: m.modwt_covariance(a, a, "db4", 2, truncate=True),
        "correlation": lambda m, a: m.modwt_correlation(a, a, "db4", 2, truncate=True),
    }
    with pytest.raises(jw.JWaveFailure) as ej:
        fns[call](jm, x)
    with pytest.raises(jt.JWaveFailure) as et:
        fns[call](jt, torch.tensor(x))
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("unbiased", [True, False])
@pytest.mark.parametrize("wavelet,level", [("db4", 5), ("Haar", 7), ("sym8", 3)])
def test_scale_statistics_match_jax(unbiased, wavelet, level, rng):
    x = rng.standard_normal((3, 2048))
    y = 0.6 * x + rng.standard_normal((3, 2048))
    xt, yt = torch.tensor(x), torch.tensor(y)
    assert_close(jt.modwt_variance(xt, wavelet, level, unbiased=unbiased),
                 jw.modwt_variance(x, wavelet, level, unbiased=unbiased), 1e-10, "variance")
    for a, b in zip(jt.modwt_variance_ci(xt, wavelet, level, 0.9, unbiased=unbiased),
                    jw.modwt_variance_ci(x, wavelet, level, 0.9, unbiased=unbiased)):
        assert_close(a, b, 1e-10, "variance ci")
    assert_close(jt.modwt_covariance(xt, yt, wavelet, level, unbiased=unbiased),
                 jw.modwt_covariance(x, y, wavelet, level, unbiased=unbiased), 1e-10, "cov")
    assert_close(jt.modwt_correlation(xt, yt, wavelet, level, unbiased=unbiased),
                 jw.modwt_correlation(x, y, wavelet, level, unbiased=unbiased), 1e-10, "corr")
    for a, b in zip(jt.wavelet_log_spectrum(xt, wavelet, level, unbiased=unbiased),
                    jw.wavelet_log_spectrum(x, wavelet, level, unbiased=unbiased)):
        assert_close(a, b, 1e-10, "log spectrum")


@pytest.mark.parametrize("kind", ["fgn", "fbm"])
@pytest.mark.parametrize("unbiased", [True, False])
@pytest.mark.parametrize("n", [512, 4096])
def test_hurst_exponent_matches_jax(kind, unbiased, n, rng):
    """The automatic level choice included (db4 at 4096 unbiased picks 9)."""
    x = rng.standard_normal((2, n))
    if kind == "fbm":
        x = np.cumsum(x, axis=-1)
    got = jt.hurst_exponent(torch.tensor(x), kind=kind, unbiased=unbiased)
    assert_close(got, jw.hurst_exponent(x, kind=kind, unbiased=unbiased), 1e-10, "H")


def test_hurst_of_white_noise_is_one_half(rng):
    h = jt.hurst_exponent(torch.tensor(rng.standard_normal((4, 16384))))
    assert float((h - 0.5).abs().max()) < 0.05


@pytest.mark.parametrize("args,match", [
    (dict(kind="brown"), "kind"),
    (dict(level=None, wavelet="Discrete Meyer"), "too short"),
])
def test_hurst_errors_match(args, match):
    x = np.zeros((64,))
    with pytest.raises(jw.JWaveFailure, match=match) as ej:
        jw.hurst_exponent(x, **args)
    with pytest.raises(jt.JWaveFailure) as et:
        jt.hurst_exponent(torch.tensor(x), **args)
    assert str(et.value) == str(ej.value)


def test_statistics_errors_match():
    x = np.zeros((16,))
    cases = [
        lambda m, a: m.modwt_variance(a, "db4", 2),  # unbiased needs N > L_j - 1
        lambda m, a: m.modwt_variance_ci(a, "db4", 1, confidence=1.5),
        lambda m, a: m.wavelet_log_spectrum(a, "db4", 1),
        lambda m, a: m.modwt_covariance(a, a[:8], "db4", 1),
    ]
    for fn in cases:
        with pytest.raises(jw.JWaveFailure) as ej:
            fn(jw, x)
        with pytest.raises(jt.JWaveFailure) as et:
            fn(jt, torch.tensor(x))
        assert str(et.value) == str(ej.value)


def test_float32_cascade_on_cpu_runs_the_plain_kernels(rng):
    """method=PALLAS on a CPU float32 tensor runs K1/K2's plain versions under
    the whole analysis layer; no kernel launches."""
    cuda_modwt.reset_launch_counts()
    x = rng.standard_normal((2, 1024))
    pallas = jt.ConvolutionMethod.PALLAS
    xt = torch.tensor(x, dtype=torch.float32)
    mra = jt.modwt_mra(xt, "db4", 4, method=pallas)
    assert mra.dtype == torch.float32
    assert_close(mra, jw.modwt_mra(x, "db4", 4), 1e-5, "f32 mra")
    assert_close(jt.modwt_variance(xt, "db4", 4, method=pallas), jw.modwt_variance(x, "db4", 4),
                 1e-5, "f32 variance")
    assert cuda_modwt.launch_counts == {"modwt_cascade": 0, "imodwt_cascade": 0}
