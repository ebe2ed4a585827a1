"""jwave_tpu_torch's denoising and order statistics against jwave_tpu, on the
same seeded float64 input: thresholds, the three threshold rules, 1D and 2D
denoising, and the radix-select median with its gradient. The discrete
decisions are compared first (hard-threshold masks, SURE's argmin), then
the values: 1e-12 of max|ref| for the elementwise rules, 1e-10 through the
transforms' FFT levels."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import jwave_tpu as jw  # noqa: E402
jd = importlib.import_module("jwave_tpu.denoise")  # the package re-exports `denoise`
from jwave_tpu.utils import select as js  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch.utils import select as ts  # noqa: E402

from torch_parity import assert_close  # noqa: E402


def _noisy(rng, shape, n_tone=64.0):
    t = np.arange(shape[-1])
    return np.sin(2 * np.pi * t / n_tone) + 0.4 * rng.standard_normal(shape)


# --------------------------------------------------------------------------
# order statistics
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 7, 64, 1001])
def test_kth_smallest_matches_jax(dtype, n, rng):
    a = np.abs(rng.standard_normal((3, n)))
    a[0, : n // 2] = a[0, 0]  # ties
    at = torch.tensor(a, dtype=dtype)
    ks = tuple(sorted({0, n // 2, n - 1}))
    got = ts.kth_smallest_nonneg(at, ks)
    want = js.kth_smallest_nonneg(jnp.asarray(at.numpy()), ks)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[-1].numpy(), at.sort(dim=-1).values[:, ks[-1]].numpy())


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1000])
def test_median_routes_agree_with_jax(n, rng):
    a = rng.standard_normal((4, n))
    want = np.asarray(js.median_abs(jnp.asarray(a), force=False))
    np.testing.assert_array_equal(np.asarray(js.median_abs(jnp.asarray(a), force=True)), want)
    at = torch.tensor(a)
    np.testing.assert_array_equal(jt.median_abs(at).numpy(), want)
    np.testing.assert_array_equal(jt.median_abs(at, force=True).numpy(), want)
    np.testing.assert_array_equal(jt.median_abs(at, force=False).numpy(), want)


def test_even_median_averages_the_middle_pair():
    a = torch.tensor([[4.0, 1.0, 3.0, 2.0]])
    assert float(jt.median_abs(a)) == 2.5 == float(jt.median_abs(a, force=True))


@pytest.mark.parametrize("n", [7, 8])
def test_median_gradient_spreads_over_ties_as_jax(n, rng):
    a = np.abs(rng.standard_normal((2, n)))
    a[1, 1:5] = np.sort(a[1])[n // 2]  # the middle values tied four times
    w = rng.standard_normal(2)
    g_j = jax.grad(lambda m: jnp.sum(js.median_nonneg(m) * w))(jnp.asarray(a))
    at = torch.tensor(a, requires_grad=True)
    (ts.median_nonneg(at) * torch.tensor(w)).sum().backward()
    assert_close(at.grad, g_j, 1e-12, "median grad")


# --------------------------------------------------------------------------
# thresholds
# --------------------------------------------------------------------------

def test_soft_and_hard_threshold_match_jax(rng):
    c = rng.standard_normal((3, 200))
    tau = np.abs(rng.standard_normal((3, 1)))
    ct, tt = torch.tensor(c), torch.tensor(tau)
    np.testing.assert_array_equal((jt.hard_threshold(ct, tt) != 0).numpy(),
                                  np.asarray(jd.hard_threshold(c, tau)) != 0)
    assert_close(jt.hard_threshold(ct, tt), jd.hard_threshold(c, tau), 1e-12, "hard")
    assert_close(jt.soft_threshold(ct, tt), jd.soft_threshold(c, tau), 1e-12, "soft")
    assert_close(jt.mad_sigma(ct), jd.mad_sigma(c), 1e-12, "mad")


@pytest.mark.parametrize("signal", ["sparse", "dense", "zero_sigma"])
def test_sure_threshold_matches_jax(signal, rng):
    band = rng.standard_normal((4, 512))
    if signal == "dense":
        band[:, ::4] += 6.0
    sigma = np.array([1.0, 0.8, 1.3, 0.0 if signal == "zero_sigma" else 1.0])
    n = band.shape[-1]
    # the discrete decision first: SURE's argmin over the sorted candidates
    y = band / np.where(sigma > 0, sigma, 1.0)[:, None]
    a = np.sort(np.abs(y), axis=-1)
    k = np.arange(n)
    risk = n - 2.0 * (k + 1.0) + np.cumsum(a * a, axis=-1) + (n - 1.0 - k) * a * a
    tr = torch.tensor(risk)
    np.testing.assert_array_equal(torch.argmin(tr, dim=-1).numpy(),
                                  np.asarray(jnp.argmin(jnp.asarray(risk), axis=-1)))
    assert_close(jt.sure_threshold(torch.tensor(band), torch.tensor(sigma)),
                 jd.sure_threshold(band, sigma), 1e-12, "sure")


def test_bayes_threshold_matches_jax(rng):
    band = rng.standard_normal((3, 256)) * np.array([[0.5], [1.0], [3.0]])
    sigma = np.array([1.0, 1.0, 1.0])  # first band all noise: kill-all branch
    assert_close(jt.bayes_threshold(torch.tensor(band), torch.tensor(sigma)),
                 jd.bayes_threshold(band, sigma), 1e-12, "bayes")


# --------------------------------------------------------------------------
# denoise / denoise_2d
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["soft", "hard"])
@pytest.mark.parametrize("method", ["universal", "sure", "bayes"])
def test_denoise_matches_jax(mode, method, rng):
    x = _noisy(rng, (3, 1024))
    got = jt.denoise(torch.tensor(x), "db4", 4, mode=mode, method=method)
    want = jw.denoise(x, "db4", 4, mode=mode, method=method)
    assert_close(got, want, 1e-10, f"denoise {mode} {method}")


def test_denoise_explicit_threshold_and_keep_mask(rng):
    x = _noisy(rng, (2, 512))
    c = jt.modwt(torch.tensor(x), "db4", 3)
    cj = jw.modwt(x, "db4", 3)
    np.testing.assert_array_equal((c[..., :3, :].abs() > 0.3).numpy(),
                                  np.asarray(jnp.abs(cj[..., :3, :]) > 0.3))
    assert_close(jt.denoise(torch.tensor(x), "db4", 3, mode="hard", threshold=0.3),
                 jw.denoise(x, "db4", 3, mode="hard", threshold=0.3), 1e-10, "explicit")


def test_denoise_improves_snr(rng):
    t = np.arange(4096)
    clean = np.sin(2 * np.pi * t / 256.0)
    noisy = clean + 0.5 * rng.standard_normal(4096)
    out = jt.denoise(torch.tensor(noisy), "db4", 5).numpy()
    assert np.mean((out - clean) ** 2) < 0.25 * np.mean((noisy - clean) ** 2)


@pytest.mark.parametrize("mode", ["soft", "hard"])
@pytest.mark.parametrize("method", ["universal", "sure", "bayes"])
def test_denoise_2d_matches_jax(mode, method, rng):
    img = _noisy(rng, (32, 48), 16.0)
    got = jt.denoise_2d(torch.tensor(img), "db4", 2, mode=mode, method=method)
    want = jw.denoise_2d(img, "db4", 2, mode=mode, method=method)
    assert_close(got, want, 1e-10, f"denoise_2d {mode} {method}")


@pytest.mark.parametrize("fn", ["denoise", "denoise_2d"])
@pytest.mark.parametrize("kw", [dict(mode="medium"), dict(method="minimax")])
def test_denoise_errors_match(fn, kw):
    x = np.zeros((32, 32))
    with pytest.raises(jw.JWaveFailure) as ej:
        getattr(jw, fn)(x, **kw)
    with pytest.raises(jt.JWaveFailure) as et:
        getattr(jt, fn)(torch.tensor(x), **kw)
    assert str(et.value) == str(ej.value)


def test_denoise_dtcwt_is_not_exported(rng):
    """denoise_dtcwt is exported now: held against the JAX package's at
    1e-10 (the bivariate shrinkage of tests/test_torch_dtcwt.py, here on one
    image with the default levels and window)."""
    img = _noisy(rng, (64, 64), 16.0)
    got = jt.denoise_dtcwt(torch.tensor(img))
    assert_close(got, jax.jit(jw.denoise_dtcwt)(img), 1e-10, "denoise_dtcwt")
