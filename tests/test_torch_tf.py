"""jwave_tpu_torch's time-frequency layer against jwave_tpu: analytic
signal, superlets, EWT, Wigner-Ville, VMD and matching pursuit, on the same
seeded float64 input. Every one runs FFTs, so the bound is 1e-10 of
max|ref|; host-side tables (the EWT bank, the Gabor dictionary) are equal
to 1e-12. Discrete decisions are compared before values: EWT boundaries
exactly, the pursuit's atoms and shifts exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import jwave_tpu as jw  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402

from torch_parity import assert_close, to_np  # noqa: E402

FFT_BOUND = 1e-10


def _tones(rng, shape, fs=1000.0, freqs=(40.0, 150.0)):
    t = np.arange(shape[-1]) / fs
    x = sum(np.cos(2 * np.pi * f * t + k) for k, f in enumerate(freqs))
    return x + 0.2 * rng.standard_normal(shape)


@pytest.mark.parametrize("n", [255, 256])
def test_analytic_family_matches_jax(n, rng):
    x = rng.standard_normal((3, n))
    xt = torch.tensor(x)
    z = jt.analytic_signal(xt)
    assert z.dtype == torch.complex128
    assert_close(z, jw.analytic_signal(x), FFT_BOUND, "analytic_signal")
    assert_close(z.real, x, FFT_BOUND, "Re z = x")
    assert_close(jt.envelope(xt), jw.envelope(x), FFT_BOUND, "envelope")
    assert_close(jt.instantaneous_frequency(xt, 100.0), jw.instantaneous_frequency(x, 100.0),
                 FFT_BOUND, "instantaneous_frequency")


def test_analytic_dtypes_and_errors():
    assert jt.analytic_signal(torch.arange(8)).dtype == torch.complex64
    assert jt.analytic_signal(torch.zeros(8, dtype=torch.float32)).dtype == torch.complex64
    for bad in (torch.zeros(4, dtype=torch.complex64), torch.zeros(1)):
        with pytest.raises(jt.JWaveFailure) as et:
            jt.analytic_signal(bad)
        with pytest.raises(jw.JWaveFailure) as ej:
            jw.analytic_signal(jnp.asarray(bad.numpy()))
        assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("kw", [dict(), dict(multiplicative=False, order_max=5),
                                dict(order_min=2, order_max=3, base_cycles=2.0)])
def test_superlet_matches_jax(kw, rng):
    x = _tones(rng, (2, 512))
    freqs = np.linspace(5.0, 200.0, 12)
    got = jt.superlet(torch.tensor(x), freqs, 1000.0, **kw)
    assert tuple(got.shape) == (2, 12, 512)
    assert_close(got, jw.superlet(x, freqs, 1000.0, **kw), FFT_BOUND, "superlet")


@pytest.mark.parametrize("n_modes", [1, 3, 5])
def test_ewt_matches_jax(n_modes, rng):
    x = _tones(rng, (2, 1024), freqs=(20.0, 90.0, 230.0, 400.0))
    b_t = jt.ewt_boundaries(x, n_modes)
    b_j = jw.ewt_boundaries(x, n_modes)
    np.testing.assert_array_equal(b_t, b_j)
    assert_close(jt.ewt_filter_bank(1024, b_t), jw.ewt_filter_bank(1024, b_j), 1e-12, "bank")
    res = jt.ewt(torch.tensor(x), n_modes)
    want = jw.ewt(x, n_modes)
    np.testing.assert_array_equal(res.boundaries, want.boundaries)
    assert res.n_modes == n_modes
    assert_close(res.modes, want.modes, FFT_BOUND, "ewt modes")
    back = jt.iewt(res)
    assert_close(back, jw.iewt(want), FFT_BOUND, "iewt")
    assert_close(back, x, FFT_BOUND, "iewt(ewt(x)) = x")


def test_ewt_explicit_boundaries_and_errors(rng):
    x = rng.standard_normal(64)
    b = [0.5, 1.5]
    assert_close(jt.ewt(torch.tensor(x), boundaries=b).modes,
                 jw.ewt(x, boundaries=b).modes, FFT_BOUND, "explicit")
    for fn in (lambda m, a: m.ewt(a(np.zeros(4)), 2), lambda m, a: m.ewt(a(np.zeros(64))),
               lambda m, a: m.ewt_filter_bank(64, [0.5, 0.5]),
               lambda m, a: m.ewt_filter_bank(64, [4.0])):
        with pytest.raises(jw.JWaveFailure) as ej:
            fn(jw, np.asarray)
        with pytest.raises(jt.JWaveFailure) as et:
            fn(jt, torch.as_tensor)
        assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("kw", [dict(), dict(n_bins=32), dict(n_bins=64, time_window=5),
                                dict(n_bins=16, lag_window=7), dict(time_window=3, lag_window=3)])
def test_wigner_ville_matches_jax(kw, rng):
    x = _tones(rng, (2, 96))
    tfr, freqs = jt.wigner_ville(torch.tensor(x), 1000.0, **kw)
    tfr_j, freqs_j = jw.wigner_ville(x, 1000.0, **kw)
    assert tfr.dtype == torch.float64
    assert_close(freqs, freqs_j, 1e-12, "wvd freqs")
    assert_close(tfr, tfr_j, FFT_BOUND, "wvd")


@pytest.mark.parametrize("kw", [dict(), dict(init="log", tau=0.5), dict(init="zero", dc=True),
                                dict(alpha=500.0, n_iter=7)])
def test_vmd_matches_jax(kw, rng):
    x = _tones(rng, (2, 256), freqs=(30.0, 120.0, 300.0))
    kw = {"n_iter": 40, **kw}
    res = jt.vmd(torch.tensor(x), 3, **kw)
    want = jw.vmd(x, 3, **kw)
    assert res.n_modes == 3 and tuple(res.convergence.shape) == (2, kw["n_iter"])
    assert_close(res.omegas, want.omegas, FFT_BOUND, "omegas")
    assert_close(res.modes, want.modes, FFT_BOUND, "modes")
    assert_close(res.convergence, want.convergence, FFT_BOUND, "convergence")
    assert_close(res.frequencies(1000.0), want.frequencies(1000.0), FFT_BOUND, "Hz")


def test_vmd_odd_length_and_errors(rng):
    x = rng.standard_normal(101)
    assert_close(jt.vmd(torch.tensor(x), 2, n_iter=10).modes, jw.vmd(x, 2, n_iter=10).modes,
                 FFT_BOUND, "odd n")
    for fn in (lambda m, a: m.vmd(a(np.zeros(2)), 2), lambda m, a: m.vmd(a(np.zeros(16)), 0),
               lambda m, a: m.vmd(a(np.zeros(16)), 2, init="random"),
               lambda m, a: m.vmd(a(np.zeros(16)), 2, n_iter=0)):
        with pytest.raises(jw.JWaveFailure) as ej:
            fn(jw, np.asarray)
        with pytest.raises(jt.JWaveFailure) as et:
            fn(jt, torch.as_tensor)
        assert str(et.value) == str(ej.value)


def test_gabor_dictionary_matches_jax():
    for kw in (dict(), dict(freqs_per_scale=5), dict(scales=[4, 16])):
        a, b = jt.gabor_dictionary(128, **kw), jw.gabor_dictionary(128, **kw)
        for name in ("cos_atoms", "sin_atoms", "cross", "scale", "freq"):
            assert_close(getattr(a, name), getattr(b, name), 1e-12, name)


@pytest.mark.parametrize("kw", [dict(), dict(freqs_per_scale=6)])
def test_matching_pursuit_matches_jax(kw, rng):
    x = _tones(rng, (2, 128), fs=128.0, freqs=(10.0, 33.0))
    res = jt.matching_pursuit(torch.tensor(x), 6, **kw)
    want = jw.matching_pursuit(x, 6, **kw)
    # the picks first: the same atoms at the same shifts
    np.testing.assert_array_equal(res.atom_idx.numpy(), np.asarray(want.atom_idx))
    np.testing.assert_array_equal(res.positions.numpy(), np.asarray(want.positions))
    for name in ("alphas", "betas", "residual", "energies", "amplitudes"):
        assert_close(getattr(res, name), getattr(want, name), FFT_BOUND, name)
    assert_close(res.reconstruct(), want.reconstruct(), FFT_BOUND, "reconstruct")
    assert_close(res.reconstruct(3), want.reconstruct(3), FFT_BOUND, "reconstruct(3)")
    assert_close(res.reconstruct() + res.residual, x, FFT_BOUND, "reconstruction + residual")
    assert_close(res.atom_frequencies(128.0), want.atom_frequencies(128.0), 1e-12, "freqs")
    assert np.all(np.diff(to_np(res.energies), axis=-1) <= 1e-12)


def test_matching_pursuit_errors():
    for fn in (lambda m, a: m.matching_pursuit(a(np.zeros(8))),
               lambda m, a: m.matching_pursuit(a(np.zeros(32)), 0),
               lambda m, a: m.matching_pursuit(a(np.zeros(32)), 2,
                                               dictionary=m.gabor_dictionary(64))):
        with pytest.raises(jw.JWaveFailure) as ej:
            fn(jw, np.asarray)
        with pytest.raises(jt.JWaveFailure) as et:
            fn(jt, torch.as_tensor)
        assert str(et.value) == str(ej.value)
