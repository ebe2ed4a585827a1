"""jwave_tpu_torch's continuous layer against jwave_tpu: the six mother
wavelets, the FFT module, the CWT family and the Fourier/CWT facade entries,
on the same numpy inputs in float64.

Tolerances (scale-relative, ``torch_parity.assert_close``): 1e-12 where the
two packages compute the same operators term by term (wavelet formulas,
paddings, the direct correlation), 1e-10 where FFT roundoff of two FFT
libraries enters (every FFT path)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import importlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402

import jwave_tpu as jw  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402

# the modules, not the functions of the same name that the packages export
jcwt = importlib.import_module("jwave_tpu.transforms.cwt")
jfft = importlib.import_module("jwave_tpu.transforms.fft")
tcwt = importlib.import_module("jwave_tpu_torch.transforms.cwt")
tfft = importlib.import_module("jwave_tpu_torch.transforms.fft")

from torch_parity import assert_close  # noqa: E402

EXACT = 1e-12
FFT = 1e-10


def cpu(a):
    """numpy or a Python number as a tensor on the CPU (numpy input with no
    ``device`` goes to the card)."""
    return torch.as_tensor(np.asarray(a))

WAVELETS = [
    ("morlet", ()), ("morlet", (2.0, 1.5)), ("mexican hat", (1.5,)), ("ricker", ()),
    ("paul", ()), ("paul", (2,)), ("dog", (1,)), ("dog", (3, 0.7)), ("dog", (4,)),
    ("meyer", ()), ("morse", ()), ("morse", (60.0, 2.0)),
]


def _pair(name, args):
    return jw.get_continuous_wavelet(name, *args), jt.get_continuous_wavelet(name, *args)


@pytest.mark.parametrize("name,args", WAVELETS)
def test_psi_and_psi_hat_match_jax(name, args):
    wj, wt = _pair(name, args)
    t = np.linspace(-8.0, 8.0, 161)
    om = np.linspace(-25.0, 25.0, 201)
    assert_close(wt.psi(cpu(t)), wj.psi(jnp.asarray(t)), EXACT, "psi")
    assert_close(wt.psi_hat(cpu(om)), wj.psi_hat(jnp.asarray(om)), EXACT, "psi_hat")
    assert_close(wt.psi_hat_scaled(cpu(om), 2.5, 0.3),
                 wj.psi_hat_scaled(jnp.asarray(om), 2.5, 0.3), EXACT, "psi_hat_scaled")
    assert_close(wt.psi_scaled(cpu(t), 1.7), wj.psi_scaled(jnp.asarray(t), 1.7), EXACT,
                 "psi_scaled")
    assert wt.name == wj.name and wt.center_frequency == wj.center_frequency
    assert wt.is_analytic == wj.is_analytic
    assert wt.effective_support() == wj.effective_support()


@pytest.mark.parametrize("dtype,cdtype", [(torch.float64, torch.complex128),
                                          (torch.float32, torch.complex64)])
@pytest.mark.parametrize("name", ["morlet", "mexican hat", "paul", "dog", "meyer", "morse"])
def test_complex_width_follows_real_input(name, dtype, cdtype):
    w = jt.get_continuous_wavelet(name)
    x = torch.linspace(-3.0, 3.0, 9, dtype=dtype)
    assert w.psi(x).dtype == cdtype and w.psi_hat(x).dtype == cdtype


def test_reference_point_values():
    """Mirror of tests/test_cwt.py's point checks (Morlet's psi_hat carries
    sqrt(2*pi*fb); Paul is zero for w <= 0; Meyer has compact support)."""
    m = jt.MorletWavelet(1.0, 1.0)
    assert complex(m.psi(cpu(0.0))) == pytest.approx(1 / np.sqrt(2 * np.pi), abs=1e-12)
    assert complex(m.psi_hat(cpu(2 * np.pi))) == pytest.approx(np.sqrt(2 * np.pi), abs=1e-12)
    assert complex(jt.MexicanHatWavelet(1.0).psi(cpu(1.0))) == pytest.approx(0.0, abs=1e-12)
    p = jt.PaulWavelet(4)
    assert complex(p.psi_hat(cpu(-1.0))) == 0.0 and complex(p.psi_hat(cpu(0.0))) == 0.0
    d = jt.DOGWavelet(2, 1.0)
    assert complex(d.psi(cpu(0.0))).real == pytest.approx(-2.0 * d.norm, abs=1e-12)
    me = jt.MeyerWavelet()
    assert abs(complex(me.psi_hat(cpu(2 * np.pi / 3 * 0.9)))) == 0.0
    assert abs(complex(me.psi_hat(cpu(8 * np.pi / 3 * 1.1)))) == 0.0
    mo = jt.MorseWavelet(20.0, 3.0)
    om = np.linspace(0.01, 6.0, 20000)
    mag = np.abs(mo.psi_hat(cpu(om)).numpy())
    assert abs(om[mag.argmax()] - mo.omega_peak) < 1e-3 and abs(mag.max() - 2.0) < 1e-5
    assert mo.admissibility_constant() == jw.MorseWavelet(20.0, 3.0).admissibility_constant()
    assert mo.bandwidth() == jw.MorseWavelet(20.0, 3.0).bandwidth()


def test_morse_checks_of_test_morse():
    """tests/test_morse.py's small checks on the port: zero spectrum at and
    below w = 0, Paul(m) proportional to Morse(m, 1), the closed-form
    admissibility against quadrature, no float32 overflow at beta = 120."""
    w = jt.MorseWavelet(20.0, 3.0)
    assert np.array_equal(w.psi_hat(cpu([-2.0, -0.5, 0.0])).numpy(), np.zeros(3))
    om = np.linspace(0.01, 30.0, 500)
    rp = np.abs(jt.PaulWavelet(4).psi_hat(cpu(om)).numpy())
    rm = np.abs(jt.MorseWavelet(4.0, 1.0).psi_hat(cpu(om)).numpy())
    keep = rm > 1e-12
    assert np.allclose(rp[keep] / rm[keep], (rp[keep] / rm[keep])[0], rtol=1e-10, atol=0)
    w2 = jt.MorseWavelet(6.0, 2.0)
    om = np.linspace(1e-6, 30.0, 400000)
    numeric = np.trapezoid(np.abs(w2.psi_hat(cpu(om)).numpy()) ** 2 / om, om)
    assert abs(w2.admissibility_constant() - numeric) <= 1e-4 * numeric
    big = jt.MorseWavelet(120.0, 3.0)
    mag = big.psi_hat(torch.linspace(0.1, 2.0 * big.omega_peak, 4000)).abs()
    assert bool(torch.isfinite(mag).all()) and abs(float(mag.max()) - 2.0) < 1e-3
    m = jt.get_continuous_wavelet("morse", 8.0, 2.0)
    assert m.beta == 8.0 and m.gamma == 2.0
    with pytest.raises(ValueError):
        jt.MorseWavelet(20.0, 0.0)


def test_wavelet_lookup_and_guards():
    assert isinstance(jt.get_continuous_wavelet("Mexican Hat"), jt.MexicanHatWavelet)
    w = jt.PaulWavelet(3)
    assert jt.get_continuous_wavelet(w) is w
    with pytest.raises(jt.JWaveNotKnown):
        jt.get_continuous_wavelet("haar")
    for bad in (lambda: jt.MorletWavelet(0.0), lambda: jt.PaulWavelet(0),
                lambda: jt.DOGWavelet(11), lambda: jt.MorseWavelet(-1.0)):
        with pytest.raises(ValueError):
            bad()


# --------------------------------------------------------------------------
# FFT module
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 64, 100, 127])
def test_fft_ifft_match_numpy_and_jax(n, rng):
    z = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    got = jt.fft(torch.tensor(z))
    assert_close(got, np.fft.fft(z), FFT, "fft")
    assert_close(got, jw.fft(jnp.asarray(z)), FFT, "fft vs jax")
    assert_close(jt.ifft(got), z, FFT, "ifft round trip")
    assert_close(jt.ifft(torch.tensor(z)), jw.ifft(jnp.asarray(z)), FFT, "ifft vs jax")
    assert_close(tfft.fft(torch.tensor(z.T.copy()), axis=0), np.fft.fft(z.T, axis=0), FFT,
                 "axis 0")


@pytest.mark.parametrize("n", [5, 12, 100, 256])
def test_bluestein_and_dft_match(n, rng):
    z = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    zt = torch.tensor(z)
    assert_close(tfft.bluestein_fft(zt), np.fft.fft(z), FFT, "bluestein")
    assert_close(tfft.bluestein_fft(zt, inverse=True), np.fft.ifft(z), FFT, "bluestein inverse")
    assert_close(tfft.bluestein_fft(zt), jfft.bluestein_fft(jnp.asarray(z)), FFT, "bluestein jax")
    assert_close(tfft.dft(zt), jfft.dft(jnp.asarray(z)), FFT, "dft")
    assert_close(tfft.idft(tfft.dft(zt)), z, FFT, "idft round trip")
    x = rng.standard_normal(2 * n)
    xt = cpu(x)
    assert_close(tfft.fft_interleaved(xt), jfft.fft_interleaved(jnp.asarray(x)), FFT, "fft il")
    assert_close(tfft.ifft_interleaved(xt), jfft.ifft_interleaved(jnp.asarray(x)), FFT, "ifft il")
    assert_close(tfft.dft_interleaved(xt), jfft.dft_interleaved(jnp.asarray(x)), FFT, "dft il")
    assert_close(tfft.idft_interleaved(xt), jfft.idft_interleaved(jnp.asarray(x)), FFT, "idft il")
    assert tfft.bluestein_fft(torch.tensor(x[:n], dtype=torch.float32)).dtype == torch.complex64


def test_fft_conventions(rng):
    """Mirror of tests/test_fft.py: NumPy normalization, conjugate symmetry
    of a real input's spectrum, linearity."""
    d = np.zeros(8, complex)
    d[0] = 1.0
    assert_close(jt.fft(cpu(d)), np.ones(8), EXACT, "delta")
    x = rng.standard_normal(64)
    X = jt.fft(torch.tensor(x)).numpy()
    assert np.allclose(X[1:], np.conj(X[1:][::-1]), atol=1e-9)
    z1, z2 = rng.standard_normal(32) + 0j, rng.standard_normal(32) + 1j
    lhs = jt.fft(torch.tensor(2.0 * z1 - 3.0 * z2))
    assert_close(lhs, 2.0 * jt.fft(torch.tensor(z1)) - 3.0 * jt.fft(torch.tensor(z2)), FFT, "lin")


@pytest.mark.parametrize("name", ["Fast Fourier Transform", "Discrete Fourier Transform"])
def test_fourier_facades_match_jax(name, rng):
    t = jt.TransformBuilder.create(name, device="cpu")
    tj = jw.TransformBuilder.create(name)
    z = rng.standard_normal(24) + 1j * rng.standard_normal(24)
    assert_close(t.forward(z), tj.forward(z), FFT, "complex forward")
    assert_close(t.reverse(t.forward(z)), z, FFT, "complex round trip")
    x = rng.standard_normal(48)
    assert_close(t.forward(x), tj.forward(x), FFT, "interleaved forward")
    assert_close(t.reverse(t.forward(x)), x, FFT, "interleaved round trip")
    m = rng.standard_normal((8, 16)) + 1j * rng.standard_normal((8, 16))
    assert_close(t.forward(m), np.fft.fft2(m), FFT, "2D complex")
    assert_close(t.forward(m), tj.forward(m), FFT, "2D vs jax")
    assert_close(t.reverse(t.forward(m)), m, FFT, "2D round trip")
    assert jt.TransformBuilder.identify(t) == jw.TransformBuilder.identify(tj) == name


# --------------------------------------------------------------------------
# CWT family
# --------------------------------------------------------------------------

def test_scale_generators_padding_and_omega():
    assert_close(jt.generate_log_scales(1.0, 100.0, 5), jw.generate_log_scales(1.0, 100.0, 5),
                 EXACT, "log scales")
    assert_close(jt.generate_linear_scales(1.0, 9.0, 5), [1, 3, 5, 7, 9], EXACT, "linear")
    for bad in ((-1.0, 10.0, 5), (5.0, 1.0, 3), (1.0, 10.0, 1)):
        with pytest.raises(ValueError):
            jt.generate_log_scales(*bad)
        with pytest.raises(ValueError):
            jt.generate_linear_scales(*bad)
    x = torch.tensor([1.0, 2, 3, 4, 5], dtype=torch.float64)
    want = {"ZERO": [1, 2, 3, 4, 5, 0, 0, 0], "CONSTANT": [1, 2, 3, 4, 5, 5, 5, 5],
            "PERIODIC": [1, 2, 3, 4, 5, 1, 2, 3], "SYMMETRIC": [1, 2, 3, 4, 5, 4, 3, 2]}
    for p in jt.PaddingType:
        assert_close(tcwt.pad_signal(x, 8, p), want[p.name], EXACT, p.name)
        assert_close(tcwt.pad_signal(x, 14, p),
                     jcwt.pad_signal(jnp.asarray(x.numpy()), 14, jw.PaddingType(p.value)),
                     EXACT, f"{p.name} long")
    assert_close(tcwt._omega_axis(8, 2.0), jcwt._omega_axis(8, 2.0), 0.0, "omega")


@pytest.mark.parametrize("padding", list(jw.PaddingType))
@pytest.mark.parametrize("n", [100, 128])
def test_cwt_matches_jax(padding, n, rng):
    x = rng.standard_normal((2, n))
    sc = jw.generate_log_scales(1.5, 30.0, 7)
    got = jt.cwt(torch.tensor(x), sc, jt.MorletWavelet(1.0, 1.0), 2.0,
                 jt.PaddingType(padding.value))
    want = jw.cwt(jnp.asarray(x), sc, jw.MorletWavelet(1.0, 1.0), 2.0, padding)
    assert_close(got.coefficients, want.coefficients, FFT, "coefficients")
    assert_close(got.scales, want.scales, 0.0, "scales")
    assert_close(got.time_axis, want.time_axis, EXACT, "time axis")
    assert got.sampling_rate == want.sampling_rate and got.wavelet_name == want.wavelet_name


@pytest.mark.parametrize("name", ["morlet", "mexican hat", "paul", "dog", "meyer", "morse"])
def test_cwt_direct_matches_jax(name, rng):
    x = rng.standard_normal((2, 96))
    sc = [0.8, 2.0, 3.0, 7.5]
    got = jt.cwt_direct(torch.tensor(x), sc, name, 1.0).coefficients
    want = jw.cwt_direct(jnp.asarray(x), sc, name, 1.0).coefficients
    assert_close(got, want, EXACT, "direct")


def test_cwt_result_container(rng):
    sig = rng.standard_normal(64)
    res = jt.cwt(torch.tensor(sig), [1.0, 2.0, 4.0], "morlet", 10.0)
    ref = jw.cwt(jnp.asarray(sig), [1.0, 2.0, 4.0], "morlet", 10.0)
    assert res.n_scales == 3 and res.n_time == 64
    for m in ("magnitude", "phase", "real", "imaginary", "scalogram"):
        assert_close(getattr(res, m)(), getattr(ref, m)(), FFT, m)
    assert_close(res.scale_to_frequency(1.5), ref.scale_to_frequency(1.5), EXACT, "freqs")
    assert_close(res.coefficients_at_scale(1), ref.coefficients_at_scale(1), FFT, "at scale")
    assert_close(res.coefficients_at_time(5), ref.coefficients_at_time(5), FFT, "at time")
    with pytest.raises(IndexError):
        res.coefficients_at_scale(3)
    with pytest.raises(IndexError):
        res.coefficients_at_time(64)


@pytest.mark.parametrize("name", ["morlet", "mexican hat", "paul"])
def test_icwt_matches_jax_and_reconstructs(name):
    fs, n = 100.0, 512
    t = np.arange(n) / fs
    # on-bin tones: in-band reconstruction is exact for pow-2 lengths
    sig = np.sin(2 * np.pi * (51 * fs / n) * t) + 0.5 * np.cos(2 * np.pi * (113 * fs / n) * t)
    sc = jw.generate_log_scales(0.005, 0.5, 48)
    res = jt.cwt(torch.tensor(sig), sc, name, fs, jt.PaddingType.PERIODIC)
    ref = jw.cwt(jnp.asarray(sig), sc, name, fs, jw.PaddingType.PERIODIC)
    wt, wj = jt.get_continuous_wavelet(name), jw.get_continuous_wavelet(name)
    rec = jt.icwt(res, wt)
    assert_close(rec, jw.icwt(ref, wj), FFT, "icwt vs jax")
    assert_close(rec, sig, 1e-8, "reconstruction")


def test_icwt_by_name_warns():
    sig = torch.tensor(np.sin(np.arange(64) / 3.0))
    res = jt.cwt(sig, [2.0, 4.0, 8.0, 16.0], "morlet", 1.0, jt.PaddingType.PERIODIC)
    with pytest.warns(UserWarning):
        rec = jt.icwt(res)
    assert tuple(rec.shape) == (64,)


def test_cwt_chunked_batched_and_f32(rng):
    x = rng.standard_normal((3, 200))
    sc = jw.generate_log_scales(1.0, 32.0, 10)
    full = jt.cwt(torch.tensor(x), sc, "morlet", 2.0)
    chunked = jt.cwt_chunked(torch.tensor(x), sc, "morlet", 2.0, scale_chunk=3)
    assert_close(chunked.coefficients, full.coefficients, EXACT, "chunked vs full")
    assert_close(chunked.coefficients,
                 jw.cwt_chunked(jnp.asarray(x), sc, "morlet", 2.0, scale_chunk=3).coefficients,
                 FFT, "chunked vs jax")
    assert_close(full.coefficients[1], jt.cwt(torch.tensor(x[1]), sc, "morlet", 2.0).coefficients,
                 EXACT, "batched row")
    c32 = jt.cwt(torch.tensor(x, dtype=torch.float32), sc, "morlet", 2.0).coefficients
    assert c32.dtype == torch.complex64
    assert_close(c32, full.coefficients, 1e-5, "f32 against f64")


def test_xwt_and_coherence_match_jax(rng):
    fs, n = 100.0, 256
    t = np.arange(n) / fs
    a = np.sin(2 * np.pi * 8 * t) + 0.3 * rng.standard_normal(n)
    b = np.sin(2 * np.pi * 8 * t + np.pi / 4) + 0.3 * rng.standard_normal(n)
    sc = jw.generate_log_scales(2e-2, 2e-1, 8)
    xt = jt.xwt(torch.tensor(a), torch.tensor(b), sc, jt.MorletWavelet(1, 1), fs)
    xj = jw.xwt(jnp.asarray(a), jnp.asarray(b), sc, jw.MorletWavelet(1, 1), fs)
    assert_close(xt.coefficients, xj.coefficients, FFT, "xwt")
    r2, xr = jt.wavelet_coherence(torch.tensor(a), torch.tensor(b), sc, jt.MorletWavelet(1, 1), fs)
    r2j, xrj = jw.wavelet_coherence(jnp.asarray(a), jnp.asarray(b), sc, jw.MorletWavelet(1, 1), fs)
    assert_close(r2, r2j, FFT, "coherence")
    assert_close(xr.coefficients, xrj.coefficients, FFT, "coherence xwt")
    assert float(r2.min()) >= 0.0 and float(r2.max()) <= 1.0
    r2s, _ = jt.wavelet_coherence(torch.tensor(a), torch.tensor(a), sc, "morlet", fs)
    assert float(r2s.min()) > 0.999


def test_cwt_facade_matches_jax(rng):
    sig = rng.standard_normal(256)
    sc = [2.0, 4.0]
    t = jt.TransformBuilder.create("Continuous Wavelet Transform", device="cpu")
    tj = jw.TransformBuilder.create("Continuous Wavelet Transform")
    b, bj = t.get_basic_transform(), tj.get_basic_transform()
    assert isinstance(b.cwavelet, jt.MorletWavelet)
    assert_close(b.transform_fft(sig, sc).coefficients, bj.transform_fft(sig, sc).coefficients,
                 FFT, "transform_fft")
    assert_close(b.transform(sig, sc).coefficients, bj.transform(sig, sc).coefficients,
                 EXACT, "transform (direct)")
    assert_close(b.transform_parallel(sig, sc).coefficients,
                 b.transform_fft(sig, sc).coefficients, 0.0, "parallel alias")
    with pytest.raises(jt.JWaveFailure):
        t.forward(sig)
    with pytest.raises(jt.JWaveFailure):
        t.reverse(sig)
    p = jt.ContinuousWaveletTransform("paul", jt.PaddingType.ZERO, device="cpu")
    pj = jw.ContinuousWaveletTransform("paul", jw.PaddingType.ZERO)
    assert_close(p.transform_fft(sig, sc, 4.0).coefficients,
                 pj.transform_fft(sig, sc, 4.0).coefficients, FFT, "paul zero padding")
    assert jt.TransformBuilder.identify(t) == "Continuous Wavelet Transform"
