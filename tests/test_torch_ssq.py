"""jwave_tpu_torch's synchrosqueezed CWT against jwave_tpu: ``ssq_cwt`` on
every reassignment route, clip and drop, int and explicit frequency grids,
``issq_cwt`` with bands, ``extract_ridge``, ``ridge_tube_mask`` and the
error cases, on the same numpy inputs in float64.

The bin index rounds and the |W| threshold is a hard cut, so a roundoff
difference could move a coefficient to the next bin. Each parity test first
checks on its seed that both packages give the same bin indices, then holds
``Tx`` at 1e-10 of max|Tx| (the FFT roundoff of two FFT libraries)."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import jwave_tpu as jw  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402

from torch_parity import assert_close  # noqa: E402

jssq = importlib.import_module("jwave_tpu.transforms.ssq")
tssq = importlib.import_module("jwave_tpu_torch.transforms.ssq")

FFT = 1e-10
FS = 1000.0
SCALES = jw.generate_log_scales(0.002, 0.2, 64)  # 5..500 Hz for Morlet(1,1)


def tone(f0, n=1024, phase=0.0):
    t = np.arange(n) / FS
    return np.cos(2 * np.pi * f0 * t + phase)


def two_tone(n=1024):
    return tone(40.0, n) + 0.5 * tone(150.0, n, phase=1.0)


def _bins(x, scales, wav_t, wav_j, frequencies=None, out_of_range="clip"):
    """(port, JAX) bin indices of ``ssq_cwt``'s default threshold on ``x``,
    each package computing its own W and dW/db (JAX's lines of ssq_cwt up to
    the index, written out with its own functions)."""
    from jwave_tpu.transforms.fft import fft as jfft_any, ifft as jifft_any

    jcwt = importlib.import_module("jwave_tpu.transforms.cwt")
    freqs = tssq._default_bins(np.asarray(scales), wav_t.center_frequency, frequencies)
    wgt = np.asarray(scales) ** -0.5 * tssq._log_measure(np.asarray(scales))
    n, s = x.shape[-1], len(scales)
    W, dW = tssq._cwt_and_derivative(torch.tensor(x), np.asarray(scales), wav_t, FS,
                                     jt.PaddingType.SYMMETRIC)
    eps = float(np.finfo(np.float64).eps)
    g = 10.0 * np.sqrt(eps) * (W.real ** 2 + W.imag ** 2).amax(dim=(-2, -1), keepdim=True).sqrt()
    k_t = tssq._reassign_inputs(W, dW, wgt, freqs, g, out_of_range)[1].numpy()

    p = 1 << (n - 1).bit_length()
    spec = jfft_any(jcwt.pad_signal(jnp.asarray(x), p, jw.PaddingType.SYMMETRIC))
    om = jnp.asarray(jcwt._omega_axis(p, FS))
    w_hat = jnp.conj(wav_j.psi_hat_scaled(om[None, :], jnp.asarray(scales)[:, None]))
    bank = jnp.concatenate([w_hat, w_hat * (1j * om)[None, :]], axis=0)
    out = jifft_any(spec[..., None, :] * bank)[..., :n]
    Wj, dWj = out[..., :s, :], out[..., s:, :]
    m2 = jnp.real(Wj) ** 2 + jnp.imag(Wj) ** 2
    gj = 10.0 * jnp.sqrt(eps) * jnp.sqrt(jnp.max(m2, axis=(-2, -1), keepdims=True))
    f_inst = jnp.imag(dWj * jnp.conj(Wj)) / jnp.where(m2 > 0, m2, 1.0) / (2.0 * np.pi)
    keep = m2 > gj * gj
    if out_of_range == "drop":
        keep = keep & (f_inst > 0)
    k = jssq._bin_index(jnp.where(keep & (f_inst > 0), f_inst, freqs[0]), freqs)
    if out_of_range == "clip":
        k = jnp.where(keep, jnp.clip(k, 0, len(freqs) - 1), len(freqs))
    else:
        k = jnp.where(keep & (k >= 0) & (k < len(freqs)), k, len(freqs))
    return k_t, np.asarray(k)


@pytest.mark.parametrize("reassign", ["auto", "scatter", "dense"])
@pytest.mark.parametrize("out_of_range", ["clip", "drop"])
def test_ssq_cwt_matches_jax(reassign, out_of_range):
    x = two_tone()
    wt, wj = jt.MorletWavelet(1, 1), jw.MorletWavelet(1, 1)
    k_t, k_j = _bins(x, SCALES, wt, wj, out_of_range=out_of_range)
    assert np.array_equal(k_t, k_j)
    got = jt.ssq_cwt(torch.tensor(x), SCALES, wt, FS, out_of_range=out_of_range,
                     reassign=reassign)
    want = jw.ssq_cwt(jnp.asarray(x), SCALES, wj, FS, out_of_range=out_of_range,
                      reassign="scatter" if reassign == "auto" else reassign)
    assert got.Tx.dtype == torch.complex128
    assert_close(got.Tx, want.Tx, FFT, "Tx")
    assert_close(got.frequencies, want.frequencies, 1e-15, "frequencies")
    assert_close(got.scales, want.scales, 0.0, "scales")
    assert_close(got.time_axis, want.time_axis, 1e-15, "time axis")
    assert got.wavelet_name == want.wavelet_name and got.sampling_rate == want.sampling_rate
    assert got.n_freqs == 64 and got.n_time == 1024


@pytest.mark.parametrize("frequencies", [None, 32, "linear"])
def test_bin_indices_agree_and_grids(frequencies):
    """Both packages give the same bin indices, for log (None, int) and
    explicit linear grids (the affine map and the midpoint search), and then
    the same Tx; the two _bin_index functions agree on the same input too."""
    x = two_tone()
    grid = np.linspace(10.0, 400.0, 48) if frequencies == "linear" else frequencies
    wt = jt.MorletWavelet(1, 1)
    k_t, k_j = _bins(x, SCALES, wt, jw.MorletWavelet(1, 1), frequencies=grid)
    assert np.array_equal(k_t, k_j)
    freqs = tssq._default_bins(SCALES, wt.center_frequency, grid)
    f = np.exp(np.linspace(np.log(freqs[0]) - 0.3, np.log(freqs[-1]) + 0.3, 4001))
    assert np.array_equal(tssq._bin_index(torch.tensor(f), freqs).numpy(),
                          np.asarray(jssq._bin_index(jnp.asarray(f), freqs)))
    got = jt.ssq_cwt(torch.tensor(x), SCALES, wt, FS, frequencies=grid)
    want = jw.ssq_cwt(jnp.asarray(x), SCALES, jw.MorletWavelet(1, 1), FS, frequencies=grid)
    assert_close(got.Tx, want.Tx, FFT, "Tx")
    assert_close(got.frequencies, want.frequencies, 1e-15, "grid")


def test_pallas_route_matches_jax_interpret(monkeypatch):
    """reassign="pallas": the port casts to complex64 and takes K6's plain
    version on the CPU; JAX runs its Pallas kernel in interpret mode. Both
    sum in float32: bound 1e-5 of max|Tx|."""
    from jax.experimental import pallas as pl

    from jwave_tpu.ops import pallas_reassign as pr

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(pr.pl, "pallas_call", patched)
    x = two_tone(512)
    got = jt.ssq_cwt(torch.tensor(x), SCALES[::2], "morlet", FS, reassign="pallas")
    want = jw.ssq_cwt(jnp.asarray(x), SCALES[::2], "morlet", FS, reassign="pallas")
    assert got.Tx.dtype == torch.complex64
    assert_close(got.Tx, np.asarray(want.Tx), 1e-5, "Tx")


@pytest.mark.parametrize("wavelet", ["paul", "morse"])
def test_other_analytic_wavelets_match_jax(wavelet):
    wt, wj = jt.get_continuous_wavelet(wavelet), jw.get_continuous_wavelet(wavelet)
    fc = wt.center_frequency
    sc = jw.generate_log_scales(fc / 400.0, fc / 8.0, 48)
    x = tone(60.0, 512)
    got = jt.ssq_cwt(torch.tensor(x), sc, wt, FS)
    want = jw.ssq_cwt(jnp.asarray(x), sc, wj, FS)
    assert_close(got.Tx, want.Tx, FFT, "Tx")
    assert_close(jt.issq_cwt(got, wt), jw.issq_cwt(want, wj), FFT, "issq")


def test_batched_gamma_and_padding():
    xs = np.stack([tone(40.0, 512), tone(120.0, 512)])
    got = jt.ssq_cwt(torch.tensor(xs), SCALES, "morlet", FS, gamma=0.05,
                     padding=jt.PaddingType.ZERO)
    want = jw.ssq_cwt(jnp.asarray(xs), SCALES, "morlet", FS, gamma=0.05,
                      padding=jw.PaddingType.ZERO)
    assert tuple(got.Tx.shape) == (2, 64, 512)
    assert_close(got.Tx, want.Tx, FFT, "Tx")
    one = jt.ssq_cwt(torch.tensor(xs[1]), SCALES, "morlet", FS, gamma=0.05,
                     padding=jt.PaddingType.ZERO)
    assert_close(got.Tx[1], one.Tx, 1e-12, "batched row")


def test_issq_cwt_matches_jax_and_bands():
    n = 2048
    x = tone(40.0, n) + 0.5 * tone(150.0, n, phase=1.0)
    sc = jw.generate_log_scales(0.002, 0.2, 128)
    wt, wj = jt.MorletWavelet(1, 1), jw.MorletWavelet(1, 1)
    got = jt.ssq_cwt(torch.tensor(x), sc, wt, FS)
    want = jw.ssq_cwt(jnp.asarray(x), sc, wj, FS)
    assert tssq.one_integral_constant(wt) == jssq.one_integral_constant(wj)
    full = jt.issq_cwt(got, wt)
    assert_close(full, jw.issq_cwt(want, wj), FFT, "full")
    interior = slice(n // 8, -n // 8)
    assert np.abs(full.numpy() - x)[interior].max() < 2e-3  # test_ssq.py's bound
    lo = jt.issq_cwt(got, wt, band=(20.0, 80.0))
    assert_close(lo, jw.issq_cwt(want, wj, band=(20.0, 80.0)), FFT, "band tuple")
    mask = np.zeros(tuple(got.Tx.shape), bool)
    mask[: got.n_freqs // 2] = True
    assert_close(jt.issq_cwt(got, wt, band=mask), jw.issq_cwt(want, wj, band=mask), FFT, "mask")
    with pytest.warns(UserWarning):
        by_name = jt.issq_cwt(got)
    assert_close(by_name, full, 0.0, "by name")


def test_extract_ridge_and_tube_match_jax():
    n = 1024
    x = tone(40.0, n) + 0.8 * tone(160.0, n, phase=0.9)
    got = jt.ssq_cwt(torch.tensor(x), SCALES, "morlet", FS)
    want = jw.ssq_cwt(jnp.asarray(x), SCALES, "morlet", FS)
    idx, freqs = jt.extract_ridge(got, n_ridges=2, tube_width=3)
    idx_j, freqs_j = jw.extract_ridge(want, n_ridges=2, tube_width=3)
    assert tuple(idx.shape) == (2, n)
    assert np.array_equal(idx.numpy(), np.asarray(idx_j))
    assert_close(freqs, freqs_j, 1e-15, "ridge frequencies")
    mid = slice(n // 4, 3 * n // 4)
    meds = sorted(float(np.median(freqs[r].numpy()[mid])) for r in range(2))
    assert abs(meds[0] - 40.0) / 40.0 < 0.05 and abs(meds[1] - 160.0) / 160.0 < 0.05
    m = jt.ridge_tube_mask(got, idx[0], tube_width=4)
    assert np.array_equal(m.numpy(), np.asarray(jw.ridge_tube_mask(want, idx_j[0], tube_width=4)))
    assert_close(jt.issq_cwt(got, "morlet", band=m), jw.issq_cwt(want, "morlet", band=m),
                 FFT, "tube reconstruction")
    assert_close(got.ridge(), want.ridge(), 1e-15, "argmax ridge")


def test_batched_ridges_match_jax():
    xs = np.stack([tone(30.0, 256), tone(120.0, 256)])
    got = jt.ssq_cwt(torch.tensor(xs), SCALES, "morlet", FS)
    want = jw.ssq_cwt(jnp.asarray(xs), SCALES, "morlet", FS)
    idx, _ = jt.extract_ridge(got, penalty=3.0)
    idx_j, _ = jw.extract_ridge(want, penalty=3.0)
    assert tuple(idx.shape) == (2, 1, 256)
    assert np.array_equal(idx.numpy(), np.asarray(idx_j))


def test_error_cases_match_jax():
    """test_ssq.py's guards: non-analytic wavelets, one scale, bad grids,
    bad routes and modes, empty bands, no ridges, 64-bit into the kernel."""
    x = torch.tensor(tone(50.0, 512))
    for wav in (jt.MexicanHatWavelet(), jt.MorletWavelet(1.0, 0.3)):
        with pytest.raises(jt.JWaveFailure):
            jt.ssq_cwt(x, SCALES, wav, FS)
    assert jt.MorletWavelet(1.0, 1.0).is_analytic
    with pytest.raises(jt.JWaveFailure):
        jt.ssq_cwt(x, SCALES[:1], "morlet", FS)
    grid = np.linspace(10.0, 400.0, 64)
    with pytest.raises(jt.JWaveFailure):
        jt.ssq_cwt(x, SCALES, "morlet", FS, frequencies=grid[::-1])
    with pytest.raises(jt.JWaveFailure):
        jt.ssq_cwt(x, SCALES, "morlet", FS, frequencies=1)
    with pytest.raises(jt.JWaveFailure):
        jt.ssq_cwt(x, SCALES, "morlet", FS, reassign="sorted")
    with pytest.raises(jt.JWaveFailure):
        jt.ssq_cwt(x, SCALES, "morlet", FS, out_of_range="nearest")
    res = jt.ssq_cwt(x, SCALES, "morlet", FS)
    with pytest.raises(jt.JWaveFailure):
        jt.issq_cwt(res, "morlet", band=(1e6, 2e6))
    with pytest.raises(jt.JWaveFailure):
        jt.extract_ridge(res, n_ridges=0)
    from jwave_tpu_torch.ops import cuda_reassign

    with pytest.raises(jt.JWaveFailure, match="float32"):
        cuda_reassign.reassign(torch.zeros((4, 128), dtype=torch.complex128),
                               torch.zeros((4, 128), dtype=torch.int32), 8)


def test_float32_signal_gives_complex64_and_keeps_the_column_sum():
    """A float32 signal stays complex64 all the way (the bank is cast before
    the product), and with out_of_range="clip" each column of Tx sums to the
    weighted scale sum of the kept coefficients."""
    x = torch.tensor(two_tone(1024), dtype=torch.float32)
    res = jt.ssq_cwt(x, SCALES, "morlet", FS)
    assert res.Tx.dtype == torch.complex64 and res.time_axis.dtype == torch.float32
    wav = jt.MorletWavelet(1, 1)
    W, dW = tssq._cwt_and_derivative(x, SCALES, wav, FS, jt.PaddingType.SYMMETRIC)
    assert W.dtype == torch.complex64
    mag2 = W.real ** 2 + W.imag ** 2
    g = 10.0 * np.sqrt(np.finfo(np.float32).eps) * mag2.amax(dim=(-2, -1), keepdim=True).sqrt()
    freqs = tssq._default_bins(SCALES, wav.center_frequency, None)
    wgt = SCALES ** -0.5 * tssq._log_measure(SCALES)
    contrib, k = tssq._reassign_inputs(W, dW, wgt, freqs, g, "clip")
    kept = torch.where(k < 64, contrib, 0).sum(dim=-2)
    assert_close(res.Tx.sum(dim=-2), kept, 1e-5, "column sums")
