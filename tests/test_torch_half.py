"""Half-precision input on the port's FFT paths, against jwave_tpu on the
same seeded numpy input. ``torch.fft`` takes neither bfloat16 nor float16,
so these paths promote half input to float32 at their entry, as the JAX
package computes them; the output dtype follows what the JAX package gives
with 64-bit mode off: complex64 for the transforms, float32 for the real
planes and reconstructions, the input's dtype for ``ewt``/``iewt``/``vmd``
(computed in float32, cast back).

Bound: 1e-2 of max|ref|. Both packages start from the same half-precision
values (exact in float32), so they differ by float32 roundoff, except where
the output is cast back to bfloat16 (2^-9 relative)."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import jwave_tpu as jw  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402

from torch_parity import assert_close  # noqa: E402

jfft = importlib.import_module("jwave_tpu.transforms.fft")
tfft = importlib.import_module("jwave_tpu_torch.transforms.fft")

HALF_BOUND = 1e-2
SCALES = [2.0, 4.0, 8.0]
SSQ_SCALES = np.array([2.0, 3.0, 4.0, 6.0, 8.0])
FREQS = np.array([0.1, 0.2])
BOUNDS = [0.5, 1.5]
C64, F32, SAME = "complex64", "float32", "input"


def _flip(a):
    return a.flip(0) if hasattr(a, "flip") else a[::-1]


# name -> (function of (package, fft module, input), the port's output dtype)
CASES = {
    "fft": (lambda m, f, a: f.fft(a), C64),
    "ifft": (lambda m, f, a: f.ifft(a), C64),
    "cwt": (lambda m, f, a: m.cwt(a, SCALES).coefficients, C64),
    "cwt_chunked": (lambda m, f, a: m.cwt_chunked(a, SCALES, scale_chunk=2).coefficients, C64),
    "cwt_direct": (lambda m, f, a: m.cwt_direct(a, SCALES).coefficients, C64),
    "xwt": (lambda m, f, a: m.xwt(a, _flip(a), SCALES).coefficients, C64),
    "ssq_cwt": (lambda m, f, a: m.ssq_cwt(a, SSQ_SCALES, "morlet", 1.0).Tx, C64),
    "analytic_signal": (lambda m, f, a: m.analytic_signal(a), C64),
    "icwt": (lambda m, f, a: m.icwt(m.cwt(a, SCALES), "morlet"), F32),
    "issq_cwt": (lambda m, f, a: m.issq_cwt(m.ssq_cwt(a, SSQ_SCALES, "morlet", 1.0), "morlet"),
                 F32),
    "wavelet_coherence": (lambda m, f, a: m.wavelet_coherence(a, _flip(a), SCALES)[0], F32),
    "envelope": (lambda m, f, a: m.envelope(a), F32),
    "instantaneous_frequency": (lambda m, f, a: m.instantaneous_frequency(a, 10.0), F32),
    "superlet": (lambda m, f, a: m.superlet(a, FREQS, 1.0, order_max=3), F32),
    "wigner_ville": (lambda m, f, a: m.wigner_ville(a, 1.0, n_bins=32)[0], F32),
    "ewt": (lambda m, f, a: m.ewt(a, boundaries=BOUNDS).modes, SAME),
    "vmd": (lambda m, f, a: m.vmd(a, 2, n_iter=2).modes, SAME),
}


def _half_input(rng, dtype):
    """(torch half tensor, the same values as a jax half array)."""
    t = np.arange(256) / 256.0
    x = np.cos(2 * np.pi * 12 * t) + 0.5 * np.cos(2 * np.pi * 40 * t + 1.0) \
        + 0.2 * rng.standard_normal((2, 256))
    xt = torch.tensor(x).to(dtype)
    xj = jnp.asarray(xt.to(torch.float32).numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16)
    return xt, xj


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("name", list(CASES))
def test_half_input_on_the_fft_paths_matches_jax(name, dtype, rng):
    fn, out = CASES[name]
    xt, xj = _half_input(rng, dtype)
    got = fn(jt, tfft, xt)
    want = {C64: torch.complex64, F32: torch.float32, SAME: dtype}[out]
    assert got.dtype == want, f"{name}: {got.dtype}"
    ref = np.asarray(fn(jw, jfft, xj)).astype(np.complex128 if out == C64 else np.float64)
    assert_close(got, ref, HALF_BOUND, name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_ssq_plane_iewt_and_vmd_fields_with_half_input(dtype, rng):
    """What the per-function cases do not read: the squeezed plane, the
    EWT's detected boundaries and adjoint, VMD's centre frequencies (input
    dtype) and convergence trace (float32)."""
    xt, xj = _half_input(rng, dtype)
    tx = jt.ssq_cwt(xt, SSQ_SCALES, "morlet", 1.0).Tx
    assert tx.dtype == torch.complex64 and tuple(tx.shape) == (2, 5, 256)
    res, ref = jt.ewt(xt, 3), jw.ewt(xj, 3)
    np.testing.assert_array_equal(res.boundaries, ref.boundaries)
    back = jt.iewt(res)
    assert back.dtype == dtype
    assert_close(back, np.asarray(jw.iewt(ref)).astype(np.float64), HALF_BOUND, "iewt")
    v, vr = jt.vmd(xt, 2, n_iter=5), jw.vmd(xj, 2, n_iter=5)
    assert v.omegas.dtype == dtype and v.convergence.dtype == torch.float32
    assert_close(v.omegas, np.asarray(vr.omegas).astype(np.float64), HALF_BOUND, "omegas")
    assert_close(v.convergence, np.asarray(vr.convergence).astype(np.float64), HALF_BOUND,
                 "convergence")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_paths_that_raise_in_both_packages_still_raise(dtype, rng):
    xt, xj = _half_input(rng, dtype)
    for fn in (lambda m, a: m.modwt(a, "db4", 2, method=m.ConvolutionMethod.FFT),
               lambda m, a: m.matching_pursuit(a, 2)):
        with pytest.raises(Exception):
            fn(jw, xj)
        with pytest.raises(Exception):
            fn(jt, xt)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_discrete_paths_keep_half_precision(dtype, rng):
    """``ensure_float`` is untouched: MODWT, FWT and ``denoise`` (``sure``
    too: neither package raises on it) keep the half dtype in both
    packages."""
    xt, xj = _half_input(rng, dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    for name, fn in (("modwt", lambda m, a: m.modwt(a, "db4", 2)),
                     ("fwt", lambda m, a: m.fwt(a, "db4", 2)),
                     ("denoise sure", lambda m, a: m.denoise(a, "db4", 2, method="sure"))):
        got, ref = fn(jt, xt), fn(jw, xj)
        assert got.dtype == dtype and ref.dtype == jdt, name


def test_ensure_fft_float_rule():
    from jwave_tpu_torch.ops.butterfly import ensure_float, ensure_fft_float

    for dt, want in ((torch.bfloat16, torch.float32), (torch.float16, torch.float32),
                     (torch.float32, torch.float32), (torch.float64, torch.float64),
                     (torch.int32, torch.float32), (torch.complex64, torch.complex64)):
        assert ensure_fft_float(torch.zeros(4, dtype=dt)).dtype == want
    assert ensure_float(torch.zeros(4, dtype=torch.bfloat16)).dtype == torch.bfloat16


@pytest.mark.parametrize("dtype,cdtype", [(torch.float64, torch.complex128),
                                          (torch.float32, torch.complex64),
                                          (torch.bfloat16, torch.complex64)])
def test_cwt_with_no_scales(dtype, cdtype, rng):
    x = rng.standard_normal((3, 100))
    res = jt.cwt(torch.tensor(x).to(dtype), [], "morlet", 10.0)
    ref = jw.cwt(jnp.asarray(x), [], "morlet", 10.0)
    assert tuple(res.coefficients.shape) == tuple(ref.coefficients.shape) == (3, 0, 100)
    assert res.coefficients.dtype == cdtype
    assert res.coefficients.dtype == jt.cwt(torch.tensor(x).to(dtype), [2.0]).coefficients.dtype
    assert tuple(res.scales.shape) == tuple(ref.scales.shape) == (0,)
    assert_close(res.time_axis, ref.time_axis, 1e-6, "time axis")
    assert res.n_scales == 0 and res.n_time == 100 and res.wavelet_name == ref.wavelet_name


@pytest.mark.parametrize("name", ["cwt_direct", "cwt_chunked", "ssq_cwt"])
def test_other_transforms_with_no_scales_raise_in_both(name, rng):
    x = rng.standard_normal(64)
    with pytest.raises(Exception):
        getattr(jw, name)(jnp.asarray(x), np.array([]))
    with pytest.raises(Exception):
        getattr(jt, name)(torch.tensor(x), np.array([]))
