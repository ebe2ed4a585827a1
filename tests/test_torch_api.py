"""The jwave_tpu_torch facade against jwave_tpu's, and the slice whole: the
step of __graft_entry__.entry() (MODWT db4 L5 then its inverse on a batched
float32 signal) through both packages on the same input."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import jwave_tpu as jw  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402

from torch_parity import assert_close  # noqa: E402


def test_haar_fwt_of_ones():
    """Reference demo: the Haar FWT of ones(16) is [4, 0, ...] and reverses to ones."""
    t = jt.TransformBuilder.create("Fast Wavelet Transform", "Haar", device="cpu")
    y = t.forward(np.ones(16))
    assert y.device.type == "cpu"
    want = np.zeros(16)
    want[0] = 4.0
    assert_close(y, want, 1e-12, "forward")
    assert_close(t.reverse(y), np.ones(16), 1e-12, "reverse")


def test_modwt_db4_round_trip(rng):
    m = jt.MODWTTransform("db4", device="cpu")
    sig = rng.standard_normal(777)
    c = m.forward_modwt(sig, 4)
    assert tuple(c.shape) == (5, 777)
    assert_close(c, jw.MODWTTransform("db4").forward_modwt(sig, 4), 1e-12, "coefficients")
    assert_close(m.inverse_modwt(c), sig, 1e-12, "round trip")
    assert tuple(m.inverse_modwt(torch.zeros((3, 0, 5))).shape) == (3, 0)
    assert tuple(m.inverse_modwt(None).shape) == (0,)


@pytest.mark.parametrize("shape", [(1024,), (64, 128), (8, 16, 32)])
def test_builder_fwt_matches_jax_facade(shape, rng):
    x = rng.standard_normal(shape)
    t = jt.TransformBuilder.create("Fast Wavelet Transform", "db4", device="cpu")
    tj = jw.TransformBuilder.create("Fast Wavelet Transform", "db4")
    y = t.forward(x)
    assert_close(y, tj.forward(x), 1e-12, "forward")
    assert_close(t.reverse(y), tj.reverse(np.asarray(y)), 1e-12, "reverse")
    assert_close(t.reverse(y), x, 1e-10, "round trip")


def test_builder_levels_and_modwt_facade(rng):
    x = rng.standard_normal((64, 128))
    t = jt.TransformBuilder.create("Fast Wavelet Transform", "sym8", device="cpu")
    tj = jw.TransformBuilder.create("Fast Wavelet Transform", "sym8")
    assert_close(t.forward(x, 2, 3), tj.forward(x, 2, 3), 1e-12, "2D levels")
    assert_close(t.decompose(x[0]), tj.decompose(x[0]), 1e-12, "decompose")
    m = jt.TransformBuilder.create("MODWT", "db4", device="cpu")
    mj = jw.TransformBuilder.create("MODWT", "db4")
    s = rng.standard_normal(256)
    assert_close(m.forward(s), mj.forward(s), 1e-12, "flattened modwt")
    assert_close(m.reverse(m.forward(s)), s, 1e-12, "flattened round trip")
    assert jt.TransformBuilder.identify(m) == jw.TransformBuilder.identify(mj)
    assert jt.TransformBuilder.identify(t) == "Fast Wavelet Transform"


def test_complex_input_bridges(rng):
    z = rng.standard_normal(32) + 1j * rng.standard_normal(32)
    b = jt.FastWaveletTransform("db4")
    got = b.forward(torch.tensor(z))
    assert_close(got, jw.FastWaveletTransform("db4").forward(z), 1e-12, "complex forward")
    assert_close(b.reverse(got), z, 1e-10, "complex round trip")


def test_unported_transform_names_raise():
    for name in ("Wavelet Packet Transform", "Lifting Wavelet Transform", "nope"):
        with pytest.raises(jt.JWaveNotKnown, match="not ported yet"):
            jt.TransformBuilder.create(name, "db4")


@pytest.mark.parametrize("entry", ["as_tensor", "modwt", "facade", "SlidingState.from_numpy"])
def test_numpy_input_goes_to_the_card_by_default(entry):
    """Numpy input with no ``device`` becomes a tensor on "cuda". Without a
    card that raises torch's own error: nothing quietly runs on the CPU."""
    from jwave_tpu_torch.ops.butterfly import as_tensor

    x = np.ones(16)
    calls = {
        "as_tensor": lambda: as_tensor(x),
        "modwt": lambda: jt.modwt(x, "db4", 2),
        "facade": lambda: jt.TransformBuilder.create("Fast Wavelet Transform", "Haar").forward(x),
        "SlidingState.from_numpy":
            lambda: jt.SlidingState.from_numpy([x[:7]], np.ones((2, 16)), x).coeffs,
    }
    if torch.cuda.is_available():
        assert calls[entry]().is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            calls[entry]()


def test_device_argument():
    t = jt.TransformBuilder.create("Fast Wavelet Transform", "Haar", device="meta")
    assert t.get_basic_transform().device.type == "meta"
    cpu = torch.ones(8)
    assert jt.fwt(cpu, "Haar").device.type == "cpu"


def test_wrappers_raise_instead_of_falling_back():
    """A tensor that is neither on the CPU nor on CUDA reaches no plain path."""
    from jwave_tpu_torch.ops import cuda_modwt, cuda_pyramid

    g0, h0 = np.ones(2) / 2, np.ones(2) / 2
    x = torch.empty((2, 64), device="meta")
    with pytest.raises(jt.JWaveFailure):
        cuda_modwt.modwt_cascade(x, g0, h0, 2)
    with pytest.raises(jt.JWaveFailure):
        cuda_modwt.imodwt_cascade(torch.empty((2, 3, 64), device="meta"), g0, h0)
    with pytest.raises(jt.JWaveFailure):
        cuda_pyramid.pyramid_rows(x, g0, h0, 2)
    with pytest.raises(jt.JWaveFailure):
        cuda_pyramid.pyramid_rows_transposed(x, g0, h0, 2)
    with pytest.raises(jt.JWaveFailure):
        cuda_pyramid.ipyramid_rows_transposed(x, g0, h0, 1.0, 2)
    from jwave_tpu_torch.ops import cuda_reassign

    with pytest.raises(jt.JWaveFailure):
        cuda_reassign.reassign(torch.empty((3, 64), dtype=torch.complex64, device="meta"),
                               torch.empty((3, 64), dtype=torch.int32, device="meta"), 4)


def test_slice_whole_matches_entry():
    """__graft_entry__.entry()'s step through JAX against the port on the same
    (8, 4096) float32 input. Both run f32 (FFT cascade on the CPU; the f32
    roundoff of two different FFT libraries), so the bound is 1e-5 of the
    largest value for the coefficients and 1e-5 absolute on the
    reconstruction of a unit-variance signal."""
    import __graft_entry__ as entry_mod

    fn, (x_j,) = entry_mod.entry()
    back_j, coeffs_j = jax.jit(fn)(x_j)
    x = np.asarray(x_j)
    assert x.dtype == np.float32 and x.shape == (8, 4096)
    coeffs = jt.modwt(torch.tensor(x), "Daubechies 4", 5)
    back = jt.imodwt(coeffs, "Daubechies 4")
    assert coeffs.dtype == torch.float32 and tuple(coeffs.shape) == (8, 6, 4096)
    assert_close(coeffs, np.asarray(coeffs_j, dtype=np.float64), 1e-5, "coefficients")
    assert_close(back, np.asarray(back_j, dtype=np.float64), 1e-5, "reconstruction")
    assert_close(back, x.astype(np.float64), 1e-5, "round trip")
    # the cascade kernels' plain versions on the same input agree as well
    c2 = jt.modwt(torch.tensor(x), "Daubechies 4", 5, method=jt.ConvolutionMethod.PALLAS)
    assert_close(c2, np.asarray(coeffs_j, dtype=np.float64), 1e-5, "cascade coefficients")
    b2 = jt.imodwt(c2, "Daubechies 4", method=jt.ConvolutionMethod.PALLAS)
    assert_close(b2, x.astype(np.float64), 1e-5, "cascade round trip")
