"""jwave_tpu_torch.ops butterfly and circular convolutions against
jwave_tpu.ops and the numpy oracle, in float64 at 1e-12."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import oracle  # noqa: E402
from jwave_tpu.filters import get_filter  # noqa: E402
from jwave_tpu.ops import butterfly as jb  # noqa: E402
from jwave_tpu.ops import circular as jc  # noqa: E402
from jwave_tpu_torch.ops import butterfly as tb  # noqa: E402
from jwave_tpu_torch.ops import circular as tc  # noqa: E402

from torch_parity import assert_close  # noqa: E402

# Discrete Meyer (M = 62) on h = 16 wraps the filter around the block several times
BANKS = ["Haar", "Daubechies 4", "Symlet 8", "Discrete Meyer", "Battle 23"]


@pytest.mark.parametrize("name", BANKS)
@pytest.mark.parametrize("h", [16, 64])
def test_butterfly_forward(name, h, rng):
    fb = get_filter(name)
    x = rng.standard_normal((3, h))
    got = tb.butterfly_forward(torch.tensor(x), fb.dec_lo, fb.dec_hi)
    assert_close(got, jb.butterfly_forward(jnp.asarray(x), fb.dec_lo, fb.dec_hi), 1e-12, name)
    assert_close(got[1], oracle.butterfly_forward(x[1], fb.dec_lo, fb.dec_hi), 1e-12, name)


@pytest.mark.parametrize("name", BANKS + ["Haar orthogonal"])
@pytest.mark.parametrize("h", [16, 64])
def test_butterfly_reverse(name, h, rng):
    fb = get_filter(name)
    y = rng.standard_normal((3, h))
    got = tb.butterfly_reverse(torch.tensor(y), fb.rec_lo, fb.rec_hi, fb.recon_gain)
    want = jb.butterfly_reverse(jnp.asarray(y), fb.rec_lo, fb.rec_hi, fb.recon_gain)
    assert_close(got, want, 1e-12, name)
    assert_close(got[2], oracle.butterfly_reverse(y[2], fb.rec_lo, fb.rec_hi, fb.recon_gain),
                 1e-12, name)


def _level_filter(name, level):
    return oracle.upsample(oracle.modwt_base_filters(get_filter(name))[1], level)


@pytest.mark.parametrize("name,level", [("Haar", 1), ("Daubechies 4", 3),
                                        ("Symlet 8", 4), ("Discrete Meyer", 2)])
@pytest.mark.parametrize("n", [37, 256])
def test_circular_conv_forms(name, level, n, rng):
    """Direct and FFT convolution and adjoint; filters longer than the signal
    are wrapped (Discrete Meyer level 2 has 123 taps against n = 37)."""
    f = _level_filter(name, level)
    x = rng.standard_normal((2, n))
    xt, xj = torch.tensor(x), jnp.asarray(x)
    want = jc.circular_conv(xj, f)
    want_adj = jc.circular_conv_adjoint(xj, f)
    assert_close(tc.circular_conv(xt, f), want, 1e-12, "conv")
    assert_close(tc.circular_conv_adjoint(xt, f), want_adj, 1e-12, "adjoint")
    assert_close(tc.circular_conv_fft(xt, f), jc.circular_conv_fft(xj, f), 1e-12, "fft")
    assert_close(tc.circular_conv_adjoint_fft(xt, f), jc.circular_conv_adjoint_fft(xj, f),
                 1e-12, "fft adjoint")
    assert_close(tc.circular_conv_fft(xt, f), want, 1e-12, "fft vs direct")
    fw = tc.wrap_filter(f, n)
    np.testing.assert_array_equal(fw, jc.wrap_filter(f, n))
    assert_close(tc.circular_conv(xt, f)[0], oracle.circular_convolve(x[0], fw), 1e-12, "oracle")
    assert_close(tc.circular_conv_adjoint(xt, f)[0],
                 oracle.circular_convolve_adjoint(x[0], fw), 1e-12, "oracle adjoint")


def test_filter_spectrum_equal():
    f = _level_filter("Daubechies 4", 3)
    np.testing.assert_array_equal(tc.filter_spectrum(f, 64), jc.filter_spectrum(f, 64))


def test_ensure_float_promotes_integers():
    x = torch.arange(8)
    assert tb.ensure_float(x).dtype == torch.get_default_dtype()
    y = torch.ones(4, dtype=torch.float32)
    assert tb.ensure_float(y) is y


def test_as_tensor_keeps_tensors_where_they_lie():
    t = torch.zeros(3)
    assert tb.as_tensor(t) is t
    assert tb.as_tensor(np.zeros(3), device="cpu").device.type == "cpu"
    assert tb.as_tensor([1.0, 2.0], device="meta").device.type == "meta"
