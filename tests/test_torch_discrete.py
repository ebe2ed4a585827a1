"""jwave_tpu_torch's arbitrary-length drivers and small discrete modules
against jwave_tpu, on the same seeded float64 input: the Ancient Egyptian
decomposition (functions, facade and the builder's prefix), the shifting
transform at power-of-two and odd lengths, the host numerics helpers,
compression and the value containers. Bounds (of max|ref|, absolute below
1): 1e-10 through the transforms; the helpers, the compressors' masks and
the containers exactly."""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import jwave_tpu as jw  # noqa: E402
from jwave_tpu.utils import numerics as jn  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch.utils import numerics as tn  # noqa: E402

from torch_parity import assert_close, to_np  # noqa: E402


# --------------------------------------------------------------------------
# numerics helpers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 100, 1000, 65537])
def test_numerics_helpers_match_jax(n):
    assert tn.ancient_egyptian_decompose(n) == jn.ancient_egyptian_decompose(n)
    assert tn.ancient_egyptian_compose(tn.ancient_egyptian_decompose(n)) == n
    assert tn.next_power_of_two(n) == jn.next_power_of_two(n)
    assert tn.scalb(1.5, n % 40 - 20) == jn.scalb(1.5, n % 40 - 20)
    for block in (1, 2, 64):
        if n >= block:
            assert tn.ancient_egyptian_decompose_blocked(n, block) == \
                jn.ancient_egyptian_decompose_blocked(n, block)
    for fn in ("create_sine_oscillation", "create_cosine_oscillation"):
        np.testing.assert_array_equal(getattr(tn, fn)(n, 3.0), getattr(jn, fn)(n, 3.0))


def test_numerics_errors_match_jax():
    for call in (lambda m: m.ancient_egyptian_decompose(0),
                 lambda m: m.ancient_egyptian_decompose_blocked(100, 48),
                 lambda m: m.ancient_egyptian_decompose_blocked(10, 64)):
        with pytest.raises(jw.JWaveFailure) as ej:
            call(jn)
        with pytest.raises(jt.JWaveFailure) as et:
            call(tn)
        assert str(et.value) == str(ej.value)


# --------------------------------------------------------------------------
# Ancient Egyptian decomposition
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 5, 100, 777])
def test_aed_matches_jax(n, rng):
    x = rng.standard_normal((2, n))
    got = jt.aed_forward(torch.tensor(x), lambda c: jt.fwt(c, "db2"))
    want = jax.jit(lambda a: jw.aed_forward(a, lambda c: jw.fwt(c, "db2")))(x)
    assert_close(got, want, 1e-10, "forward")
    back = jt.aed_reverse(got, lambda c: jt.ifwt(c, "db2"))
    want_back = jax.jit(lambda a: jw.aed_reverse(a, lambda c: jw.ifwt(c, "db2")))(want)
    assert_close(back, want_back, 1e-10, "reverse")
    assert_close(back, x, 1e-10, "round trip")


@pytest.mark.parametrize("inner", ["Fast Wavelet Transform", "Wavelet Packet Transform",
                                   "Lifting Wavelet Transform", ""])
def test_aed_prefix_matches_jax(inner, rng):
    name = ("Ancient Egyptian Decomposition " + inner).strip()
    wavelet = "cdf53" if inner.startswith("Lifting") else "db4"
    x = rng.standard_normal(100)
    t = jt.TransformBuilder.create(name, wavelet, device="cpu")
    tj = jw.TransformBuilder.create(name, wavelet)
    basic = t.get_basic_transform()
    assert isinstance(basic, jt.AncientEgyptianDecomposition)
    assert basic.device.type == "cpu" and basic.inner.device.type == "cpu"
    assert jt.TransformBuilder.identify(t) == jw.TransformBuilder.identify(tj)
    assert basic.get_wavelet().name == tj.get_basic_transform().get_wavelet().name
    y = t.forward(x)
    assert_close(y, tj.forward(x), 1e-10, "forward")
    assert_close(t.reverse(y), x, 1e-10, "round trip")
    assert_close(t.forward(x, 2), tj.forward(x, 2), 1e-10, "forward at level 2")


# --------------------------------------------------------------------------
# shifting
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 64, 100, 101])
@pytest.mark.parametrize("wavelet", ["Haar", "Daubechies 4"])
def test_shifting_matches_jax(wavelet, n, rng):
    """Power-of-two and odd lengths; the reverse is the JAX package's
    corrected mirror, so the round trip holds at every length."""
    x = rng.standard_normal((2, n))
    got = jt.shifting_forward(torch.tensor(x), wavelet)
    want = jax.jit(partial(jw.shifting_forward, wavelet=wavelet))(x)
    assert_close(got, want, 1e-10, "forward")
    assert_close(jt.shifting_reverse(torch.tensor(np.asarray(want)), wavelet),
                 jax.jit(partial(jw.shifting_reverse, wavelet=wavelet))(want), 1e-10, "reverse")
    assert_close(jt.shifting_reverse(got, wavelet), x, 1e-10, "round trip")


def test_shifting_facade_matches_jax(rng):
    x = rng.standard_normal((3, 100))
    t = jt.TransformBuilder.create("Shifting Wavelet Transform", "db4", device="cpu")
    tj = jw.TransformBuilder.create("Shifting Wavelet Transform", "db4")
    assert jt.TransformBuilder.identify(t) == "Shifting Wavelet Transform"
    y = t.get_basic_transform().forward(x)
    assert_close(y, tj.get_basic_transform().forward(x), 1e-10, "forward")
    assert_close(t.get_basic_transform().reverse(y), x, 1e-10, "round trip")


# --------------------------------------------------------------------------
# the builder's names
# --------------------------------------------------------------------------

def test_builder_names_match_jax():
    assert sorted(jt.TransformBuilder._NAMES) == sorted(jw.TransformBuilder._NAMES)
    for name in jw.TransformBuilder._NAMES:
        t = jt.TransformBuilder.create(name.title(), device="cpu")
        tj = jw.TransformBuilder.create(name.title())
        assert jt.TransformBuilder.identify(t) == jw.TransformBuilder.identify(tj), name
        assert type(t.get_basic_transform()).__name__ == type(tj.get_basic_transform()).__name__


# --------------------------------------------------------------------------
# compression
# --------------------------------------------------------------------------

@pytest.mark.parametrize("threshold", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("kind", ["CompressorMagnitude", "CompressorPeaksAverage"])
def test_compressors_match_jax(kind, threshold, rng):
    coeffs = np.asarray(jw.fwt(rng.standard_normal((8, 64)), "db4"))
    c, cj = getattr(jt, kind)(threshold), getattr(jw, kind)(threshold)
    got = c.compress(torch.tensor(coeffs))
    want = np.asarray(cj.compress(coeffs))
    np.testing.assert_array_equal(to_np(got) == 0.0, want == 0.0)  # the masks first
    assert_close(got, want, 0.0, "kept values")
    assert float(c.magnitude) == pytest.approx(float(cj.magnitude), rel=1e-12)
    rate = jt.Compressor.compression_rate(got)
    assert rate.dtype == torch.float64
    assert float(rate) == pytest.approx(float(jw.Compressor.compression_rate(want)), rel=1e-12)
    assert jt.Compressor.compression_rate(got.float()).dtype == torch.float32


def test_compressor_rejects_a_threshold_like_jax():
    for m in (jw, jt):
        with pytest.raises(m.JWaveFailure, match="threshold should be larger than zero"):
            m.CompressorMagnitude(0.0)


# --------------------------------------------------------------------------
# datatypes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind, dims", [("Line", (5,)), ("LineFull", (5,)), ("LineHash", (5,)),
                                        ("Block", (3, 4)), ("BlockFull", (3, 4)),
                                        ("BlockHash", (3, 4)), ("Space", (2, 3, 4)),
                                        ("SpaceFull", (2, 3, 4)), ("SpaceHash", (2, 3, 4))])
def test_containers_match_jax(kind, dims):
    offsets = tuple(range(1, len(dims) + 1))
    c, cj = getattr(jt, kind)(*dims, *offsets), getattr(jw, kind)(*dims, *offsets)
    for m, box in ((jt, c), (jw, cj)):
        assert not box.is_allocated
        if m is jt or not kind.endswith("Hash"):  # JAX's sparse get reads None first
            with pytest.raises(m.JWaveNotAllocated):
                box.get(*offsets)
        box.alloc()
        box.set(*offsets, 2.5)
        box.set(*(o + d - 1 for o, d in zip(offsets, dims)), -1.0)
        with pytest.raises(m.JWaveNotValid):
            box.get(*(o - 1 for o in offsets))
    np.testing.assert_array_equal(c.to_numpy(), cj.to_numpy())
    assert c.get(*offsets) == cj.get(*offsets) == 2.5
    if kind.endswith("Hash"):
        assert c.stored == cj.stored == 2
        c.set(*offsets, 0.0)
        assert c.stored == 1
    else:
        t = c.to_torch(device="cpu")
        assert t.dtype == torch.float64 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), cj.to_numpy())
    c.erase()
    assert not c.is_allocated
    with pytest.raises(jt.JWaveNotValid):
        getattr(jt, kind)(*((0,) + dims[1:]))


def test_complex_bridges_match_jax(rng):
    z = rng.standard_normal((2, 5)) + 1j * rng.standard_normal((2, 5))
    inter = jt.complex_to_interleaved(z)
    np.testing.assert_array_equal(inter, jw.complex_to_interleaved(z))
    np.testing.assert_array_equal(jt.interleaved_to_complex(inter),
                                  jw.interleaved_to_complex(inter))
    np.testing.assert_array_equal(jt.interleaved_to_complex(inter), z)
