"""jwave_tpu_torch MODWT against jwave_tpu: the transform in float64 at
1e-12, and the plain versions of the cascade kernels K1/K2 against the
Pallas kernels they replace (interpret mode) and the JAX DIRECT path."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import jwave_tpu as jw  # noqa: E402
from jwave_tpu.ops import pallas_modwt as pm  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch.ops import cuda_modwt  # noqa: E402

from torch_parity import assert_close  # noqa: E402

# the packages re-export the function `modwt` under the module's name
jm = importlib.import_module("jwave_tpu.transforms.modwt")
tm = importlib.import_module("jwave_tpu_torch.transforms.modwt")

M = jt.ConvolutionMethod


@pytest.mark.parametrize("method", ["AUTO", "DIRECT", "FFT"])
@pytest.mark.parametrize("boundary", ["periodic", "reflection"])
@pytest.mark.parametrize("n,level", [(777, 1), (777, 5), (777, 9), (4096, 1), (4096, 5), (4096, 9)])
def test_modwt_imodwt_match_jax(method, boundary, n, level, rng):
    x = rng.standard_normal((2, n))
    kw = dict(method=getattr(M, method))
    jkw = dict(method=getattr(jw.ConvolutionMethod, method))
    got = jt.modwt(torch.tensor(x), "Daubechies 4", level, boundary=boundary, truncate=False, **kw)
    want = jw.modwt(x, "Daubechies 4", level, boundary=boundary, truncate=False, **jkw)
    assert_close(got, want, 1e-12, "modwt")
    assert_close(jt.imodwt(got, "Daubechies 4", **kw), jw.imodwt(want, "Daubechies 4", **jkw),
                 1e-12, "imodwt")
    if boundary == "reflection":
        assert_close(jt.modwt(torch.tensor(x), "db4", level, boundary=boundary, **kw),
                     jw.modwt(x, "db4", level, boundary=boundary, **jkw), 1e-12, "truncated")


def test_per_level_auto_routing_matches(rng):
    for name, n, level in (("Haar", 300, 6), ("db4", 128, 5), ("sym8", 1000, 3)):
        for thr in (16, 4096, 10**6):
            assert tm._direct_prefix_levels(name, level, n, M.AUTO, thr) == \
                jm._direct_prefix_levels(name, level, n, jw.ConvolutionMethod.AUTO, thr)
        x = rng.standard_normal((n,))
        assert_close(jt.modwt(torch.tensor(x), name, level, fft_threshold=2000),
                     jw.modwt(x, name, level, fft_threshold=2000), 1e-12, name)


@pytest.mark.parametrize("name", ["Haar", "Daubechies 4", "Discrete Meyer", "Battle 23"])
def test_base_filters_equal(name):
    for a, b in zip(tm._modwt_base_filters(name), jm._modwt_base_filters(name)):
        np.testing.assert_array_equal(a, b)


def test_modwt_1d_facade_matches(rng):
    x = rng.standard_normal((2, 256))
    got = jt.modwt_1d(torch.tensor(x), "db4", 4)
    assert_close(got, jw.modwt_1d(jnp.asarray(x), "db4", 4), 1e-12, "modwt_1d")
    assert_close(jt.imodwt_1d(got, "db4"), jw.imodwt_1d(jnp.asarray(np.asarray(got)), "db4"),
                 1e-12, "imodwt_1d")
    assert_close(jt.imodwt_1d(got, "db4", 4), x, 1e-12, "round trip")


# --------------------------------------------------------------------------
# plain versions of K1/K2
# --------------------------------------------------------------------------

@pytest.fixture
def _interpret(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(pm.pl, "pallas_call", patched)
    yield


def test_plain_cascade_matches_pallas_kernels(_interpret, rng):
    """K1/K2's plain versions against modwt_pallas/imodwt_pallas, f32 (4, 256)
    db4 L4: both accumulate in f32 in a different order, so the bound is
    2e-6 of the largest reference value."""
    x = rng.standard_normal((4, 256)).astype(np.float32)
    g0, h0 = tm._modwt_base_filters("db4")
    got = cuda_modwt.modwt_cascade_torch(torch.tensor(x), g0, h0, 4)
    want = np.asarray(pm.modwt_pallas(jnp.asarray(x), "db4", 4))
    assert got.dtype == torch.float32
    assert float(np.max(np.abs(got.numpy() - want))) < 2e-6 * float(np.max(np.abs(want)))
    back = cuda_modwt.imodwt_cascade_torch(got, g0, h0)
    want_back = np.asarray(pm.imodwt_pallas(jnp.asarray(got.numpy()), "db4"))
    assert float(np.max(np.abs(back.numpy() - want_back))) < \
        2e-6 * float(np.max(np.abs(want_back)))


@pytest.mark.parametrize("name,n,level", [("Haar", 64, 6), ("db4", 777, 9),
                                          ("Discrete Meyer", 256, 5), ("Battle 23", 300, 3)])
def test_plain_cascade_matches_jax_direct(name, n, level, rng):
    """f64, including a halo longer than the signal (Discrete Meyer L5 on 256)."""
    x = rng.standard_normal((3, n))
    g0, h0 = tm._modwt_base_filters(name)
    got = cuda_modwt.modwt_cascade_torch(torch.tensor(x), g0, h0, level)
    want = jw.modwt(x, name, level, method=jw.ConvolutionMethod.DIRECT)
    assert_close(got, want, 1e-12, "K1 plain")
    assert_close(cuda_modwt.imodwt_cascade_torch(got, g0, h0),
                 jw.imodwt(want, name, method=jw.ConvolutionMethod.DIRECT), 1e-12, "K2 plain")


@pytest.mark.parametrize("method", ["PALLAS", "MXU"])
def test_cascade_methods_on_cpu_take_the_plain_version(method, rng):
    x = rng.standard_normal((2, 4, 128)).astype(np.float32)
    cuda_modwt.reset_launch_counts()
    c = jt.modwt(torch.tensor(x), "db4", 3, method=getattr(M, method))
    assert c.shape == (2, 4, 4, 128) and c.dtype == torch.float32
    want = jw.modwt(x.astype(np.float64), "db4", 3, method=jw.ConvolutionMethod.DIRECT)
    assert_close(c, want, 1e-5, "f32 cascade")
    assert_close(jt.imodwt(c, "db4", method=getattr(M, method)), x, 1e-5, "round trip")
    assert cuda_modwt.launch_counts == {"modwt_cascade": 0, "imodwt_cascade": 0}


def test_bfloat16_cascade_on_cpu(rng):
    x = torch.tensor(rng.standard_normal((2, 256)), dtype=torch.bfloat16)
    c = jt.modwt(x, "db4", 3, method=M.PALLAS)
    assert c.dtype == torch.bfloat16
    want = jw.modwt(x.double().numpy(), "db4", 3, method=jw.ConvolutionMethod.DIRECT)
    assert_close(c, want, 1e-2, "bf16 storage")


# --------------------------------------------------------------------------
# error cases, as the JAX package raises them
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,level", [(2**14, 14), (16, 5), (16, 0)])
def test_level_errors_match(n, level):
    x = np.zeros((n,))
    with pytest.raises(jw.JWaveFailure) as ej:
        jw.modwt(x, "db4", level)
    with pytest.raises(jt.JWaveFailure) as et:
        jt.modwt(torch.tensor(x), "db4", level)
    assert str(et.value) == str(ej.value)


def test_empty_signal():
    got = jt.modwt(torch.zeros((3, 0)), "db4", 4)
    assert tuple(got.shape) == tuple(jw.modwt(np.zeros((3, 0)), "db4", 4).shape) == (3, 5, 0)
    assert tuple(jt.imodwt(got, "db4").shape) == (3, 0)


@pytest.mark.parametrize("method", ["PALLAS", "MXU"])
def test_cascade_on_float64_raises(method):
    x = np.zeros((2, 256))
    with pytest.raises(jw.JWaveFailure):
        jw.modwt(x, "db4", 3, method=jw.ConvolutionMethod.PALLAS)
    with pytest.raises(jt.JWaveFailure):
        jt.modwt(torch.tensor(x), "db4", 3, method=getattr(M, method))
    with pytest.raises(jt.JWaveFailure):
        jt.imodwt(torch.zeros((2, 4, 256), dtype=torch.float64), "db4",
                  method=getattr(M, method))


def test_bad_boundary_raises():
    with pytest.raises(jt.JWaveFailure):
        jt.modwt(torch.zeros(64), "db4", 2, boundary="zero")
    with pytest.raises(jt.JWaveFailure):
        jt.imodwt(torch.zeros((1, 64)), "db4")
