"""jwave_tpu_torch's performance-variant names against jwave_tpu, on the same
seeded float64 input: the in-place FWT (which writes into the input's
storage), the pooled and parallel aliases, and the streaming MODWT. Bound:
1e-10 of max|ref| (absolute below 1)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jwave_tpu as jw  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402

from torch_parity import assert_close  # noqa: E402


def test_in_place_fwt_reuses_the_input_storage(rng):
    x = rng.standard_normal((4, 256))
    t = jt.InPlaceFastWaveletTransform("db4", device="cpu")
    buf = torch.tensor(x)
    ptr = buf.data_ptr()
    y = t.forward_in_place(buf)
    assert y is buf and y.data_ptr() == ptr
    assert_close(y, jw.InPlaceFastWaveletTransform("db4").forward_in_place(x.copy()), 1e-10,
                 "forward")
    back = t.reverse_in_place(y)
    assert back.data_ptr() == ptr
    assert_close(back, x, 1e-10, "round trip")
    assert t.name == jw.InPlaceFastWaveletTransform.name


def test_in_place_fwt_of_integers_returns_a_new_tensor():
    ints = torch.arange(16)
    y = jt.InPlaceFastWaveletTransform("Haar", device="cpu").forward_in_place(ints)
    assert y.dtype == torch.get_default_dtype() and ints.dtype == torch.int64
    assert_close(y, jw.fwt(np.arange(16.0), "Haar"), 1e-6, "integer input")


@pytest.mark.parametrize("name, base", [
    ("PooledWaveletPacketTransform", "WaveletPacketTransform"),
    ("ParallelWaveletPacketTransform", "WaveletPacketTransform"),
    ("PooledMODWTTransform", "MODWTTransform"),
    ("EfficientMODWTTransform", "MODWTTransform"),
    ("PooledFastFourierTransform", "FastFourierTransform"),
    ("ParallelDiscreteFourierTransform", "FastFourierTransform"),
])
def test_aliases_match_jax(name, base, rng):
    cls, cls_j = getattr(jt, name), getattr(jw, name)
    assert issubclass(cls, getattr(jt, base)) and cls.name == cls_j.name
    args = () if "Fourier" in name else ("db4",)
    b = cls(*args, device="cpu")
    bj = cls_j(*args)
    x = rng.standard_normal((2, 64))
    y = b.forward(x)
    assert_close(y, bj.forward(x), 1e-10, "forward")
    assert_close(b.reverse(y), bj.reverse(np.asarray(y)), 1e-10, "reverse")
    if name.startswith("Parallel") and "Packet" in name:
        assert b.shutdown() is None


def test_parallel_transform_wraps_like_jax(rng):
    img = rng.standard_normal((32, 64))
    t = jt.ParallelTransform(jt.FastWaveletTransform("db4", device="cpu"), min_size=8)
    tj = jw.ParallelTransform(jw.FastWaveletTransform("db4"), min_size=8)
    assert isinstance(t, jt.Transform) and t.min_size == tj.min_size == 8
    assert_close(t.forward(img), tj.forward(img), 1e-10, "2D forward")
    assert_close(t.reverse(t.forward(img)), img, 1e-10, "2D round trip")


@pytest.mark.parametrize("n, level, chunk", [(1000, 3, 128), (777, 2, 100), (4096, 5, 1024),
                                             (30, 3, 8)])
def test_streaming_modwt_matches_jax(n, level, chunk, rng):
    """Chunks with their circular left context equal the whole transform
    (the last case is shorter than the context: one whole transform)."""
    x = rng.standard_normal(n)
    e = jt.EfficientMODWTTransform("db4", device="cpu")
    got = e.forward_streaming(x, level, chunk)
    assert_close(got, jw.EfficientMODWTTransform("db4").forward_streaming(x, level, chunk),
                 1e-10, "streaming")
    assert_close(got, e.forward_modwt(x, level), 1e-10, "whole transform")


def test_streaming_modwt_errors_match_jax():
    for m, a in ((jw, np.asarray), (jt, torch.tensor)):
        e = m.EfficientMODWTTransform("db4", **({} if m is jw else {"device": "cpu"}))
        with pytest.raises(m.JWaveFailure, match="expects a 1-D signal"):
            e.forward_streaming(a(np.ones((2, 64))), 2, 16)
        with pytest.raises(m.JWaveFailure, match="chunk must be positive"):
            e.forward_streaming(a(np.ones(64)), 2, 0)
        with pytest.raises(m.JWaveFailure, match="level 7 exceeds"):
            e.forward_streaming(a(np.ones(64)), 7, 16)
