"""jwave_tpu_torch's wavelet packet transform and best bases against
jwave_tpu, on the same seeded float64 input.

Bounds (of max|ref|, absolute below 1): the packet transforms 1e-10 (the
same butterflies or the same composite bank, summed in another order); the
composite bank 1e-14 (the same numpy code); the interleaved layout 1e-9
against the JAX package's tile kernel, forced on with its MXU dial; bf16
1e-2 (each stored value rounds to 2^-9). Best bases compare the chosen
nodes exactly before the cost and the coefficients."""
import importlib
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import jwave_tpu as jw  # noqa: E402
from jwave_tpu.ops import composite as jcomp  # noqa: E402
jwpt = importlib.import_module("jwave_tpu.transforms.wpt")  # the package re-exports `wpt`
import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch.ops import composite as tcomp  # noqa: E402
twpt = importlib.import_module("jwave_tpu_torch.transforms.wpt")

import oracle  # noqa: E402
from torch_parity import assert_close  # noqa: E402

WAVELETS = ["Haar", "Daubechies 4", "Symlet 8", "Coiflet 3", "BiOrthogonal 3/5"]


def _jax_pair(x, wavelet, level):
    """The JAX package's wpt (fused, its default) and iwpt of it, jitted."""
    fwd = jax.jit(partial(jw.wpt, wavelet=wavelet, level=level))(x)
    inv = jax.jit(partial(jw.iwpt, wavelet=wavelet, level=level))(fwd)
    return np.asarray(fwd), np.asarray(inv)


@pytest.mark.parametrize("wavelet", WAVELETS)
def test_chunk_schedule_matches_jax(wavelet):
    fb = jt.get_filter(wavelet)
    fbj = jw.get_filter(wavelet)
    for p in range(1, 17):
        for level in range(p + 1):
            assert twpt._chunk_schedule(1 << p, level, fb) == \
                jwpt._chunk_schedule(1 << p, level, fbj), (p, level)


@pytest.mark.parametrize("wavelet", WAVELETS + ["Discrete Meyer"])
def test_composite_filters_match_jax(wavelet):
    fb = jt.get_filter(wavelet)
    for levels in range(1, 7):
        got = tcomp.composite_filters(fb.dec_lo, fb.dec_hi, levels)
        want = jcomp.composite_filters(fb.dec_lo, fb.dec_hi, levels)
        assert_close(got, want, 1e-14, f"bank L{levels}")
        for n in (8, 64):
            assert_close(tcomp._wrap_bank(got, n), jcomp._wrap_bank(want, n), 1e-14,
                         f"wrapped bank L{levels} N{n}")


@pytest.mark.parametrize("n", [8, 1024])
@pytest.mark.parametrize("wavelet", WAVELETS)
def test_wpt_matches_jax_at_every_level(wavelet, n, rng):
    """Fused (the default) and level by level, forward and inverse."""
    x = rng.standard_normal((2, n))
    for level in range(n.bit_length()):
        want, want_inv = _jax_pair(x, wavelet, level)
        for fused in (True, False):
            got = jt.wpt(torch.tensor(x), wavelet, level, fused=fused)
            assert got.dtype == torch.float64
            assert_close(got, want, 1e-10, f"wpt L{level} fused={fused}")
            back = jt.iwpt(torch.tensor(want), wavelet, level, fused=fused)
            assert_close(back, want_inv, 1e-10, f"iwpt L{level} fused={fused}")
            assert_close(jt.iwpt(got, wavelet, level, fused=fused), x, 1e-10, "round trip")


@pytest.mark.parametrize("wavelet", WAVELETS)
def test_wpt_every_size_against_the_oracle(wavelet, rng):
    """N 8 to 1024, every level, against tests/oracle.py's float64 loop."""
    fb = jt.get_filter(wavelet)
    for p in range(3, 11):
        x = rng.standard_normal(1 << p)
        for level in range(p + 1):
            want = oracle.wpt(x, fb, level)
            for fused in (True, False):
                assert_close(jt.wpt(torch.tensor(x), wavelet, level, fused=fused), want, 1e-10,
                             f"N{1 << p} L{level} fused={fused}")


@pytest.mark.parametrize("wavelet, level", [("Haar", 1), ("Haar", 6), ("Daubechies 4", 3),
                                            ("Daubechies 4", 6), ("Symlet 8", 5)])
def test_interleaved_layout_matches_jax(wavelet, level, rng):
    x = rng.standard_normal((3, 512))
    jw.config.set_mxu_butterfly("on")
    try:
        want = np.asarray(jw.wpt(x, wavelet, level, layout="interleaved"))
        want_inv = np.asarray(jw.iwpt(want, wavelet, level, layout="interleaved"))
    finally:
        jw.config.set_mxu_butterfly("auto")
    got = jt.wpt(torch.tensor(x), wavelet, level, layout="interleaved")
    assert_close(got, want, 1e-9, "interleaved forward")
    assert_close(jt.iwpt(torch.tensor(want), wavelet, level, layout="interleaved"), want_inv,
                 1e-9, "interleaved inverse")
    sub = jt.wpt(torch.tensor(x), wavelet, level)
    assert_close(jt.wpt_interleaved_to_subband(got, level), sub, 0.0, "to subband")
    assert_close(jt.wpt_subband_to_interleaved(sub, level), got, 0.0, "to interleaved")
    assert_close(jt.wpt_subband_to_interleaved(sub, level),
                 jw.wpt_subband_to_interleaved(np.asarray(sub), level), 0.0, "JAX's permutation")


@pytest.mark.parametrize("fn", ["wpt", "iwpt"])
def test_interleaved_layout_raises_with_the_dial_off_as_jax_does(fn, rng):
    """JAX's interleaved layout needs its MXU tile kernel, which the butterfly
    dial turns off: both packages raise the same failure, word for word."""
    x = rng.standard_normal((2, 256))
    jw.config.set_mxu_butterfly("off")
    jt.config.set_mxu_butterfly("off")
    try:
        with pytest.raises(jw.JWaveFailure) as want:
            getattr(jw, fn)(x, "Daubechies 2", 3, layout="interleaved")
        with pytest.raises(jt.JWaveFailure) as got:
            getattr(jt, fn)(torch.tensor(x), "Daubechies 2", 3, layout="interleaved")
    finally:
        jw.config.set_mxu_butterfly("auto")
        jt.config.set_mxu_butterfly("auto")
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    assert "and the MXU butterfly dial enabled" in str(got.value)


@pytest.mark.parametrize("case", ["N % 128", "level 0", "level 7", "composite bank > 512",
                                  "fused=False"])
def test_interleaved_layout_raises_where_jax_does(case, rng):
    n, wavelet, level, fused = {
        "N % 128": (64, "Haar", 2, True),
        "level 0": (256, "Haar", 0, True),
        "level 7": (256, "Haar", 7, True),
        "composite bank > 512": (1024, "Discrete Meyer", 4, True),
        "fused=False": (256, "Haar", 2, False),
    }[case]
    x = rng.standard_normal(n)
    jw.config.set_mxu_butterfly("on")
    try:
        for fn in (jw.wpt, jw.iwpt):
            with pytest.raises(jw.JWaveFailure, match="layout='interleaved' requires"):
                fn(x, wavelet, level, fused=fused, layout="interleaved")
    finally:
        jw.config.set_mxu_butterfly("auto")
    for fn in (jt.wpt, jt.iwpt):
        with pytest.raises(jt.JWaveFailure, match="layout='interleaved' requires"):
            fn(torch.tensor(x), wavelet, level, fused=fused, layout="interleaved")


@pytest.mark.parametrize("case", ["odd length", "level -1", "level too deep", "layout"])
def test_wpt_errors_match_jax(case):
    x, level, layout = {
        "odd length": (np.ones(100), None, "subband"),
        "level -1": (np.ones(64), -1, "subband"),
        "level too deep": (np.ones(64), 7, "subband"),
        "layout": (np.ones(64), 2, "rows"),
    }[case]
    for fwd, inv, arr in ((jw.wpt, jw.iwpt, x), (jt.wpt, jt.iwpt, torch.tensor(x))):
        msgs = []
        for fn in (fwd, inv):
            with pytest.raises((jw.JWaveFailure, jt.JWaveFailure)) as e:
                fn(arr, "db4", level, layout=layout)
            msgs.append(str(e.value))
        if fwd is jw.wpt:
            want = msgs
        else:
            assert msgs == want


def test_wpt_bfloat16_matches_jax(rng):
    """bf16 in, bf16 out, as in the JAX package with x64 off."""
    x = rng.standard_normal((2, 256)).astype(np.float32)
    xb = torch.tensor(x).to(torch.bfloat16)
    for fused in (True, False):
        want = jax.jit(partial(jw.wpt, wavelet="db4", level=6, fused=fused))(
            jnp.asarray(x, jnp.bfloat16))
        assert want.dtype == jnp.bfloat16
        got = jt.wpt(xb, "db4", 6, fused=fused)
        assert got.dtype == torch.bfloat16
        assert_close(got.float(), np.asarray(want, np.float64), 1e-2, f"bf16 fused={fused}")
        back = jt.iwpt(got, "db4", 6, fused=fused)
        assert back.dtype == torch.bfloat16
        # fused: one bf16 store of the result; level by level: one store a
        # level, six in all
        assert_close(back.float(), jt.iwpt(got.double(), "db4", 6, fused=fused),
                     1e-2 if fused else 2e-2,
                     f"bf16 inverse fused={fused} against float64 on the same coefficients")


def _two_signals(rng):
    t = np.arange(256)
    return np.stack([np.sin(2 * np.pi * t / 37.0) + 0.3 * rng.standard_normal(256),
                     np.sign(np.sin(2 * np.pi * t / 128.0)) + 0.3 * rng.standard_normal(256)])


def _two_images(rng):
    yy, xx = np.mgrid[0:64, 0:64]
    return np.stack([np.sin(2 * np.pi * xx / 16.0) * np.cos(2 * np.pi * yy / 32.0),
                     (xx > 20).astype(float)]) + 0.2 * rng.standard_normal((2, 64, 64))


@pytest.mark.parametrize("cost", ["shannon", "threshold", "l1"])
@pytest.mark.parametrize("wavelet", ["Haar", "Daubechies 4"])
def test_best_basis_matches_jax(wavelet, cost, rng):
    x = _two_signals(rng)
    kw = dict(max_level=5, cost=cost, threshold=0.5)
    bb = jt.best_basis(torch.tensor(x), wavelet, **kw)
    bj = jw.best_basis(x, wavelet, **kw)
    assert bb.nodes == bj.nodes
    assert bb.cost == pytest.approx(bj.cost, rel=1e-10)
    assert (bb.n, bb.wavelet) == (bj.n, bj.wavelet)
    for got, want in zip(bb.coefficients, bj.coefficients):
        assert_close(got, want, 1e-10, "node coefficients")
    assert_close(jt.best_basis_reconstruct(bb), x, 1e-10, "reconstruction")


@pytest.mark.parametrize("cost", ["shannon", "threshold", "l1"])
def test_best_basis_2d_matches_jax(cost, rng):
    img = _two_images(rng)
    kw = dict(max_level=3, cost=cost, threshold=0.5)
    bb = jt.best_basis_2d(torch.tensor(img), "db4", **kw)
    bj = jw.best_basis_2d(img, "db4", **kw)
    assert bb.nodes == bj.nodes
    assert bb.cost == pytest.approx(bj.cost, rel=1e-10)
    assert (bb.shape, bb.wavelet) == (bj.shape, bj.wavelet)
    for got, want in zip(bb.coefficients, bj.coefficients):
        assert_close(got, want, 1e-10, "node coefficients")
    assert_close(jt.best_basis_2d_reconstruct(bb), img, 1e-10, "reconstruction")


def test_best_basis_errors_match_jax():
    for fn, arr, err in ((jt.best_basis, torch.ones(64), jt.JWaveFailure),
                         (jw.best_basis, np.ones(64), jw.JWaveFailure)):
        with pytest.raises(err, match="unknown cost 'entropy'"):
            fn(arr, "Haar", cost="entropy")
    with pytest.raises(jt.JWaveFailure, match="not 2\\^p"):
        jt.best_basis(torch.ones(100), "Haar")
    with pytest.raises(jt.JWaveFailure, match="not 2\\^p x 2\\^q"):
        jt.best_basis_2d(torch.ones(48, 64), "Haar")


def test_carried_best_bases_invert_like_jax(rng):
    """A JAX result carried across by from_numpy inverts as JAX's does."""
    x = _two_signals(rng)  # the shapes above: JAX compiles nothing new
    bj = jw.best_basis(x, "Daubechies 4", 5)
    bb = jt.BestBasis.from_numpy(bj.nodes, [np.asarray(c) for c in bj.coefficients], bj.cost,
                                 bj.n, bj.wavelet, device="cpu")
    assert bb.nodes == bj.nodes and bb.coefficients[0].device.type == "cpu"
    want = jax.jit(lambda c: jw.best_basis_reconstruct(  # one compile, not one a primitive
        jwpt.BestBasis(bj.nodes, c, bj.cost, bj.n, bj.wavelet)))(bj.coefficients)
    assert_close(jt.best_basis_reconstruct(bb), want, 1e-10, "1D")
    img = _two_images(rng)
    bj2 = jw.best_basis_2d(img, "Daubechies 4", 3)
    bb2 = jt.BestBasis2D.from_numpy(bj2.nodes, [np.asarray(c) for c in bj2.coefficients],
                                    bj2.cost, bj2.shape, bj2.wavelet, device="cpu")
    want2 = jax.jit(lambda c: jw.best_basis_2d_reconstruct(
        jwpt.BestBasis2D(bj2.nodes, c, bj2.cost, bj2.shape, bj2.wavelet)))(bj2.coefficients)
    assert_close(jt.best_basis_2d_reconstruct(bb2), want2, 1e-10, "2D")


@pytest.mark.parametrize("shape", [(256,), (4, 128), (64, 32)])
def test_packet_facade_matches_jax(shape, rng):
    x = rng.standard_normal(shape)
    t = jt.TransformBuilder.create("Wavelet Packet Transform", "db4", device="cpu")
    tj = jw.TransformBuilder.create("Wavelet Packet Transform", "db4")
    y = t.forward(x)
    assert_close(y, tj.forward(x), 1e-10, "forward")
    assert_close(t.reverse(y), tj.reverse(np.asarray(y)), 1e-10, "reverse")
    assert_close(t.reverse(y), x, 1e-10, "round trip")
    assert jt.TransformBuilder.identify(t) == "Wavelet Packet Transform"
