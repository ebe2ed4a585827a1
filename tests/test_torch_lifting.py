"""jwave_tpu_torch's lifting-scheme FWT against jwave_tpu, on the same seeded
float64 input: the three schemes under both boundaries, single level and
multi-level, their names and aliases, the errors, and the facade. Bounds
(of max|ref|, absolute below 1): 1e-10 (the same FMA chain in the same
order); bf16 1e-2 (each stored value rounds to 2^-9) against the float64
lifting of the same bf16 values."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import jwave_tpu as jw  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402

from torch_parity import assert_close  # noqa: E402

SCHEMES = ["Haar lifting", "CDF 5/3", "CDF 9/7"]
BOUNDARIES = ["periodic", "symmetric"]


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_lifting_fwt_matches_jax(scheme, boundary, rng):
    x = rng.standard_normal((3, 256))
    for level in (None, 0, 1, 4, 8):
        got = jt.lifting_fwt(torch.tensor(x), scheme, level, boundary)
        want = jw.lifting_fwt(x, scheme, level, boundary)
        assert got.dtype == torch.float64
        assert_close(got, want, 1e-10, f"forward L{level}")
        assert_close(jt.lifting_ifwt(torch.tensor(np.asarray(want)), scheme, level, boundary),
                     jw.lifting_ifwt(want, scheme, level, boundary), 1e-10, f"inverse L{level}")
        assert_close(jt.lifting_ifwt(got, scheme, level, boundary), x, 1e-10, "round trip")


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_lifting_dwt_matches_jax(scheme, boundary, rng):
    x = rng.standard_normal((2, 5, 18))
    a, d = jt.lifting_dwt(torch.tensor(x), scheme, boundary)
    aj, dj = jw.lifting_dwt(x, scheme, boundary)
    assert_close(a, aj, 1e-10, "approx")
    assert_close(d, dj, 1e-10, "detail")
    assert_close(jt.lifting_idwt(a, d, scheme, boundary), jw.lifting_idwt(aj, dj, scheme, boundary),
                 1e-10, "synthesis")


def test_scheme_names_and_aliases_match_jax():
    assert jt.lifting_schemes() == jw.lifting_schemes()
    for name in ("haar", "HAAR_1", "cdf53", "cdf-5/3", "LeGall", "legall53", "cdf97", "CDF 9.7",
                 "jpeg2000") + jw.lifting_schemes():
        got, want = jt.get_scheme(name), jw.get_scheme(name)
        assert (got.name, got.steps, got.k_s, got.k_d) == \
            (want.name, want.steps, want.k_s, want.k_d)
    assert jt.get_scheme(jt.get_scheme("cdf97")) is jt.get_scheme("cdf97")
    with pytest.raises(jt.JWaveNotKnown, match="unknown lifting scheme 'cdf22'"):
        jt.get_scheme("cdf22")


@pytest.mark.parametrize("case", ["boundary", "odd length", "not 2^p", "level",
                                  "shapes differ"])
def test_lifting_errors_match_jax(case):
    calls = {
        "boundary": lambda m, a: m.lifting_fwt(a(np.ones(8)), boundary="zero"),
        "odd length": lambda m, a: m.lifting_dwt(a(np.ones(7))),
        "not 2^p": lambda m, a: m.lifting_fwt(a(np.ones(12))),
        "level": lambda m, a: m.lifting_ifwt(a(np.ones(8)), level=4),
        "shapes differ": lambda m, a: m.lifting_idwt(a(np.ones(4)), a(np.ones(5))),
    }
    msgs = []
    for m, a in ((jw, np.asarray), (jt, torch.tensor)):
        with pytest.raises(m.JWaveFailure) as e:
            calls[case](m, a)
        msgs.append(str(e.value).replace("torch.Size([4])", "(4,)").replace(
            "torch.Size([5])", "(5,)"))
    assert msgs[0] == msgs[1]


def test_lifting_bfloat16(rng):
    """bf16 in, bf16 out, as in the JAX package with x64 off. Held against
    the float64 lifting of the same bf16 values: the port computes a level
    in float32, where the JAX package computes in bf16 with the lifting
    constants rounded to bf16 (2% off at one level, so not a reference at
    1e-2)."""
    x = rng.standard_normal((3, 256)).astype(np.float32)  # the shape above: nothing to compile
    xb = torch.tensor(x).to(torch.bfloat16)
    exact = np.asarray(jw.lifting_fwt(xb.double().numpy(), "CDF 9/7", 8))
    got = jt.lifting_fwt(xb, "CDF 9/7", 8)
    assert got.dtype == torch.bfloat16
    traced = jax.eval_shape(lambda a: jw.lifting_fwt(a, "CDF 9/7", 8),
                            jax.ShapeDtypeStruct(x.shape, jnp.bfloat16))
    assert traced.dtype == jnp.bfloat16
    assert_close(got.float(), exact, 1e-2, "bf16 forward")
    back = jt.lifting_ifwt(got, "CDF 9/7", 8)
    assert back.dtype == torch.bfloat16
    assert_close(back.float(), xb.double(), 1e-2, "bf16 round trip")


@pytest.mark.parametrize("shape", [(64,), (4, 32), (16, 32)])
def test_lifting_facade_matches_jax(shape, rng):
    x = rng.standard_normal(shape)
    t = jt.TransformBuilder.create("Lifting Wavelet Transform", "cdf97", device="cpu")
    tj = jw.TransformBuilder.create("Lifting Wavelet Transform", "cdf97")
    assert t.get_wavelet().name == "CDF 9/7"
    y = t.forward(x)
    assert_close(y, tj.forward(x), 1e-10, "forward")
    assert_close(t.reverse(y), x, 1e-10, "round trip")
    if len(shape) == 1:
        dec = t.decompose(x)
        assert_close(dec, tj.decompose(x), 1e-10, "decompose")
        assert_close(t.recompose(dec), x, 1e-10, "recompose")
    haar = jt.TransformBuilder.create("Lifting Wavelet Transform", device="cpu")
    assert haar.get_wavelet().name == "Haar lifting"
