"""jwave_tpu_torch's sliding MODWT against jwave_tpu on the same seeded
float64 streams: init and updates column for column (1e-12 of max|ref|:
term-by-term FMAs in another order), the state carried over from a JAX
state mid-stream through ``SlidingState.from_numpy``, and the interior
contract against the port's own ``modwt`` of the window."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import jwave_tpu as jw  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402

from torch_parity import assert_close  # noqa: E402


def _assert_state(got, want, what):
    assert len(got.hist) == len(want.hist)
    for a, b in zip(got.hist, want.hist):
        assert_close(a, b, 1e-12, f"{what}: hist")
    assert_close(got.coeffs, want.coeffs, 1e-12, f"{what}: coeffs")
    assert_close(got.window, want.window, 1e-12, f"{what}: window")


@pytest.mark.parametrize("wavelet,level,wlen", [("haar", 4, 64), ("db4", 3, 128),
                                                ("sym8", 2, 96), ("db4", 8, 512)])
def test_init_matches_jax(wavelet, level, wlen, rng):
    x0 = rng.standard_normal((2, wlen))
    _assert_state(jt.sliding_modwt_init(torch.tensor(x0), wavelet, level),
                  jw.sliding_modwt_init(jnp.asarray(x0), wavelet, level), "init")


@pytest.mark.parametrize("step", [1, 7, 64, 300])
def test_updates_match_jax(step, rng):
    wlen, level = 128, 4
    sig = rng.standard_normal((2, wlen + 4 * step))
    st_t = jt.SlidingMODWT("db4", level, wlen).init(torch.tensor(sig[:, :wlen]))
    st_j = jw.SlidingMODWT("db4", level, wlen).init(sig[:, :wlen])
    for pos in range(wlen, sig.shape[-1], step):
        st_t = jt.sliding_modwt_update(st_t, torch.tensor(sig[:, pos:pos + step]), "db4", level)
        st_j = jw.sliding_modwt_update(st_j, jnp.asarray(sig[:, pos:pos + step]), "db4", level)
        _assert_state(st_t, st_j, f"update at {pos}")


def test_resume_from_a_jax_state(rng):
    """A JAX state mid-stream, carried over as numpy arrays, resumes in the
    port: the next updates agree with JAX's own."""
    wlen, level, step = 512, 8, 64
    sig = rng.standard_normal((3, wlen + 6 * step))
    sl_j = jw.SlidingMODWT("db4", level, wlen)
    st_j = sl_j.init(sig[:, :wlen])
    for pos in range(wlen, wlen + 3 * step, step):
        st_j = sl_j.update(st_j, sig[:, pos:pos + step])
    st_t = jt.SlidingState.from_numpy([np.asarray(h) for h in st_j.hist],
                                      np.asarray(st_j.coeffs), np.asarray(st_j.window),
                                      device="cpu")
    assert st_t.coeffs.dtype == torch.float64 and st_t.coeffs.device.type == "cpu"
    _assert_state(st_t, st_j, "carried over")
    sl_t = jt.SlidingMODWT("db4", level, wlen)
    for pos in range(wlen + 3 * step, sig.shape[-1], step):
        st_j = sl_j.update(st_j, sig[:, pos:pos + step])
        st_t = sl_t.update(st_t, sig[:, pos:pos + step])
        _assert_state(st_t, st_j, f"resumed at {pos}")


def test_interior_equals_modwt_of_the_window(rng):
    wlen, level, step = 256, 3, 32
    sig = rng.standard_normal(wlen + 5 * step)
    sl = jt.SlidingMODWT("db4", level, wlen)
    st = sl.init(torch.tensor(sig[:wlen]))
    for pos in range(wlen, sig.shape[0], step):
        st = sl.update(st, sig[pos:pos + step])
    ref = jt.modwt(torch.tensor(sig[-wlen:]), "db4", level)
    m = jt.get_filter("db4").length
    for j in range(1, level + 1):
        s = (m - 1) * ((1 << j) - 1)
        assert_close(st.coeffs[j - 1, s:], ref[j - 1, s:], 1e-12, f"W_{j} interior")
    assert_close(st.coeffs[level, s:], ref[level, s:], 1e-12, "V_J interior")


def test_errors_match():
    cases = [
        lambda m, a: m.sliding_modwt_init(a(np.zeros(16)), "db4", 9),
        lambda m, a: m.SlidingMODWT("db4", 0, 64),
        lambda m, a: m.SlidingMODWT("db4", 3, 64).init(a(np.zeros(32))),
    ]
    for fn in cases:
        with pytest.raises(jw.JWaveFailure) as ej:
            fn(jw, np.asarray)
        with pytest.raises(jt.JWaveFailure) as et:
            fn(jt, torch.as_tensor)
        assert str(et.value) == str(ej.value)
