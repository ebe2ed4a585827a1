"""jwave_tpu_torch's wavelet scattering (1D and 2D) against jwave_tpu on the
same seeded float64 input.

The port runs the spectral form, which is the JAX package's hatch
(``config.set_mxu_dft('off')``): the two agree to roundoff, bound 1e-12 of
max|ref| per order. JAX's default route reassociates the same maps onto
matrix units and truncates Gaussian tails: bound 1e-6 per order (measured
~5e-8). The banks and path tables are equal exactly. One JAX scattering call
costs seconds on the CPU, so each is made once, by a module-scoped fixture.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import jwave_tpu as jw  # noqa: E402
from jwave_tpu import config as jconfig  # noqa: E402
from jwave_tpu.transforms import scattering as js  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch.transforms import scattering as ts  # noqa: E402

from torch_parity import assert_close, to_np  # noqa: E402

HATCH = 1e-12    # the same spectral form: FFT roundoff of two libraries
DEFAULT = 1e-6   # JAX's matrix-unit route: Gaussian tails truncated at ~1e-7
ORDERS = ("S0", "S1", "S2")


@pytest.fixture(scope="module")
def jax_ref():
    """``get(key, fn, route)``: JAX's result of ``fn()`` on the spectral hatch
    (route "off") or the default route ("auto"), computed once per module;
    the dial is restored after each call."""
    memo = {}
    before = jconfig.mxu_dft()

    def get(key, fn, route):
        if (key, route) not in memo:
            jconfig.set_mxu_dft(route)
            try:
                memo[key, route] = fn()
            finally:
                jconfig.set_mxu_dft(before)
        return memo[key, route]

    yield get
    jconfig.set_mxu_dft(before)


def _rel(got, want) -> float:
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / np.abs(w).max()) if w.size else 0.0


def _hold(got, want, bound, what):
    for name in ORDERS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == torch.float64, (what, name, g.dtype)
        err = _rel(g, w)
        assert err <= bound, f"{what} {name}: {err:.3e} > {bound:.0e} of max|ref|"
    np.testing.assert_array_equal(got.paths, want.paths)


CASES_1D = {
    "2x1024 J4 Q4": ((2, 1024), dict(J=4, Q=4), {}),
    "3x700 J5 Q8 Q2=2 zero pad, oversampling 2": (
        (3, 700), dict(J=5, Q=8, Q2=2, oversampling=2), {"padding": "ZERO"}),
    "1000 no batch, oversampling >= J": ((1000,), dict(J=3, Q=2, oversampling=5), {}),
}
CASES_2D = {
    "2x32x32 J2 L4": ((2, 32, 32), dict(J=2, L=4)),
    "24x40 J3 L6 oversampling 1": ((24, 40), dict(J=3, L=6, oversampling=1)),
    "16x20 J1 (no path)": ((16, 20), dict(J=1, L=4)),
}


def _input(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _run_1d(case, route, jax_ref):
    shape, kw, pad = CASES_1D[case]
    x = _input(shape, 1)
    kw_j = dict(kw, **{k: getattr(jw.PaddingType, v) for k, v in pad.items()})
    kw_t = dict(kw, **{k: getattr(jt.PaddingType, v) for k, v in pad.items()})
    want = jax_ref(("1d", case), lambda: jw.scattering1d(x, **kw_j), route)
    return jt.scattering1d(torch.tensor(x), **kw_t), want


def _run_2d(case, route, jax_ref):
    shape, kw = CASES_2D[case]
    x = _input(shape, 2)
    want = jax_ref(("2d", case), lambda: jw.scattering2d(x, **kw), route)
    return jt.scattering2d(torch.tensor(x), **kw), want


@pytest.mark.parametrize("args", [(1024, 4, 4, 1), (2048, 5, 8, 2)])
def test_filter_bank_equals_jax(args):
    got, want = ts.scattering_filter_bank(*args), js.scattering_filter_bank(*args)
    for name in ("psi1_hat", "psi2_hat", "phi_hat", "xi1", "xi2", "paths"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


def test_filter_bank_2d_equals_jax():
    got = ts.scattering_filter_bank_2d(64, 64, 3, 6)
    want = js.scattering_filter_bank_2d(64, 64, 3, 6)
    for name in ("psi_hat", "phi_hat", "xi", "thetas", "paths"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


@pytest.mark.parametrize("case", list(CASES_1D))
def test_scattering1d_matches_jax_spectral_hatch(case, jax_ref):
    got, want = _run_1d(case, "off", jax_ref)
    _hold(got, want, HATCH, case)
    np.testing.assert_array_equal(got.xi1, want.xi1)
    np.testing.assert_array_equal(got.xi2, want.xi2)


def test_scattering1d_matches_jax_default_route(jax_ref):
    case = "2x1024 J4 Q4"
    got, want = _run_1d(case, "auto", jax_ref)
    _hold(got, want, DEFAULT, case)


@pytest.mark.parametrize("case", list(CASES_2D))
def test_scattering2d_matches_jax_spectral_hatch(case, jax_ref):
    got, want = _run_2d(case, "off", jax_ref)
    _hold(got, want, HATCH, case)
    np.testing.assert_array_equal(got.xi, want.xi)
    np.testing.assert_array_equal(got.thetas, want.thetas)


def test_scattering2d_matches_jax_default_route(jax_ref):
    case = "2x32x32 J2 L4"
    got, want = _run_2d(case, "auto", jax_ref)
    _hold(got, want, DEFAULT, case)


def test_no_path_gives_an_empty_s2():
    res = jt.scattering2d(torch.tensor(_input((3, 16, 20), 3)), 1, L=4)
    assert tuple(res.S2.shape) == (3, 0, 8, 10) and res.n_paths == 0
    assert tuple(res.features().shape) == (3, 5, 8, 10)


def test_oversampling_at_or_past_j_is_the_full_rate_transform():
    """Every rate is 1 with oversampling >= J: more oversampling changes
    nothing, and the critical-rate result is its subsample within the
    decimation's tail budget."""
    x = torch.tensor(_input((2, 512), 4))
    full = jt.scattering1d(x, 4, Q=4, oversampling=4)
    more = jt.scattering1d(x, 4, Q=4, oversampling=9)
    for name in ORDERS:
        assert torch.equal(getattr(full, name), getattr(more, name)), name
    crit = jt.scattering1d(x, 4, Q=4)
    for name, tol in (("S0", 1e-12), ("S1", 1e-4), ("S2", 2e-3)):
        assert _rel(getattr(crit, name), getattr(full, name)[..., ::16]) <= tol, name


def test_features_and_metadata():
    x = torch.tensor(_input((2, 3, 512), 5))
    r = jt.scattering1d(x, 5, Q=4, sampling_rate=100.0)
    k1, t = 5 * 4 + 1, 512 // 32
    assert tuple(r.S0.shape) == (2, 3, t) and tuple(r.S1.shape) == (2, 3, k1, t)
    assert tuple(r.S2.shape) == (2, 3, r.n_paths, t) and r.paths.shape == (r.n_paths, 2)
    assert r.n_paths == int(np.sum(r.xi2[:, None] < r.xi1[None, :]))
    np.testing.assert_array_equal(r.frequencies1, r.xi1 * 100.0)
    assert r.xi1[0] == ts.XI_MAX
    f = r.features()
    assert tuple(f.shape) == (2, 3, 1 + k1 + r.n_paths, t)
    assert torch.equal(f[..., 0, :], r.S0) and torch.equal(f[..., 1:1 + k1, :], r.S1)
    assert torch.equal(f[..., 1 + k1:, :], r.S2)

    img = torch.tensor(_input((2, 40, 48), 6))
    r2 = jt.scattering2d(img, 2, L=6)
    bank = ts.scattering_filter_bank_2d(128, 128, 2, 6)
    assert r2.n_orientations == 6 and r2.n_paths == len(bank.paths) == 36
    assert tuple(r2.S1.shape) == (2, 12, 10, 12) and tuple(r2.S2.shape) == (2, 36, 10, 12)
    f2 = r2.features()
    assert tuple(f2.shape) == (2, 1 + 12 + 36, 10, 12)
    assert torch.equal(f2[:, 0], r2.S0) and torch.equal(f2[:, 13:], r2.S2)


ERRORS = {
    "1d scalar": (lambda m, x: m.scattering1d(x(np.float64(1.0)), 1)),
    "1d complex": (lambda m, x: m.scattering1d(x(np.ones(64) + 0j), 2)),
    "1d one sample": (lambda m, x: m.scattering1d(x(np.ones(1)), 1)),
    "1d J 0": (lambda m, x: m.scattering1d(x(np.ones(64)), 0)),
    "1d Q 0": (lambda m, x: m.scattering1d(x(np.ones(64)), 2, Q=0)),
    "1d Q2 0": (lambda m, x: m.scattering1d(x(np.ones(64)), 2, Q2=0)),
    "1d 2^J past N": (lambda m, x: m.scattering1d(x(np.ones(16)), 5)),
    "2d one axis": (lambda m, x: m.scattering2d(x(np.ones(16)), 2)),
    "2d complex": (lambda m, x: m.scattering2d(x(np.ones((16, 16)) + 0j), 2)),
    "2d one row": (lambda m, x: m.scattering2d(x(np.ones((1, 16))), 1)),
    "2d J 0": (lambda m, x: m.scattering2d(x(np.ones((16, 16))), 0)),
    "2d L 0": (lambda m, x: m.scattering2d(x(np.ones((16, 16))), 2, L=0)),
    "2d 2^J past the extent": (lambda m, x: m.scattering2d(x(np.ones((8, 8))), 4)),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_invalid_arguments_raise_as_in_jax(case):
    call = ERRORS[case]
    with pytest.raises(jw.JWaveFailure) as ej:
        call(jw, jax.numpy.asarray)
    with pytest.raises(jt.JWaveFailure) as et:
        call(jt, torch.tensor)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32, torch.int32,
                                   torch.float64])
def test_output_dtypes(dtype):
    """float64 in, float64 out; any other real input computes in float32, as
    the JAX package does (bf16, f16, f32 and int32 give float32 S0/S1/S2)."""
    base = torch.tensor(np.round(4 * _input((2, 256), 7)))
    x = base.to(dtype)
    want_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    r1 = jt.scattering1d(x, 3, Q=2)
    r2 = jt.scattering2d(x.reshape(2, 16, 16), 2, L=4)
    ref1 = jt.scattering1d(x.to(want_dtype), 3, Q=2)
    ref2 = jt.scattering2d(x.to(want_dtype).reshape(2, 16, 16), 2, L=4)
    for got, ref in ((r1, ref1), (r2, ref2)):
        for name in ORDERS:
            assert getattr(got, name).dtype == want_dtype, (name, getattr(got, name).dtype)
            assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_gradient_matches_jax_spectral_hatch(jax_ref):
    x = _input((1, 256), 8)
    t = torch.tensor(x, requires_grad=True)
    (g,) = torch.autograd.grad(jt.scattering1d(t, 3, Q=2).features().sum(), t)
    want = jax_ref("grad", lambda: jax.grad(
        lambda a: jw.scattering1d(a, 3, Q=2).features().sum())(x), "off")
    assert_close(g, want, 1e-8, "gradient of features().sum()")


def test_ifft_mag_two_real_matches_jax():
    rng = np.random.default_rng(9)
    z = rng.standard_normal((3, 64)) + 1j * rng.standard_normal((3, 64))
    got = ts.ifft_mag_two_real(torch.tensor(z), torch.complex128)
    assert_close(got, js.ifft_mag_two_real(jax.numpy.asarray(z), jax.numpy.complex128), 1e-12,
                 "ifft_mag_two_real")
    assert_close(got, np.abs(np.fft.ifft(z, axis=-1)), 1e-12, "|ifft|")


def test_warm_call_reuses_the_device_constants(monkeypatch):
    """The second call of a geometry finds its constants in the cache (the
    same tensor objects) and makes no tensor from host data."""
    x = torch.tensor(_input((2, 300), 10))
    img = torch.tensor(_input((20, 24), 11))
    jt.scattering1d(x, 3, Q=2)
    jt.scattering2d(img, 2, L=3)
    p1 = ts._plan_1d(300, 3, 2, 1, 0, torch.float64, x.device)
    p2 = ts._plan_2d(20, 24, 2, 3, 0, torch.float64, img.device)
    assert ts._plan_1d(300, 3, 2, 1, 0, torch.float64, x.device) is p1
    assert ts._plan_1d(300, 3, 2, 1, 0, torch.float32, x.device) is not p1
    assert all(g.psi is h.psi for g, h in zip(
        p1.order1, ts._plan_1d(300, 3, 2, 1, 0, torch.float64, x.device).order1))
    assert ts._plan_2d(20, 24, 2, 3, 0, torch.float64, img.device).psi is p2.psi

    made = []
    for name in ("as_tensor", "tensor", "from_numpy"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _r=real, _n=name, **k: (made.append(_n),
                                                                              _r(*a, **k))[1])
    jt.scattering1d(x, 3, Q=2)
    jt.scattering2d(img, 2, L=3)
    assert made == []


def test_caches_are_bounded():
    for n in range(64, 64 + 2 * ts._CONST_CACHE_MAX + 2, 2):
        jt.scattering1d(torch.ones(n, dtype=torch.float64), 2, Q=1)
    assert len(ts._CONST_CACHE) == ts._CONST_CACHE_MAX
    assert len(ts._BANK_CACHE) <= ts._BANK_CACHE_MAX
    for n in range(16, 16 + 2 * ts._BANK_CACHE_MAX + 2):
        ts.scattering_filter_bank(n, 2, 1)
    assert len(ts._BANK_CACHE) == ts._BANK_CACHE_MAX
