"""The plain reference against the port's CPU float64 path at small sizes,
and against perfect reconstruction. The reference itself imports nothing
of the port; these tests do, to hold the two side by side."""
import math

import numpy as np
import pytest
import torch

import jwave_tpu_torch as jt
from benchmark.reference import fwt, modwt, sliding, taps
from benchmark.reference.precision import FLOAT64, TF32, to_float32, to_tf32

W = "Daubechies 4"
#: the published taps are orthonormal to ~1e-12 (sum of squares - 1 =
#: -9.3e-13), which bounds perfect reconstruction in float64
RECON = 1e-10


def _x(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape))


def test_db4_taps_are_an_orthonormal_bank_and_the_ports():
    lo, hi = taps.fwt_bank(W)
    fb = jt.filters.get_filter(W)
    np.testing.assert_allclose(lo, fb.dec_lo, rtol=0, atol=1e-15)
    np.testing.assert_allclose(hi, fb.dec_hi, rtol=0, atol=1e-15)
    assert math.isclose(sum(lo), math.sqrt(2), abs_tol=1e-12)
    assert math.isclose(sum(v * v for v in lo), 1.0, abs_tol=1e-12)
    for s in (2, 4, 6):  # orthogonal to its even shifts
        assert abs(sum(lo[i] * lo[i + s] for i in range(8 - s))) < 1e-12


@pytest.mark.parametrize("n,level", [(300, 5), (48, 3), (1000, 1)])
def test_modwt_matches_the_port_in_float64(n, level):
    x = _x(3, n, seed=n)
    g, h = taps.modwt_filters(W)
    want = modwt.modwt(x, g, h, level)
    got = jt.modwt(x, W, level)
    assert got.dtype == torch.float64
    assert float((got - want).abs().max()) < 1e-12
    back = jt.imodwt(want, W)
    assert float((back - modwt.imodwt(want, g, h)).abs().max()) < 1e-12


@pytest.mark.parametrize("n,level", [(300, 5), (64, 6)])
def test_modwt_reconstructs_perfectly(n, level):
    x = _x(2, n, seed=1)
    g, h = taps.modwt_filters(W)
    assert float((modwt.imodwt(modwt.modwt(x, g, h, level), g, h) - x).abs().max()) < RECON


@pytest.mark.parametrize("n,level", [(256, 6), (64, 1), (32, 5), (16, 4)])
def test_fwt_rows_matches_the_port_in_float64(n, level):
    x = _x(4, n, seed=n + level)
    lo, hi = taps.fwt_bank(W)
    want = fwt.fwt_rows(x, lo, hi, level)
    assert float((jt.fwt(x, W, level) - want).abs().max()) < 1e-12
    assert float((jt.ifwt(want, W, level) - fwt.ifwt_rows(want, lo, hi, level)).abs().max()) < 1e-12
    assert float((fwt.ifwt_rows(want, lo, hi, level) - x).abs().max()) < RECON


def test_fwt2d_matches_the_port_in_float64():
    m = _x(64, 128, seed=2)
    lo, hi = taps.fwt_bank(W)
    want = fwt.fwt_nd(m, lo, hi, (6, 6))
    assert float((jt.fwt2d(m, W, 6, 6) - want).abs().max()) < 1e-12
    assert float((jt.ifwt2d(want, W, 6, 6) - fwt.ifwt_nd(want, lo, hi, (6, 6))).abs().max()) < 1e-12
    assert float((fwt.ifwt_nd(want, lo, hi, (6, 6)) - m).abs().max()) < RECON


def test_fwt3d_matches_the_facade_in_float64():
    v = _x(16, 32, 64, seed=3)
    lo, hi = taps.fwt_bank(W)
    tr = jt.Transform(jt.FastWaveletTransform(W))
    want = fwt.fwt_nd(v, lo, hi, (4, 4, 4))
    assert float((tr.forward(v, 4, 4, 4) - want).abs().max()) < 1e-12
    assert float((tr.reverse(want, 4, 4, 4) - fwt.ifwt_nd(want, lo, hi, (4, 4, 4))).abs().max()) < 1e-12
    assert float((fwt.ifwt_nd(want, lo, hi, (4, 4, 4)) - v).abs().max()) < RECON


def test_causal_modwt_matches_the_ports_sliding_updates_in_float64():
    level, window, chunk = 5, 128, 16
    stream = _x(3, window + 9 * chunk, seed=4)
    g, h = taps.modwt_filters(W)
    want = sliding.causal_modwt(stream, g, h, level)
    st = jt.sliding_modwt_init(stream[:, :window], W, level)
    assert float((st.coeffs - want[..., :window]).abs().max()) < 1e-12
    for u in range(9):
        end = window + (u + 1) * chunk
        st = jt.sliding_modwt_update(st, stream[:, end - chunk:end], W, level)
        assert float((st.coeffs - want[..., end - window:end]).abs().max()) < 1e-12


def test_causal_modwt_equals_the_periodic_one_past_the_wrap():
    """Columns t >= (M-1)(2^J - 1) never wrap, so the two agree there."""
    x = _x(2, 400, seed=5)
    g, h = taps.modwt_filters(W)
    start = 7 * (2 ** 5 - 1)
    a = sliding.causal_modwt(x, g, h, 5)[..., start:]
    b = modwt.modwt(x, g, h, 5)[..., start:]
    assert float((a - b).abs().max()) < 1e-12


def test_tf32_keeps_ten_mantissa_bits_rounded_to_nearest_even():
    one = torch.tensor([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, -3.0],
                       dtype=torch.float64)
    assert to_tf32(one).tolist() == [1.0, 1 + 2.0 ** -10, 1.0, 1 + 2 * 2.0 ** -10, -3.0]
    assert to_float32(torch.tensor([1 + 2.0 ** -30], dtype=torch.float64)).item() == 1.0


def test_the_tf32_reference_departs_from_float64_by_the_rounding():
    x = _x(2, 512, seed=6)
    g, h = taps.modwt_filters(W)
    exact = modwt.modwt(x, g, h, 5, FLOAT64)
    low = modwt.modwt(x, g, h, 5, TF32)
    rel = float((low - exact).abs().max() / exact.abs().max())
    assert 1e-5 < rel < 1e-2
