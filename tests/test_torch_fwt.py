"""jwave_tpu_torch FWT against jwave_tpu: fwt/ifwt/fwt2d/ifwt2d and the
decompose/split helpers in float64 at 1e-12, the plain versions of the
pyramid kernels K3/K4 against the Pallas kernels they replace, and the
volume's rotated route (fwt3d/ifwt3d) in its plain versions: against the
separable path and JAX, its rule, spans and gradient, and the rotated
forms' plans."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import jwave_tpu as jw  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu.filters import get_filter  # noqa: E402
from jwave_tpu.ops.mxu_pyramid import _levels_done, fwt_forward_fused  # noqa: E402
from jwave_tpu.ops.pallas_pyramid import fwt1d_fused, fwt2d_fused  # noqa: E402
from jwave_tpu.transforms import ndim as jw_ndim  # noqa: E402
from jwave_tpu_torch.ops import cuda_pyramid  # noqa: E402
from jwave_tpu_torch.transforms import ndim as jt_ndim  # noqa: E402
from jwave_tpu_torch.utils import profiling  # noqa: E402

from torch_parity import assert_close  # noqa: E402

BANKS = ["Haar", "Daubechies 4", "Symlet 8", "Discrete Meyer", "Battle 23",
         "Haar orthogonal", "BiOrthogonal 3/5"]


@pytest.mark.parametrize("name", BANKS)
@pytest.mark.parametrize("level", [None, 1, 3])
def test_fwt_ifwt_match_jax(name, level, rng):
    x = rng.standard_normal((3, 64))
    got = jt.fwt(torch.tensor(x), name, level)
    want = jw.fwt(x, name, level)
    assert_close(got, want, 1e-12, "fwt")
    assert_close(jt.ifwt(got, name, level), jw.ifwt(want, name, level), 1e-12, "ifwt")


@pytest.mark.parametrize("n,level", [(64, 2), (64, 3), (64, 6), (32, 2)])
def test_battle23_partial_levels(n, level, rng):
    """Battle 23 (transform wavelength 8) stops early; the inverse must undo
    exactly the levels the forward did."""
    x = rng.standard_normal((2, n))
    got = jt.fwt(torch.tensor(x), "Battle 23", level)
    assert_close(got, jw.fwt(x, "Battle 23", level), 1e-12, "fwt")
    assert_close(jt.ifwt(got, "Battle 23", level),
                 jw.ifwt(np.asarray(got), "Battle 23", level), 1e-12, "ifwt")


def test_levels_done_matches():
    for n in (1, 2, 8, 64, 1024):
        for tw in (2, 8):
            for level in (0, 1, 3, 20):
                assert cuda_pyramid.levels_done(n, tw, level) == _levels_done(n, tw, level)


def test_decompose_recompose_split_merge(rng):
    x = rng.standard_normal((2, 64))
    got = jt.fwt_decompose(torch.tensor(x), "db4")
    want = jw.fwt_decompose(x, "db4")
    assert_close(got, want, 1e-12, "decompose")
    for level in (None, 2):
        assert_close(jt.fwt_recompose(got, "db4", level), jw.fwt_recompose(want, "db4", level),
                     1e-12, "recompose")
    y = jt.fwt(torch.tensor(x), "db4", 3)
    parts = jt.fwt_split(y, 3)
    want_parts = jw.fwt_split(jnp.asarray(np.asarray(y)), 3)
    assert list(parts) == list(want_parts)
    for k in parts:
        assert_close(parts[k], want_parts[k], 0, k)
    assert_close(jt.fwt_merge(parts), y, 0, "merge")
    assert jt.fwt_max_level(64) == jw.fwt_max_level(64)


@pytest.mark.parametrize("shape,lr,lc", [((16, 32), None, None), ((32, 64), 2, 3),
                                         ((16, 16), 0, 4)])
@pytest.mark.parametrize("name", ["Haar", "db4"])
def test_fwt2d_ifwt2d_match_jax(shape, lr, lc, name, rng):
    x = rng.standard_normal(shape)
    got = jt.fwt2d(torch.tensor(x), name, lr, lc)
    want = jw.fwt2d(x, name, lr, lc)
    assert_close(got, want, 1e-12, "fwt2d")
    assert_close(jt.ifwt2d(got, name, lr, lc), jw.ifwt2d(want, name, lr, lc), 1e-12, "ifwt2d")


def test_fwt2d_batched_and_errors(rng):
    x = rng.standard_normal((2, 16, 32))
    assert_close(jt.fwt2d(torch.tensor(x), "db4", 2, 2), jw.fwt2d(x, "db4", 2, 2), 1e-12, "3D")
    for bad in ((24, 32), (32, 24)):
        with pytest.raises(jt.JWaveFailure):
            jt.fwt2d(torch.zeros(bad), "db4")
    with pytest.raises(jt.JWaveFailure):
        jt.fwt2d(torch.zeros((16, 16)), "db4", 5, 1)
    with pytest.raises(jt.JWaveFailure):
        jt.fwt(torch.zeros(24), "db4")
    with pytest.raises(jt.JWaveFailure):
        jt.ifwt(torch.zeros(16), "db4", 5)


def test_fwt_f32_on_cpu_matches_jax(rng):
    x = rng.standard_normal((4, 512)).astype(np.float32)
    got = jt.fwt(torch.tensor(x), "sym8")
    assert got.dtype == torch.float32
    assert_close(got, jw.fwt(x.astype(np.float64), "sym8"), 1e-5, "f32")


# --------------------------------------------------------------------------
# plain versions of K3/K4 against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------

def test_plain_k3_matches_fwt1d_fused(rng):
    """(16, 4096) db4 L6 f32: both accumulate in f32 in another order, so the
    bound is 2e-6 of the largest reference value, as for the Pallas tests."""
    fb = get_filter("db4")
    x = rng.standard_normal((16, 4096)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fwt1d_fused(jnp.asarray(x), "db4", 6))
    got = cuda_pyramid.pyramid_rows_torch(torch.tensor(x), fb.dec_lo, fb.dec_hi, 6)
    assert float(np.max(np.abs(got.numpy() - want))) < 2e-6 * float(np.max(np.abs(want)))


def test_plain_k4_two_passes_match_fwt2d_fused(rng):
    """(512, 1024) db4 L3: two plain transposed passes = the fused 2D kernel."""
    fb = get_filter("db4")
    x = rng.standard_normal((512, 1024)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fwt2d_fused(jnp.asarray(x), "db4", 3, 3))
    y = cuda_pyramid.pyramid_rows_transposed_torch(torch.tensor(x), fb.dec_lo, fb.dec_hi, 3)
    assert tuple(y.shape) == (1024, 512)
    got = cuda_pyramid.pyramid_rows_transposed_torch(y, fb.dec_lo, fb.dec_hi, 3)
    assert float(np.max(np.abs(got.numpy() - want))) < 2e-6 * float(np.max(np.abs(want)))


@pytest.mark.parametrize("name,n,level", [("Haar", 64, 6), ("Discrete Meyer", 32, 5),
                                          ("Battle 23", 64, 6), ("Symlet 8", 128, 4)])
def test_plain_pyramid_matches_jax_f64(name, n, level, rng):
    fb = get_filter(name)
    x = rng.standard_normal((3, n))
    done = cuda_pyramid.levels_done(n, fb.transform_wavelength, level)
    got = cuda_pyramid.pyramid_rows_torch(torch.tensor(x), fb.dec_lo, fb.dec_hi, done)
    assert_close(got, fwt_forward_fused(jnp.asarray(x), fb, level), 1e-12, "K3 plain")
    assert_close(cuda_pyramid.pyramid_rows_transposed_torch(torch.tensor(x), fb.dec_lo,
                                                            fb.dec_hi, done),
                 np.asarray(jw.fwt(x, name, level)).T, 1e-12, "K4 plain")


# The volume's rotated route (transforms/fwt.py fwt3d, ifwt3d): three rotated
# passes, each (a b, c) rows stored as (c, a b), here on the CPU through the
# rotated forms' plain versions (K4's and K5's functions)
fwt_module = importlib.import_module("jwave_tpu_torch.transforms.fwt")
VOLUMES = [((8, 16, 32), "Daubechies 4", (2, 3, 1)), ((8, 16, 32), "Daubechies 4", (None,) * 3),
           ((4, 4, 64), "Symlet 8", (0, 2, 6)), ((2, 8, 4), "Haar", (1, 0, 2)),
           ((16, 2, 8), "Battle 23", (4, 1, 3)), ((32, 8, 16), "Daubechies 2", (5, 3, 4))]


def _route_levels(shape, fb, levels):
    """The levels each pass does, R first, as the route works them out."""
    return tuple(cuda_pyramid.levels_done(n, fb.transform_wavelength,
                                          n.bit_length() - 1 if lv is None else lv)
                 for n, lv in zip(reversed(shape), reversed(levels)))


@pytest.mark.parametrize("shape,name,levels", VOLUMES, ids=lambda v: str(v))
def test_rotated_route_plain_model_matches_ndim_and_jax(shape, name, levels, rng):
    """Three rotated passes of the plain forms (pyramid_rows_transposed_torch,
    ipyramid_rows_transposed_torch) give ``ndim.forward_3d``/``reverse_3d``
    over ``fwt``/``ifwt`` to the element's rounding, and JAX's
    ``forward_3d``/``reverse_3d``, in float64."""
    fb = jt.get_filter(name)
    lp, lq, lr = levels
    x = rng.standard_normal(shape)
    done = _route_levels(shape, fb, levels)
    got = fwt_module._fwt3d_rotated(torch.tensor(x), fb, done)
    sep = jt_ndim.forward_3d(lambda v, lv: jt.fwt(v, fb, lv), torch.tensor(x), lp, lq, lr)
    want = jw_ndim.forward_3d(lambda v, lv: jw.fwt(v, name, lv), x, lp, lq, lr)
    assert tuple(got.shape) == shape and got.is_contiguous()
    assert_close(got, sep.numpy(), 1e-12, "fwt3d against ndim.forward_3d")
    assert_close(got, want, 1e-12, "fwt3d against JAX")
    back = fwt_module._ifwt3d_rotated(got, fb, done)
    sep_back = jt_ndim.reverse_3d(lambda v, lv: jt.ifwt(v, fb, lv), sep, lp, lq, lr)
    want_back = jw_ndim.reverse_3d(lambda v, lv: jw.ifwt(v, name, lv), want, lp, lq, lr)
    assert_close(back, sep_back.numpy(), 1e-12, "ifwt3d against ndim.reverse_3d")
    assert_close(back, want_back, 1e-12, "ifwt3d against JAX")


@pytest.mark.parametrize("shape,dtype,levels,want", [
    ((256, 256, 256), torch.float32, (6, 6, 6), (6, 6, 6)),
    ((32, 64, 128), torch.float32, (2, None, 3), (3, 6, 2)),   # R, Q, P; None: the maximum
    ((2, 2, 2), torch.float32, (1, 0, 1), (1, 0, 1)),
    ((2048, 4, 8), torch.float32, (None,) * 3, (3, 2, 11)),
    ((4096, 8, 8), torch.float32, (3, 3, 3), None),            # longer than the rotated forms
    ((1, 8, 8), torch.float32, (0, 3, 3), None),               # an extent of 1
    ((3, 8, 8), torch.float32, (0, 3, 3), None),               # not a power of two
    ((8, 8, 8), torch.float32, (4, 3, 3), None),               # a level out of range: raises there
    ((8, 8, 8), torch.float64, (3, 3, 3), None),               # no kernel for float64
    ((2, 8, 8, 8), torch.float32, (3, 3, 3), None),            # rank 4
    ((8, 8), torch.float32, (3, 3, 3), None),                  # rank 2
])
def test_rotated_route_takes_the_volumes_its_forms_take(monkeypatch, shape, dtype, levels, want):
    """The route's rule, with the card's test of device and dtype let through
    for float32 here: a rank-3 float32 volume whose extents are powers of two
    from 2 to ROT_MAX and whose levels are in range; every other input keeps
    the separable path. Battle 23 would stop before its levels: the levels
    are those each pass does. On the CPU nothing takes it."""
    fb = jt.get_filter("db4")
    x = torch.zeros(shape, dtype=dtype)
    assert fwt_module._rotated_levels(x, fb, levels[::-1]) is None
    monkeypatch.setattr(fwt_module, "_on_kernel", lambda t: t.dtype == torch.float32)
    assert fwt_module._rotated_levels(x, fb, levels[::-1]) == want
    fb23 = jt.get_filter("Battle 23")
    if want is not None:
        assert fwt_module._rotated_levels(x, fb23, levels[::-1]) == _route_levels(
            shape, fb23, levels)


def test_facade_volume_takes_the_route_where_the_rule_lets_it(monkeypatch, rng):
    """Through the facade, with the rule's device test let through on the
    CPU: the forward and reverse are one ``fwt3d``/``ifwt3d`` span each, with
    no ``ndim`` pass or transpose under them, equal to the separable path;
    and the gradient of a loss through both equals the separable path's
    (the rotated passes' adjoints: K7 and K3 on the transposed gradient)."""
    tr = jt.Transform(jt.FastWaveletTransform("db4"))
    x = torch.tensor(rng.standard_normal((8, 16, 32)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((8, 16, 32)), dtype=torch.float32)
    sep_y = tr.forward(x, 2, 3, 1)
    sep_r = tr.reverse(sep_y * w, 2, 3, 1)
    xg = x.clone().requires_grad_()
    (sep_grad,) = torch.autograd.grad((tr.reverse(tr.forward(xg, 2, 3, 1) * w, 2, 3, 1)
                                       * w).sum(), xg)
    monkeypatch.setattr(fwt_module, "_on_kernel", lambda t: t.dtype == torch.float32)
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        y = tr.forward(x, 2, 3, 1)
        r = tr.reverse(y * w, 2, 3, 1)
    spans = profiling.spans()
    profiling.reset_spans()
    assert [(s.name, s.parent) for s in spans] == [("fwt3d", "Transform.forward"),
                                                   ("Transform.forward", None),
                                                   ("ifwt3d", "Transform.reverse"),
                                                   ("Transform.reverse", None)]
    torch.testing.assert_close(y, sep_y, rtol=0, atol=1e-5)
    torch.testing.assert_close(r, sep_r, rtol=0, atol=1e-5)
    (grad,) = torch.autograd.grad((tr.reverse(tr.forward(xg, 2, 3, 1) * w, 2, 3, 1)
                                   * w).sum(), xg)
    torch.testing.assert_close(grad, sep_grad, rtol=0, atol=1e-4)


def test_rotated_plans():
    """``csrc/pyramid.cu`` k3_rotated_layout's and k7_layout's arithmetic,
    worked out by hand, and every row length the rotated forms take fits a
    block's shared memory for any filter length."""
    # rows of 256: 16 an item; two sets of 16 x 260 floats and 16 x 132 of
    # approximations after the 136 of taps and mbarriers: 10568 floats
    assert cuda_pyramid.k3_rotated_plan(256) == (16, 4 * 10568, 160)
    # rows of 2048: 8 an item (a 32-byte sector a column piece): 136 + 2 x
    # 16416 + 8224 = 41192 floats
    assert cuda_pyramid.k3_rotated_plan(2048) == (8, 4 * 41192, 160)
    assert cuda_pyramid.k3_rotated_plan(64) == (64, 4 * (136 + 2 * 4352 + 2304), 160)
    # K7's rotated form on rows of 256 at db4 L6: a set of round4(16 x 260) + 4
    # = 4164 floats; the even levels' buffer 16 x (128 + 4) = 2112 floats, the
    # odd 16 x (64 + 4) = 1088; 388 + 2 x 4164 + 2112 + 1088 = 11916 floats
    plan = cuda_pyramid.k7_plan(256, 6, 8, rotated=True)
    assert plan[:5] == (4096, 16, (128, 64, 32, 16, 8, 4), 4 * 4164, 4 * 11916)
    assert cuda_pyramid.k7_plan(2048, 1, 8, rotated=True)[:2] == (16384, 8)  # 8 rows at least
    for lg in range(1, cuda_pyramid.ROT_MAX.bit_length()):
        n = 1 << lg
        assert cuda_pyramid.rotated_rows(n)
        assert cuda_pyramid.k3_rotated_plan(n).smem_bytes <= cuda_pyramid.SMEM_LIMIT
        for m in (2, 8, 16, 62, 64):
            for levels in (0, 1, lg):
                plan = cuda_pyramid.k7_plan(n, levels, m, rotated=True)
                assert plan.rows >= cuda_pyramid.ROT_MIN_ROWS and plan.tile == plan.rows * n
                assert plan.smem_bytes <= cuda_pyramid.SMEM_LIMIT
    assert not any(cuda_pyramid.rotated_rows(n) for n in (0, 1, 3, 12, 2 * cuda_pyramid.ROT_MAX))


def test_rotated_wrappers_refuse_what_the_kernels_do_not_take():
    """Off the CPU the rotated wrappers launch or raise (the device check
    first); on the CPU they take the plain versions, count no launch and no
    rotated pass, and keep the plain versions' gradients."""
    fb = jt.get_filter("db4")
    y = torch.zeros(2, 64, device="meta")
    for fn, args in ((cuda_pyramid.pyramid_rows_rotated, (fb.dec_lo, fb.dec_hi, 3)),
                     (cuda_pyramid.ipyramid_rows_rotated, (fb.rec_lo, fb.rec_hi, 1.0, 3))):
        with pytest.raises(jt.JWaveFailure, match="CUDA"):
            fn(y, *args)
    before = profiling.counts()
    x = torch.arange(128.0).reshape(2, 64)
    got = cuda_pyramid.pyramid_rows_rotated(x, fb.dec_lo, fb.dec_hi, 3)
    assert torch.equal(got, cuda_pyramid.pyramid_rows_transposed_torch(x, fb.dec_lo, fb.dec_hi, 3))
    back = cuda_pyramid.ipyramid_rows_rotated(got.t().contiguous(), fb.rec_lo, fb.rec_hi,
                                              fb.recon_gain, 3)
    assert torch.allclose(back.t(), x, atol=1e-3)
    after = profiling.counts()
    assert after["launch.K3"] == before["launch.K3"] and after["launch.K7"] == before["launch.K7"]
    assert after[cuda_pyramid.ROTATED_PASSES] == before[cuda_pyramid.ROTATED_PASSES]
