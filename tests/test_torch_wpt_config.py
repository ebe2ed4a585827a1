"""The 2D wavelet packet transform of the benchmark's configuration
``wpt-db4-L6`` (the WPT facade's ``forward_2d``/``reverse_2d`` on stacks of
frames) at small sizes: the facade against the benchmark's plain reference
(``benchmark/reference/wpt.py``) in float64 and float32, the reference
against the JAX package's ``wpt``/``iwpt``, the plain model of K8's and K9's
plan for the cell's rows of 2048 at 6 levels, and the facade's spans and
counters under the profiler.

On the card the cell's own size runs in ``tests/test_torch_kernels.py``
(``-m cuda -k wpt_facade_2d``).
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch.ops import cuda_wpt  # noqa: E402
from jwave_tpu_torch.transforms import ndim  # noqa: E402
from jwave_tpu_torch.utils import profiling  # noqa: E402

from benchmark.compare import RelErr  # noqa: E402
from benchmark.reference import taps  # noqa: E402
from benchmark.reference import wpt as ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LIMITS = json.loads((ROOT / "benchmark" / "limits" / "wpt-db4-L6.frames-8x2048.json").read_text())
#: float64 against float64: the two sum the same products in another order
F64_BOUND = 1e-12


def _bank(wavelet):
    """(lo, hi) as the reference takes them: the frozen copy for db4, the
    port's orthonormal filters for the other banks."""
    if wavelet == "Daubechies 4":
        return taps.fwt_bank(wavelet)
    fb = jt.get_filter(wavelet)
    return tuple(float(v) for v in fb.dec_lo), tuple(float(v) for v in fb.dec_hi)


def _stack(shape, seed, dtype):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed), dtype=dtype)


#: (shape, wavelet, level_rows, level_cols): db4 at every level from 1 to
#: full depth on each axis; Haar at full depth; Symlet 8 at 6 levels along
#: rows of 64 (two chunks: five levels fused, the sixth on the butterfly)
CASES = ([((2, 32, 64), "Daubechies 4", min(lv, 5), lv) for lv in range(1, 7)]
         + [((3, 16, 16), "Daubechies 4", lv, lv) for lv in range(1, 5)]
         + [((2, 32, 64), "Haar", 5, 6), ((3, 16, 16), "Haar", 4, 4),
            ((2, 32, 64), "Symlet 8", 5, 6), ((3, 16, 16), "Symlet 8", 4, 4)])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape,wavelet,lr,lc", CASES, ids=lambda v: str(v))
def test_the_facade_in_2d_matches_the_reference(shape, wavelet, lr, lc, dtype):
    x = _stack(shape, 2**31 + sum(shape) + lr + lc, dtype)
    w = jt.WaveletPacketTransform(wavelet, device="cpu")
    y = w.forward_2d(x, lr, lc)
    r = w.reverse_2d(y, lr, lc)
    assert y.dtype == r.dtype == dtype and y.shape == r.shape == x.shape
    lo, hi = _bank(wavelet)
    ry = ref.wpt_nd(x, lo, hi, (lr, lc))
    coeffs = RelErr().add(y, ry).value
    recon = RelErr().add(r, ref.iwpt_nd(ry, lo, hi, (lr, lc))).value
    bound = F64_BOUND if dtype == torch.float64 else min(LIMITS.values())
    assert coeffs <= bound and recon <= bound, (coeffs, recon)


def test_the_facade_in_2d_batches_over_leading_axes_and_takes_each_axis_its_level():
    x = _stack((2, 3, 16, 32), 5, torch.float64)
    w = jt.WaveletPacketTransform("Daubechies 4", device="cpu")
    y = w.forward_2d(x, 2, 4)
    lo, hi = taps.fwt_bank("Daubechies 4")
    assert RelErr().add(y, ref.wpt_nd(x, lo, hi, (2, 4))).value <= F64_BOUND
    # along each row (the last axis) 4 levels, along each column 2
    rows = ref.wpt_rows(x, lo, hi, 4)
    both = ref.wpt_rows(rows.transpose(-1, -2), lo, hi, 2).transpose(-1, -2)
    assert RelErr().add(y, both).value <= F64_BOUND
    assert RelErr().add(y, ref.wpt_nd(x, lo, hi, (4, 2))).value > 1e-3


@pytest.mark.parametrize("wavelet,n,level", [("Daubechies 4", 256, 6), ("Daubechies 4", 64, 6),
                                             ("Haar", 128, 7), ("Symlet 8", 128, 6),
                                             ("Daubechies 4", 2048, 6)])
def test_the_reference_matches_jax_on_rows(wavelet, n, level):
    jw = pytest.importorskip("jwave_tpu")
    x = np.random.default_rng(n + level).standard_normal((3, n))
    lo, hi = _bank(wavelet)
    want = np.asarray(jw.wpt(x, wavelet, level))
    got = ref.wpt_rows(torch.tensor(x), lo, hi, level)
    assert np.abs(got.numpy() - want).max() <= F64_BOUND * np.abs(want).max()
    back = np.asarray(jw.iwpt(want, wavelet, level))
    assert np.abs(ref.iwpt_rows(torch.tensor(want), lo, hi, level).numpy() - back).max() \
        <= F64_BOUND * np.abs(back).max()


def test_k8_k9_plan_for_the_cells_rows_matches_the_reference():
    """K8's and K9's plan for rows of 2048 at 6 levels (db4): whole rows, two
    an item, 49,616 shared bytes a block; its plain model on 5 rows (two
    whole items and a short last one) against the reference."""
    m = len(taps.SCALING["Daubechies 4"])
    plans = [cuda_wpt.wpt_plan(2048, 6, m, inverse) for inverse in (False, True)]
    assert all((p.tile, p.rows, p.smem_bytes) == (4096, 2, 49616) for p in plans)
    assert cuda_wpt.wpt_items(16384, 2048, plans[0]) == 8192
    lo, hi = taps.fwt_bank("Daubechies 4")
    x = _stack((5, 2048), 2**31 + 2048, torch.float64)
    y = cuda_wpt.wpt_analysis_tiled_torch(x, lo, hi, 6, plans[0])
    ry = ref.wpt_rows(x, lo, hi, 6)
    assert RelErr().add(y, ry).value <= F64_BOUND
    z = cuda_wpt.wpt_synthesis_tiled_torch(ry, lo, hi, 6, plans[1])
    assert RelErr().add(z, ref.iwpt_rows(ry, lo, hi, 6)).value <= F64_BOUND
    assert RelErr().add(z, x).value <= 1e-9


@pytest.fixture
def clean_spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.parametrize("wavelet,butterfly", [("Daubechies 4", 0), ("Symlet 8", 2)])
def test_the_facade_in_2d_records_its_roots_spans_and_counters(clean_spans, wavelet, butterfly):
    """``wpt2d``/``iwpt2d`` roots holding an ``ndim.pass`` an axis, each with
    its ``wpt`` (``iwpt``) span; two transposing copies a root; db4 at 6
    levels fuses each axis into one chunk, Symlet 8 leaves a level an axis
    to the butterfly."""
    x = _stack((2, 64, 64), 7, torch.float32)
    w = jt.WaveletPacketTransform(wavelet, device="cpu")
    with _profile():
        w.reverse_2d(w.forward_2d(x, 6, 6), 6, 6)
    spans = profiling.spans()
    fwd, rev = [s for s in spans if s.parent is None]
    assert (fwd.name, rev.name) == ("wpt2d", "iwpt2d") and fwd.request != rev.request
    chunks = 1 if butterfly == 0 else 2
    for root, inner in ((fwd, "wpt"), (rev, "iwpt")):
        mine = [s for s in spans if s.request == root.request]
        assert [s.parent for s in mine if s.name == inner] == ["ndim.pass"] * 2
        assert [s.args for s in mine if s.name == inner] == [
            {"n": 64, "levels": 6, "chunks": chunks}] * 2
        assert root.counts["ndim.transposes"] == 2
        assert root.counts["ndim.transpose_bytes"] == 2 * x.numel() * 4
        assert root.counts["wpt.fused_chunks"] == 2
        assert root.counts.get("wpt.butterfly_levels", 0) == butterfly
    counts = profiling.counts()
    assert all(k in counts for k in ("ndim.transposes", "ndim.transpose_bytes",
                                     "wpt.fused_chunks", "wpt.butterfly_levels"))


def test_under_transform_forward_the_2d_root_is_a_child(clean_spans):
    x = _stack((32, 64), 8, torch.float32)
    tr = jt.Transform(jt.WaveletPacketTransform("Daubechies 4", device="cpu"))
    with _profile():
        tr.reverse(tr.forward(x, 5, 6), 5, 6)
    spans = profiling.spans()
    assert [s.name for s in spans if s.parent is None] == ["Transform.forward",
                                                           "Transform.reverse"]
    assert [(s.name, s.parent) for s in spans if s.name.endswith("wpt2d")] == [
        ("wpt2d", "Transform.forward"), ("iwpt2d", "Transform.reverse")]
    fwd = next(s for s in spans if s.name == "Transform.forward")
    assert fwd.counts["ndim.transposes"] == 2 and fwd.counts["wpt.fused_chunks"] == 2


def test_only_the_copies_made_are_counted():
    w = jt.WaveletPacketTransform("Haar", device="cpu")
    for shape, copies in (((1, 4), 0), ((2, 4), 2)):  # one row: its transposed view is contiguous
        before = profiling.counts()
        w.forward_2d(torch.randn(shape), 0, 2)
        after = profiling.counts()
        assert after["ndim.transposes"] - before["ndim.transposes"] == copies
        assert after["ndim.transpose_bytes"] - before["ndim.transpose_bytes"] == copies * 4 * 8


# --------------------------------------------------------------------------
# the rotated 2D route (transforms/wpt.py wpt2d, iwpt2d): its rule, its
# plain kernels and, on the card, the route itself
# --------------------------------------------------------------------------

WPT = sys.modules["jwave_tpu_torch.transforms.wpt"]


def _by_groups(rows, group):
    """(F group, n) rows as (F, n, group): each group of rows transposed."""
    r, n = rows.shape
    return rows.reshape(r // group, group, n).transpose(1, 2)


#: (shape, group, packet length h, bank, levels)
ROTATED = [((6, 32), 2, 32, "Daubechies 4", 3), ((12, 64), 4, 16, "Haar", 2),
           ((16, 16), 16, 16, "Symlet 8", 4), ((8, 128), 8, 4, "Daubechies 4", 2),
           ((64, 64), 64, 64, "Daubechies 4", 6)]


@pytest.mark.parametrize("shape,group,h,wavelet,levels", ROTATED, ids=lambda v: str(v))
def test_the_plain_rotated_forms_are_the_plain_forms_then_the_group_transpose(
        shape, group, h, wavelet, levels):
    fb = jt.get_filter(wavelet)
    x = _stack(shape, 2**31 + sum(shape) + levels, torch.float64)
    y = cuda_wpt.wpt_analysis_rotated_torch(x, fb.dec_lo, fb.dec_hi, levels, group, h)
    want = cuda_wpt.wpt_analysis_torch(x.reshape(-1, h), fb.dec_lo, fb.dec_hi, levels)
    assert torch.equal(y, _by_groups(want.reshape(shape), group))
    z = cuda_wpt.wpt_synthesis_rotated_torch(x, fb.rec_lo, fb.rec_hi, levels, group, h,
                                             fb.recon_gain)
    want = cuda_wpt.wpt_synthesis_torch(x.reshape(-1, h), fb.rec_lo, fb.rec_hi, levels,
                                        fb.recon_gain)
    assert torch.equal(z, _by_groups(want.reshape(shape), group))
    # the kernel wrappers take the plain forms on the CPU
    assert torch.equal(cuda_wpt.wpt_rows_rotated(x, fb.dec_lo, fb.dec_hi, levels, group, h), y)
    assert torch.equal(cuda_wpt.iwpt_rows_rotated(x, fb.rec_lo, fb.rec_hi, levels, group, h,
                                                  fb.recon_gain), z)


@pytest.mark.parametrize("inverse", [False, True], ids=["K8", "K9"])
@pytest.mark.parametrize("shape,group,h,wavelet,levels,rows", [
    case + (rows,) for case in ROTATED for rows in (1, 2, 4, 8) if case[1] % rows == 0],
    ids=lambda v: str(v))
def test_the_rotated_partition_and_store_cover_each_output_once(
        shape, group, h, wavelet, levels, rows, inverse):
    """The rotated kernels' items of ``rows`` full rows (whole items in each
    group) and their last level's column stores
    (``cuda_wpt.wpt_rotated_tiled_torch``) on grids of 1, 3 and one block an
    item, against the plain rotated forms."""
    fb = jt.get_filter(wavelet)
    plan = cuda_wpt.wpt_rotated_plan(shape[1], h, levels, fb.length, inverse, rows)
    assert (plan.tile, plan.rows, plan.full_rows) == (rows * shape[1], rows * shape[1] // h,
                                                      rows)
    x = _stack(shape, 2**31 + rows + levels, torch.float64)
    pair = (fb.rec_lo, fb.rec_hi) if inverse else (fb.dec_lo, fb.dec_hi)
    gain = fb.recon_gain if inverse else 1.0
    plain = cuda_wpt.wpt_synthesis_rotated_torch if inverse else cuda_wpt.wpt_analysis_rotated_torch
    want = plain(x, *pair, levels, group, h, gain)
    for grid in (1, 3, None):
        got = cuda_wpt.wpt_rotated_tiled_torch(x, *pair, levels, group, plan, inverse, h, gain,
                                               grid)
        assert torch.allclose(got, want, rtol=0, atol=1e-13)


def test_a_rotated_item_that_straddles_two_groups_raises():
    fb = jt.get_filter("Daubechies 4")
    plan = cuda_wpt.wpt_rotated_plan(32, 32, 3, fb.length, False, 4)
    x = _stack((12, 32), 3, torch.float64)
    with pytest.raises(IndexError):
        cuda_wpt.wpt_rotated_tiled_torch(x, fb.dec_lo, fb.dec_hi, 3, 6, plan)


def test_the_rotated_plan_for_the_cells_rows():
    """Rows of 2048 at 6 levels (db4): 8 full rows an item, 16,384 floats and
    4 a row of pad in each of two stage sets and the level buffer, 197,456
    shared bytes (one block an SM), 256 compute threads and the producer
    warp; rows of 4096 halve
    to 4 an item; longer rows or rows under 4 have no plan."""
    m = len(taps.SCALING["Daubechies 4"])
    for inverse in (False, True):
        plan = cuda_wpt.wpt_rotated_plan(2048, 2048, 6, m, inverse)
        assert plan == (16384, 8, 8, 197456, 256 + 32)
        assert plan.smem_bytes == 4 * (cuda_wpt.HEAD + 3 * (16384 + 4 + 8 * 4))
        assert cuda_wpt.wpt_rotated_plan(4096, 4096, 6, m, inverse).full_rows == 4
        # packets of 4 in rows of 256: 512 rows of h an item of 8 full rows
        assert cuda_wpt.wpt_rotated_plan(256, 4, 2, m, inverse)[:3] == (2048, 512, 8)
    assert cuda_wpt.wpt_rotated_plan(2 * cuda_wpt.ROT_MAX, 2048, 6, m) is None
    assert cuda_wpt.wpt_rotated_plan(2, 2, 1, m) is None
    assert [cuda_wpt.rot_pad(r) for r in (1, 2, 4, 8, 16)] == [32, 16, 8, 4, 4]


@pytest.fixture
def on_kernel(monkeypatch):
    """The route's device test passed by any float32 tensor, so that the rule
    and the route's plain run are seen on the CPU."""
    monkeypatch.setattr(WPT, "_on_kernel", lambda x: x.dtype == torch.float32)


DB4 = jt.get_filter("Daubechies 4")


@pytest.mark.parametrize("shape,levels,forward,inverse", [
    ((8, 2048, 2048), (6, 6), True, True),     # the packet cell's request
    ((256, 512), (6, 6), True, True),          # one matrix: one frame
    ((2, 3, 64, 128), (3, 5), True, True),     # two leading axes, level_rows != level_cols
    ((2, 256, 512), (None, None), True, True),  # full depth: the forward's last chunks are
                                                # packets of 4 and 8 after a chunk in place
    ((3, 64, 128), (7, 3), False, False),      # 7 levels on rows of 64: the separable path raises
    ((3, 64, 128), (3, 7), False, True),       # rows of 128 at 7: the forward ends in a butterfly
    ((3, 64, 128), (0, 3), False, False),      # level 0: no chunk
    ((4, 64), (2, 2), False, False),           # 4 rows: no item of 8 rows fits the group
    ((3, 48, 64), (2, 2), False, False),       # 48 rows: not a power of two
    ((64,), (None, None), False, False),       # rank 1
])
def test_which_inputs_take_the_rotated_route(on_kernel, shape, levels, forward, inverse):
    x = torch.empty(shape, device="meta")
    lr, lc = levels
    for inv, want in ((False, forward), (True, inverse)):
        passes = WPT._rotated_passes(x, DB4, (lc, lr), inv)
        assert (passes is not None) == want, (inv, passes)
    if forward and inverse:
        passes = WPT._rotated_passes(x, DB4, (lc, lr), False)
        h, w = shape[-2:]
        assert [(n, g) for n, g, _, _ in passes] == [(w, h), (h, w)]


def test_the_route_keeps_off_the_cpu_other_dtypes_and_huge_stacks(on_kernel, monkeypatch):
    x = torch.empty((8, 2048, 2048), device="meta")
    assert WPT._rotated_passes(x, DB4, (6, 6), False) is not None
    assert WPT._rotated_passes(x.double(), DB4, (6, 6), False) is None
    assert WPT._rotated_passes(x.half(), DB4, (6, 6), False) is None
    assert WPT._rotated_passes(torch.empty((512, 2048, 2048), device="meta"), DB4, (6, 6),
                               False) is None
    monkeypatch.undo()  # the route's own test: a CUDA float32 tensor
    assert WPT._rotated_passes(torch.empty((2, 64, 64)), DB4, (6, 6), False) is None


@pytest.mark.parametrize("shape,lr,lc", [((2, 64, 128), 6, 6), ((3, 32, 64), 3, 5),
                                         ((2, 256, 512), None, None)])
def test_the_route_run_plain_matches_the_separable_path_with_no_copy(on_kernel, clean_spans,
                                                                     shape, lr, lc):
    """The route on the CPU (the plain rotated forms) against the separable
    path, float32 and float64 inputs: one ``wpt`` (``iwpt``) span an axis
    under each root, each with today's args, and no transposing copy."""
    x = _stack(shape, 2**31 + sum(shape), torch.float32)
    w = jt.WaveletPacketTransform("Daubechies 4", device="cpu")
    with _profile():
        y = w.forward_2d(x, lr, lc)
        r = w.reverse_2d(y, lr, lc)
    sep_y = ndim.forward_2d(lambda v, lvl: jt.wpt(v, DB4, lvl), x.double(), lr, lc)
    sep_r = ndim.reverse_2d(lambda v, lvl: jt.iwpt(v, DB4, lvl), y.double(), lr, lc)
    assert RelErr().add(y, sep_y).value <= 1e-6 and RelErr().add(r, sep_r).value <= 1e-6
    assert RelErr().add(r, x).value <= 1e-5
    spans = profiling.spans()
    fwd, rev = [s for s in spans if s.parent is None]
    assert (fwd.name, rev.name) == ("wpt2d", "iwpt2d")
    h, wd = shape[-2:]
    for root, inner in ((fwd, "wpt"), (rev, "iwpt")):
        assert "ndim.transposes" not in root.counts and root.counts["wpt.fused_chunks"] >= 2
        got = [s.args["n"] for s in spans if s.request == root.request and s.name == inner]
        assert got == [wd, h] and not any(s.name == "ndim.pass" for s in spans
                                           if s.request == root.request)


# ---- on the card: the route at the cell's size and smaller ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the rotated kernels have no CPU mode")
    return torch.device("cuda")


def _separable(x, lr, lc, inverse=False):
    if inverse:
        return ndim.reverse_2d(lambda v, lvl: jt.iwpt(v, DB4, lvl), x, lr, lc)
    return ndim.forward_2d(lambda v, lvl: jt.wpt(v, DB4, lvl), x, lr, lc)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lr,lc", [((8, 2048, 2048), 6, 6), ((256, 512), 6, 6),
                                         ((4, 256, 512), 3, 5), ((2, 256, 512), None, None)])
def test_the_route_on_the_card_matches_the_separable_path(cuda, shape, lr, lc):
    """``forward_2d``/``reverse_2d`` on the rotated route against the
    separable path over ``wpt``/``iwpt`` on the same card, 1e-6 of max|ref|;
    two rotated passes and no transposing copy each way."""
    x = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(2**31 + 27),
                    device=cuda)
    w = jt.WaveletPacketTransform("Daubechies 4")
    before = profiling.counts()
    y = w.forward_2d(x, lr, lc)
    r = w.reverse_2d(y, lr, lc)
    torch.cuda.synchronize()
    after = profiling.counts()
    assert after["ndim.rotated_passes"] - before["ndim.rotated_passes"] == 4
    assert after["ndim.transposes"] == before["ndim.transposes"]
    assert RelErr().add(y, _separable(x, lr, lc)).value <= 1e-6
    assert RelErr().add(r, _separable(y, lr, lc, True)).value <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["forward_2d", "reverse_2d"])
def test_gradients_through_the_route_match_the_separable_path(cuda, inverse):
    """The gradient of a weighted sum through the route (the rotated K8's
    backward is K9 in place on the gradient transposed back, and the other
    way round) against the same through the separable path on the card."""
    gen = torch.Generator(device=cuda).manual_seed(2**31 + 28)
    x = torch.randn((2, 256, 512), generator=gen, device=cuda, requires_grad=True)
    wgt = torch.randn((2, 256, 512), generator=gen, device=cuda)
    w = jt.WaveletPacketTransform("Daubechies 4")
    fn = w.reverse_2d if inverse else w.forward_2d
    before = profiling.counts()["ndim.rotated_passes"]
    (g,) = torch.autograd.grad((fn(x, 5, 6) * wgt).sum(), x)
    assert profiling.counts()["ndim.rotated_passes"] - before == 2
    (want,) = torch.autograd.grad((_separable(x, 5, 6, inverse) * wgt).sum(), x)
    assert RelErr().add(g, want).value <= 1e-5
