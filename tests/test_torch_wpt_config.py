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
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch.ops import cuda_wpt  # noqa: E402
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
