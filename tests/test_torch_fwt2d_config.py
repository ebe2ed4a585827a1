"""The 2D fast wavelet transform of the benchmark's configuration
``fwt2d-db4-L6`` (the FWT facade's ``forward_2d``/``reverse_2d`` on stacks of
frames) at small sizes: the facade, on the separable path and on the grouped
route run plain, against the benchmark's plain reference
(``benchmark/reference/fwt.py``) in float64 and float32; the grouped plain
versions of K4 and K5 against the per-frame ones; the route's rule; its
gradients; and the roots, the launches' ``group`` and the rotated passes
under the profiler.

On the card the cell's own size runs in ``tests/test_torch_kernels.py``
(``-m cuda -k "grouped or fwt2d"``).
"""
import sys
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch.ops import cuda_build, cuda_pyramid  # noqa: E402
from jwave_tpu_torch.utils import profiling  # noqa: E402

from benchmark.compare import RelErr  # noqa: E402
from benchmark.reference import fwt as ref  # noqa: E402
from benchmark.reference import taps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LIMITS = json.loads((ROOT / "benchmark" / "limits" / "fwt2d-db4-L6.images-8x2048.json")
                    .read_text())
#: float64 against float64: the two sum the same products in another order
F64_BOUND = 1e-12
FWT = sys.modules["jwave_tpu_torch.transforms.fwt"]
DB4 = jt.get_filter("Daubechies 4")


def _bank(wavelet):
    """(lo, hi) as the reference takes them: the frozen copy for db4, the
    port's orthonormal filters for the other banks."""
    if wavelet == "Daubechies 4":
        return taps.fwt_bank(wavelet)
    fb = jt.get_filter(wavelet)
    return tuple(float(v) for v in fb.dec_lo), tuple(float(v) for v in fb.dec_hi)


def _stack(shape, seed, dtype):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed), dtype=dtype)


@pytest.fixture
def on_kernel(monkeypatch):
    """The route's device test passed by any float32 tensor, so that the rule
    and the route's plain run (the grouped plain versions) are seen on the
    CPU."""
    monkeypatch.setattr(FWT, "_on_kernel", lambda x: x.dtype == torch.float32)


#: (shape, wavelet, level_rows, level_cols): db4 at several levels, Haar at
#: full depth, Symlet 8
CASES = ([((3, 32, 64), "Daubechies 4", lr, lc) for lr, lc in ((1, 1), (3, 4), (5, 6))]
         + [((2, 16, 16), "Daubechies 4", 4, 4), ((2, 16, 16), "Daubechies 4", 2, 3),
            ((3, 32, 64), "Haar", 5, 6), ((2, 16, 16), "Haar", 4, 4),
            ((3, 32, 64), "Symlet 8", 3, 4), ((2, 16, 16), "Symlet 8", 2, 2)])


@pytest.mark.parametrize("route", ["separable", "grouped"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape,wavelet,lr,lc", CASES, ids=lambda v: str(v))
def test_the_facade_in_2d_matches_the_reference(monkeypatch, shape, wavelet, lr, lc, dtype,
                                                route):
    if route == "grouped":  # the grouped K4/K5 passes, run plain on the CPU
        monkeypatch.setattr(FWT, "_on_kernel", lambda x: True)
    x = _stack(shape, 2**31 + sum(shape) + lr + lc, dtype)
    t = jt.FastWaveletTransform(wavelet, device="cpu")
    y = t.forward_2d(x, lr, lc)
    r = t.reverse_2d(y, lr, lc)
    assert y.dtype == r.dtype == dtype and y.shape == r.shape == x.shape
    lo, hi = _bank(wavelet)
    ry = ref.fwt_nd(x, lo, hi, (lr, lc))
    coeffs = RelErr().add(y, ry).value
    recon = RelErr().add(r, ref.ifwt_nd(ry, lo, hi, (lr, lc))).value
    bound = F64_BOUND if dtype == torch.float64 else min(LIMITS.values())
    assert coeffs <= bound and recon <= bound, (coeffs, recon)


@pytest.mark.parametrize("frames,group,n,wavelet,levels,gain", [
    (3, 4, 16, "Daubechies 4", 3, 1.0), (2, 8, 32, "Haar", 5, 1.0),
    (5, 2, 64, "Symlet 8", 2, 1.0), (2, 16, 8, "Haar orthogonal", 3, 0.5),
    (1, 6, 32, "Daubechies 4", 4, 1.0)])
def test_the_grouped_plain_versions_are_each_frame_alone(frames, group, n, wavelet, levels,
                                                        gain):
    """K4's and K5's plain versions in groups: every frame's rows as the
    ungrouped form of that frame alone, (F n, group) stacked, bit for bit;
    one group is the plain transpose of the rows' pyramid, as before."""
    fb = jt.get_filter(wavelet)
    x = _stack((frames * group, n), 2**31 + n + group, torch.float64)
    forms = ((cuda_pyramid.pyramid_rows_transposed_torch, cuda_pyramid.pyramid_rows_torch,
              (fb.dec_lo, fb.dec_hi, levels, gain)),
             (cuda_pyramid.ipyramid_rows_transposed_torch, cuda_pyramid.ipyramid_rows_torch,
              (fb.rec_lo, fb.rec_hi, gain, levels)))
    for grouped, rows, args in forms:
        got = grouped(x, *args, group=group)
        assert tuple(got.shape) == (frames * n, group) and got.is_contiguous()
        alone = torch.cat([grouped(x[f * group:(f + 1) * group], *args)
                           for f in range(frames)])
        assert torch.equal(got, alone)
        whole = grouped(x, *args)
        assert whole.is_contiguous()
        assert torch.equal(whole, rows(x, *args).transpose(0, 1).contiguous())
        assert torch.equal(grouped(x, *args, group=x.shape[0]), whole)


@pytest.mark.parametrize("shape,levels,want", [
    ((8, 2048, 2048), (6, 6), (6, 6)),         # the cell's request
    ((256, 512), (6, 6), (6, 6)),              # one matrix: one frame
    ((2, 3, 64, 128), (3, 5), (5, 3)),         # two leading axes, the passes' order (cols, rows)
    ((5, 16, 256), (None, None), (8, 4)),      # full depth on each axis
    ((3, 1, 64), (None, None), (6, 0)),        # frames of one row
    ((3, 64, 128), (7, 3), None),              # 7 levels on columns of 64: separable (it raises)
    ((3, 48, 64), (2, 2), None),               # 48 rows: not a power of two
    ((2, 32768, 4), (2, 2), None),             # columns of 32768: over a K4 block's rows
    ((0, 16, 16), (2, 2), None),               # no frame
    ((64,), (None, None), None),               # rank 1
])
def test_which_inputs_take_the_grouped_route(on_kernel, shape, levels, want):
    x = torch.empty(shape, device="meta")
    lr, lc = levels
    for rows_per_block in (cuda_pyramid.k4_rows_per_block, cuda_pyramid.k5_rows_per_block):
        assert FWT._frame_levels(x, DB4, (lc, lr), rows_per_block) == want


def test_the_route_keeps_off_the_cpu_other_dtypes_and_huge_stacks(on_kernel, monkeypatch):
    x = torch.empty((8, 2048, 2048), device="meta")
    rule = cuda_pyramid.k4_rows_per_block
    assert FWT._frame_levels(x, DB4, (6, 6), rule) == (6, 6)
    assert FWT._frame_levels(x.double(), DB4, (6, 6), rule) is None
    assert FWT._frame_levels(x.half(), DB4, (6, 6), rule) is None
    assert FWT._frame_levels(torch.empty((512, 2048, 2048), device="meta"), DB4, (6, 6),
                             rule) is None
    monkeypatch.undo()  # the route's own test: a CUDA float32 tensor
    assert FWT._frame_levels(torch.empty((2, 64, 64)), DB4, (6, 6), rule) is None


@pytest.mark.parametrize("which,group", [("K4", 4), ("K5", 4), ("K4", None), ("K5", None)])
def test_the_grouped_functions_backward_is_the_adjoint(which, group):
    """gradcheck of K4's and K5's autograd Functions in groups (their plain
    versions on the CPU, float64): the backward is the other kernel in
    groups on the gradient transposed back within each group."""
    fb = jt.get_filter("Daubechies 4")
    x = _stack((12, 16), 2**31 + 12, torch.float64).requires_grad_()
    if which == "K4":
        def fn(a):
            return cuda_pyramid.pyramid_rows_transposed(a, fb.dec_lo, fb.dec_hi, 2, 0.5,
                                                        group=group)
    else:
        def fn(a):
            return cuda_pyramid.ipyramid_rows_transposed(a, fb.rec_lo, fb.rec_hi, 1.0, 2,
                                                         group=group)
    assert type(fn(x).grad_fn).__name__.endswith("RowsTBackward")
    assert torch.autograd.gradcheck(fn, (x,))


@pytest.fixture
def clean_spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.parametrize("route", ["separable", "grouped"])
def test_the_2d_calls_are_roots_and_children_of_transform(clean_spans, monkeypatch, route):
    """``fwt2d``/``ifwt2d`` roots (children under ``Transform.forward``/
    ``.reverse``): on the separable path an ``ndim.pass`` an axis and two
    transposing copies a root, on the grouped route neither."""
    if route == "grouped":
        monkeypatch.setattr(FWT, "_on_kernel", lambda x: x.dtype == torch.float32)
    x = _stack((2, 32, 64), 7, torch.float32)
    t = jt.FastWaveletTransform("Daubechies 4", device="cpu")
    with _profile():
        t.reverse_2d(t.forward_2d(x, 5, 6), 5, 6)
    spans = profiling.spans()
    fwd, rev = [s for s in spans if s.parent is None]
    assert (fwd.name, rev.name) == ("fwt2d", "ifwt2d") and fwd.request != rev.request
    copies = 2 if route == "separable" else 0
    for root in (fwd, rev):
        passes = [s for s in spans if s.request == root.request and s.name == "ndim.pass"]
        assert len(passes) == copies and root.counts.get("ndim.transposes", 0) == copies
    profiling.reset_spans()
    tr = jt.Transform(t)
    with _profile():
        tr.reverse(tr.forward(x[0], 5, 6), 5, 6)
    spans = profiling.spans()
    assert [s.name for s in spans if s.parent is None] == ["Transform.forward",
                                                           "Transform.reverse"]
    assert [(s.name, s.parent) for s in spans if s.name.endswith("fwt2d")] == [
        ("fwt2d", "Transform.forward"), ("ifwt2d", "Transform.reverse")]


@pytest.mark.parametrize("shape,group,rows_per_block", [
    ((16384, 2048), 2048, 8),   # the cell's pass: 8 rows a block
    ((28, 32), 4, 4),           # groups of 4: blocks of 4, inside one group
    ((6, 32), 2, 2),            # groups of 2
    ((6, 32), None, 8),         # one group: the matrix's blocks, a ragged one
    ((64, 4096), 16, 4),        # rows of 4096: 4 a block
])
@pytest.mark.parametrize("inverse", [False, True], ids=["K4", "K5"])
def test_a_grouped_launch_takes_its_blocks_span_and_count(clean_spans, monkeypatch, shape,
                                                          group, rows_per_block, inverse):
    """What a launch of K4 (K5) hands the kernel, seen on the CPU with the
    launch itself recorded instead: the rows a block (no block across two
    groups), the group, the output (F N, group); a ``launch.K4`` (``K5``)
    span with the ``group`` arg; one rotated pass."""
    launched = []
    monkeypatch.setattr(cuda_pyramid, "_check", lambda *a: None)
    monkeypatch.setattr(cuda_build, "launch", lambda kernel, args, *rest: launched.append(
        (kernel[1], args, rest)))
    x = torch.zeros(shape)
    before = profiling.counts()[cuda_pyramid.ROTATED_PASSES]
    with _profile():
        out = cuda_pyramid._launch_transposed(
            x, DB4.dec_lo, DB4.dec_hi, 3, 1.0, group,
            cuda_pyramid._K5_LAUNCH if inverse else cuda_pyramid._K4_LAUNCH)
    r, n = shape
    g = group or r
    assert tuple(out.shape) == (r // g * n, g)
    ((symbol, args, rest),) = launched
    assert symbol == ("jw_ipyramid_rows_t" if inverse else "jw_pyramid_rows_t")
    assert args[3:10] == (r, n, 3, 8, rows_per_block, 1.0, g)
    assert rest[-1] == ("K5" if inverse else "K4")
    assert profiling.counts()[cuda_pyramid.ROTATED_PASSES] == before + 1
    (sp,) = profiling.spans()
    assert sp.name == f"launch.{rest[-1]}" and sp.args == {"rows": r, "n": n, "levels": 3,
                                                            "group": g}


def test_a_group_that_does_not_divide_the_rows_raises(monkeypatch):
    monkeypatch.setattr(cuda_pyramid, "_check", lambda *a: None)
    with pytest.raises(jt.JWaveFailure, match="groups of 5"):
        cuda_pyramid._launch_transposed(torch.zeros((12, 32)), DB4.dec_lo, DB4.dec_hi, 3, 1.0,
                                        5, cuda_pyramid._K4_LAUNCH)
