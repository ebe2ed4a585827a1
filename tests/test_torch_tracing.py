"""The port's spans and counters (``jwave_tpu_torch.utils.profiling``) on the
CPU: off, a span is one shared null context that reads no clock and enters
no profiler event; under torch.profiler the facade, the transforms, the
ndim passes and the sliding update record their spans on the Chrome trace's
clock, with request numbers, parents and the roots' counter changes, and
``profiling.trace`` writes them into its Chrome trace.

Tests marked ``cuda`` need a card and skip without one. Run them there with

    python -m pytest tests/test_torch_tracing.py -m cuda --noconftest -o addopts=''
"""
import ast
import ctypes
import importlib
import json
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch.ops import cuda_build  # noqa: E402
from jwave_tpu_torch.utils import host, profiling  # noqa: E402

#: Kineto rounds a trace's base time down to a multiple of this many seconds
TRIMONTH_NS = 7_889_238 * 10**9
# the modules (the package's names ``cwt`` and ``ssq`` are the functions)
tcwt = importlib.import_module("jwave_tpu_torch.transforms.cwt")
tssq = importlib.import_module("jwave_tpu_torch.transforms.ssq")


@pytest.fixture(autouse=True)
def clean():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _boom(*args, **kwargs):
    raise AssertionError("called with no profiler recording")


def test_off_a_span_is_one_shared_object_that_reads_no_clock(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _boom)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(time_ns=_boom))
    a = profiling.span("sliding.update")
    assert a is profiling.span("launch.K1", rows=4, n=8, levels=2)
    with a:
        with profiling.span("inner"):
            pass
    st = jt.sliding_modwt_init(torch.randn(2, 64), "db4", 3)
    jt.sliding_modwt_update(st, torch.randn(2, 8), "db4", 3)
    jt.Transform(jt.FastWaveletTransform("db4")).forward(torch.randn(4, 8, 16), 1, 1, 1)
    jt.modwt(torch.randn(2, 40), "db4", 2)
    assert profiling.spans() == []


def _sliding_spans(level=4):
    st = jt.sliding_modwt_init(torch.randn(3, 128), "db4", level)
    with _profile():
        jt.sliding_modwt_update(st, torch.randn(3, 16), "db4", level)
    return profiling.spans()


def test_a_sliding_update_records_its_upload_taps_levels_and_assembly():
    level = 4
    spans = _sliding_spans(level)
    root = [s for s in spans if s.parent is None]
    assert [s.name for s in root] == ["sliding.update"]
    assert {s.request for s in spans} == {root[0].request}
    kids = [s for s in spans if s is not root[0]]
    assert [s.name for s in kids] == (["sliding.upload", "sliding.taps"]
                                      + ["sliding.level"] * level + ["sliding.assemble"])
    assert all(s.parent == "sliding.update" for s in kids)
    assert [s.args["j"] for s in kids if s.name == "sliding.level"] == list(range(level))
    for s in kids:  # inside the update, one after another
        assert root[0].start_ns <= s.start_ns <= s.end_ns <= root[0].end_ns
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))


def test_the_chrome_trace_holds_each_span_on_the_same_clock(tmp_path):
    level = 4
    st = jt.sliding_modwt_init(torch.randn(3, 128), "db4", level)
    with profiling.trace(str(tmp_path)):
        jt.sliding_modwt_update(st, torch.randn(3, 16), "db4", level)
    spans = profiling.spans()
    data = json.loads((tmp_path / "trace.json").read_text())
    events = data["traceEvents"]
    marks = [e for e in events if str(e.get("name", "")).startswith("jw.")]
    assert all(e["cat"] == "user_annotation" for e in marks)
    assert sorted(e["name"] for e in marks) == sorted("jw." + s.name for s in spans)
    base = spans[0].start_ns // TRIMONTH_NS * TRIMONTH_NS  # Kineto's rule
    assert data.get("baseTimeNanoseconds", base) == base
    # the clock: each level's conv1d, as torch's profiler stamped it, lies
    # inside that level's span converted by the rule
    convs = sorted((e for e in events if e.get("name") == "aten::conv1d"),
                   key=lambda e: float(e["ts"]))
    levels = [s for s in spans if s.name == "sliding.level"]
    assert len(convs) == len(levels) == level
    for s, e in zip(levels, convs):
        a, b = (s.start_ns - base) / 1e3, (s.end_ns - base) / 1e3
        assert a - 50.0 <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= b + 50.0, s


def test_a_3d_facade_forward_records_three_axis_passes():
    tr = jt.Transform(jt.FastWaveletTransform("db4"))
    x = torch.randn(8, 16, 32)
    with _profile():
        y = tr.forward(x, 2, 2, 2)
    torch.testing.assert_close(y, tr.get_basic_transform().forward_3d(x, 2, 2, 2))
    spans = profiling.spans()
    root = [s for s in spans if s.parent is None]
    assert [s.name for s in root] == ["Transform.forward"]
    passes = [s for s in spans if s.name == "ndim.pass"]
    assert [s.args["axis"] for s in passes] == [-1, -2, -3]
    assert all(s.parent == "Transform.forward" for s in passes)
    assert [s.parent for s in spans if s.name == "fwt"] == ["ndim.pass"] * 3
    assert [s.parent for s in spans if s.name == "ndim.transpose"] == ["ndim.pass"] * 3
    assert not [s for s in spans if s.name == "taps"]  # the FWT's taps are made in its launch
    with _profile():
        tr.reverse(y, 2, 2, 2)
    names = [s.name for s in profiling.spans() if s.parent is None]
    assert names == ["Transform.forward", "Transform.reverse"]
    assert len({s.request for s in profiling.spans() if s.parent is None}) == 2


def test_each_root_takes_a_new_request_and_carries_its_counter_changes():
    with _profile():
        with profiling.span("outer", k=1):
            profiling.count("test.things", 2)
            with profiling.span("inner"):
                profiling.count("test.things")
        jt.modwt(torch.randn(2, 40), "db4", 2)
    spans = profiling.spans()
    assert [(s.name, s.parent) for s in spans] == [("inner", "outer"), ("outer", None),
                                                   ("modwt", None)]
    inner, outer, modwt = spans
    assert inner.request == outer.request != modwt.request
    assert outer.args == {"k": 1} and outer.counts == {"test.things": 3}
    assert inner.counts == {} and modwt.counts == {}


def test_counts_hold_every_kernels_launches_beside_the_counters():
    profiling.reset_counts()
    got = profiling.counts()
    assert {f"launch.K{k}" for k in range(1, 10)} <= set(got)
    assert got["upload.calls"] == got["upload.bytes"] == 0
    assert all(v == 0 for v in got.values())
    profiling.count("test.things", 5)
    assert profiling.counts()["test.things"] == 5
    profiling.reset_counts()
    assert profiling.counts()["test.things"] == 0


def test_launch_counts_are_the_launch_counters_of_profiling():
    """``ops.launch_counts()`` is the ``launch.*`` slice of
    ``profiling.counts()``, all eleven listed at 0 after either reset;
    ``ops.reset_launch_counts()`` zeroes those alone; and ``utils/profiling``
    imports nothing of ``ops``."""
    names = [f"launch.{k}" for k in jt.ops.launch_counts()]
    assert len(names) == 11 and {"launch.K6.fused", "launch.K6.peak"} <= set(names)
    profiling.reset_counts()
    assert all(profiling.counts()[k] == 0 for k in names)
    for k in ("launch.K3", "launch.K6.peak", "upload.calls", "K1.whole_row_launches"):
        profiling.count(k, 2)
    got = profiling.counts()
    assert jt.ops.launch_counts() == {k[len("launch."):]: v for k, v in got.items()
                                      if k.startswith("launch.")}
    assert jt.ops.launch_counts()["K3"] == jt.ops.launch_counts()["K6.peak"] == 2
    jt.ops.reset_launch_counts()
    after = profiling.counts()
    assert all(after[k] == 0 for k in names)
    assert {k: v for k, v in after.items() if k not in names} == {
        k: v for k, v in got.items() if k not in names}
    assert after["upload.calls"] == after["K1.whole_row_launches"] == 2
    for node in ast.walk(ast.parse(Path(profiling.__file__).read_text())):
        if isinstance(node, ast.ImportFrom):
            assert "ops" not in (node.module or "").split(".")
            assert all(alias.name != "ops" for alias in node.names)
        elif isinstance(node, ast.Import):
            assert all("ops" not in alias.name.split(".") for alias in node.names)


def test_a_launch_counts_once_its_check_passes(monkeypatch):
    """``cuda_build.launch``: the entry gets its signature once and the
    stream last; a CUDA error raises with the wrapper's name and counts
    nothing; a launch that returns 0 counts one for each K-name it names."""
    class Entry:
        argtypes = None

        def __init__(self, err):
            self.err, self.calls = err, []

        def __call__(self, *args):
            self.calls.append(args)
            return self.err

    lib = types.SimpleNamespace(jw_error_string=lambda err: b"an illegal memory access",
                                jw_bad=Entry(700), jw_good=Entry(0))
    monkeypatch.setattr(cuda_build, "library", lambda name: lib)
    monkeypatch.setattr(cuda_build, "stream_handle", lambda device: "stream")
    signature = [object(), object()]
    jt.ops.reset_launch_counts()
    with pytest.raises(jt.JWaveError, match="^squeeze: CUDA error 700: an illegal memory"):
        cuda_build.launch(("reassign", "jw_bad", signature), (1, 2), "cpu", "squeeze", "K6",
                          "K6.fused")
    assert not any(jt.ops.launch_counts().values())
    for _ in range(2):
        cuda_build.launch(("reassign", "jw_good", signature), (1, 2), "cpu", "squeeze", "K6",
                          "K6.fused")
    assert lib.jw_good.calls == [(1, 2, "stream")] * 2
    assert lib.jw_good.argtypes is signature and lib.jw_good.restype is ctypes.c_int
    assert jt.ops.launch_counts() == {**dict.fromkeys(cuda_build.KERNELS, 0), "K6": 2,
                                      "K6.fused": 2}


def test_copies_to_the_cpu_are_no_uploads():
    profiling.reset_counts()
    host.as_tensor(np.ones(8, np.float32), device="cpu")
    host.copy_to_device(np.ones(8, np.float32), device="cpu")
    st = jt.sliding_modwt_init(torch.randn(2, 64), "db4", 2)
    jt.sliding_modwt_update(st, torch.randn(2, 8), "db4", 2)
    got = profiling.counts()
    assert got["upload.calls"] == 0 and got["upload.bytes"] == 0


def test_the_span_buffer_drops_and_counts_past_its_cap(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAP", 3)
    profiling.reset_counts()
    with _profile():
        for _ in range(5):
            with profiling.span("x"):
                pass
    assert len(profiling.spans()) == 3
    assert profiling.counts()["spans.dropped"] == 2
    assert len(profiling.spans()) == 3  # reading leaves them
    profiling.reset_spans()
    assert profiling.spans() == []


# --------------------------------------------------------------------------
def _ssq_spans(monkeypatch, rows=5, device="cpu"):
    """Two ssq_cwt calls, cold then warm, in chunks of two rows."""
    tcwt._CONSTANTS.clear()
    x = torch.randn(rows, 512, device=device)
    scales = jt.generate_log_scales(4.0, 64.0, 8)
    row = tssq._row_bytes(8, 512, 512, 8, 4)
    monkeypatch.setattr(tssq, "_memory_budget", lambda dev: 2 * row)
    with _profile():
        jt.ssq_cwt(x, scales, "morlet", 1.0)
        jt.ssq_cwt(x, scales, "morlet", 1.0)
    tcwt._CONSTANTS.clear()
    return profiling.spans()


def test_ssq_cwt_records_its_constants_and_each_chunks_transform_and_phase(monkeypatch):
    spans = _ssq_spans(monkeypatch)
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["ssq_cwt", "ssq_cwt"]
    for root, hit in zip(roots, (0, 1)):
        mine = [s for s in spans if s.request == root.request and s is not root]
        top = [s for s in mine if s.parent == "ssq_cwt"]
        assert [s.name for s in top] == ["ssq.constants"] + ["ssq.chunk"] * 3
        assert top[0].args == {"hit": hit}
        chunks = top[1:]
        assert [c.args for c in chunks] == [{"rows": 2, "n": 512, "scales": 8}] * 2 + [
            {"rows": 1, "n": 512, "scales": 8}]
        inner = [s for s in mine if s.parent == "ssq.chunk"]
        assert [s.name for s in inner] == ["ssq.cwt", "ssq.phase"] * 3
        for chunk, (cwt_span, phase) in zip(chunks, zip(inner[::2], inner[1::2])):
            assert chunk.start_ns <= cwt_span.start_ns <= cwt_span.end_ns <= phase.start_ns
            assert phase.end_ns <= chunk.end_ns
        for s in mine:
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        assert root.counts["ssq.chunks"] == 3
        assert root.counts.get("ssq.constant_builds", 0) == 1 - hit


def test_cwt_records_its_root_and_constants():
    tcwt._CONSTANTS.clear()
    x = torch.randn(2, 256)
    with _profile():
        jt.cwt(x, [4.0, 8.0], "morlet", 1.0)
        jt.cwt(x, [4.0, 8.0], "morlet", 1.0)
    tcwt._CONSTANTS.clear()
    spans = profiling.spans()
    assert [(s.name, s.parent) for s in spans] == [
        ("cwt.constants", "cwt"), ("cwt", None)] * 2
    assert [s.args for s in spans if s.name == "cwt.constants"] == [{"hit": 0}, {"hit": 1}]
    assert [s.counts.get("cwt.constant_builds", 0) for s in spans if s.parent is None] == [1, 0]


def test_the_rotated_passes_metric_reads_the_counter(monkeypatch):
    """``benchmark/metrics/rotated_passes.volume.py``: the median over the
    ``Transform.forward`` roots of their ``ndim.rotated_passes`` change (the
    reverse roots not counted), and None for a program that lists no such
    counter, as the parent of the rotated route does."""
    from benchmark import harness, program_spans

    reader = harness.load_reader("per_layer", "rotated_passes.volume")
    roots = [program_spans.Span(name, None, q, 0.0, 1.0, {}, c) for q, (name, c) in enumerate((
        ("Transform.forward", {"ndim.rotated_passes": 3, "launch.K3": 3}),
        ("Transform.reverse", {"ndim.rotated_passes": 3, "launch.K7": 3}),
        ("Transform.forward", {"ndim.rotated_passes": 3}),
        ("Transform.forward", {"launch.K3": 3})))]
    monkeypatch.setattr(program_spans, "records", lambda run: roots)
    run = types.SimpleNamespace()
    assert reader.read(run) == 3
    assert profiling.counts()["ndim.rotated_passes"] >= 0  # listed from the start
    monkeypatch.setattr(program_spans, "_profiling",
                        lambda: types.SimpleNamespace(counts=lambda: {"launch.K3": 3}))
    assert reader.read(run) is None
    monkeypatch.setattr(program_spans, "_profiling", lambda: None)
    assert reader.read(run) is None


# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the uploads and kernel launches happen only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_sliding_update_from_the_host_uploads_twice(card):
    st = jt.sliding_modwt_init(torch.randn(8, 512, device=card), "db4", 5)
    chunk = np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32)
    jt.sliding_modwt_update(st, chunk, "db4", 5)  # warm
    with _profile():
        jt.sliding_modwt_update(st, chunk, "db4", 5)
    (root,) = [s for s in profiling.spans() if s.parent is None]
    assert root.name == "sliding.update"
    assert root.counts["upload.calls"] == 2  # the samples and the filter pair
    assert root.counts["upload.bytes"] == chunk.nbytes + 2 * 8 * 4


@pytest.mark.cuda
def test_the_volume_path_launches_k3_and_k7_inside_their_spans(card):
    tr = jt.Transform(jt.FastWaveletTransform("db4"))
    v = torch.randn(64, 64, 64, device=card)
    tr.reverse(tr.forward(v, 6, 6, 6), 6, 6, 6)  # warm: the library loaded
    with _profile():
        tr.reverse(tr.forward(v, 6, 6, 6), 6, 6, 6)
    spans = profiling.spans()
    k3 = [s for s in spans if s.name == "launch.K3"]
    k7 = [s for s in spans if s.name == "launch.K7"]
    assert [s.parent for s in k3] == ["fwt3d"] * 3 and [s.parent for s in k7] == ["ifwt3d"] * 3
    assert all(s.args["rows"] == 64 * 64 and s.args["n"] == 64 and s.args["rotated"] == 1
               for s in k3 + k7)
    assert not [s for s in spans if s.name in ("ndim.transpose", "ndim.pass")]
    fwd, rev = [s for s in spans if s.parent is None]
    assert fwd.counts["launch.K3"] == 3 and rev.counts["launch.K7"] == 3
    assert fwd.counts["ndim.rotated_passes"] == rev.counts["ndim.rotated_passes"] == 3
    assert "upload.calls" not in fwd.counts  # the taps are on the card already
    assert "library.pyramid.load_s" in profiling.counts()


@pytest.mark.cuda
def test_ssq_cwt_launches_k6_inside_each_chunk_and_uploads_once(card, monkeypatch):
    spans = _ssq_spans(monkeypatch, device=card)
    k6 = [s for s in spans if s.name == "launch.K6"]
    assert [s.parent for s in k6] == ["ssq.chunk"] * 6
    assert [s.args["rows"] for s in k6] == [2, 2, 1] * 2
    cold, warm = [s for s in spans if s.parent is None]
    assert cold.counts["launch.K6"] == warm.counts["launch.K6"] == 3
    assert cold.counts["upload.calls"] > 0 and "upload.calls" not in warm.counts
