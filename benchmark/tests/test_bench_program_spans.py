"""The readers of the program's own spans and counters
(``benchmark/program_spans.py`` and the metrics that use it), on synthetic
traces and span buffers: the clock conversion, the check that every root
lies inside its request's ``bench.call``, the idle time inside the program,
the sliding update's medians and the kernel libraries' load time."""
import types

import pytest

from benchmark import harness, program_spans
from benchmark import trace as tracing

PERIOD_NS = program_spans.TRIMONTH_S * 10**9
BASE = 230 * PERIOD_NS  # a trace base by Kineto's rule


def _ns(us: float) -> int:
    return BASE + int(round(us * 1000))


def _trace(device, calls, window=(0.0, 100.0)):
    events = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
               "ts": window[0], "dur": window[1] - window[0]}]
    events += [{"ph": "X", "cat": "kernel", "name": "k", "ts": a, "dur": b - a}
               for a, b in device]
    events += [{"ph": "X", "cat": "user_annotation", "name": "bench.call", "ts": a, "dur": b - a}
               for a, b in calls]
    return tracing.Trace(events)


def _rec(name, parent, request, a_us, b_us, args=None, counts=None):
    return (name, parent, request, _ns(a_us), _ns(b_us), args or {}, counts or {})


def _run(trace):
    return types.SimpleNamespace(trace=trace)


class _Program:
    """Stands for ``jwave_tpu_torch.utils.profiling``."""

    def __init__(self, raw, counts=None):
        self.raw, self.counts_ = raw, counts or {}

    def spans(self):
        return list(self.raw)

    def counts(self):
        return dict(self.counts_)


@pytest.fixture
def program(monkeypatch):
    """Sets the span buffer (and counters) the readers find."""
    def put(raw, counts=None):
        monkeypatch.setattr(program_spans, "_profiling", lambda: _Program(raw, counts))
    return put


#: two requests: device busy 0-10, 30-55 and 80-100 of a 100 us slice
TRACE = _trace(device=[(0, 10), (30, 55), (80, 100)], calls=[(0, 40), (50, 90)])
RAW = [_rec("taps", "modwt", 1, 6, 8), _rec("modwt", None, 1, 5, 35),
       _rec("launch.K1", "imodwt", 2, 60, 84), _rec("imodwt", None, 2, 52, 85)]


def test_stamps_convert_to_the_traces_microseconds_by_kinetos_rule():
    assert program_spans.base_ns(BASE) == BASE
    assert program_spans.base_ns(BASE + PERIOD_NS - 1) == BASE
    assert program_spans.base_ns(BASE - 1) == BASE - PERIOD_NS
    spans = program_spans.convert(RAW)
    assert [(s.name, s.start, s.end) for s in spans][:2] == [("taps", 6.0, 8.0),
                                                              ("modwt", 5.0, 35.0)]
    assert spans[1].parent is None and spans[0].request == spans[1].request == 1


def _records(program, raw, trace=TRACE):
    program(raw)
    return program_spans.records(_run(trace))


def test_roots_must_lie_inside_their_requests_call(program):
    assert _records(program, RAW) is not None
    # out by up to 20 us at either end is still inside
    ok = (RAW[:1] + [_rec("modwt", None, 1, -15, 35)] + RAW[2:3]
          + [_rec("imodwt", None, 2, 52, 108)])
    assert _records(program, ok) is not None
    for late in (_rec("imodwt", None, 2, 52, 111), _rec("imodwt", None, 2, 112, 118)):
        assert _records(program, RAW[:3] + [late]) is None
        assert program_spans.idle_in_program(_run(TRACE)) is None
        assert program_spans.median_child_us(_run(TRACE), "imodwt", "launch.K1") is None
    assert _records(program, [_rec("modwt", None, 1, -25, 35)]) is None  # before the first call
    # a clock off by a whole ms (the stamps read against another base)
    shifted = [(n, p, q, a + 10**6, b + 10**6, x, c) for n, p, q, a, b, x, c in RAW]
    assert _records(program, shifted) is None


def test_nothing_to_read_gives_none(program):
    assert _records(program, RAW, trace=None) is None
    assert _records(program, []) is None
    assert _records(program, RAW, trace=_trace([], calls=[])) is None
    assert _records(program, [RAW[0]]) is None  # no root


def test_idle_in_program_is_the_gaps_inside_root_spans(program):
    # gaps 10-30 and 55-80; roots 5-35 and 52-85 hold all 45 us of them
    program(RAW)
    assert program_spans.idle_in_program(_run(TRACE)) == pytest.approx(45.0)
    # a root that covers only part of a gap counts that part
    program(RAW[:1] + [_rec("modwt", None, 1, 5, 20)] + RAW[2:])
    assert program_spans.idle_in_program(_run(TRACE)) == pytest.approx(10.0 + 25.0)


def test_idle_by_span_names_the_innermost_program_span(program):
    program([_rec("launch.K1", "modwt", 1, 15, 25), _rec("modwt", None, 1, 5, 35),
             _rec("imodwt", None, 2, 52, 85)])
    got = program_spans.idle_by_span(_run(TRACE))
    assert got == [["imodwt", pytest.approx(25e-6)], ["launch.K1", pytest.approx(20e-6)]]
    program([_rec("modwt", None, 1, 5, 30)])
    wide = _trace(device=[(0, 10)], calls=[(0, 40)], window=(0.0, 100.0))
    got = program_spans.idle_by_span(_run(wide))
    assert got == [["outside", pytest.approx(90e-6)]]  # the gap's middle, 55, is outside


def _updates():
    """Three sliding updates, one a call; uploads 10, 30 and 20 us; levels
    2 + 3, 4 + 4 and 1 + 1 us; taps absent from the third."""
    calls = [(0, 100), (100, 200), (200, 300)]
    raw = []
    for q, (t0, up, levels, taps, copies) in enumerate(
            [(0, 10, (2, 3), 7, 2), (100, 30, (4, 4), 5, 2), (200, 20, (1, 1), None, 3)]):
        t = t0 + 1
        raw.append(_rec("sliding.upload", "sliding.update", q, t, t + up))
        t += up
        if taps is not None:
            raw.append(_rec("sliding.taps", "sliding.update", q, t, t + taps))
            t += taps
        for j, d in enumerate(levels):
            raw.append(_rec("sliding.level", "sliding.update", q, t, t + d, {"j": j}))
            t += d
        raw.append(_rec("sliding.update", None, q, t0 + 1, t + 1, {},
                        {"upload.calls": copies, "upload.bytes": 64 * copies}))
    return _run(_trace([(0, 1)], calls, window=(0.0, 300.0))), raw


def test_the_sliding_medians_over_updates(program):
    run, raw = _updates()
    program(raw)
    # the slice is idle from 1 us on; the three updates hold 23 + 44 + 23 us of it
    assert program_spans.idle_in_program(run) == pytest.approx(30.0)
    med = program_spans.median_child_us
    assert med(run, "sliding.update", "sliding.upload") == pytest.approx(20.0)
    assert med(run, "sliding.update", "sliding.level") == pytest.approx(5.0)  # 5, 8, 2
    assert med(run, "sliding.update", "sliding.taps") == pytest.approx(5.0)  # 7, 5, 0
    assert program_spans.median_root_count(run, "sliding.update", "upload.calls") == 2
    assert med(run, "modwt", "taps") is None


@pytest.mark.parametrize("metric,want", [
    ("upload_us.stream", 20.0), ("taps_us.stream", 5.0), ("levels_us.stream", 5.0),
    ("uploads.stream", 2), ("idle_in_program.stream", 30.0),
    ("kernel_load_s", 2.5)])
def test_each_metric_reads_the_programs_buffer(program, metric, want):
    run, raw = _updates()
    program(raw, {"library.modwt.load_s": 2.0, "library.pyramid.load_s": 0.5, "upload.calls": 9})
    assert harness.load_reader("per_layer", metric).read(run) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["upload_us.stream", "taps_us.stream", "levels_us.stream",
                                    "uploads.stream", "idle_in_program.batch",
                                    "idle_in_program.stream", "kernel_load_s"])
def test_a_program_without_spans_reads_none(monkeypatch, metric):
    run, _ = _updates()
    monkeypatch.setattr(program_spans, "_profiling", lambda: None)
    assert harness.load_reader("per_layer", metric).read(run) is None
    # and one that records nothing, no library loaded
    monkeypatch.setattr(program_spans, "_profiling", lambda: _Program([], {"upload.calls": 0}))
    assert harness.load_reader("per_layer", metric).read(run) is None


def test_the_program_in_this_checkout_records_spans():
    prof = program_spans._profiling()
    assert prof is not None and isinstance(prof.spans(), list)
