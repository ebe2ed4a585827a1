"""The reader of ``rotated_passes.wpt2d`` on span buffers: the packet cell's
rotated passes a ``wpt2d`` root, 0 for a root that copied instead, and None
for a program that lists no such counter or records no roots."""
import types

import pytest

from benchmark import harness, program_spans

METRIC = "rotated_passes.wpt2d"


def _roots(passes):
    s = program_spans.Span
    return [s("wpt2d", None, 1, 0.0, 40.0, {}, {"ndim.rotated_passes": passes[0]}),
            s("iwpt2d", None, 2, 40.0, 99.0, {}, {"ndim.rotated_passes": 2}),
            s("wpt2d", None, 3, 100.0, 160.0, {}, {"ndim.rotated_passes": passes[1]}),
            s("wpt2d", None, 4, 160.0, 200.0, {}, {"ndim.rotated_passes": passes[2]})]


@pytest.mark.parametrize("passes,want", [((2, 2, 2), 2), ((2, 1, 2), 2), ((0, 0, 2), 0)])
def test_the_metric_is_the_median_over_the_forward_roots(monkeypatch, passes, want):
    monkeypatch.setattr(program_spans, "records", lambda run: _roots(passes))
    reader = harness.load_reader("per_layer", METRIC)
    assert reader.read(types.SimpleNamespace()) == want


def test_a_root_that_rotated_nothing_reads_zero(monkeypatch):
    s = program_spans.Span
    spans = [s("wpt2d", None, 1, 0.0, 40.0, {}, {"ndim.transposes": 2})]
    monkeypatch.setattr(program_spans, "records", lambda run: spans)
    assert harness.load_reader("per_layer", METRIC).read(types.SimpleNamespace()) == 0


def test_a_program_without_the_counter_or_the_roots_reads_none(monkeypatch):
    reader = harness.load_reader("per_layer", METRIC)
    monkeypatch.setattr(program_spans, "records", lambda run: _roots((2, 2, 2)))
    monkeypatch.setattr(program_spans, "_profiling",
                        lambda: types.SimpleNamespace(counts=lambda: {"launch.K8": 2}))
    assert reader.read(types.SimpleNamespace()) is None
    monkeypatch.setattr(program_spans, "_profiling", lambda: None)
    assert reader.read(types.SimpleNamespace()) is None
    monkeypatch.undo()
    monkeypatch.setattr(program_spans, "records", lambda run: None)
    assert reader.read(types.SimpleNamespace()) is None
