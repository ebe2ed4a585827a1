"""The cell ``wpt-db4-L6.frames-8x2048`` on the CPU at tiny sizes: its
configuration's one cut, the entry's inputs and check against the reference,
the reference in lower precisions against the cell's limits, K8's and K9's
work by hand, and the packet layer's metric readers on span buffers."""
import contextlib
import json
import math
import types
from pathlib import Path

import pytest
import torch

from benchmark import harness, program_spans, roofline, wpt_work
from benchmark.compare import RelErr
from benchmark.entries import wpt2d_roundtrip
from benchmark.reference import taps
from benchmark.reference import wpt as ref
from benchmark.reference.precision import TF32
from benchmark.reference.ssq import BF16

BENCH = Path(__file__).resolve().parents[1]
CELL = "wpt-db4-L6.frames-8x2048"
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
CFG = json.loads((BENCH / "configs" / "wpt-db4-L6.json").read_text())
MIX = json.loads((BENCH / "traffic" / "frames-8x2048.json").read_text())
LIMITS = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())


def _nospan(name):
    return contextlib.nullcontext()


def test_the_configuration_states_the_deployment_and_its_one_cut():
    assert CFG["reduced"] == ["frames"] and CFG["frames"] == MIX["shape"][0] == 8
    assert "source_frames" in CFG and set(CFG["assumed"]) >= {"levels", "frames"}
    assert (CFG["wavelet"], CFG["level"], CFG["dtype"], CFG["tf32"]) == (
        "Daubechies 4", 6, "float32", False)
    assert MIX["shape"][1:] == [2048, 2048]  # the source's image, not cut
    config = next(c for c in SPEC["configs"] if c["name"] == CFG["name"])
    assert config["source"] == CFG["source"] and config["reduced"] == CFG["reduced"]
    cell = harness.resolve(SPEC, CELL)
    assert cell.mix["entry"] == "wpt2d_roundtrip" and set(cell.limits) == {"coeffs_err",
                                                                           "recon_err"}
    assert (cell.mix["in_flight"], cell.mix["warmup"], cell.mix["sample"],
            cell.mix["distinct_inputs"]) == (8, 3, 2, 4)
    assert cell.limits == {"coeffs_err": 3e-5, "recon_err": 3e-5}


def _cell(seed, shape=(2, 32, 64), level=5):
    import jwave_tpu_torch as jt

    return wpt2d_roundtrip.Cell(jt, {**CFG, "level": level}, {**MIX, "shape": list(shape)},
                                seed, "cpu", _nospan)


def test_inputs_come_from_the_seed():
    a, b, c = _cell(2**31 + 9), _cell(2**31 + 9), _cell(4)
    assert a.x.dtype == torch.float32 and tuple(a.x.shape) == (4, 2, 32, 64)
    assert torch.equal(a.x, b.x) and not torch.equal(a.x, c.x)
    assert a.units(0) == 2 * 32 * 64
    assert abs(float(a.x.double().std()) - 1.0) < 0.05


def test_the_entry_passes_its_check_and_a_wrong_answer_fails():
    c = _cell(2**31 + 1)
    kept = [(i, c.call(i), None) for i in range(2)]
    errs = c.check(kept)
    assert set(errs) == set(LIMITS) and all(len(v) == 2 for v in errs.values())
    assert all(max(v) <= LIMITS[k] for k, v in errs.items()), errs
    y, r = kept[1][1]
    # the packets of the last level swapped in pairs along each row
    swapped = y.reshape(2, 32, 16, 2, 2).flip(-2).reshape(y.shape)
    bad = c.check([(1, (swapped, r), None)])
    assert bad["coeffs_err"][0] > 0.1 and bad["recon_err"][0] <= LIMITS["recon_err"]
    assert c.check([(1, (y, r * 0.5), None)])["recon_err"][0] > 0.1
    nan = y.clone()
    nan[0, 0, 0] = float("nan")
    assert c.check([(1, (nan, r), None)])["coeffs_err"] == [math.inf]
    # a request takes its own stack: another stack's answer fails
    assert c.check([(2, (y, r), None)])["coeffs_err"][0] > 0.1


@pytest.mark.parametrize("prec", [TF32, BF16], ids=lambda p: p.name)
def test_the_reference_in_a_lower_precision_fails_the_cells_limits(prec):
    c = _cell(2**31 + 3, shape=(1, 64, 128), level=6)
    lo, hi = taps.fwt_bank(CFG["wavelet"])
    x = c.x[0, 0]
    want = ref.wpt_nd(x, lo, hi, (6, 6))
    low = ref.wpt_nd(x, lo, hi, (6, 6), prec=prec)
    coeffs = RelErr().add(low, want).value
    recon = RelErr().add(ref.iwpt_nd(low, lo, hi, (6, 6), prec=prec),
                         ref.iwpt_nd(want, lo, hi, (6, 6))).value
    assert coeffs > LIMITS["coeffs_err"] and recon > LIMITS["recon_err"], (coeffs, recon)


def test_k8_k9_work_by_hand():
    # the cell's pass: 16384 rows of 2048, 6 levels of 8 taps
    b, f = wpt_work.wpt_rows(16384, 2048, 6, 8)
    assert b == 2 * 4 * 16384 * 2048 == 268_435_456
    assert f == 2 * 8 * 2048 * 6 * 16384 == 3_221_225_472
    # bound by bytes: 80.1 us at 3.35 TB/s against 48.1 us of flops at 67 TFLOP/s
    assert roofline.bound_s(b, f) == pytest.approx(b / roofline.HBM_BYTES_PER_S)
    assert roofline.bound_s(b, f) == pytest.approx(80.13e-6, rel=1e-3)
    # a level's flops are those of the pyramid's first step on the same rows
    assert wpt_work.wpt_rows(3, 64, 1, 8)[1] == roofline.pyramid_rows(3, 64, 1, 8)[1]
    c = _cell(1, shape=(2, 32, 64), level=5)
    assert c.kernel_work(0) == [("K8", *wpt_work.wpt_rows(64, 64, 5, 8)),
                                ("K8", *wpt_work.wpt_rows(128, 32, 5, 8)),
                                ("K9", *wpt_work.wpt_rows(64, 64, 5, 8)),
                                ("K9", *wpt_work.wpt_rows(128, 32, 5, 8))]


def _roots():
    """Two requests: a ``wpt2d`` root with two ``wpt`` spans of 10 and 12 us
    and two copies, an ``iwpt2d`` root (not read), then a ``wpt2d`` root with
    spans of 20 and 24 us."""
    s = program_spans.Span
    return [s("wpt", "ndim.pass", 1, 1.0, 11.0, {}, {}),
            s("wpt", "ndim.pass", 1, 20.0, 32.0, {}, {}),
            s("wpt2d", None, 1, 0.0, 40.0, {}, {"ndim.transposes": 2, "launch.K8": 2}),
            s("iwpt", "ndim.pass", 2, 41.0, 90.0, {}, {}),
            s("iwpt2d", None, 2, 40.0, 99.0, {}, {"ndim.transposes": 2, "launch.K9": 2}),
            s("wpt", "ndim.pass", 3, 101.0, 121.0, {}, {}),
            s("wpt", "ndim.pass", 3, 130.0, 154.0, {}, {}),
            s("wpt2d", None, 3, 100.0, 160.0, {}, {"ndim.transposes": 2})]


@pytest.mark.parametrize("metric,want", [("transposes.wpt2d", 2),
                                         ("wpt_us.wpt2d", (22 + 44) / 2)])
def test_each_packet_metric_reads_its_roots(monkeypatch, metric, want):
    monkeypatch.setattr(program_spans, "records", lambda run: _roots())
    reader = harness.load_reader("per_layer", metric)
    assert reader.read(types.SimpleNamespace()) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["transposes.wpt2d", "wpt_us.wpt2d"])
def test_a_program_without_the_roots_reads_none(monkeypatch, metric):
    reader = harness.load_reader("per_layer", metric)
    # the parent's program: the facade's 2D calls are bare ndim passes
    bare = [program_spans.Span("ndim.pass", None, 1, 0.0, 10.0, {"axis": -1}, {})]
    monkeypatch.setattr(program_spans, "records", lambda run: bare)
    assert reader.read(types.SimpleNamespace()) is None
    monkeypatch.setattr(program_spans, "records", lambda run: None)
    assert reader.read(types.SimpleNamespace()) is None


def test_the_cell_runs_on_the_cpu_at_a_tiny_size():
    run = harness.run_cell(CELL, 2**31 + 11, 0.2, False, device="cpu",
                           mix={"shape": [2, 64, 64], "warmup": 1, "in_flight": 2})
    assert harness.correct(run) and run.requests >= 1
    assert run.units == run.requests * 2 * 64 * 64
    assert set(run.checks) == set(LIMITS)
