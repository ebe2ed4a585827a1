"""The cell ``fwt2d-db4-L6.images-8x2048`` on the CPU at tiny sizes: its
configuration's one cut, the entry's inputs and check against the reference,
the reference in lower precisions against the cell's limits, K4's and K5's
work by hand, and the 2D route's metric readers on span buffers."""
import contextlib
import json
import math
import types
from pathlib import Path

import pytest
import torch

from benchmark import harness, program_spans, roofline
from benchmark.compare import RelErr
from benchmark.entries import fwt2d_frames_roundtrip
from benchmark.reference import fwt as ref
from benchmark.reference import taps
from benchmark.reference.precision import TF32
from benchmark.reference.ssq import BF16

BENCH = Path(__file__).resolve().parents[1]
CELL = "fwt2d-db4-L6.images-8x2048"
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
CFG = json.loads((BENCH / "configs" / "fwt2d-db4-L6.json").read_text())
MIX = json.loads((BENCH / "traffic" / "images-8x2048.json").read_text())
LIMITS = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())


def _nospan(name):
    return contextlib.nullcontext()


def test_the_configuration_states_the_deployment_and_its_one_cut():
    assert CFG["reduced"] == ["frames"] and CFG["frames"] == MIX["shape"][0] == 8
    assert "source_frames" in CFG and set(CFG["assumed"]) >= {"levels", "frames"}
    assert (CFG["wavelet"], CFG["level"], CFG["dtype"], CFG["tf32"]) == (
        "Daubechies 4", 6, "float32", False)
    assert MIX["shape"][1:] == [2048, 2048]  # the source's image, not cut
    volume = json.loads((BENCH / "configs" / "fwt-db4-L6.json").read_text())
    assert CFG["guarantees"] == volume["guarantees"] and CFG["source"] == volume["source"]
    config = next(c for c in SPEC["configs"] if c["name"] == CFG["name"])
    assert config["source"] == CFG["source"] and config["reduced"] == CFG["reduced"]
    cell = harness.resolve(SPEC, CELL)
    assert cell.workload["chips"] == 1 and cell.mix["entry"] == "fwt2d_frames_roundtrip"
    assert (cell.mix["in_flight"], cell.mix["warmup"], cell.mix["sample"],
            cell.mix["distinct_inputs"]) == (8, 3, 2, 4)
    assert cell.limits == {"coeffs_err": 3e-5, "recon_err": 3e-5}


def test_the_cell_reports_the_batch_metrics_and_its_own_and_not_copy_ms():
    per_layer = {m["name"] for m in harness.metrics_for(SPEC, CELL, "per_layer")}
    assert per_layer == {"kernel_roofline", "idle_share.batch", "host_us.batch",
                         "idle_in_program.batch", "kernel_load_s", "rotated_passes.fwt2d",
                         "transposes.fwt2d", "fwt2d_us.fwt2d"}
    assert {m["name"] for m in harness.metrics_for(SPEC, CELL, "end_to_end")} == {
        "throughput", "setup_s"}
    mine = [m for m in SPEC["per_layer"] if m["name"].endswith(".fwt2d")]
    assert all((m["layer"], m["moves"], m["workloads"]) == ("ndim", "throughput", [CELL])
               for m in mine) and len(mine) == 3


def _cell(seed, shape=(2, 32, 64), level=5):
    import jwave_tpu_torch as jt

    return fwt2d_frames_roundtrip.Cell(jt, {**CFG, "level": level},
                                       {**MIX, "shape": list(shape)}, seed, "cpu", _nospan)


def test_inputs_come_from_the_seed():
    a, b, c = _cell(2**31 + 9), _cell(2**31 + 9), _cell(4)
    assert a.x.dtype == torch.float32 and tuple(a.x.shape) == (4, 2, 32, 64)
    assert torch.equal(a.x, b.x) and not torch.equal(a.x, c.x)
    assert a.units(0) == 2 * 32 * 64
    assert _cell(1, shape=tuple(MIX["shape"][:1]) + (4, 4)).units(0) == 8 * 16
    assert abs(float(a.x.double().std()) - 1.0) < 0.05


def test_the_entry_passes_its_check_and_a_wrong_answer_fails():
    c = _cell(2**31 + 1)
    kept = [(i, c.call(i), None) for i in range(2)]
    errs = c.check(kept)
    assert set(errs) == set(LIMITS) and all(len(v) == 2 for v in errs.values())
    assert all(max(v) <= LIMITS[k] for k, v in errs.items()), errs
    y, r = kept[1][1]
    # the layout [A_L | D_L | ... | D_1] along each row: the finest details first fails
    swapped = torch.cat([y[..., 32:], y[..., :32]], dim=-1)
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
    want = ref.fwt_nd(x, lo, hi, (6, 6))
    low = ref.fwt_nd(x, lo, hi, (6, 6), prec=prec)
    coeffs = RelErr().add(low, want).value
    recon = RelErr().add(ref.ifwt_nd(low, lo, hi, (6, 6), prec=prec),
                         ref.ifwt_nd(want, lo, hi, (6, 6))).value
    assert coeffs > LIMITS["coeffs_err"] and recon > LIMITS["recon_err"], (coeffs, recon)


def test_k4_k5_work_by_hand():
    # the cell's pass: 16384 rows of 2048, 6 levels of 8 taps
    b, f = roofline.pyramid_rows(16384, 2048, 6, 8)
    assert b == 2 * 4 * 16384 * 2048 == 268_435_456
    assert f == 2 * 8 * (2048 + 1024 + 512 + 256 + 128 + 64) * 16384 == 1_056_964_608
    # bound by bytes: 80.1 us at 3.35 TB/s against 15.8 us of flops at 67 TFLOP/s
    assert roofline.bound_s(b, f) == pytest.approx(b / roofline.HBM_BYTES_PER_S)
    assert roofline.bound_s(b, f) == pytest.approx(80.13e-6, rel=1e-3)
    c = _cell(1, shape=(2, 32, 64), level=5)
    assert c.kernel_work(0) == [("K4", *roofline.pyramid_rows(64, 64, 5, 8)),
                                ("K4", *roofline.pyramid_rows(128, 32, 5, 8)),
                                ("K5", *roofline.pyramid_rows(64, 64, 5, 8)),
                                ("K5", *roofline.pyramid_rows(128, 32, 5, 8))]
    # the symbols kernel_roofline reads K4 and K5 by
    assert roofline.kernel_of("(anonymous namespace)::pyramid_rows_t_kernel(float*)") == "K4"
    assert roofline.kernel_of("ipyramid_rows_t_kernel(float const*)") == "K5"


def _roots():
    """Two requests: an ``fwt2d`` root of 40 us with its two rotated passes
    and an ``ifwt2d`` root of 59 us, then an ``fwt2d`` root of 60 us that
    copied (the separable path) and an ``ifwt2d`` root of 30 us."""
    s = program_spans.Span
    return [s("launch.K4", "fwt2d", 1, 1.0, 11.0, {"group": 2048}, {}),
            s("fwt2d", None, 1, 0.0, 40.0, {}, {"ndim.rotated_passes": 2, "launch.K4": 2}),
            s("ifwt2d", None, 2, 40.0, 99.0, {}, {"ndim.rotated_passes": 2, "launch.K5": 2}),
            s("ndim.pass", "fwt2d", 3, 101.0, 121.0, {"axis": -1}, {}),
            s("fwt2d", None, 3, 100.0, 160.0, {}, {"ndim.transposes": 2}),
            s("ifwt2d", None, 4, 160.0, 190.0, {}, {"ndim.transposes": 2})]


@pytest.mark.parametrize("metric,want", [("rotated_passes.fwt2d", 1), ("transposes.fwt2d", 1),
                                         ("fwt2d_us.fwt2d", (40 + 60) / 2 + (59 + 30) / 2)])
def test_each_2d_route_metric_reads_its_roots(monkeypatch, metric, want):
    monkeypatch.setattr(program_spans, "records", lambda run: _roots())
    reader = harness.load_reader("per_layer", metric)
    assert reader.read(types.SimpleNamespace()) == pytest.approx(want)


def test_the_route_reads_two_rotated_passes_and_no_copy(monkeypatch):
    spans = [s for s in _roots() if s.request in (1, 2)]
    monkeypatch.setattr(program_spans, "records", lambda run: spans)
    read = {m: harness.load_reader("per_layer", m).read(types.SimpleNamespace())
            for m in ("rotated_passes.fwt2d", "transposes.fwt2d")}
    assert read == {"rotated_passes.fwt2d": 2, "transposes.fwt2d": 0}


@pytest.mark.parametrize("metric", ["rotated_passes.fwt2d", "transposes.fwt2d",
                                    "fwt2d_us.fwt2d"])
def test_a_program_without_the_roots_reads_none(monkeypatch, metric):
    reader = harness.load_reader("per_layer", metric)
    # the parent's program: a stack's 2D calls are bare ndim passes
    bare = [program_spans.Span("ndim.pass", None, 1, 0.0, 10.0, {"axis": -1},
                               {"ndim.transposes": 1})]
    monkeypatch.setattr(program_spans, "records", lambda run: bare)
    assert reader.read(types.SimpleNamespace()) is None
    monkeypatch.setattr(program_spans, "records", lambda run: None)
    assert reader.read(types.SimpleNamespace()) is None


def test_the_rotated_passes_reader_needs_the_counter(monkeypatch):
    reader = harness.load_reader("per_layer", "rotated_passes.fwt2d")
    monkeypatch.setattr(program_spans, "records", lambda run: _roots())
    monkeypatch.setattr(program_spans, "_profiling",
                        lambda: types.SimpleNamespace(counts=lambda: {"launch.K4": 2}))
    assert reader.read(types.SimpleNamespace()) is None


def test_the_cell_runs_on_the_cpu_at_a_tiny_size():
    run = harness.run_cell(CELL, 2**31 + 11, 0.2, False, device="cpu",
                           mix={"shape": [2, 64, 64], "warmup": 1, "in_flight": 2})
    assert harness.correct(run) and run.requests >= 1
    assert run.units == run.requests * 2 * 64 * 64
    assert set(run.checks) == set(LIMITS)
