"""The cell ``cwt-morlet-64.ssq-32x1M`` on the CPU at tiny sizes: its
configuration's keys, the entry's inputs and check against the reference,
the check's arithmetic (slack, column sums, the share of weight moved),
K6's work by hand, and the continuous layer's metric readers on synthetic
traces and span buffers."""
import contextlib
import json
import math
import types
from pathlib import Path

import pytest
import torch

from benchmark import harness, program_spans, reassign_work, roofline
from benchmark import trace as tracing
from benchmark.entries import ssq_cwt
from benchmark.reference import ssq as ref
from benchmark.reference.precision import TF32

BENCH = Path(__file__).resolve().parents[1]
CELL = "cwt-morlet-64.ssq-32x1M"
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
CFG = json.loads((BENCH / "configs" / "cwt-morlet-64.json").read_text())
MIX = json.loads((BENCH / "traffic" / "ssq-32x1M.json").read_text())
LIMITS = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())


def _nospan(name):
    return contextlib.nullcontext()


def test_the_configuration_states_the_deployment_and_its_one_cut():
    assert CFG["reduced"] == ["channels"] and CFG["channels"] == MIX["channels"] == 32
    assert set(CFG["assumed"]) >= {"Morlet(6.0)", "scale range", "chirp", "channels"}
    # Morlet(6.0): centre angular frequency 6 rad with the Gaussian exp(-t^2 / 2)
    assert CFG["fb"] == 1.0 and CFG["omega0"] == 6.0
    assert math.isclose(2 * math.pi * CFG["fc"], CFG["omega0"])
    assert CFG["scales"] == CFG["bins"] == 64 and CFG["samples"] == MIX["samples"] == 2**20
    assert (CFG["dtype"], CFG["out_dtype"], CFG["out_of_range"], CFG["padding"]) == (
        "float32", "complex64", "clip", "symmetric")
    assert CFG["tf32"] is False
    config = next(c for c in SPEC["configs"] if c["name"] == CFG["name"])
    assert config["source"] == CFG["source"] and config["reduced"] == CFG["reduced"]
    cell = harness.resolve(SPEC, CELL)
    assert cell.mix["entry"] == "ssq_cwt" and set(cell.limits) == {"conserve_err", "tx_err",
                                                                    "flip_share"}
    assert (cell.mix["in_flight"], cell.mix["warmup"], cell.mix["sample"],
            cell.mix["distinct_inputs"]) == (2, 3, 1, 2)


def _cell(seed, channels=3, samples=4096, scales=16):
    import jwave_tpu_torch as jt

    cfg = {**CFG, "scales": scales, "bins": scales}
    mix = {**MIX, "channels": channels, "samples": samples}
    return ssq_cwt.Cell(jt, cfg, mix, seed, "cpu", _nospan)


def test_inputs_come_from_the_seed_and_stay_in_the_band():
    a, b, c = _cell(2**31 + 9), _cell(2**31 + 9), _cell(4)
    assert a.x.dtype == torch.float32 and tuple(a.x.shape) == (2, 3, 4096)
    assert torch.equal(a.x, b.x) and not torch.equal(a.x, c.x)
    # unit cosines in noise of variance 0.05: the power of each channel ~0.55
    power = a.x.double().pow(2).mean(dim=-1)
    assert bool(((power > 0.45) & (power < 0.65)).all())
    assert a.units(0) == 3 * 4096 and a.scales.shape == (16,)
    assert math.isclose(a.scales[0], 4.0) and math.isclose(a.scales[-1], 1024.0)


def test_the_entry_passes_its_check_and_a_wrong_answer_fails():
    c = _cell(2**31 + 1)
    kept = [(i, c.call(i), None) for i in range(2)]
    errs = c.check(kept)
    assert set(errs) == set(LIMITS)
    assert all(max(v) <= LIMITS[k] for k, v in errs.items()), errs
    out = kept[1][1]
    shifted = types.SimpleNamespace(Tx=torch.roll(out.Tx, 1, dims=-2))  # every bin one up
    bad = c.check([(1, shifted, None)])
    assert bad["tx_err"][0] > 0.1 and bad["flip_share"][0] > 0.1
    halved = types.SimpleNamespace(Tx=out.Tx * 0.5)
    assert c.check([(1, halved, None)])["conserve_err"][0] > 0.1
    nan = out.Tx.clone()
    nan[0, 0, 0] = float("nan")
    assert all(v == [math.inf] for v in c.check([(1, types.SimpleNamespace(Tx=nan), None)]
                                                 ).values())


@pytest.mark.parametrize("prec", [TF32, ref.BF16], ids=lambda p: p.name)
def test_the_reference_in_a_lower_precision_fails_the_cells_limits(prec):
    c = _cell(2**31 + 3, channels=2)
    err = ssq_cwt.SSQErr()
    for r in range(2):
        x = c.x[0, r:r + 1]
        want = ref.ssq(x, c.scales, c.fb, c.fc, c.fs, c.bins, delta=ssq_cwt.DELTA)
        err.add(ref.ssq(x, c.scales, c.fb, c.fc, c.fs, c.bins, prec=prec).tx, want)
    assert any(v > LIMITS[k] for k, v in err.values().items()), err.values()


def _plane(tx, mass, slack=None, slack_sum=None):
    """A reference answer: Tx (rows, K, N), mass (rows, N) and their slack
    (none unless given)."""
    tx = torch.as_tensor(tx, dtype=torch.complex128)
    mass = torch.as_tensor(mass, dtype=torch.float64)
    slack = torch.zeros(tx.shape) if slack is None else torch.as_tensor(slack)
    slack_sum = torch.zeros(mass.shape) if slack_sum is None else torch.as_tensor(slack_sum)
    return ref.Squeezed(tx, mass, slack.double(), slack_sum.double())


def test_the_checks_arithmetic_by_hand():
    # one row, 3 bins, 2 columns; kept weight 4 + 2
    want = _plane([[[2, 1], [2, 1], [0, 0]]], [[4.0, 2.0]])
    # column 0: a contribution of 1 moved from bin 0 to bin 1; column 1 exact
    got = torch.tensor([[[1, 1], [3, 1], [0, 0]]], dtype=torch.complex64)
    v = ssq_cwt.SSQErr().add(got, want).values()
    assert v["conserve_err"] == 0.0  # the column sums agree
    assert v["tx_err"] == pytest.approx(1 / 2)  # |1| over max |Tx_ref| = 2
    assert v["flip_share"] == pytest.approx(2 / (2 * 6))  # 1 of the 6 moved
    # the moved coefficient was undecided: slack of 1 at both bins excuses it
    slack = [[[1, 0], [1, 0], [0, 0]]]
    v = ssq_cwt.SSQErr().add(got, _plane(want.tx, want.mass, slack)).values()
    assert v["tx_err"] == 0.0 and v["flip_share"] == pytest.approx(1 / 6)
    # a coefficient of 0.5 dropped at the threshold: excused only where undecided
    drop = torch.tensor([[[2, 0.5], [2, 1], [0, 0]]], dtype=torch.complex64)
    v = ssq_cwt.SSQErr().add(drop, want).values()
    assert v["conserve_err"] == pytest.approx(0.5 / 4) and v["tx_err"] == pytest.approx(0.25)
    v = ssq_cwt.SSQErr().add(drop, _plane(want.tx, want.mass, [[[0, 0.5], [0, 0], [0, 0]]],
                                          [[0, 0.5]])).values()
    assert v["conserve_err"] == 0.0 and v["tx_err"] == 0.0
    # blocks accumulate: the largest error over the largest reference, the sums summed
    err = ssq_cwt.SSQErr().add(got, want).add(got * 0, _plane(want.tx * 0, want.mass * 0))
    assert err.values()["tx_err"] == pytest.approx(1 / 2)
    assert err.values()["flip_share"] == pytest.approx(2 / 12)
    assert ssq_cwt.SSQErr().values()["tx_err"] == math.inf  # nothing compared


def test_slack_lists_coefficients_within_float32_of_a_bin_edge_or_the_threshold():
    c = _cell(2**31 + 5, channels=1)
    x = c.x[0, :1]
    none = ref.ssq(x, c.scales, c.fb, c.fc, c.fs, c.bins)
    some = ref.ssq(x, c.scales, c.fb, c.fc, c.fs, c.bins, delta=ssq_cwt.DELTA)
    more = ref.ssq(x, c.scales, c.fb, c.fc, c.fs, c.bins, delta=100 * ssq_cwt.DELTA)
    assert torch.equal(none.tx, some.tx) and torch.equal(none.mass, some.mass)
    assert not none.slack.any() and not none.slack_sum.any()
    n_some, n_more = int((some.slack > 0).sum()), int((more.slack > 0).sum())
    assert 0 < n_some < n_more and n_some < some.slack.numel() // 10
    assert bool((some.slack <= more.slack + 1e-12).all())
    # a coefficient undecided at the threshold is slack at its bin too
    assert bool((some.slack_sum <= some.slack.sum(dim=-2) + 1e-12).all())
    assert some.slack_sum.any()


def test_k6_work_by_hand():
    # one row, 64 scales, 2^20 samples, 64 bins: 12 B a contribution, 8 B an output
    b, f = reassign_work.reassign(1, 64, 2**20, 64)
    assert b == 2**20 * (64 * 12 + 64 * 8) and f == 2 * 64 * 2**20
    b32, f32 = reassign_work.reassign(32, 64, 2**20, 64)
    assert (b32, f32) == (32 * b, 32 * f)
    # bound by bytes: 42.9 GB over 3.35 TB/s
    assert roofline.bound_s(b32, f32) == pytest.approx(b32 / roofline.HBM_BYTES_PER_S)
    assert roofline.bound_s(b32, f32) == pytest.approx(0.012821, rel=1e-4)
    c = _cell(1)
    assert c.kernel_work(0) == [("K6", *reassign_work.reassign(3, 16, 4096, 16))]


PERIOD_NS = program_spans.TRIMONTH_S * 10**9
BASE = 230 * PERIOD_NS


def _rec(name, parent, request, a_us, b_us, args=None, counts=None):
    ns = lambda us: BASE + int(round(us * 1000))  # noqa: E731
    return (name, parent, request, ns(a_us), ns(b_us), args or {}, counts or {})


class _Program:
    def __init__(self, raw):
        self.raw = raw

    def spans(self):
        return list(self.raw)

    def counts(self):
        return {}


def _two_requests():
    """Two ssq_cwt calls of two chunks each; cuFFT 10 + 10 us and eager
    kernels 30 + 20 us in all."""
    events = [{"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 200}]
    events += [{"ph": "X", "cat": "user_annotation", "name": "bench.call", "ts": a, "dur": 100}
               for a in (0, 100)]
    kernels = [("void regular_fft_factor<1024u, EPT<16u>>(float2*)", 1, 11),
               ("void vector_fft<256u>(float2*)", 101, 111),
               ("void at::native::elementwise_kernel<128, 2>(int)", 20, 50),
               ("void at::native::vectorized_elementwise_kernel<4>(int)", 120, 140),
               ("(anonymous namespace)::reassign_kernel(float2 const*, int const*)", 60, 70)]
    events += [{"ph": "X", "cat": "kernel", "name": n, "ts": a, "dur": b - a}
               for n, a, b in kernels]
    raw = []
    for q, t0, builds, uploads in ((1, 0, 0, 0), (2, 100, 1, 3)):
        raw.append(_rec("ssq.constants", "ssq_cwt", q, t0 + 1, t0 + 2, {"hit": 1 - builds}))
        for k, c0 in enumerate((t0 + 2, t0 + 40)):
            raw.append(_rec("ssq.cwt", "ssq.chunk", q, c0, c0 + 5 + q))
            raw.append(_rec("ssq.phase", "ssq.chunk", q, c0 + 10, c0 + 20 + 2 * q))
            raw.append(_rec("ssq.chunk", "ssq_cwt", q, c0, c0 + 30, {"rows": 2}))
        raw.append(_rec("ssq_cwt", None, q, t0 + 1, t0 + 90, {},
                        {"ssq.chunks": 2, "ssq.constant_builds": builds,
                         "upload.calls": uploads}))
    run = types.SimpleNamespace(trace=tracing.Trace(events), launches={"K6": 2}, kernel_work=[])
    return run, raw


@pytest.mark.parametrize("metric,want", [
    ("chunks.ssq", 2), ("constant_builds.ssq", 1), ("uploads.ssq", 1.5),
    ("cwt_us.ssq", (12 + 14) / 2), ("phase_us.ssq", (24 + 28) / 2),
    ("fft_ms.ssq", 10e-3), ("eager_ms.ssq", 25e-3)])
def test_each_continuous_metric_reads_its_spans_or_kernels(monkeypatch, metric, want):
    run, raw = _two_requests()
    monkeypatch.setattr(program_spans, "_profiling", lambda: _Program(raw))
    assert harness.load_reader("per_layer", metric).read(run) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["chunks.ssq", "constant_builds.ssq", "uploads.ssq",
                                    "cwt_us.ssq", "phase_us.ssq"])
def test_a_program_without_the_spans_reads_none(monkeypatch, metric):
    run, _ = _two_requests()
    monkeypatch.setattr(program_spans, "_profiling", lambda: None)
    assert harness.load_reader("per_layer", metric).read(run) is None
    monkeypatch.setattr(program_spans, "_profiling", lambda: _Program([]))
    assert harness.load_reader("per_layer", metric).read(run) is None


@pytest.mark.parametrize("metric", ["fft_ms.ssq", "eager_ms.ssq"])
def test_an_untraced_run_reads_none(metric):
    assert harness.load_reader("per_layer", metric).read(types.SimpleNamespace(trace=None)) is None


def test_the_cell_runs_on_the_cpu_at_a_tiny_size():
    run = harness.run_cell(CELL, 2**31 + 11, 0.2, False, device="cpu",
                           mix={"channels": 2, "samples": 2048, "warmup": 1})
    assert harness.correct(run) and run.requests >= 1 and run.units == run.requests * 2 * 2048
    assert set(run.checks) == set(LIMITS)
