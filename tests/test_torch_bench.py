"""The port's bench (``jwave_tpu_torch.bench``) on the CPU at tiny shapes:
the JAX bench's row names and headline keys, every row's error against
float64 within its bound, four rows' float32 outputs against the JAX
functions on the same input, the skip logic, the sweep, the kernel smoke and
the timing routine's CPU path. Times here are the CPU's and are not
checked."""
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import jwave_tpu as jw  # noqa: E402
from jwave_tpu.transforms.fwt import fwt as jfwt  # noqa: E402
from jwave_tpu_torch import bench  # noqa: E402
from jwave_tpu_torch.utils import profiling  # noqa: E402

from torch_parity import assert_close, to_np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
_SRC = (ROOT / "bench.py").read_text()
#: the JAX bench's row names: its row("...") calls and its details["..."] keys
JAX_ROWS = sorted(set(re.findall(r'\brow\(\s*"([^"]+)"', _SRC))
                  | set(re.findall(r'details\["([^"]+)"\]', _SRC)))
#: bench.py's shapes cut to a size the CPU runs in seconds
TINY = {"signals": (2, 512), "modwt_sweep": (2, (64, 128)), "image": 128,
        "rows_256x16K": (4, 512), "volume": 32, "signals8": (2, 1024), "image512": 64,
        "image256": 32, "chirp": 4096, "sliding_updates": 16, "wvd": (2, 512),
        "superlet": (2, 1024), "ewt": (2, 1024), "vmd": 256, "pursuit": (2, 256),
        "sweep_modwt": (64, 128), "sweep_wpt": (64, 256), "sweep_cwt": (512, (10, 25))}
#: the rows bench.py runs only off the CPU
CARD_ONLY = {"fwt2d_db4_L6_2048_xla", "fwt1d_db4_L8_256x16K_pallas", "pallas_smoke",
             "modwt_db4_L5_pallas", "modwt_db4_L5_bf16dial", "fwt2d_db4_L6_2048_bf16dial"}
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "device", "dtype", "partial",
                 "elapsed_s", "modwt_db4_L5"}


def _lines(text):
    return [json.loads(s) for s in text.splitlines() if s.startswith("{")]


@pytest.fixture(scope="module")
def full_run():
    """One run of every row, the card-only ones on their plain versions:
    (details, printed lines, the rows' float32 outputs)."""
    import contextlib
    import io

    outputs = {}
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(bench, "REPS", 2)
        details = bench.main(shapes=TINY, device="cpu", card_rows=True, outputs=outputs)
    return details, _lines(buf.getvalue()), outputs


def test_the_jax_bench_has_28_rows():
    assert len(JAX_ROWS) == 28 and "modwt_db4_L5" in JAX_ROWS and "pallas_smoke" in JAX_ROWS


def test_row_names_are_the_jax_benchs(full_run):
    details, _, _ = full_run
    rows = {k for k, v in details.items() if isinstance(v, dict)}
    assert sorted(rows) == JAX_ROWS


@pytest.mark.parametrize("name", JAX_ROWS)
def test_each_row_is_measured_and_within_its_bound(name, full_run):
    r = full_run[0][name]
    assert "error" not in r and "skipped" not in r, r
    if name == "pallas_smoke":
        assert r["ok"] is True
        assert {"max_err_vs_fft", "roundtrip_err", "mxu_err_vs_fft", "mxu_fwt_roundtrip_err",
                "sha256_coeffs_r4", "shape", "wavelet", "level"} <= set(r)
        return
    if name == "sliding_modwt_w512_L8_step64":
        assert r["us_per_update"] > 0 and r["us_recompute_per_window"] > 0
    elif name == "modwt_sweep_us_b8_L4":
        for size in ("64", "128"):
            assert all(r[size][m] > 0 for m in ("direct", "fft", "mxu"))
    else:
        assert r["ms"] > 0 and r["wall_ms"] > 0
        assert r["host_syncs"] is None and r["launches"] == {}  # the CPU: plain versions
    assert 0 <= r["err"] <= r["bound"]
    want = (bench.BF16_BOUND if "bf16dial" in name
            else bench.LOOSE_BOUND if name.startswith(("scattering", "denoise", "vmd"))
            else bench.F32_BOUND)
    assert r["bound"] == want


def test_the_last_line_is_the_compact_headline(full_run):
    details, lines, _ = full_run
    assert [("details" in s) for s in lines] == [True, False] * 4
    last = lines[-1]
    assert set(last) == HEADLINE_KEYS and last["partial"] is False
    assert last["metric"] == "MODWT-db4-L5 throughput per chip" and last["unit"] == "Msamples/s"
    assert last["device"] == "cpu" and last["dtype"] == "float32"
    assert last["value"] == details["modwt_db4_L5"]["Msamples_per_s"] > 0
    assert last["vs_baseline"] == pytest.approx(last["value"] / 0.248, rel=1e-3)
    assert last["modwt_db4_L5"]["batch"] == 2 and last["modwt_db4_L5"]["n"] == 512
    # the headline is flushed right after its row, before any other row
    assert set(lines[0]["details"]) - {"partial", "elapsed_s"} == {
        "device", "dtype", "budget_s", "torch", "clock", "modwt_db4_L5"}


def _ssq_jax(a):
    """JAX computes float32 input in float64 here; its |W| threshold is then
    pinned at float32's default (10 sqrt(eps) max|W| per signal), as the
    port's float32 call sets it."""
    scales, morlet = jw.generate_log_scales(1e-5, 1e-2, 64), jw.MorletWavelet(1.0, 1.0)
    w_max = jnp.abs(jw.cwt(a, scales, morlet, 1e6).coefficients).max(axis=(-2, -1))
    gamma = 10.0 * np.sqrt(np.finfo(np.float32).eps) * w_max[:, None, None]
    r = jw.ssq_cwt(a, scales, morlet, sampling_rate=1e6, gamma=gamma)
    return jnp.sum(jnp.real(r.Tx), axis=-2)


@pytest.mark.parametrize("name,jax_fn", [
    ("modwt_db4_L5", lambda a: jw.modwt(a, "Daubechies 4", 5).sum(axis=-2)),
    ("fwt1d_db4_L8", lambda a: jfwt(a, "Daubechies 4", 8)),
    ("wpt_db4_L6", lambda a: jw.wpt(a, "Daubechies 4", 6)),
    ("ssq_cwt_64scales_8x64K", _ssq_jax),
])
def test_row_output_matches_the_jax_function(name, jax_fn, full_run):
    x, got = full_run[2][name]
    assert got.dtype == torch.float32
    want = np.asarray(jax_fn(jnp.asarray(to_np(x), dtype=jnp.float32)))
    assert_close(got, want, bench.F32_BOUND, name)


@pytest.fixture(scope="module")
def default_run():
    """A run with card_rows left at its default and ``jt.wpt`` raising."""
    import contextlib
    import io

    import jwave_tpu_torch as jt

    def broken(*args, **kwargs):
        raise RuntimeError("no such kernel")

    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(jt, "wpt", broken)
        mp.setattr(bench, "REPS", 1)
        return bench.main(shapes=TINY, device="cpu")


def test_card_rows_are_skipped_on_the_cpu_by_default(default_run):
    skipped = {k for k, v in default_run.items() if isinstance(v, dict) and "skipped" in v}
    assert skipped == CARD_ONLY
    assert all(default_run[k] == {"skipped": "card only"} for k in CARD_ONLY)


def test_a_row_that_raises_records_its_error_and_fails_the_run(default_run):
    assert default_run["wpt_db4_L6"] == {"error": "RuntimeError: no such kernel"}
    assert bench.failures(default_run) == ["wpt_db4_L6"]
    assert default_run["denoise_dtcwt_512"]["ms"] > 0  # the run went on


def test_an_exhausted_budget_skips_every_row_but_the_headline(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_BUDGET_S", "0")
    monkeypatch.setattr(bench, "REPS", 1)
    details = bench.main(shapes=TINY, device="cpu", card_rows=True)
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["value"] > 0 and details["budget_s"] == 0
    assert {k for k, v in details.items() if v == {"skipped": "budget"}} == \
        set(JAX_ROWS) - {"modwt_db4_L5"}


def test_sweep_prints_its_three_cpu_sections(monkeypatch, capsys):
    monkeypatch.setattr(bench, "REPS", 1)
    bench.sweep(shapes=TINY, device="cpu")
    out = capsys.readouterr().out.splitlines()
    heads = [s for s in out if s.startswith("#")]
    assert len(heads) == 3 and "MODWT" in heads[0] and "WPT" in heads[1] and "CWT" in heads[2]
    rows = _lines("\n".join(out))
    assert [next(iter(r)) for r in rows] == ["modwt_sweep_us"] * 2 + ["wpt_sweep"] * 2 + \
        ["cwt_sweep"] * 2
    assert all(rows[i]["modwt_sweep_us"][m] > 0 for i in (0, 1)
               for m in ("direct", "fft", "pallas", "mxu"))
    assert [r["cwt_sweep"]["scales"] for r in rows[4:]] == [10, 25]


def test_pallas_smoke_on_the_cpu_runs_the_plain_versions():
    res = bench.pallas_smoke("cpu")
    assert res["ok"] is True and res["shape"] == [8, 1024] and res["level"] == 3
    assert res["launches"] == {"K1": 0, "K2": 0, "K3": 0, "K7": 0}
    assert max(res["max_err_vs_fft"], res["mxu_err_vs_fft"]) < 1e-5
    assert len(res["sha256_coeffs_r4"]) == 16


def test_median_ms_times_by_the_host_clock_on_the_cpu():
    calls = []
    ms = profiling.median_ms(lambda: calls.append(sum(range(20000))), reps=5, card=False)
    assert ms > 0 and len(calls) == 8  # three warm-up runs, then five timed
    # device=True changes nothing off the card
    assert profiling.median_ms(lambda: None, reps=3, device=True, card=False) >= 0


def test_rel_err_is_relative_to_each_outputs_largest_value():
    a = torch.tensor([1.0, 2.0, 4.0])
    assert bench.rel_err(a + 1e-3, a.double()) == pytest.approx(1e-3 / 4, rel=1e-3)
    z = torch.complex(a, -a)
    assert bench.rel_err((a, z * (1 + 1e-4)), (a.double(), z.to(torch.complex128))) == \
        pytest.approx(1e-4, rel=1e-2)


def test_pursuit_row_compares_picks_exactly_then_energies(full_run):
    r = full_run[0]["matching_pursuit_16atoms_4x2K"]
    assert isinstance(r["picks_equal"], bool) and r["err"] <= bench.F32_BOUND


def test_bench_without_a_card_exits_1_with_torchs_error():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench runs there")
    for args in (["-m", "jwave_tpu_torch", "bench"], ["-m", "jwave_tpu_torch.bench"]):
        out = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 1 and out.stdout == ""
        assert out.stderr.startswith("error: ") and "CUDA" in out.stderr
