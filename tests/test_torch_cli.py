"""The port's console entry point (``python -m jwave_tpu_torch``) against the
JAX package's, and its profiling helpers, on the CPU."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402,F401

from jwave_tpu import cli as jcli  # noqa: E402
from jwave_tpu_torch import cli as tcli  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch.utils import profiling  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out.splitlines(), err.splitlines()


def _numbers(line):
    return [float(v) for v in re.findall(r"-?\d+\.?\d*(?:e[-+]\d+)?", line.split(":", 1)[1])]


def test_list_names_the_same_transforms_filters_and_taps(capsys):
    rc_t, out_t, _ = _run(tcli.main, ["list"], capsys)
    rc_j, out_j, _ = _run(jcli.main, ["list"], capsys)
    assert rc_t == rc_j == 0
    stop_t = next(i for i, s in enumerate(out_t) if s.startswith("continuous wavelets"))
    stop_j = next(i for i, s in enumerate(out_j) if s.startswith("continuous wavelets"))
    assert out_t[:stop_t] == out_j[:stop_j]
    assert sum("taps)" in s for s in out_t) == len(jt.available_filters())


@pytest.mark.parametrize("wavelet", ["Haar", "Daubechies 4"])
def test_demo_on_the_cpu_prints_the_jax_packages_numbers(wavelet, capsys):
    rc_t, out_t, err_t = _run(tcli.main, ["Fast Wavelet Transform", wavelet, "--device", "cpu"],
                              capsys)
    rc_j, out_j, _ = _run(jcli.main, ["Fast Wavelet Transform", wavelet], capsys)
    assert rc_t == rc_j == 0 and err_t == []
    assert len(out_t) == len(out_j) == 5 and out_t[:2] == out_j[:2]
    for got, want in zip(out_t[2:4], out_j[2:4]):
        assert got.split(":")[0] == want.split(":")[0]
        np.testing.assert_allclose(_numbers(got), _numbers(want), atol=1e-12)
    assert out_t[4].startswith("max |error| = ") and float(out_t[4].split()[-1]) < 1e-5


def test_denoise_prints_the_jax_packages_errors(capsys):
    rc_t, out_t, _ = _run(tcli.main, ["denoise", "db4", "--device", "cpu"], capsys)
    rc_j, out_j, _ = _run(jcli.main, ["denoise", "db4"], capsys)
    assert rc_t == rc_j == 0 and out_t[0] == out_j[0]
    mse = [(t, j) for t, j in zip(out_t, out_j) if "MSE" in t]
    assert len(mse) == 4
    for t, j in mse:
        assert t.split("MSE")[0] == j.split("MSE")[0]
        assert abs(float(t.split()[-1]) - float(j.split()[-1])) <= 1e-6


def test_bench_runs_on_the_cpu(monkeypatch, capsys):
    """``bench --device cpu`` runs the port's bench (at tiny shapes here) and
    returns 0; ``--sweep`` and ``--pallas-smoke`` likewise."""
    import json

    from jwave_tpu_torch import bench
    from test_torch_bench import TINY

    for key, value in TINY.items():
        monkeypatch.setitem(bench.SHAPES, key, value)
    monkeypatch.setattr(bench, "REPS", 1)
    assert tcli.main(["bench", "--device", "cpu"]) == 0
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["metric"] == "MODWT-db4-L5 throughput per chip" and last["partial"] is False
    assert tcli.main(["bench", "--sweep", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("\n# ") == 2
    assert tcli.main(["bench", "--pallas-smoke", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["pallas_smoke"]["ok"] is True


def test_bench_flags_go_with_bench_only(capsys):
    rc, out, err = _run(tcli.main, ["list", "--sweep"], capsys)
    assert rc == 1 and out == [] and err == ["error: --sweep and --pallas-smoke go with bench"]


def test_unknown_transform_is_one_error_line(capsys):
    rc, out, err = _run(tcli.main, ["No Such Transform", "--device", "cpu"], capsys)
    assert rc == 1 and out == [] and len(err) == 1 and err[0].startswith("error: ")
    assert "unknown transform" in err[0]


def test_demo_runs_on_the_card_by_default(capsys):
    """--device defaults to "cuda": without a card the demo prints torch's
    error on one line and exits 1 (nothing falls back to the CPU)."""
    rc, out, err = _run(tcli.main, [], capsys)
    if torch.cuda.is_available():
        assert rc == 0 and len(out) == 5
    else:
        assert rc == 1 and out == [] and len(err) == 1 and "CUDA" in err[0]


def test_module_entry_point_lists():
    out = subprocess.run([sys.executable, "-m", "jwave_tpu_torch", "list"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("transforms:\n") and "Daubechies 4" in out.stdout


def test_time_fn_and_throughput_are_positive():
    x = torch.randn(4, 1024)
    s = profiling.time_fn(jt.fwt, x, "db4", warmup=1, iters=3)
    assert s > 0
    assert profiling.throughput(jt.fwt, x, "db4", samples=x.numel(), warmup=1, iters=3) > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as prof:
        jt.fwt(torch.randn(2, 256), "db4")
    path = tmp_path / "t" / "trace.json"
    assert path.is_file() and path.stat().st_size > 0
    assert len(prof.key_averages()) > 0
