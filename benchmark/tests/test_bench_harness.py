"""The harness is driven by data: a new configuration, traffic mix, limits
and metric are files of their own that it finds by name, with no other
file edited. And ``BENCHMARK.json`` keeps to the benchmark's contract."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_command_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd[1:]:
        if "/" in w or w.endswith(".py"):
            assert any(w.startswith(p.rstrip("/") + "/") for p in SPEC["paths"]), w
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a full check with 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines_use_the_allowed_characters():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(("config", c["name"]))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(("workload", w["name"]))
    for kind, extra in (("end_to_end", {"bound"}), ("per_layer", {"layer", "moves"})):
        for m in SPEC[kind]:
            assert set(m) - {"workloads"} == {"name", "unit", "better", "source"} | extra
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            names.append(("metric", m["name"]))
    for _, n in names:
        assert NAME.match(n), n
    assert len(set(names)) == len(names)


def test_configs_cells_and_their_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    assert 1 <= len(configs) <= 24 and 1 <= len(SPEC["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert {w["config"] for w in SPEC["workloads"]} == set(configs)
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(pairs) // 4)
    files = [c["file"] for c in configs.values()]
    assert len(set(files)) == len(files)
    for c in configs.values():
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()


def test_metrics_bounds_readers_and_what_each_cell_reports():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (BENCH / "end_to_end" / f"{m['name']}.py").is_file()
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        for cell in m.get("workloads", []):
            assert cell in cells
            assert m["moves"] in {x["name"] for x in harness.metrics_for_e2e(SPEC, cell)}
    for m in list(e2e.values()):
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        reported = {m["name"] for m in harness.metrics_for(SPEC, cell, "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.metrics_for(SPEC, cell, "per_layer")


EXTRA_CONFIG = {"name": "extra-db4-L3", "wavelet": "Daubechies 4", "level": 3,
                "dtype": "float32", "tf32": False, "assumed": {}, "reduced": []}
EXTRA_MIX = {"entry": "modwt_roundtrip", "lengths": [256], "samples": 1024,
             "distinct_inputs": 2, "in_flight": 2, "warmup": 1, "sample": 1}
EXTRA_METRIC = '"""Requests of the window."""\n\n\ndef read(run):\n    return run.requests\n'


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    cell = "extra-db4-L3.tiny-4x256"
    added = {
        "benchmark/configs/extra-db4-L3.json": json.dumps(EXTRA_CONFIG),
        "benchmark/traffic/tiny-4x256.json": json.dumps(EXTRA_MIX),
        f"benchmark/limits/{cell}.json": json.dumps({"coeffs_err": 1e-5, "recon_err": 1e-5}),
        "benchmark/metrics/requests_made.py": EXTRA_METRIC,
    }
    for rel, text in added.items():
        (tmp_path / rel).write_text(text)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "extra-db4-L3", "source": "https://example.org/extra",
                            "file": "benchmark/configs/extra-db4-L3.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": cell, "config": "extra-db4-L3",
                              "traffic": "tiny-4x256", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "throughput":
            m["workloads"].append(cell)
    spec["per_layer"].append({"name": "requests_made", "unit": "requests", "better": "higher",
                              "source": "host_clock", "layer": "harness",
                              "moves": "throughput", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
        "from pathlib import Path\n"
        "from benchmark import harness\n"
        f"root = Path({str(tmp_path)!r})\n"
        "assert Path(harness.__file__).is_relative_to(root)\n"
        "bench = harness.load_benchmark(root)\n"
        f"run = harness.run_cell({cell!r}, 7, 0.2, False, device='cpu', root=root)\n"
        "print(json.dumps({'correct': harness.correct(run), 'level': run.cell.cfg['level'],\n"
        "  'e2e': harness.read_metrics(bench, run, 'end_to_end', root),\n"
        "  'layer': harness.read_metrics(bench, run, 'per_layer', root)}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] and got["level"] == 3
    assert set(got["e2e"]) == {"throughput", "setup_s"}
    assert set(got["layer"]) == {"requests_made"} and got["layer"]["requests_made"]["value"] > 0
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "benchmark").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert {str(p) for p in set(after) - set(before)} == set(added)
    assert all(after[p] == b for p, b in before.items())


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    c = harness.resolve(SPEC, cell)
    assert c.mix["entry"] and (BENCH / "entries" / f"{c.mix['entry']}.py").is_file()
    assert c.limits and all(v > 0 for v in c.limits.values())


def test_every_seed_runs_the_batch_lengths_equally_often_in_another_order():
    from benchmark.entries import modwt_roundtrip

    cfg = {"wavelet": "Daubechies 4", "level": 5, "dtype": "float32"}
    mix = {"lengths": [64, 90, 128, 181], "samples": 1000, "distinct_inputs": 2}
    orders = []
    for seed in (3, 2**31 + 5):
        c = modwt_roundtrip.Cell(None, cfg, mix, seed, "cpu", None)
        shapes = [tuple(c._batch(i).shape) for i in range(8)]
        assert shapes[:4] == shapes[4:]
        assert sorted(n for _, n in shapes[:4]) == mix["lengths"]
        assert all(r == 1000 // n and c.units(i) == r * n for i, (r, n) in enumerate(shapes))
        (k1, b1, f1), (k2, b2, f2) = c.kernel_work(0)
        assert (k1, k2) == ("K1", "K2") and (b1, f1) == (b2, f2)
        orders.append([n for _, n in shapes[:4]])
    assert orders[0] != orders[1]


def test_the_image_entry_is_checked_against_the_reference():
    # no cell drives it yet (PERF.md, Open questions); a later cell is then data alone
    import contextlib

    import jwave_tpu_torch as jt
    from benchmark.entries import image2d_roundtrip

    cfg = {"wavelet": "Daubechies 4", "level": 6, "dtype": "float32"}
    c = image2d_roundtrip.Cell(jt, cfg, {"shape": [128, 128], "distinct_inputs": 2}, 9, "cpu",
                               lambda name: contextlib.nullcontext())
    kept = [(i, c.call(i), None) for i in range(3)]
    assert max(max(v) for v in c.check(kept).values()) < 1e-6
    y, r = kept[1][1]
    y = y.clone()
    y[64:] = 0  # half of the coefficients left out
    assert c.check([(1, (y, r), None)])["coeffs_err"][0] > 0.1
    assert [k for k, _, _ in c.kernel_work(0)] == ["K4", "K4", "K5", "K5"]
