"""The general harness: finds a cell's files by name, drives its traffic as
a closed loop, traces a slice of it, checks what the timed path produced,
and reads the metrics.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the names in ``BENCHMARK.json``:

- ``benchmark/configs/<config>.json`` (the path a config's ``file`` gives):
  the wavelet, level and precision the program runs with;
- ``benchmark/traffic/<traffic>.json``: the mix, read by this generator:
  ``entry`` (a module of ``benchmark/entries/``, the kind of request),
  its shapes, ``distinct_inputs``, ``in_flight`` (requests enqueued ahead
  of the one the host waits for), ``warmup`` (requests in set-up) and
  ``sample`` (requests whose outputs the check compares, drawn from
  the seed, besides the window's last);
- ``benchmark/limits/<cell>.json``: the limit of each number the check
  compares;
- ``benchmark/end_to_end/<metric>.py`` and ``benchmark/metrics/<metric>.py``:
  a ``read(run)`` each, which returns the metric from a :class:`Run` or
  None where the run has nothing to read.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import random
import tempfile
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import trace as tracing

ROOT = Path(__file__).resolve().parent.parent

#: seconds of traffic that a ``--trace 1`` run traces after its window
TRACE_SECONDS = 0.5
#: top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "jwave_tpu")


@dataclass
class Cell:
    """A cell and the files its names lead to."""
    name: str
    workload: dict
    config: dict
    cfg: dict
    mix: dict
    limits: dict


@dataclass
class Run:
    """What one run measured, for the metric readers."""
    cell: Cell
    setup_s: float
    window_s: float
    requests: int
    units: int  # input samples of the window's requests
    latencies_s: list = field(default_factory=list)  # request start to its answer on the host
    host_s: list = field(default_factory=list)  # host time in a request's calls
    launches: dict = field(default_factory=dict)  # kernel launches in the window
    kernel_work: list = field(default_factory=list)  # (kernel, bytes, flops) of the traced calls
    trace: tracing.Trace | None = None
    syncs: int | None = None  # host waits for the stream in one warm request
    checks: dict = field(default_factory=dict)  # name -> (value, limit)
    failed: int = 0
    memory_peak_bytes: int = 0


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell called ``name`` with its configuration, mix and limits."""
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(root / c["file"]) as f:
        cfg = json.load(f)
    with open(root / "benchmark" / "traffic" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    limits_path = root / "benchmark" / "limits" / f"{name}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.exists() else {}
    return Cell(name, w, c, cfg, mix, limits)


def metrics_for(bench: dict, name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that cell ``name`` reports:
    those that list it, and those without a list, in every cell (an
    end-to-end metric) or in every cell that reports the end-to-end metric
    they move (a per-layer one)."""
    e2e = {m["name"] for m in metrics_for_e2e(bench, name)}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if name in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def metrics_for_e2e(bench: dict, name: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]


def forbidden(modules) -> list[str]:
    """The names in :data:`FORBIDDEN` among the top-level names (the part
    before the first dot, compared whole) of ``modules``."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def load_reader(kind: str, metric: str, root: Path = ROOT):
    """The module ``benchmark/<end_to_end|metrics>/<metric>.py``."""
    folder = "end_to_end" if kind == "end_to_end" else "metrics"
    path = root / "benchmark" / folder / f"{metric}.py"
    mod_name = f"benchmark.{folder}.{metric.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(bench: dict, run: Run, kind: str, root: Path = ROOT) -> dict:
    out = {}
    for m in metrics_for(bench, run.cell.name, kind):
        value = load_reader(kind, m["name"], root).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


class Spans:
    """The benchmark's own spans: profiler annotations while a slice is
    traced, nothing otherwise."""

    def __init__(self):
        self.on = False
        self._none = contextlib.nullcontext()

    def __call__(self, name: str):
        return torch.profiler.record_function(tracing.PREFIX + name) if self.on else self._none


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclass
class Window:
    requests: int
    units: int
    seconds: float
    host_s: list
    latencies_s: list
    kept: list


def drive(cell, seconds: float, in_flight: int, device, spans: Spans, first: int = 0,
          sample: int = 0, rng: random.Random | None = None, record: bool = False) -> Window:
    """A closed loop of one caller for ``seconds``: request i is made by
    ``cell.call(i)`` and its answer brought to the host by ``cell.result``
    (and, with ``record``, kept by ``cell.record`` once its latency is
    taken); on the card the host then waits until at most ``in_flight``
    requests are unfinished. The window ends when the last request is
    done. ``kept`` holds ``sample`` requests drawn uniformly (reservoir
    sampling from ``rng``) and the last, as (i, out, result)."""
    events = ([torch.cuda.Event() for _ in range(in_flight)]
              if torch.device(device).type == "cuda" else [])
    host, lat, slots = [], [], []
    last = None
    n = units = 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while time.perf_counter() < deadline:
        i = first + n
        t0 = time.perf_counter()
        with spans("call"):
            out = cell.call(i)
        t1 = time.perf_counter()
        with spans("result"):
            res = cell.result(i, out)
        host.append(t1 - t0)
        if res is not None:
            lat.append(time.perf_counter() - t0)
            if record:
                cell.record(i, res)
        units += cell.units(i)
        last = (i, out, res)
        if sample:
            if len(slots) < sample:
                slots.append(last)
            else:
                j = rng.randrange(n + 1)
                if j < sample:
                    slots[j] = last
        if events:
            ev = events[n % len(events)]
            with spans("wait"):
                ev.synchronize()  # the request made in_flight requests ago
            ev.record()
        n += 1
    with spans("drain"):
        _sync(device)
    seconds = time.perf_counter() - t_start
    kept = slots + ([last] if last is not None and all(k is not last for k in slots) else [])
    return Window(n, units, seconds, host, lat, kept)


def _count_syncs(cell, i: int) -> int:
    """Host waits for the stream in one warm request, by torch's sync debug
    mode (which warns at each)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            cell.result(i, cell.call(i))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def _traced_slice(cell, mix, device, spans: Spans, first: int) -> tuple[tracing.Trace, int]:
    """The same loop for :data:`TRACE_SECONDS` under torch.profiler, read back
    from its Chrome trace; returns the trace and the requests made."""
    from torch.profiler import ProfilerActivity, profile

    spans.on = True
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with spans("window"):
                    w = drive(cell, TRACE_SECONDS, mix["in_flight"], device,
                              spans, first=first)
    finally:
        spans.on = False
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        tr = tracing.load(path)
    return tr, w.requests


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device="cuda", api=None,
             mix: dict | None = None, t_start: float | None = None, root: Path = ROOT,
             bench: dict | None = None) -> Run:
    """One run of cell ``name``: set-up, warm-up, the window, a traced slice
    where ``trace``, then the check. ``api`` is the program (by default
    ``jwave_tpu_torch``); ``mix`` replaces entries of the cell's mix."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_benchmark(root) if bench is None else bench
    cell = resolve(bench, name, root)
    if mix:
        cell.mix = {**cell.mix, **mix}
    if api is None:
        api = importlib.import_module("jwave_tpu_torch")
    entry = importlib.import_module(f"benchmark.entries.{cell.mix['entry']}")
    spans = Spans()
    with torch.no_grad():
        c = entry.Cell(api, cell.cfg, cell.mix, seed, device, spans)
        for k in range(cell.mix.get("warmup", 3)):
            c.result(-1 - k, c.call(-1 - k))
        _sync(device)
        gc.collect()
        gc.freeze()  # set-up's objects leave the collector's sweeps in the window
        counters = getattr(api, "ops", None)
        if counters is not None:
            counters.reset_launch_counts()
        setup_s = time.perf_counter() - t_start
        w = drive(c, seconds, cell.mix["in_flight"], device, spans,
                  sample=cell.mix.get("sample", 0), rng=random.Random(seed), record=True)
        run = Run(cell, setup_s, w.seconds, w.requests, w.units, w.latencies_s, w.host_s)
        if counters is not None:
            run.launches = {k: v for k, v in counters.launch_counts().items() if v}
        if torch.device(device).type == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated()
        if trace:
            run.trace, traced = _traced_slice(c, cell.mix, device, spans, first=w.requests)
            run.kernel_work = [k for i in range(w.requests, w.requests + traced)
                               for k in c.kernel_work(i)]
            if torch.device(device).type == "cuda":
                run.syncs = _count_syncs(c, w.requests + traced)
        errs = c.check(w.kept)
    for k, values in errs.items():
        run.checks[k] = (max(values), cell.limits.get(k))
    run.failed = max((sum(v > cell.limits[k] for v in values) if k in cell.limits else 0)
                     for k, values in errs.items())
    return run


def correct(run: Run) -> bool:
    """Every number compared is within its limit (and has one)."""
    return all(lim is not None and v <= lim for v, lim in run.checks.values())
