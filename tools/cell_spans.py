"""Where a benchmark cell's host time goes, by jwave_tpu_torch's own spans.

    python3 tools/cell_spans.py --workload <cell> --seed <n> [--seconds <s>] [--syncs]

From the root of a checkout, on a CUDA card. Runs the cell as
``benchmark/run.py --trace 1`` does (set-up, a window of ``--seconds``,
default 5, then a traced slice) and prints one JSON line: the cell's
per-layer metrics; the traced slice's idle device time by the innermost
benchmark span (``idle_gaps``) and by the innermost program span
(``program_idle_gaps``, ``outside`` where none is open); the median us a
request of each program span (``span_us``, the spans of one name in a
request summed). With ``--syncs`` it prints instead the host syncs of one
warm request, each named by the innermost frames of the program and of the
benchmark at which torch's sync debug mode warned (in a fresh process: torch
warns of some syncs once a process). Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
import traceback
import warnings
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def span_us(spans) -> dict:
    """Median over requests of the us in each span name (summed in a request)."""
    per: dict = defaultdict(lambda: defaultdict(float))
    for s in spans:
        per[s.name][s.request] += s.end - s.start
    return {n: statistics.median(v.values()) for n, v in sorted(per.items())}


def _frame(stack, part: str) -> str | None:
    for f in reversed(stack):
        if f"/{part}/" in f.filename:
            return f"{f.filename.split(f'/{part}/', 1)[1]}:{f.lineno} {f.name}"
    return None


def sync_sites(cell, i: int) -> list[dict]:
    """The host syncs of request ``i`` (made and read back), each with the
    innermost program and benchmark frames on the stack."""
    import torch

    sites = []

    def hook(message, category, filename, lineno, file=None, line=None):
        stack = traceback.extract_stack()[:-1]
        sites.append({"program": _frame(stack, "jwave_tpu_torch"),
                      "benchmark": _frame(stack, "benchmark"), "what": str(message)[:90]})

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            cell.result(i, cell.call(i))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sites


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--syncs", action="store_true")
    args = p.parse_args(argv)

    import torch

    from benchmark import harness, program_spans
    from jwave_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_benchmark(ROOT)
    if args.syncs:
        cell = harness.resolve(bench, args.workload, ROOT)
        entry = importlib.import_module(f"benchmark.entries.{cell.mix['entry']}")
        with torch.no_grad():
            c = entry.Cell(importlib.import_module("jwave_tpu_torch"), cell.cfg, cell.mix,
                           args.seed, "cuda", harness.Spans())
            for k in range(3):
                c.result(k, c.call(k))
            torch.cuda.synchronize()
            print(json.dumps({"cell": args.workload, "syncs": sync_sites(c, 3)}), flush=True)
        return 0
    profiling.reset_spans()
    run = harness.run_cell(args.workload, args.seed, args.seconds, True, bench=bench)
    spans = program_spans.records(run)
    out = {"cell": args.workload, "seed": args.seed, "card": torch.cuda.get_device_name(0),
           "metrics": {k: v["value"] for k, v in
                       harness.read_metrics(bench, run, "per_layer").items()},
           "window_s": run.trace.window_s, "busy_s": run.trace.busy_s(),
           "idle_gaps": run.trace.idle_by_span(),
           "program_idle_gaps": program_spans.idle_by_span(run),
           "span_us": span_us(spans) if spans else None,
           "spans": len(profiling.spans()), "counts": profiling.counts()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
