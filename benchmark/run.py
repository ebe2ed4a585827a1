"""Run one cell of the benchmark of jwave_tpu_torch on a CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (importing torch and the program,
loading or building its kernels, making the cell's inputs on the card from
the seed, warming the cell's shapes up) ends where the window starts; the
window drives the cell's traffic for ``--seconds``; with ``--trace 1`` a
slice of the same traffic is then traced. What the timed path produced is
compared with the plain reference (``benchmark/reference/``) once the
window has closed. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared with
its limit); the last lines of standard error repeat the checks.

Exits 2, with no result, without a CUDA card or with fewer cards than the
cell asks for, and 3 if a JAX module was loaded in this process.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(ROOT / "build" / "bench_cache" / _dir)
sys.path.insert(0, str(ROOT))


def _say(*lines):
    for line in lines:
        print(line, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness, roofline

    bench = harness.load_benchmark(ROOT)
    cell = harness.resolve(bench, args.workload, ROOT)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _say(f"no result: {args.workload} needs {chips} CUDA card(s), found {have}")
        return 2

    run = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           t_start=_T0, bench=bench)
    print(json.dumps({"card": roofline.card_line(),
                      "peaks": {"hbm_bytes_per_s": roofline.HBM_BYTES_PER_S,
                                "f32_flop_per_s": roofline.F32_FLOP_PER_S}}), flush=True)

    loaded = harness.forbidden(sys.modules)
    if loaded:
        _say(f"no result: the process holds {', '.join(loaded)}")
        return 3

    kind = "per_layer" if args.trace else "end_to_end"
    result = {"correct": harness.correct(run), "attempted": run.requests, "failed": run.failed,
              "metrics": harness.read_metrics(bench, run, kind),
              "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                         "memory_peak_bytes": run.memory_peak_bytes}}
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_by_span()}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    _say(*(f"check {k}: {v!r} limit {lim!r}" for k, (v, lim) in run.checks.items()))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
