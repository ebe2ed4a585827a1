"""Time ``denoise`` in the state that ``chip_smoke.py`` leaves a process in.

    cd <tree> && python3 <repo>/tools/after_smoke.py [--out FILE]

Runs ``main()`` of the ``chip_smoke.py`` in the current directory in this
process (its output goes to ``--out``), then times ``denoise`` db4 L4
8 x 65536 float32 the way its timing phase does (wall: CUDA events around
the call, median of 25 after a 128 MB write that flushes the L2; host:
perf_counter around the call, which waits for the threshold's device sync)
three times: as ``main()`` left the process, after ``torch.cuda.empty_cache()``,
and in a fresh CUDA stream of the same process. Then one profiled call
gives its heaviest host ops and its kernels' device time, and nvidia-smi
the SM clock and power beside. Run it from a ``git archive`` of each of two
commits, in turns, to see whether a difference between their ``chip_smoke``
runs is the process's state. Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def _smi() -> str:
    q = "clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"
    return subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=Path("after_smoke_main.log"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("after_smoke: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke

    with args.out.open("w") as f, contextlib.redirect_stdout(f):
        rc = chip_smoke.main()
    print(json.dumps({"chip_smoke_rc": rc, "smi": _smi()}), flush=True)
    import jwave_tpu_torch as jt

    x = torch.as_tensor(np.random.default_rng(25).standard_normal((8, 65536)),
                        dtype=torch.float32, device="cuda")
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device="cuda")

    def fn():
        return jt.denoise(x, "db4", 4)

    def wall(label):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ms, host = [], []
        for _ in range(25):
            flush.fill_(1.0)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
            host.append((t1 - t0) * 1e3)
        print(json.dumps({"time": f"denoise db4 L4 8x65536, {label}",
                          "wall_ms": float(np.median(ms)), "host_ms": float(np.median(host)),
                          "smi": _smi()}), flush=True)

    wall("as chip_smoke left the process")
    torch.cuda.empty_cache()
    wall("after torch.cuda.empty_cache()")
    with torch.cuda.stream(torch.cuda.Stream()):
        wall("in a fresh stream")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    ev = sorted(avg, key=lambda e: -e.self_cpu_time_total)[:10]
    kern = sorted((e for e in avg if e.self_device_time_total > 0),
                  key=lambda e: -e.self_device_time_total)[:8]
    print(json.dumps({"trace": "denoise", "host_ops_self_us": [
        [e.key[:60], e.count, round(e.self_cpu_time_total, 1)] for e in ev],
        "kernels_device_us": [[e.key[:60], e.count, round(e.self_device_time_total, 1)]
                              for e in kern]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
