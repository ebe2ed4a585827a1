"""Where the time of jwave_tpu_torch's paths goes on a CUDA card.

    python3 tools/trace_torch.py [--out DIR] [--only NAME ...]

Traces one warm call of each path with torch.profiler, prints the device
time by kernel name (top 12 each), the device's busy time against the span
of its kernels and against the host wall time of an untraced call, and
writes a Chrome trace per call into DIR (default build/trace/). The paths:
ssq_cwt (8 x 65536 float32, Morlet(1,1), 64 log scales 1e-5..1e-2 s, fs =
1e6), fwt and ifwt (64 x 65536 db4 L8; ifwt runs the plain synthesis
butterflies), ifwt2d (2048 x 2048 db4 L6), the entry step's gradient (modwt ->
imodwt db4 L5 64 x 65536), denoise (db4 L4 8 x 65536), modwt_mra (db4 L5
64 x 65536), one sliding MODWT update (8 streams, window 512, db4 L8, chunk
64), bench.py's shapes of wigner_ville, superlet, ewt -> iewt, vmd,
matching_pursuit and analytic_signal, wpt and iwpt (db4 L6 64 x 65536,
fused), lifting_fwt (CDF 9/7 L8 64 x 65536), dtcwt (L6 8 x 65536),
scattering1d (8 x 65536, J=8, Q=8) and scattering2d (256 x 256, J=3, L=8). The
port's precision dial stays at its default, true float32. Needs a CUDA
card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def _trace(label, fn, out_dir: Path):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    span_ms = ((max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels))
               / 1e3 if kernels else 0.0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({"trace": label, "host_wall_ms_untraced": wall_ms,
                      "device_span_ms": span_ms, "device_busy_ms": busy_ms,
                      "device_idle_share_of_span": 1.0 - busy_ms / span_ms if span_ms else None,
                      "device_idle_share_of_wall": max(0.0, 1.0 - busy_ms / wall_ms),
                      "n_kernels": len(kernels),
                      "top_kernels_ms": [[k[:80], v / 1e3] for k, v in top]}), flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / f"trace_{label}.json"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "trace"))
    ap.add_argument("--only", nargs="*", help="trace only these paths")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import jwave_tpu_torch as jt

    dev = torch.device("cuda")
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((8, 65536)),
                        dtype=torch.float32, device=dev)
    scales = jt.generate_log_scales(1e-5, 1e-2, 64)
    wav = jt.MorletWavelet(1.0, 1.0)
    img = torch.as_tensor(np.random.default_rng(2).standard_normal((2048, 2048)),
                          dtype=torch.float32, device=dev)

    def sig(shape, seed):
        return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape),
                               dtype=torch.float32, device=dev)

    x64 = sig((64, 65536), 1).requires_grad_()
    w64 = sig((64, 65536), 7)
    x8 = sig((8, 65536), 25)
    sl = jt.SlidingMODWT("db4", 8, 512)
    state = sl.init(sig((8, 512), 16))
    chunk = sig((8, 64), 17)
    xw, xsl, xv, xm = sig((8, 4096), 17), sig((8, 16384), 18), sig(2048, 20), sig((4, 2048), 21)
    ewt_sig = np.random.default_rng(19).standard_normal(16384)
    ewt_b = jt.ewt_boundaries(ewt_sig, 5)
    xe = torch.as_tensor(np.tile(ewt_sig, (8, 1)), dtype=torch.float32, device=dev)
    img256 = sig((256, 256), 33)
    paths = {
        "ssq_cwt": lambda: jt.ssq_cwt(x, scales, wav, 1e6),
        "fwt": lambda: jt.fwt(x64.detach(), "db4", 8),
        "ifwt": lambda: jt.ifwt(x64.detach(), "db4", 8),
        "ifwt2d": lambda: jt.ifwt2d(img, "db4", 6, 6),
        "entry_grad": lambda: torch.autograd.grad(
            (jt.imodwt(jt.modwt(x64, "db4", 5), "db4") * w64).sum(), x64),
        "denoise": lambda: jt.denoise(x8, "db4", 4),
        "modwt_mra": lambda: jt.modwt_mra(x64.detach(), "db4", 5),
        "sliding_update": lambda: sl.update(state, chunk),
        "wigner_ville": lambda: jt.wigner_ville(xw, 1.0, n_bins=512),
        "superlet": lambda: jt.superlet(xsl, np.linspace(5.0, 200.0, 64), 1000.0),
        "ewt_iewt": lambda: jt.iewt(jt.ewt(xe, boundaries=ewt_b)),
        "vmd": lambda: jt.vmd(xv, 3),
        "matching_pursuit": lambda: jt.matching_pursuit(xm, 16),
        "analytic_signal": lambda: jt.analytic_signal(x8),
        "wpt": lambda: jt.wpt(x64.detach(), "db4", 6),
        "iwpt": lambda: jt.iwpt(x64.detach(), "db4", 6),
        "lifting_fwt": lambda: jt.lifting_fwt(x64.detach(), "CDF 9/7", 8),
        "dtcwt": lambda: jt.dtcwt(x8, 6),
        "scattering1d": lambda: jt.scattering1d(x8, 8, Q=8),
        "scattering2d": lambda: jt.scattering2d(img256, 3, L=8),
    }
    out = Path(args.out)
    for name, fn in paths.items():
        if not args.only or name in args.only:
            _trace(name, fn, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
