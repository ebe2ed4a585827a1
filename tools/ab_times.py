"""Another commit's kernels against this tree's, in one process on one CUDA
card: the consumers of K1 and K4.

    python3 tools/ab_times.py --parent build/parent [--rounds 6] [--reps 25]
                              [--variants parent new] [--calls TEXT ...]
                              [--out build/ab_times.jsonl] [--trace]

``--parent`` is another commit's tree, unpacked (``git archive <commit> |
tar -x -C build/parent``). Its ``jwave_tpu_torch`` is imported under another
name beside this tree's, so the two share one process, one CUDA context and
one card, and whatever slows the host slows both. Each variant's K1 and K4
are first held against the plain version (1e-5 of max|ref|).

The calls are the consumers of K1 (K1 alone at 64 x 65536 db4 L5 and at
``denoise``'s 8 x 65536 db4 L4, the entry step ``imodwt(modwt(x))`` and its
gradient, whose backward runs K1 as K2's adjoint, ``modwt_mra`` at 64 x
65536, ``denoise`` db4 L4 8 x 65536) and of K4 (one K4 pass and ``fwt2d`` at
2048^2 db4 L6, the gradient of ``ifwt2d`` there, whose backward runs K4 as
K5's adjoint). ``--variants`` keeps one or both trees (one alone measures
one tree in a process of its own: the inputs are made by the plain
versions, so no other kernel runs there), and ``--calls`` keeps the calls
whose name contains one of the given texts.

Each round times every call in the turns A B B A over its variants, the
first variant alternating from round to round, three ways, each the median
of ``--reps`` runs after a 128 MB write that flushes the 50 MB L2:

  device  CUDA events after a ~5 ms GPU spin, so the host's launches are
          queued before the first event: the device's time alone;
  wall    CUDA events with no spin: a host slower than the device shows;
  host    perf_counter around the call, with no sync: the time to enqueue.

Every measurement goes to ``--out`` as a JSON line; stdout gets one summary
line per call and variant (median, min and max over the rounds of the mean
of the round's two turns) and per call the ratio new/parent, with the ways
whose rounds disagree on its side of 1 listed as "unresolved" (the spread
exceeds the gap). With ``--trace``, one profiled call of each variant of
the host-bound calls kept prints its heaviest host ops and its kernels'
device time. Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
F32_BOUND = 1e-5


def _load(name: str, package_dir: Path):
    """Import the package at ``package_dir`` under the module name ``name``."""
    init = package_dir / "__init__.py"
    spec = importlib.util.spec_from_file_location(name, init,
                                                  submodule_search_locations=[str(package_dir)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _modules(name: str):
    sub = {k: importlib.import_module(f"{name}.{k}") for k in
           ("ops.cuda_build", "ops.cuda_modwt", "ops.cuda_pyramid", "transforms.modwt")}
    return sys.modules[name], sub


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "ab_times.jsonl")
    ap.add_argument("--variants", nargs="+", default=["parent", "new"],
                    choices=["parent", "new"])
    ap.add_argument("--calls", nargs="+", default=[""])
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_times: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = card.strip().splitlines()[0] if card.strip() else torch.cuda.get_device_name(0)
    print(json.dumps({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}),
          flush=True)

    sys.path.insert(0, str(ROOT))
    _load("jwave_tpu_torch_parent", args.parent.resolve() / "jwave_tpu_torch")
    new_jt, new = _modules("jwave_tpu_torch")
    par_jt, par = _modules("jwave_tpu_torch_parent")
    trees = [new, par] if "parent" in args.variants else [new]
    with ThreadPoolExecutor(4) as ex:
        for j in [ex.submit(m["ops.cuda_build"].library, k) for m in trees
                  for k in ("modwt", "pyramid")]:
            j.result()

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def dev_t(shape, grad=False):
        t = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
        return t.requires_grad_() if grad else t

    x, x8, img = dev_t((64, 65536)), dev_t((8, 65536)), dev_t((2048, 2048))
    xg, img_g = dev_t((64, 65536), True), dev_t((2048, 2048), True)
    w, w_img = dev_t((64, 65536)), dev_t((2048, 2048))
    g0, h0 = new["transforms.modwt"]._modwt_base_filters("db4")
    fb = new_jt.get_filter("db4")
    lo, hi = fb.dec_lo, fb.dec_hi

    def calls(jt, m):
        cm, cp = m["ops.cuda_modwt"], m["ops.cuda_pyramid"]
        grad = torch.autograd.grad
        return {
            "K1 64x65536 db4 L5": lambda: cm.modwt_cascade(x, g0, h0, 5),
            "entry step modwt+imodwt db4 L5 64x65536":
                lambda: jt.imodwt(jt.modwt(x, "Daubechies 4", 5), "Daubechies 4"),
            "entry grad db4 L5 64x65536":
                lambda: grad((jt.imodwt(jt.modwt(xg, "db4", 5), "db4") * w).sum(), xg),
            "modwt_mra db4 L5 64x65536": lambda: jt.modwt_mra(x, "db4", 5),
            "denoise db4 L4 8x65536": lambda: jt.denoise(x8, "db4", 4),
            "K1 8x65536 db4 L4": lambda: cm.modwt_cascade(x8, g0, h0, 4),
            "K4 one pass db4 L6 2048^2": lambda: cp.pyramid_rows_transposed(img, lo, hi, 6),
            "fwt2d db4 L6 2048^2": lambda: jt.fwt2d(img, "db4", 6, 6),
            "ifwt2d grad db4 L6 2048^2":
                lambda: grad((jt.ifwt2d(img_g, "db4", 6, 6) * w_img).sum(), img_g),
        }

    variants = {"parent": calls(par_jt, par), "new": calls(new_jt, new)}
    variants = {v: {k: f for k, f in t.items() if any(c in k for c in args.calls)}
                for v, t in variants.items() if v in args.variants}

    # each variant's K1 and K4 against the plain version, in float64
    cm = new["ops.cuda_modwt"]
    cp = new["ops.cuda_pyramid"]
    refs = {"K1 64x65536 db4 L5": cm.modwt_cascade_torch(x.double(), g0, h0, 5),
            "K4 one pass db4 L6 2048^2": cp.pyramid_rows_transposed_torch(img.double(), lo, hi, 6)}
    for v, table in variants.items():
        for key, ref in refs.items():
            if key not in table:
                continue
            got = table[key]()
            torch.cuda.synchronize()
            rel = float((got.double() - ref).abs().max() / ref.abs().max())
            print(json.dumps({"check": f"{v}: {key} against its plain version", "rel": rel,
                              "bound": F32_BOUND}), flush=True)
            if not rel <= F32_BOUND:
                print(f"ab_times: {v} {key} disagrees with its plain version", file=sys.stderr)
                return 1
    del refs

    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device=dev)

    def measure(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        dev_ms, wall_ms, host_ms = [], [], []
        for spin in (True, False):
            for _ in range(args.reps):
                flush.fill_(1.0)
                if spin:
                    torch.cuda._sleep(10_000_000)
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                t0 = time.perf_counter()
                fn()
                t1 = time.perf_counter()
                b.record()
                b.synchronize()
                (dev_ms if spin else wall_ms).append(a.elapsed_time(b))
                if not spin:
                    host_ms.append((t1 - t0) * 1e3)
        return {"device": float(np.median(dev_ms)), "wall": float(np.median(wall_ms)),
                "host": float(np.median(host_ms))}

    names = list(variants)
    calls_kept = list(next(iter(variants.values())))
    ways = ("device", "wall", "host")
    rounds: dict = {}  # (call, variant) -> list of per-round means
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("w") as log:
        log.write(json.dumps({"card": card}) + "\n")
        for r in range(args.rounds):
            seq = names[r % len(names):] + names[:r % len(names)]
            for key in calls_kept:
                got: dict = {}
                for v in seq + seq[::-1]:
                    t = measure(variants[v][key])
                    got.setdefault(v, []).append(t)
                    log.write(json.dumps({"round": r, "call": key, "variant": v, **t}) + "\n")
                for v, ts in got.items():
                    rounds.setdefault((key, v), []).append(
                        {w_: (ts[0][w_] + ts[1][w_]) / 2 for w_ in ways})
            log.flush()
            print(json.dumps({"round": r, "done": True}), flush=True)

    for key in calls_kept:
        for v in names:
            rs = rounds.get((key, v))
            if not rs:
                continue
            print(json.dumps({"call": key, "variant": v, "card": card, **{
                w_: {"median": float(np.median([x_[w_] for x_ in rs])),
                     "min": min(x_[w_] for x_ in rs), "max": max(x_[w_] for x_ in rs)}
                for w_ in ways}}), flush=True)
        if (key, "new") in rounds and (key, "parent") in rounds:
            ratios = {w_: [x_[w_] / y_[w_]
                           for x_, y_ in zip(rounds[(key, "new")], rounds[(key, "parent")])]
                      for w_ in ways}
            print(json.dumps({"call": key, "ratio": "new/parent", **{
                w_: {"median": float(np.median(v_)), "min": min(v_), "max": max(v_)}
                for w_, v_ in ratios.items()},
                "unresolved": [w_ for w_, v_ in ratios.items() if min(v_) < 1 < max(v_)]}),
                flush=True)

    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        for key in ("denoise db4 L4 8x65536", "ifwt2d grad db4 L6 2048^2",
                    "entry grad db4 L5 64x65536"):
            for v in ("parent", "new"):
                if v not in variants or key not in variants[v]:
                    continue
                fn = variants[v][key]
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                avg = prof.key_averages()
                ev = sorted(avg, key=lambda e: -e.self_cpu_time_total)[:10]
                kern = sorted((e for e in avg if e.self_device_time_total > 0),
                              key=lambda e: -e.self_device_time_total)[:10]
                print(json.dumps({"trace": key, "variant": v, "host_ops_self_us": [
                    [e.key[:60], e.count, round(e.self_cpu_time_total, 1)] for e in ev],
                    "kernels_device_us": [[e.key[:60], e.count, round(e.self_device_time_total, 1)]
                                          for e in kern]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
