"""Another commit's kernels against this tree's, and K2's unrolled db4 body
against its generic one, in one process on one CUDA card.

    python3 tools/ab_times.py --parent build/parent [--rounds 6] [--reps 25]
                              [--variants parent new generic] [--calls TEXT ...]
                              [--out build/ab_times.jsonl] [--trace]

``--parent`` is another commit's tree, unpacked (``git archive <commit> |
tar -x -C build/parent``). Its ``jwave_tpu_torch`` is imported under another
name beside this tree's, so the two share one process, one CUDA context and
one card, and whatever slows the host slows both. A third variant,
"generic", is this tree with K2 built with ``-DJW_K2_UNROLLED_TAPS=0``, so
that db4 takes the generic sliding-window body. Each variant's K2 and K5
are first held against the plain version (1e-5 of max|ref|).

The calls are the consumers of K2 (K2 alone at 64 x 65536 db4 L5, the entry
step ``imodwt(modwt(x))`` and its gradient, ``modwt_mra`` at the same shape,
``denoise`` db4 L4 8 x 65536, the gradient of ``hurst_exponent`` at
8 x 65536, K2 alone at ``denoise``'s 8 x 65536 db4 L4) and of K5 (one K5
pass and ``ifwt2d`` at 2048^2 db4 L6, the gradient of ``fwt2d`` there).
The generic variant runs only the K2 calls. ``--variants`` keeps some of
the three (one alone measures one tree in a process of its own: the inputs
are made by the plain versions, so no other kernel runs there), and
``--calls`` keeps the calls whose name contains one of the given texts.

Each round times every call in the turns A B C C B A over its variants, the
first variant rotating from round to round, three ways, each the median of
``--reps`` runs after a 128 MB write that flushes the 50 MB L2:

  device  CUDA events after a ~5 ms GPU spin, so the host's launches are
          queued before the first event: the device's time alone;
  wall    CUDA events with no spin: a host slower than the device shows;
  host    perf_counter around the call, with no sync: the time to enqueue.

Every measurement goes to ``--out`` as a JSON line; stdout gets one summary
line per call and variant (median, min and max over the rounds of the mean
of the round's two turns) and per call the ratio new/parent and
generic/new. With ``--trace``, one profiled call of each variant of the
host-bound calls kept prints its heaviest host ops and its kernels' device
time. Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import ctypes
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


def _build_generic(cb):
    """This tree's modwt.cu with every filter length through the generic K2 body."""
    cb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = cb.BUILD_DIR / "libmodwt_generic_taps.so"
    proc = subprocess.run([cb._nvcc(), *cb.NVCC_FLAGS, "-DJW_K2_UNROLLED_TAPS=0", "-o",
                           str(target), str(cb.CSRC / "modwt.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on the generic K2 build:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(target))
    lib.jw_error_string.argtypes = [ctypes.c_int]
    lib.jw_error_string.restype = ctypes.c_char_p
    return lib, proc.stdout + proc.stderr


def _inv_ptxas(report: str) -> list[str]:
    """The -Xptxas -v lines of the K2 kernels."""
    lines, keep = [], False
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            keep = "modwt_inv_kernel" in ln
        if keep and ("Used" in ln or "spill" in ln):
            lines.append(ln.split(":", 1)[-1].strip())
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "ab_times.jsonl")
    ap.add_argument("--variants", nargs="+", default=["parent", "new", "generic"],
                    choices=["parent", "new", "generic"])
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
    with ThreadPoolExecutor(5) as ex:
        jobs = [ex.submit(m["ops.cuda_build"].library, k) for m in trees
                for k in ("modwt", "pyramid")]
        generic_job = (ex.submit(_build_generic, new["ops.cuda_build"])
                       if "generic" in args.variants else None)
        for j in jobs:
            j.result()
        generic_lib, generic_report = generic_job.result() if generic_job else (None, "")
    unrolled_lib = new["ops.cuda_build"]._LIBS.get("modwt")
    print(json.dumps({"ptxas K2 unrolled": _inv_ptxas(
        new["ops.cuda_build"].BUILD_LOG.get("modwt", (0, ""))[1]),
        "ptxas K2 generic": _inv_ptxas(generic_report)}), flush=True)

    def use(variant):
        """Point this tree's K2 at the unrolled or the generic build."""
        new["ops.cuda_build"]._LIBS["modwt"] = generic_lib if variant == "generic" else unrolled_lib

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def dev_t(shape, grad=False):
        t = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
        return t.requires_grad_() if grad else t

    x, x8, img = dev_t((64, 65536)), dev_t((8, 65536)), dev_t((2048, 2048))
    xg, xh, img_g = dev_t((64, 65536), True), dev_t((8, 65536), True), dev_t((2048, 2048), True)
    w, w_img = dev_t((64, 65536)), dev_t((2048, 2048))
    g0, h0 = new["transforms.modwt"]._modwt_base_filters("db4")
    c32 = new["ops.cuda_modwt"].modwt_cascade_torch(x, g0, h0, 5)
    c8 = new["ops.cuda_modwt"].modwt_cascade_torch(x8, g0, h0, 4)
    fb = new_jt.get_filter("db4")
    rlo, rhi = fb.rec_lo, fb.rec_hi

    def calls(jt, m):
        cm, cp = m["ops.cuda_modwt"], m["ops.cuda_pyramid"]
        grad = torch.autograd.grad
        return {
            "K2 64x65536 db4 L5": lambda: cm.imodwt_cascade(c32, g0, h0),
            "entry step modwt+imodwt db4 L5 64x65536":
                lambda: jt.imodwt(jt.modwt(x, "Daubechies 4", 5), "Daubechies 4"),
            "entry grad db4 L5 64x65536":
                lambda: grad((jt.imodwt(jt.modwt(xg, "db4", 5), "db4") * w).sum(), xg),
            "modwt_mra db4 L5 64x65536": lambda: jt.modwt_mra(x, "db4", 5),
            "denoise db4 L4 8x65536": lambda: jt.denoise(x8, "db4", 4),
            "hurst_exponent grad 8x65536": lambda: grad(jt.hurst_exponent(xh).sum(), xh),
            "K2 8x65536 db4 L4": lambda: cm.imodwt_cascade(c8, g0, h0),
            "K5 one pass db4 L6 2048^2": lambda: cp.ipyramid_rows_transposed(img, rlo, rhi, 1.0, 6),
            "ifwt2d db4 L6 2048^2": lambda: jt.ifwt2d(img, "db4", 6, 6),
            "fwt2d grad db4 L6 2048^2":
                lambda: grad((jt.fwt2d(img_g, "db4", 6, 6) * w_img).sum(), img_g),
        }

    variants = {"parent": calls(par_jt, par), "new": calls(new_jt, new),
                "generic": calls(new_jt, new)}
    variants = {v: {k: f for k, f in t.items() if any(c in k for c in args.calls)}
                for v, t in variants.items() if v in args.variants}
    k2_calls = [k for k in calls(new_jt, new) if not k.startswith(("K5", "ifwt2d", "fwt2d"))]

    # each variant's K2 and K5 against the plain version, in float64
    cm = new["ops.cuda_modwt"]
    cp = new["ops.cuda_pyramid"]
    refs = {"K2 64x65536 db4 L5": cm.imodwt_cascade_torch(c32.double(), g0, h0),
            "K5 one pass db4 L6 2048^2": cp.ipyramid_rows_transposed_torch(
                img.double(), rlo, rhi, 1.0, 6)}
    for v, table in variants.items():
        use(v)
        for key, ref in refs.items():
            if key not in table or (v == "generic" and key not in k2_calls):
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
            order = names[r % len(names):] + names[:r % len(names)]
            for key in calls_kept:
                seq = [v for v in order if v != "generic" or key in k2_calls]
                got: dict = {}
                for v in seq + seq[::-1]:
                    use(v)
                    t = measure(variants[v][key])
                    got.setdefault(v, []).append(t)
                    log.write(json.dumps({"round": r, "call": key, "variant": v, **t}) + "\n")
                for v, ts in got.items():
                    rounds.setdefault((key, v), []).append(
                        {w_: (ts[0][w_] + ts[1][w_]) / 2 for w_ in ways})
            log.flush()
            print(json.dumps({"round": r, "done": True}), flush=True)
    use("new")

    for key in calls_kept:
        for v in names:
            rs = rounds.get((key, v))
            if not rs:
                continue
            print(json.dumps({"call": key, "variant": v, "card": card, **{
                w_: {"median": float(np.median([x_[w_] for x_ in rs])),
                     "min": min(x_[w_] for x_ in rs), "max": max(x_[w_] for x_ in rs)}
                for w_ in ways}}), flush=True)
        for a_, b_ in (("new", "parent"), ("generic", "new")):
            if (key, a_) not in rounds or (key, b_) not in rounds:
                continue
            ratios = {w_: [x_[w_] / y_[w_] for x_, y_ in zip(rounds[(key, a_)], rounds[(key, b_)])]
                      for w_ in ways}
            print(json.dumps({"call": key, "ratio": f"{a_}/{b_}", **{
                w_: {"median": float(np.median(v_)), "min": min(v_), "max": max(v_)}
                for w_, v_ in ratios.items()}}), flush=True)

    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        for key in ("denoise db4 L4 8x65536", "fwt2d grad db4 L6 2048^2",
                    "entry grad db4 L5 64x65536", "hurst_exponent grad 8x65536"):
            for v in ("parent", "new"):
                if v not in variants or key not in variants[v]:
                    continue
                use(v)
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
