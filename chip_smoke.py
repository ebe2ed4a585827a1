"""Smoke run of jwave_tpu_torch on one CUDA card (written for an H100).

    python3 chip_smoke.py

Phases, each ending in torch.cuda.synchronize() so that a fault shows where
it happened; any failed check ends the run with a non-zero exit:

1. device: needs a CUDA card; prints the card's name and power limit;
   turns TF32 off (true float32, the JAX package's default precision).
2. build: compiles csrc/*.cu with nvcc and prints the build seconds.
3. kernels: K1-K4 on the card against their plain torch versions run in
   float64 on the same input, at the main path's shapes and at edge shapes.
4. main path: modwt -> imodwt (MODWT db4 L5, 64 x 65536 f32) and the FWT
   facade forward/reverse on 64 x 65536 rows and a 2048 x 2048 image, all
   through the public entry points with device="cuda"; the launch count of
   every kernel must rise; a small input is checked against the numpy
   oracle in tests/oracle.py.
5. times: CUDA events, median of 25 runs after warm-up with the L2 cache
   flushed before each, kernel beside its plain version; for context also
   the torch FFT path of the MODWT (cuFFT), which is not a kernel of this
   package.

The second line from the end is a JSON object listing each kernel with its
launches on the main path, its error and its time; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
F32_BOUND = 1e-5   # max|err| / max|ref| for float32 storage (f32 accumulation)
BF16_BOUND = 1e-2  # bf16 storage rounds each stored value to 2^-9 relative
REPS = 25


def require(ok, msg):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def main() -> int:
    # ---- 1. device -----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import jwave_tpu_torch as jt
    import oracle
    from jwave_tpu_torch.ops import cuda_build, cuda_modwt, cuda_pyramid
    from jwave_tpu_torch.transforms.modwt import _modwt_base_filters

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    jt.config.set_conv_precision("highest")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    # ---- 2. build ------------------------------------------------------
    for name in ("modwt", "pyramid"):
        t0 = time.perf_counter()
        cuda_build.library(name)
        secs, log = cuda_build.BUILD_LOG.get(name, (0.0, "(already built)"))
        print(f"build {name}: {time.perf_counter() - t0:.3f} s (nvcc {secs:.3f} s)", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  " + line.strip(), flush=True)

    # ---- 3. each kernel against its plain version ----------------------
    errors = {}

    def compare(label, got, ref, bound):
        ref = ref.double()
        err = float((got.double() - ref).abs().max())
        scale = float(ref.abs().max())
        rel = err / scale
        print(json.dumps({"check": label, "max_abs_err": err, "max_abs_ref": scale,
                          "rel": rel, "bound": bound}), flush=True)
        require(np.isfinite(rel) and rel <= bound, f"{label}: {rel} > {bound}")
        return err

    def signal(shape, dtype=torch.float32):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)

    def modwt_case(label, shape, wavelet, level, dtype=torch.float32):
        g0, h0 = _modwt_base_filters(wavelet)
        x = signal(shape, dtype)
        bound = F32_BOUND if dtype == torch.float32 else BF16_BOUND
        c = cuda_modwt.modwt_cascade(x, g0, h0, level)
        torch.cuda.synchronize()
        e1 = compare(f"K1 {label}", c, cuda_modwt.modwt_cascade_torch(x.double(), g0, h0, level), bound)
        back = cuda_modwt.imodwt_cascade(c, g0, h0)
        torch.cuda.synchronize()
        e2 = compare(f"K2 {label}", back, cuda_modwt.imodwt_cascade_torch(c.double(), g0, h0), bound)
        return e1, e2

    errors["K1"], errors["K2"] = modwt_case("64x65536 db4 L5", (64, 65536), "db4", 5)
    modwt_case("8x777 db4 L9", (8, 777), "db4", 9)
    modwt_case("4x256 dmey L5 (halo > N)", (4, 256), "Discrete Meyer", 5)
    modwt_case("4x8192 Haar L13 (two level groups)", (4, 8192), "Haar", 13)
    modwt_case("2x20000 dmey L10 (unstaged deep levels)", (2, 20000), "Discrete Meyer", 10)
    modwt_case("64x65536 db4 L5 bf16", (64, 65536), "db4", 5, torch.bfloat16)

    def pyramid_case(label, shape, wavelet, level):
        fb = jt.get_filter(wavelet)
        x = signal(shape)
        done = cuda_pyramid.levels_done(shape[1], fb.transform_wavelength, level)
        y = cuda_pyramid.pyramid_rows(x, fb.dec_lo, fb.dec_hi, done)
        torch.cuda.synchronize()
        return compare(f"K3 {label}", y,
                       cuda_pyramid.pyramid_rows_torch(x.double(), fb.dec_lo, fb.dec_hi, done),
                       F32_BOUND)

    errors["K3"] = pyramid_case("64x65536 db4 L8", (64, 65536), "db4", 8)
    pyramid_case("16x4096 sym8 L6", (16, 4096), "sym8", 6)
    pyramid_case("8x1024 Battle 23 full", (8, 1024), "Battle 23", 10)
    pyramid_case("8x4096 Haar full", (8, 4096), "Haar", 12)
    pyramid_case("4x262144 db4 L10 (cut long rows)", (4, 262144), "db4", 10)

    def fwt2d_case(label, shape, wavelet, level):
        fb = jt.get_filter(wavelet)
        x = signal(shape)
        d_cols = cuda_pyramid.levels_done(shape[1], fb.transform_wavelength, level)
        d_rows = cuda_pyramid.levels_done(shape[0], fb.transform_wavelength, level)
        y1 = cuda_pyramid.pyramid_rows_transposed(x, fb.dec_lo, fb.dec_hi, d_cols)
        torch.cuda.synchronize()
        ref1 = cuda_pyramid.pyramid_rows_transposed_torch(x.double(), fb.dec_lo, fb.dec_hi, d_cols)
        err = compare(f"K4 pass {label}", y1, ref1, F32_BOUND)
        y = jt.fwt2d(x, wavelet, level, level)
        torch.cuda.synchronize()
        ref = cuda_pyramid.pyramid_rows_transposed_torch(ref1, fb.dec_lo, fb.dec_hi, d_rows)
        compare(f"fwt2d (K4 x2) {label}", y, ref, F32_BOUND)
        return err

    errors["K4"] = fwt2d_case("2048x2048 db4 L6", (2048, 2048), "db4", 6)
    fwt2d_case("512x1024 Haar L3", (512, 1024), "Haar", 3)

    # ---- 4. the main path through the entry points ---------------------
    x64 = np.random.default_rng(1).standard_normal((64, 65536)).astype(np.float32)
    img = np.random.default_rng(2).standard_normal((2048, 2048)).astype(np.float32)
    cuda_modwt.reset_launch_counts()
    cuda_pyramid.reset_launch_counts()
    x = torch.as_tensor(x64, device=dev)
    coeffs = jt.modwt(x, "Daubechies 4", 5)
    xr = jt.imodwt(coeffs, "Daubechies 4")
    fwt_t = jt.TransformBuilder.create("Fast Wavelet Transform", "db4", device="cuda")
    rows_c = fwt_t.get_basic_transform().forward(x64)      # numpy rows -> device="cuda"
    rows_back = fwt_t.get_basic_transform().reverse(rows_c)
    img_c = fwt_t.forward(img)                              # 2D dispatch -> fwt2d
    img_back = fwt_t.reverse(img_c)
    torch.cuda.synchronize()
    launches = {"K1": cuda_modwt.launch_counts["modwt_cascade"],
                "K2": cuda_modwt.launch_counts["imodwt_cascade"],
                "K3": cuda_pyramid.launch_counts["pyramid_rows"],
                "K4": cuda_pyramid.launch_counts["pyramid_rows_transposed"]}
    print(json.dumps({"main_path_launches": launches}), flush=True)
    require(all(v >= 1 for v in launches.values()), f"a kernel was not launched: {launches}")
    for label, got, want, shape in (
        ("modwt->imodwt 64x65536 db4 L5", xr, x64, (64, 65536)),
        ("fwt->ifwt rows 64x65536 db4", rows_back, x64, (64, 65536)),
        ("fwt2d->ifwt2d 2048x2048 db4", img_back, img, (2048, 2048)),
    ):
        require(got.is_cuda and tuple(got.shape) == shape and bool(torch.isfinite(got).all()),
                f"{label}: not a finite CUDA tensor of shape {shape}")
        err = float((got.double().cpu() - torch.as_tensor(want).double()).abs().max())
        print(json.dumps({"roundtrip": label, "max_abs_err": err}), flush=True)
        require(err < 1e-4, f"{label}: round trip error {err}")
    require(tuple(coeffs.shape) == (64, 6, 65536) and coeffs.dtype == torch.float32,
            f"modwt output {tuple(coeffs.shape)} {coeffs.dtype}")
    require(tuple(rows_c.shape) == (64, 65536) and tuple(img_c.shape) == (2048, 2048),
            "FWT output shapes")

    # small inputs against the float64 numpy oracle
    small = np.random.default_rng(3).standard_normal((2, 300))
    c_small = jt.modwt(torch.as_tensor(small, dtype=torch.float32, device=dev), "db4", 4)
    want = np.stack([oracle.modwt(r, jt.get_filter("db4"), 4) for r in small])
    err = float(np.abs(c_small.cpu().double().numpy() - want).max())
    print(json.dumps({"oracle": "modwt 2x300 db4 L4", "max_abs_err": err}), flush=True)
    require(err <= F32_BOUND * np.abs(want).max(), "modwt against the oracle")
    sm = np.random.default_rng(4).standard_normal((64, 64))
    fb = jt.get_filter("db4")
    y_small = jt.fwt2d(torch.as_tensor(sm, dtype=torch.float32, device=dev), "db4")
    want2 = np.stack([oracle.fwt(r, fb, 6) for r in sm])
    want2 = np.stack([oracle.fwt(c, fb, 6) for c in want2.T]).T
    err = float(np.abs(y_small.cpu().double().numpy() - want2).max())
    print(json.dumps({"oracle": "fwt2d 64x64 db4", "max_abs_err": err}), flush=True)
    require(err <= F32_BOUND * np.abs(want2).max(), "fwt2d against the oracle")
    y1 = jt.fwt(torch.as_tensor(sm, dtype=torch.float32, device=dev), "db4", 5)
    want1 = np.stack([oracle.fwt(r, fb, 5) for r in sm])
    err = float(np.abs(y1.cpu().double().numpy() - want1).max())
    print(json.dumps({"oracle": "fwt 64x64 db4 L5", "max_abs_err": err}), flush=True)
    require(err <= F32_BOUND * np.abs(want1).max(), "fwt against the oracle")
    torch.cuda.synchronize()

    # ---- 5. times --------------------------------------------------------
    # written before every timed run so that each starts with a cold 50 MB L2,
    # as a caller with fresh data would find it
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device=dev)

    def median_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            flush.fill_(1.0)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def pair(kernel, plain):
        """plain, kernel, kernel, plain; the mean of each side's two medians."""
        p1, k1, k2, p2 = median_ms(plain), median_ms(kernel), median_ms(kernel), median_ms(plain)
        return (k1 + k2) / 2, (p1 + p2) / 2

    g0, h0 = _modwt_base_filters("db4")
    c32 = cuda_modwt.modwt_cascade(x, g0, h0, 5)
    done8 = cuda_pyramid.levels_done(65536, 2, 8)
    ximg = torch.as_tensor(img, device=dev)
    lo, hi = fb.dec_lo, fb.dec_hi
    timing = {
        "K1": pair(lambda: cuda_modwt.modwt_cascade(x, g0, h0, 5),
                   lambda: cuda_modwt.modwt_cascade_torch(x, g0, h0, 5)),
        "K2": pair(lambda: cuda_modwt.imodwt_cascade(c32, g0, h0),
                   lambda: cuda_modwt.imodwt_cascade_torch(c32, g0, h0)),
        "K1+K2": pair(lambda: jt.imodwt(jt.modwt(x, "Daubechies 4", 5), "Daubechies 4"),
                      lambda: cuda_modwt.imodwt_cascade_torch(
                          cuda_modwt.modwt_cascade_torch(x, g0, h0, 5), g0, h0)),
        "K3": pair(lambda: cuda_pyramid.pyramid_rows(x, lo, hi, done8),
                   lambda: cuda_pyramid.pyramid_rows_torch(x, lo, hi, done8)),
        "K4": pair(lambda: cuda_pyramid.pyramid_rows_transposed(ximg, lo, hi, 6),
                   lambda: cuda_pyramid.pyramid_rows_transposed_torch(ximg, lo, hi, 6)),
        "fwt2d": pair(lambda: jt.fwt2d(ximg, "db4", 6, 6),
                      lambda: cuda_pyramid.pyramid_rows_transposed_torch(
                          cuda_pyramid.pyramid_rows_transposed_torch(ximg, lo, hi, 6), lo, hi, 6)),
    }
    shapes = {"K1": ("modwt db4 L5 64x65536", 64 * 65536, "Msamples_per_s"),
              "K2": ("imodwt db4 L5 64x65536", 64 * 65536, "Msamples_per_s"),
              "K1+K2": ("modwt+imodwt db4 L5 64x65536 (entry step)", 64 * 65536, "Msamples_per_s"),
              "K3": ("fwt db4 L8 64x65536", 64 * 65536, "Msamples_per_s"),
              "K4": ("one K4 pass db4 L6 2048x2048", 2048 * 2048, "Mpix_per_s"),
              "fwt2d": ("fwt2d db4 L6 2048x2048 (K4 x2)", 2048 * 2048, "Mpix_per_s")}
    fft = jt.ConvolutionMethod.FFT
    fft_ms = median_ms(lambda: jt.imodwt(jt.modwt(x, "Daubechies 4", 5, method=fft),
                                         "Daubechies 4", method=fft))
    print(json.dumps({"time": "modwt+imodwt torch FFT path (cuFFT, for context)",
                      "shape": "db4 L5 64x65536", "ms": fft_ms,
                      "Msamples_per_s": 64 * 65536 / fft_ms / 1e3, "card": card}), flush=True)
    for key, (ms, plain_ms) in timing.items():
        label, count, unit = shapes[key]
        print(json.dumps({"time": key, "shape": label, "ms": ms, "plain_ms": plain_ms,
                          unit: count / ms / 1e3, f"plain_{unit}": count / plain_ms / 1e3,
                          "card": card}), flush=True)
    torch.cuda.synchronize()

    csrc = "jwave_tpu_torch/csrc/"
    table = [
        ("K1 modwt_cascade", "modwt.cu", "jwave_tpu/ops/pallas_modwt.py:53"),
        ("K2 imodwt_cascade", "modwt.cu", "jwave_tpu/ops/pallas_modwt.py:93"),
        ("K3 pyramid_rows", "pyramid.cu", "jwave_tpu/ops/pallas_pyramid.py:299"),
        ("K4 pyramid_rows_transposed", "pyramid.cu", "jwave_tpu/ops/pallas_pyramid.py:141"),
    ]
    kernels = []
    for (name, src, replaces) in table:
        k = name.split()[0]
        kernels.append({"name": name, "route": "cuda", "source": csrc + src, "replaces": replaces,
                        "launches": launches[k], "max_abs_err": errors[k],
                        "ms": timing[k][0], "plain_ms": timing[k][1]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
