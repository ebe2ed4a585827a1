"""Console entry point: ``python -m jwave_tpu_torch [transform] [wavelet]``.

Mirrors the reference CLI demo (jwave/JWave.java:62-123): transform a
constant length-16 array, print the time-domain input, the coefficient
("Hilbert") domain, and the reconstruction. Adds ``list``, ``denoise`` and
``bench`` subcommands the reference lacks; ``bench`` runs
:mod:`jwave_tpu_torch.bench` (``--sweep``, ``--pallas-smoke``).
``--device`` says where the work runs: the card ("cuda") unless it names
another; without a card the demo and the bench print torch's error and
exit 1.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .utils.host import host_array


def _demo(transform_name: str, wavelet_name: str, device: str) -> int:
    from .api import TransformBuilder

    t = TransformBuilder.create(transform_name, wavelet_name, device=device)
    x = np.ones(16)
    y = t.forward(x)  # on the device first: a fault prints nothing else
    xr = host_array(t.reverse(y))
    print(f"{transform_name} ({wavelet_name})")
    print("time domain:   ", np.array2string(x, precision=3))
    print("hilbert domain:", np.array2string(host_array(y), precision=3, suppress_small=True))
    print("reconstruction:", np.array2string(xr, precision=3, suppress_small=True))
    err = float(np.max(np.abs(xr - x)))
    print(f"max |error| = {err:.2e}")
    return 0 if err < 1e-5 else 1


def _list() -> int:
    from .api import TransformBuilder
    from .filters import available_filters, get_filter
    from .transforms.lifting import lifting_schemes

    print("transforms:")
    for name in sorted(TransformBuilder._NAMES):
        print(f"  {name}")
    print("  ancient egyptian decomposition <inner transform>")
    print("\nwavelets:")
    for name in available_filters():
        fb = get_filter(name)
        flags = "" if fb.junit_passing else "  [no perfect reconstruction in reference tests]"
        print(f"  {name:<22} ({fb.length:>2} taps){flags}")
    print("\nlifting schemes (Lifting Wavelet Transform):", ", ".join(lifting_schemes()))
    print("\ncontinuous wavelets: Morlet, Mexican Hat, Paul, DOG, Meyer, Morse")
    print("\nanalysis API (import jwave_tpu_torch): ssq_cwt (reassignment kernel K6),")
    print("  superlet, scattering1d/2d (spectral form, cuFFT), vmd, ewt,")
    print("  matching_pursuit, dtcwt/dtcwt2d, denoise/denoise_dtcwt, modwt_mra,")
    print("  modwt_variance, hurst_exponent, best_basis(_2d), xwt/wavelet_coherence,")
    print("  analytic_signal/instantaneous_frequency,")
    print("  modwt/imodwt (cascade kernels K1/K2 on the card),")
    print("  fwt/fwt2d/ifwt2d (pyramid kernels K3/K4/K5 on the card),")
    print("  SlidingMODWT (incremental sliding-window analysis),")
    print("  wpt(layout='interleaved') (relayout-free coefficient pipelines)")
    return 0


def _denoise_demo(wavelet_name: str, device: str) -> int:
    from .denoise import denoise

    rng = np.random.default_rng(0)
    n = 2048
    t = np.arange(n) / n
    clean = np.sign(np.sin(2 * np.pi * 20 * t))
    noisy = clean + 0.4 * rng.standard_normal(n)
    x = torch.as_tensor(noisy, device=device)
    print(f"denoise demo ({wavelet_name}): square wave + N(0, 0.4^2), n={n}")
    print(f"  noisy MSE      {np.mean((noisy - clean) ** 2):.4f}")
    for method in ("universal", "sure", "bayes"):
        out = host_array(denoise(x, wavelet_name, 5, method=method))
        print(f"  {method:<9} MSE  {np.mean((out - clean) ** 2):.4f}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="jwave_tpu_torch", description=__doc__)
    p.add_argument("transform", nargs="?", default="Fast Wavelet Transform",
                   help='e.g. "Fast Wavelet Transform", "MODWT", "list", "bench", "denoise"')
    p.add_argument("wavelet", nargs="?", default="Haar", help='e.g. "Haar", "db4", "sym8"')
    p.add_argument("--device", default="cuda",
                   help='where the work runs: "cuda" (the default) or "cpu"')
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--sweep", action="store_true", help="bench: the reference's sweeps")
    mode.add_argument("--pallas-smoke", action="store_true",
                      help="bench: the kernels' proof (K1-K3 on the card)")
    args = p.parse_args(argv)
    try:
        if args.transform == "bench":
            from . import bench

            mode = "sweep" if args.sweep else "pallas_smoke" if args.pallas_smoke else "rows"
            return bench.run(mode, args.device)
        if args.sweep or args.pallas_smoke:
            raise ValueError("--sweep and --pallas-smoke go with bench")
        if args.transform == "list":
            return _list()
        if args.transform == "denoise":
            return _denoise_demo(args.wavelet, args.device)
        return _demo(args.transform, args.wavelet, args.device)
    except Exception as e:  # clean one-line CLI errors, no traceback
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
