"""The readings that the limits of ``correct`` are set from.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --seconds 2 \
        --side program|tf32|program_tf32

runs the cell's set-up, a window and the check once a seed in one process,
and prints each run's compared numbers as a JSON line. ``program`` is the
program as the configuration states it (the lower readings); ``tf32`` puts
the reference, computed in TF32 (:data:`reference.precision.TF32`), in the
program's place (the control, which has to fail); ``program_tf32`` is the
program with its own TF32 switch on (``config.set_conv_precision("high")``),
which only the cuDNN convolutions read. The benchmark's runs do not run
this; its tests do, at small sizes.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.reference import fwt as ref_fwt  # noqa: E402
from benchmark.reference import modwt as ref_modwt  # noqa: E402
from benchmark.reference import sliding as ref_sliding  # noqa: E402
from benchmark.reference import taps  # noqa: E402
from benchmark.reference.precision import TF32  # noqa: E402


class _State:
    """A sliding state of the reference: the stream's tail and the window's
    coefficient columns."""

    def __init__(self, tail, coeffs):
        self.tail, self.coeffs = tail, coeffs


class _Transform:
    def __init__(self, api, wavelet):
        self.api, self.wavelet = api, wavelet

    def forward(self, v, *levels):
        lo, hi = taps.fwt_bank(self.wavelet)
        return ref_fwt.fwt_nd(v, lo, hi, levels, self.api.prec).float()

    def reverse(self, y, *levels):
        lo, hi = taps.fwt_bank(self.wavelet)
        return ref_fwt.ifwt_nd(y, lo, hi, levels, self.api.prec).float()


class ReferenceApi:
    """The entries' calls answered by the reference in precision ``prec``,
    as float32 tensors, in the program's place."""

    def __init__(self, prec=TF32):
        self.prec = prec

    def modwt(self, x, wavelet, level):
        g, h = taps.modwt_filters(wavelet)
        return ref_modwt.modwt(x, g, h, level, self.prec).float()

    def imodwt(self, c, wavelet):
        g, h = taps.modwt_filters(wavelet)
        return ref_modwt.imodwt(c, g, h, self.prec).float()

    def FastWaveletTransform(self, wavelet):  # noqa: N802 (the program's name)
        return wavelet

    def Transform(self, wavelet):  # noqa: N802
        return _Transform(self, wavelet)

    def sliding_modwt_init(self, x0, wavelet, level):
        g, h = taps.modwt_filters(wavelet)
        x0 = x0.to(torch.float64)
        return _State(x0, ref_sliding.causal_modwt(x0, g, h, level, self.prec).float())

    def sliding_modwt_update(self, state, samples, wavelet, level):
        g, h = taps.modwt_filters(wavelet)
        s = torch.as_tensor(samples, device=state.tail.device).to(torch.float64)
        reach = (len(g) - 1) * ((1 << level) - 1)
        tail = torch.cat([state.tail, s], -1)[..., -(reach + s.shape[-1]):]
        cols = ref_sliding.causal_modwt(tail, g, h, level, self.prec)[..., -s.shape[-1]:]
        coeffs = torch.cat([state.coeffs[..., s.shape[-1]:], cols.float()], -1)
        return _State(tail, coeffs)


def program_api(tf32: bool = False):
    api = importlib.import_module("jwave_tpu_torch")
    api.config.set_conv_precision("high" if tf32 else "highest")
    return api


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--side", choices=("program", "tf32", "program_tf32"), default="program")
    args = p.parse_args(argv)
    from benchmark import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    api = ReferenceApi(TF32) if args.side == "tf32" else program_api(args.side == "program_tf32")
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.run_cell(args.workload, seed, args.seconds, False, api=api)
        print(json.dumps({"cell": args.workload, "side": args.side, "seed": seed,
                          "requests": run.requests,
                          "checks": {k: v for k, (v, _) in run.checks.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
