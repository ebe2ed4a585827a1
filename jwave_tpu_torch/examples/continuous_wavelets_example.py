"""Tour of the continuous wavelet families (Paul, DOG, Meyer, Mexican
hat): evaluate each mother wavelet in time and frequency and run a small
CWT with each (the JAX package's ``examples/continuous_wavelets_example.py``).
"""
import numpy as np
import torch

import jwave_tpu_torch as jt
from ._common import host, run


def main(device=None):
    dev = torch.device(device or "cuda")
    fs, n = 100.0, 512
    t = np.arange(n) / fs
    sig = torch.as_tensor(np.sin(2 * np.pi * 5.0 * t) * np.exp(-((t - 2.5) ** 2)), device=dev)

    for wav in [jt.PaulWavelet(4), jt.DOGWavelet(2), jt.DOGWavelet(6), jt.MeyerWavelet(),
                jt.MexicanHatWavelet(1.0)]:
        lo, hi = wav.effective_support()
        blo, bhi = wav.bandwidth()
        tt = torch.as_tensor(np.linspace(lo, hi, 7), device=dev)
        vals = host(wav.psi(tt))
        res = jt.cwt(sig, jt.generate_log_scales(0.01, 1.0, 16), wav, fs)
        peak = float(res.magnitude().max())
        print(f"{wav.name:<16} support=[{lo:6.2f},{hi:6.2f}] band=[{blo:.3f},{bhi:.3f}] Hz "
              f"fc={wav.center_frequency:.3f} |psi(0)|={abs(vals[3]):.3f} cwt_peak={peak:.3f}")


if __name__ == "__main__":
    run(main)
