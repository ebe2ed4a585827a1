"""CWT scalogram of a two-tone signal with the Morlet wavelet: identify the
two oscillation frequencies from the scalogram's ridge scales (the JAX
package's ``examples/cwt_example.py``, after the reference's
CWTExample.java)."""
import numpy as np
import torch

import jwave_tpu_torch as jt
from ._common import host, run


def _two_tones(dev):
    fs = 1000.0
    n = 4096
    t = np.arange(n) / fs
    sig = np.sin(2 * np.pi * 25.0 * t) + 0.7 * np.sin(2 * np.pi * 120.0 * t)
    return fs, sig, torch.as_tensor(sig, device=dev)


def main(device=None):
    fs, _, sig = _two_tones(torch.device(device or "cuda"))
    wav = jt.MorletWavelet(1.0, 1.0)
    scales = jt.generate_log_scales(1e-3, 0.2, 96)
    res = jt.cwt(sig, scales, wav, fs)

    sca = host(res.scalogram())
    # two ridges: scale a = fc / f
    order = np.argsort(sca)[::-1]
    found = []
    for idx in order:
        f = wav.center_frequency / scales[idx]
        if all(abs(f - g) > 10 for g in found):
            found.append(f)
        if len(found) == 2:
            break
    mag = res.magnitude()
    print(f"scalogram shape: {tuple(res.coefficients.shape)}")
    print(f"detected frequencies: {sorted(round(f, 1) for f in found)} Hz (true: [25, 120])")
    print(f"magnitude range: [{float(mag.min()):.3f}, {float(mag.max()):.3f}]")


def inverse_demo(device=None):
    """Round trip: the scalogram back to the signal."""
    fs, sig_np, sig = _two_tones(torch.device(device or "cuda"))
    wav = jt.MorletWavelet(1.0, 1.0)
    scales = jt.generate_log_scales(1e-3, 0.2, 96)
    res = jt.cwt(sig, scales, wav, fs, jt.PaddingType.PERIODIC)
    rec = host(jt.icwt(res, wav))
    print(f"icwt reconstruction max error: {np.max(np.abs(rec - sig_np)):.2e}")


if __name__ == "__main__":
    run(main, inverse_demo)
