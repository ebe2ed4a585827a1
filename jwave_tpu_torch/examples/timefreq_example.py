"""Time-frequency analysis tour: synchrosqueezing, ridges, MRA, wavelet
variance (the JAX package's ``examples/timefreq_example.py``): sharpen a
multi-component signal's scalogram with ``ssq_cwt``, reconstruct it from
the squeezed plane, split it into additive MODWT components, and estimate
per-scale wavelet variance."""
import numpy as np
import torch

import jwave_tpu_torch as jt
from ._common import host, run


def main(device=None):
    dev = torch.device(device or "cuda")
    fs = 1000.0
    n = 4096
    t = np.arange(n) / fs
    # a 40 Hz tone plus an upward chirp 80 -> 220 Hz
    chirp = np.cos(2 * np.pi * (80 * t + 140 / (2 * t[-1]) * t**2))
    x = np.cos(2 * np.pi * 40 * t) + 0.8 * chirp
    x_t = torch.as_tensor(x, device=dev)

    # --- synchrosqueezed CWT -------------------------------------------
    wav = jt.MorletWavelet(1.0, 1.0)
    scales = jt.generate_log_scales(0.002, 0.1, 96)  # 10..500 Hz
    res = jt.ssq_cwt(x_t, scales, wav, sampling_rate=fs)
    mid = n // 2
    freqs = host(res.frequencies)
    print(f"squeezed plane: {tuple(res.Tx.shape)}, bins {freqs[0]:.1f}"
          f"..{freqs[-1]:.1f} Hz")
    mag_mid = np.abs(host(res.Tx))[:, mid]
    print(f"dominant frequency at t={t[mid]:.2f}s: "
          f"{freqs[mag_mid.argmax()]:.1f} Hz (tone: 40 Hz)")
    above = freqs > 60
    print(f"chirp ridge at t={t[mid]:.2f}s: "
          f"{freqs[above][mag_mid[above].argmax()]:.1f} Hz "
          f"(true: {80 + 140 * t[mid] / t[-1]:.1f} Hz)")

    xr = host(jt.issq_cwt(res, wav))
    interior = slice(n // 8, -n // 8)
    print(f"issq_cwt reconstruction max interior error: "
          f"{np.abs(xr - x)[interior].max():.2e}")

    # --- ridge extraction + mode separation ----------------------------
    idx, rfreqs = jt.extract_ridge(res, n_ridges=2, tube_width=3)
    rf = host(rfreqs)
    order = 0 if np.median(rf[0][interior]) < np.median(rf[1][interior]) else 1
    print(f"ridge A ~{np.median(rf[order][interior]):.1f} Hz (tone), "
          f"ridge B sweeps {rf[1 - order][interior].min():.0f}"
          f"-{rf[1 - order][interior].max():.0f} Hz (chirp)")
    mode_tone = host(jt.issq_cwt(
        res, wav, band=jt.ridge_tube_mask(res, idx[order], tube_width=4)))
    err_tone = np.abs(mode_tone - np.cos(2 * np.pi * 40 * t))[interior].max()
    print(f"extracted 40 Hz mode, max interior error vs the pure tone: "
          f"{err_tone:.3f}")

    # --- MODWT multiresolution analysis --------------------------------
    mra = host(jt.modwt_mra(x_t, "db4", level=5))  # (6, n), sums to x
    print("MRA additivity error:", np.abs(mra.sum(axis=0) - x).max())
    energies = (mra**2).sum(axis=1)
    for j, e in enumerate(energies[:-1], start=1):
        print(f"  D{j} energy {e:9.2f}  (band ~{fs / 2**(j + 1):6.1f}"
              f"-{fs / 2**j:6.1f} Hz)")
    print(f"  S5 energy {energies[-1]:9.2f}")

    # --- wavelet variance on noise -------------------------------------
    rng = np.random.default_rng(0)
    noise = 2.0 * rng.standard_normal(2**15)
    v = host(jt.modwt_variance(torch.as_tensor(noise, device=dev), "db4", level=4))
    print("white-noise wavelet variance (theory sigma^2/2^j):")
    for j, vj in enumerate(v, start=1):
        print(f"  level {j}: {vj:.3f}  vs  {4.0 / 2**j:.3f}")


if __name__ == "__main__":
    run(main)
