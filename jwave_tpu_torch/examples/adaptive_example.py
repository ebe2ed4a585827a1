"""Adaptive analysis tour: scattering features, VMD, matching pursuit,
Hurst estimation (the JAX package's ``examples/adaptive_example.py``).

Classify-ready scattering features of an AM signal, blind mode separation
with learned center frequencies, a sparse Gabor decomposition with exact
energy bookkeeping, and wavelet-domain long-memory estimation.
"""
import numpy as np
import torch

import jwave_tpu_torch as jt
from ._common import host, run


def main(device=None):
    dev = torch.device(device or "cuda")
    fs = 1000.0
    n = 4096
    t = np.arange(n) / fs

    # --- scattering features -------------------------------------------
    # an AM tone: the carrier shows up at order 1, the 8 Hz modulation at
    # order 2
    am = (1 + 0.8 * np.cos(2 * np.pi * 8 * t)) * np.cos(2 * np.pi * 200 * t)
    sc = jt.scattering1d(torch.as_tensor(am, device=dev), J=9, Q=8, sampling_rate=fs)
    k = int(sc.S1.mean(dim=-1).argmax())
    mask = sc.paths[:, 0] == k
    f2 = sc.xi2[sc.paths[mask, 1]] * fs
    f_mod = f2[int(host(sc.S2.mean(dim=-1))[mask].argmax())]
    print(f"scattering: {sc.features().shape[0]} bands x {sc.S0.shape[-1]} frames; "
          f"carrier ~{sc.frequencies1[k]:.0f} Hz, modulation ~{f_mod:.1f} Hz")

    # --- variational mode decomposition --------------------------------
    x = (np.cos(2 * np.pi * 25 * t) + 0.7 * np.cos(2 * np.pi * 110 * t)
         + 0.4 * np.cos(2 * np.pi * 310 * t))
    res = jt.vmd(torch.as_tensor(x, device=dev), 3, alpha=2000.0, tau=0.5)
    print("vmd centers (Hz):", np.round(host(res.frequencies(fs)), 1),
          f"| reconstruction err {float(np.linalg.norm(host(res.modes.sum(-2)) - x)):.2e}")

    # --- matching pursuit ----------------------------------------------
    burst = np.exp(-((t - 1.5) ** 2) / (2 * 0.03**2)) * np.cos(2 * np.pi * 150 * (t - 1.5))
    y = burst + 0.3 * np.cos(2 * np.pi * 20 * t)
    mp = jt.matching_pursuit(torch.as_tensor(y, device=dev), n_atoms=12)
    e = host(mp.energies)
    captured = 100.0 * (1.0 - e[-1] / float(np.sum(y * y)))
    print(f"matching pursuit: first pick f={float(mp.atom_frequencies(fs)[0]):.0f} Hz "
          f"at t={float(mp.positions[0]) / fs:.2f}s; 12 picks capture {captured:.1f}% of energy")

    # --- Hurst exponent -------------------------------------------------
    rng = np.random.default_rng(0)
    wn = rng.standard_normal(1 << 14)
    walk = np.cumsum(wn)
    h_wn = float(jt.hurst_exponent(torch.as_tensor(wn, device=dev)))
    h_walk = float(jt.hurst_exponent(torch.as_tensor(walk, device=dev), kind="fbm"))
    print(f"hurst: white noise H={h_wn:.2f} (0.5), random walk H={h_walk:.2f} (0.5)")


if __name__ == "__main__":
    run(main)
