"""MODWT multi-resolution analysis and denoising (the JAX package's
``examples/modwt_example.py``, after the reference's MODWTExample.java):
decompose a noisy signal, inspect per-level energies, zero the finest
detail levels, and reconstruct."""
import numpy as np
import torch

import jwave_tpu_torch as jt
from ._common import host, run


def main(device=None):
    dev = torch.device(device or "cuda")
    rng = np.random.default_rng(7)
    n = 777  # arbitrary length: the MODWT needs no power of two
    t = np.linspace(0, 4 * np.pi, n)
    clean = np.sin(t) + 0.5 * np.sin(5 * t)
    noisy = clean + 0.35 * rng.standard_normal(n)
    noisy_t = torch.as_tensor(noisy, device=dev)

    m = jt.MODWTTransform("Daubechies 4", device=dev)
    level = 5
    coeffs = host(m.forward_modwt(noisy_t, level)).copy()  # (J+1, N): [W_1..W_J, V_J]

    print(f"MODWT db4, {level} levels on N={n}")
    for j in range(level):
        print(f"  W_{j+1} energy: {np.sum(coeffs[j]**2):8.2f}")
    print(f"  V_{level} energy: {np.sum(coeffs[level]**2):8.2f}")

    # denoise: zero the two finest detail levels
    coeffs[0] = 0.0
    coeffs[1] = 0.0
    denoised = host(m.inverse_modwt(torch.as_tensor(coeffs, device=dev)))
    print(f"noisy  MSE vs clean: {np.mean((noisy - clean) ** 2):.4f}")
    print(f"denoise MSE vs clean: {np.mean((denoised - clean) ** 2):.4f}")

    # perfect reconstruction check
    full = m.forward_modwt(noisy_t, level)
    rec = host(m.inverse_modwt(full))
    print(f"perfect reconstruction error: {np.max(np.abs(rec - noisy)):.2e}")


if __name__ == "__main__":
    run(main)
