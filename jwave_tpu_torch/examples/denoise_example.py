"""Wavelet shrinkage denoising: universal vs SureShrink vs BayesShrink
(the JAX package's ``examples/denoise_example.py``): MODWT decompose ->
per-band threshold -> reconstruct, shift-invariant and batched, in 1D and
on an image."""
import numpy as np
import torch

from jwave_tpu_torch.denoise import denoise, denoise_2d
from ._common import host, run


def main(device=None):
    dev = torch.device(device or "cuda")
    rng = np.random.default_rng(0)
    n = 4096
    t = np.arange(n) / n

    # piecewise signal with sharp edges (where adaptive thresholds shine)
    clean = np.sign(np.sin(2 * np.pi * 20 * t)) + np.sin(2 * np.pi * 5 * t)
    noisy = clean + 0.4 * rng.standard_normal(n)
    print(f"noisy MSE: {np.mean((noisy - clean) ** 2):.4f}")

    for method in ("universal", "sure", "bayes"):
        for mode in ("soft", "hard"):
            out = host(denoise(torch.as_tensor(noisy, device=dev), "sym8", 5,
                               mode=mode, method=method))
            mse = np.mean((out - clean) ** 2)
            print(f"  {method:9s}/{mode:4s}: MSE {mse:.4f}")

    # batched: denoise 8 channels at once
    batch = clean + 0.4 * rng.standard_normal((8, n))
    out = host(denoise(torch.as_tensor(batch, device=dev), "sym8", 5, method="bayes"))
    print(f"batched (8, {n}) -> {out.shape}, "
          f"mean MSE {np.mean((out - clean) ** 2):.4f}")

    # 2D: shift-invariant image denoising over the separable MODWT grid
    m = 128
    yy, xx = np.mgrid[0:m, 0:m] / m
    img = np.sin(4 * np.pi * xx) * np.cos(2 * np.pi * yy) + (xx > 0.5)
    noisy_img = img + 0.3 * rng.standard_normal((m, m))
    den = host(denoise_2d(torch.as_tensor(noisy_img, device=dev), "db4", 3, method="sure"))
    print(f"2D image: noisy MSE {np.mean((noisy_img - img) ** 2):.4f} -> "
          f"denoised {np.mean((den - img) ** 2):.4f}")


if __name__ == "__main__":
    run(main)
