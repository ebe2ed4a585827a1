"""JPEG2000-style image compression with the lifting-scheme CDF 9/7 FWT
(the JAX package's ``examples/lifting_compression_example.py``): separable
2D analysis, keep the largest k% of coefficients, exact lifting synthesis,
PSNR."""
import numpy as np
import torch

import jwave_tpu_torch as jt
from jwave_tpu_torch.transforms.ndim import forward_2d, reverse_2d
from ._common import host, run


def synthetic_image(n=256):
    """Smooth background + sharp edges + texture (no image files needed)."""
    y, x = np.mgrid[0:n, 0:n] / n
    img = np.sin(3 * np.pi * x) * np.cos(2 * np.pi * y)          # smooth
    img += (np.abs(x - 0.5) < 0.18) * (np.abs(y - 0.45) < 0.3)   # box edge
    img += 0.15 * np.sin(40 * np.pi * x * y)                     # texture
    return img.astype(np.float64)


def psnr(ref, out):
    mse = np.mean((ref - out) ** 2)
    peak = ref.max() - ref.min()
    return 10 * np.log10(peak**2 / mse) if mse > 0 else np.inf


def main(device=None):
    dev = torch.device(device or "cuda")
    img = synthetic_image(256)

    def fwd(v, level):
        return jt.lifting_fwt(v, "CDF 9/7", level)

    def inv(v, level):
        return jt.lifting_ifwt(v, "CDF 9/7", level)

    coeffs = forward_2d(fwd, torch.as_tensor(img, device=dev), 5, 5)
    flat = np.abs(host(coeffs)).ravel()

    print("CDF 9/7 lifting, 5-level separable 2D, 256x256:")
    for keep in (0.20, 0.10, 0.05, 0.02):
        # keep the largest `keep` fraction of coefficients by magnitude
        tau = np.partition(flat, int((1 - keep) * flat.size))[int((1 - keep) * flat.size)]
        kept = torch.where(torch.abs(coeffs) >= float(tau), coeffs, 0.0)
        rec = host(reverse_2d(inv, kept, 5, 5))
        nnz = int(torch.count_nonzero(kept))
        print(f"  keep {keep:4.0%} ({nnz:6d} coeffs): PSNR {psnr(img, rec):6.2f} dB")

    # exactness check: no thresholding -> perfect reconstruction
    rec_full = host(reverse_2d(inv, coeffs, 5, 5))
    print(f"  keep 100%: max reconstruction error {np.max(np.abs(rec_full - img)):.2e}")


if __name__ == "__main__":
    run(main)
