"""Image pipeline on the 2D pyramid: transform -> threshold -> reconstruct,
with the precision dial (the JAX package's
``examples/image_pipeline_example.py``, whose code runs at module level;
here it is :func:`main`). A float32 image on the card runs ``fwt2d`` as
two K4 passes and ``ifwt2d`` as two K5 passes."""
import numpy as np
import torch

import jwave_tpu_torch as jt
from jwave_tpu_torch import config
from ._common import run


def main(device=None):
    dev = torch.device(device or "cuda")
    rng = np.random.default_rng(0)

    # a synthetic "image": smooth ramps + a few sharp edges + noise
    n = 512
    yy, xx = np.mgrid[0:n, 0:n] / n
    img = np.sin(3 * np.pi * xx) * np.cos(2 * np.pi * yy)
    img += (xx > 0.5) * 0.8 + (yy > 0.7) * 0.5
    img += 0.05 * rng.standard_normal((n, n))
    img = torch.as_tensor(img, dtype=torch.float32, device=dev)

    levels = 5
    coeffs = jt.fwt2d(img, "db4", levels, levels)

    # keep the strongest 5% of coefficients (sparse compression)
    flat = torch.abs(coeffs).ravel()
    thresh = torch.quantile(flat, 0.95)
    kept = torch.where(torch.abs(coeffs) >= thresh, coeffs, 0.0)
    recon = jt.ifwt2d(kept, "db4", levels, levels)

    mse_full = float(torch.mean((jt.ifwt2d(coeffs, "db4", levels, levels) - img) ** 2))
    mse_5pct = float(torch.mean((recon - img) ** 2))
    energy = float(torch.sum(img**2) / img.numel())
    print(f"roundtrip MSE (all coefficients): {mse_full:.3e}")
    print(f"5%-coefficient reconstruction MSE: {mse_5pct:.3e} "
          f"({100 * mse_5pct / energy:.2f}% of signal energy)")

    # the precision dial: trade exactness for throughput on the same call
    for dial in ("highest", "default"):
        config.set_conv_precision(dial)
        r = jt.ifwt2d(jt.fwt2d(img, "db4", levels, levels), "db4", levels, levels)
        err = float(torch.max(torch.abs(r - img)))
        print(f"precision='{dial}': roundtrip max |err| = {err:.2e}")
    config.set_conv_precision("highest")


if __name__ == "__main__":
    run(main)
