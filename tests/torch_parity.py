"""Helpers for holding jwave_tpu_torch against jwave_tpu: the same numpy
input goes to both packages, and results are compared as numpy arrays."""
from __future__ import annotations

import numpy as np


def to_np(a) -> np.ndarray:
    """A torch tensor or a jax array as a float64/complex128 numpy array."""
    if hasattr(a, "detach"):
        import torch

        a = a.detach().cpu()
        return a.to(torch.complex128 if a.is_complex() else torch.float64).numpy()
    return np.asarray(a)


def assert_close(got, want, rtol: float, what: str = ""):
    """max|got - want| <= rtol * max(max|want|, 1): a scale-relative bound,
    absolute for data of order one."""
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
    scale = max(float(np.max(np.abs(w))) if w.size else 0.0, 1.0)
    err = float(np.max(np.abs(g - w))) if w.size else 0.0
    assert err <= rtol * scale, f"{what}: max|err| {err:.3e} > {rtol:.1e} * {scale:.3e}"
