"""Where the port's inputs and host-side parameters come from and go to:
tensors stay where they lie, anything else lands on the card unless the
caller names a device, and the parameters the JAX package reads with numpy
come back to the host. A copy from host memory to a card counts as an
upload (``utils.profiling.counts()``)."""
from __future__ import annotations

import numpy as np
import torch

from .profiling import count_upload


def as_tensor(x, device=None) -> torch.Tensor:
    """A tensor stays where it lies; anything else becomes a tensor on
    ``device``, the card ("cuda") unless one is given. A caller asks for the
    CPU with a CPU tensor or ``device="cpu"``."""
    if isinstance(x, torch.Tensor):
        return x
    return count_upload(torch.as_tensor(np.asarray(x), device=device or "cuda"))


def host_array(a, dtype=None) -> np.ndarray:
    """``a`` as a numpy array on the host, as ``np.asarray`` gives a JAX
    array: a tensor is copied back from wherever it lies (bf16 by way of
    float32, which numpy lacks). For the host-side parameters the JAX
    package reads with numpy (scales, frequencies, boundaries)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        a = (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a, dtype=dtype)


def copy_to_device(a, device=None) -> torch.Tensor:
    """A copy of ``a`` (numpy, possibly read-only, e.g. a JAX package
    result's ``np.asarray``) as a tensor on ``device``, the card ("cuda")
    unless one is given: what the ``from_numpy`` constructors carry across."""
    return count_upload(torch.tensor(np.asarray(a), device=device or "cuda"))
