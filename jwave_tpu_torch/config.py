"""Precision policy and dtype helpers.

The reference computes in Java ``double``; the JAX package's default is true
float32 for every matmul and convolution (``highest``). On an NVIDIA card a
float32 ``conv1d`` goes through cuDNN in TF32 unless
``torch.backends.cudnn.allow_tf32`` is off, and TF32 keeps about three
decimal digits. ``set_conv_precision`` maps the JAX dial onto PyTorch's
switches; the settings live in torch itself, so this module keeps no state.
The hand-written kernels always accumulate in float32 and ignore the dial.
"""
from __future__ import annotations

import torch

_MATMUL_PRECISION = {"highest": "highest", "high": "high", "default": "medium"}


def set_conv_precision(name: str):
    """'highest' (true float32: TF32 off for cuDNN and cuBLAS), 'high' or
    'default' (TF32 allowed; matmul precision 'high' or 'medium')."""
    if name not in _MATMUL_PRECISION:
        raise ValueError(f"unknown precision {name!r}")
    tf32 = name != "highest"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision(_MATMUL_PRECISION[name])


def conv_precision() -> str:
    """The dial as torch's current switches give it."""
    mm = torch.get_float32_matmul_precision()
    if mm == "highest" and not torch.backends.cudnn.allow_tf32:
        return "highest"
    return "default" if mm == "medium" else "high"


def default_real_dtype() -> torch.dtype:
    return torch.get_default_dtype()


def default_complex_dtype() -> torch.dtype:
    return torch.complex128 if torch.get_default_dtype() == torch.float64 else torch.complex64
