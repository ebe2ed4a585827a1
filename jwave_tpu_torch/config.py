"""Precision policy and dtype helpers.

The reference computes in Java ``double``; the JAX package's default is true
float32 for every matmul and convolution (``highest``). On an NVIDIA card a
float32 ``conv1d`` goes through cuDNN, and torch's own default lets cuDNN
compute it in TF32, which keeps about three decimal digits. So the package
keeps its own dial, ``"highest"`` by default as in the JAX package, and runs
every convolution and matmul of its own inside :func:`dial`, which sets
torch's TF32 switches from the dial for the call and restores them after.
Importing the package changes none of torch's switches. The hand-written
kernels always accumulate in float32 and ignore the dial.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

# the dial -> torch.set_float32_matmul_precision's name for cuBLAS
_MATMUL_PRECISION = {"highest": "highest", "high": "high", "default": "medium"}

_CONV_PRECISION = "highest"


def set_conv_precision(name: str):
    """'highest' (true float32: TF32 off for cuDNN and cuBLAS, the default),
    'high' or 'default' (TF32 allowed; matmul precision 'high' or 'medium').
    Sets the package's dial; torch's switches change only inside its calls."""
    global _CONV_PRECISION
    if name not in _MATMUL_PRECISION:
        raise ValueError(f"unknown precision {name!r}")
    _CONV_PRECISION = name


def conv_precision() -> str:
    """The package's dial: 'highest', 'high' or 'default'."""
    return _CONV_PRECISION


@contextmanager
def dial():
    """Run the enclosed torch convolutions and matmuls under the dial.

    Sets ``torch.backends.cudnn.allow_tf32`` (which in torch 2.9 and later
    also sets ``cudnn.conv.fp32_precision``, the switch cuDNN's convolutions
    read) and the float32 matmul precision (which sets
    ``torch.backends.cuda.matmul.allow_tf32``) where they differ from the
    dial, and restores them afterwards."""
    cudnn = torch.backends.cudnn
    tf32, mm = _CONV_PRECISION != "highest", _MATMUL_PRECISION[_CONV_PRECISION]
    old_tf32, old_mm = cudnn.allow_tf32, torch.get_float32_matmul_precision()
    if old_tf32 != tf32:
        cudnn.allow_tf32 = tf32
    if old_mm != mm:
        torch.set_float32_matmul_precision(mm)
    try:
        yield
    finally:
        if old_tf32 != tf32:
            cudnn.allow_tf32 = old_tf32
        if old_mm != mm:
            torch.set_float32_matmul_precision(old_mm)


def default_real_dtype() -> torch.dtype:
    return torch.get_default_dtype()


def default_complex_dtype() -> torch.dtype:
    return torch.complex128 if torch.get_default_dtype() == torch.float64 else torch.complex64
