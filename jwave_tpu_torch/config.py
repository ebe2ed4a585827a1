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

The JAX package's other dials are here under the same names, so that code
written for it runs on the port: :func:`enable_x64` sets the float dtype that
integer and bool input promotes to; :func:`set_mxu_dft` and
:func:`set_mxu_butterfly` keep and validate their mode but select nothing,
since the port has one formulation of each path.
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


#: the float dtype of integer and bool input: None follows torch's default
#: dtype (float32 unless the caller changed it) until :func:`enable_x64`
_X64: bool | None = None


def enable_x64(enabled: bool = True):
    """JAX's float64 switch, for input that is not floating point: when on,
    integer and bool input promotes to float64, otherwise to float32.
    Floating-point input keeps its dtype either way, as in torch."""
    global _X64
    _X64 = bool(enabled)


def default_real_dtype() -> torch.dtype:
    """The float dtype integer and bool input promotes to."""
    if _X64 is None:
        return torch.get_default_dtype()
    return torch.float64 if _X64 else torch.float32


def default_complex_dtype() -> torch.dtype:
    return torch.complex128 if default_real_dtype() == torch.float64 else torch.complex64


_MODES = ("auto", "on", "off")
_MXU_DFT = "auto"


def set_mxu_dft(mode: str):
    """JAX's switch between dense MXU matmuls and the FFT for small DFTs:
    'auto' (the default), 'on' or 'off'. The port keeps and validates the
    mode but has one formulation, cuFFT, so the mode selects nothing."""
    global _MXU_DFT
    if mode not in _MODES:
        raise ValueError(f"unknown mxu_dft mode {mode!r}")
    _MXU_DFT = mode


def mxu_dft() -> str:
    return _MXU_DFT


_MXU_BUTTERFLY = "auto"


def set_mxu_butterfly(mode: str):
    """JAX's switch between MXU tile matmuls and convolutions for the FWT/WPT
    butterfly: 'auto' (the default), 'on' or 'off'. The port keeps and
    validates the mode but has one formulation of each path (the pyramid
    kernels, or cuDNN's convolutions), so the mode selects nothing; the plain
    butterfly route is called directly where it is wanted."""
    global _MXU_BUTTERFLY
    if mode not in _MODES:
        raise ValueError(f"unknown mxu_butterfly mode {mode!r}")
    _MXU_BUTTERFLY = mode


def mxu_butterfly() -> str:
    return _MXU_BUTTERFLY
