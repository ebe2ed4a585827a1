"""Torch primitives (butterfly, circular convolutions) and the hand-written
CUDA kernels K1-K6 with their plain versions. Importing this package builds
no kernel."""
from .butterfly import butterfly_forward, butterfly_reverse, ensure_float
from .circular import (
    circular_conv,
    circular_conv_adjoint,
    circular_conv_adjoint_fft,
    circular_conv_fft,
    filter_spectrum,
    wrap_filter,
)

__all__ = [
    "butterfly_forward", "butterfly_reverse", "ensure_float",
    "circular_conv", "circular_conv_adjoint", "circular_conv_fft",
    "circular_conv_adjoint_fft", "filter_spectrum", "wrap_filter",
]
