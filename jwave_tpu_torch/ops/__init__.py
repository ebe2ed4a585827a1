"""Torch primitives (butterfly, circular convolutions) and the hand-written
CUDA kernels K1-K9 with their plain versions. Importing this package builds
no kernel. Every launch goes through ``cuda_build.launch``, which counts it
in ``utils.profiling`` as ``launch.<K-name>``; :func:`launch_counts` reads
those counters back under the K-names."""
from ..utils.profiling import count, counts
from . import cuda_build, cuda_modwt, cuda_pyramid, cuda_reassign, cuda_wpt
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


def reset_launch_counts():
    """Set the launch counts of :func:`launch_counts` to 0; every other
    counter of ``utils.profiling`` keeps its value."""
    for k, v in launch_counts().items():
        count(f"launch.{k}", -v)


def launch_counts() -> dict:
    """Launches of K1-K9 since the last :func:`reset_launch_counts`; of K6's,
    those of its fused form (``K6.fused``); and of the peak kernel that the
    fused form's default threshold runs first (``K6.peak``): the counters
    ``launch.<K-name>`` of ``utils.profiling.counts()``."""
    now = counts()
    return {k: now[f"launch.{k}"] for k in cuda_build.KERNELS}
