"""Torch primitives (butterfly, circular convolutions) and the hand-written
CUDA kernels K1-K9 with their plain versions. Importing this package builds
no kernel."""
from . import cuda_modwt, cuda_pyramid, cuda_reassign, cuda_wpt
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
    """Set every kernel's launch count to 0."""
    for mod in (cuda_modwt, cuda_pyramid, cuda_reassign, cuda_wpt):
        mod.reset_launch_counts()


def launch_counts() -> dict:
    """Launches of K1-K9 since the last :func:`reset_launch_counts`; of K6's,
    those of its fused form (``K6.fused``); and of the peak kernel that the
    fused form's default threshold runs first (``K6.peak``)."""
    return {"K1": cuda_modwt.launch_counts["modwt_cascade"],
            "K2": cuda_modwt.launch_counts["imodwt_cascade"],
            "K3": cuda_pyramid.launch_counts["pyramid_rows"],
            "K4": cuda_pyramid.launch_counts["pyramid_rows_transposed"],
            "K5": cuda_pyramid.launch_counts["ipyramid_rows_transposed"],
            "K6": cuda_reassign.launch_counts["reassign"],
            "K7": cuda_pyramid.launch_counts["ipyramid_rows"],
            "K8": cuda_wpt.launch_counts["wpt_rows"],
            "K9": cuda_wpt.launch_counts["iwpt_rows"],
            "K6.fused": cuda_reassign.fused_launches,
            "K6.peak": cuda_reassign.peak_launches}
