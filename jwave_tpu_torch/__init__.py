"""jwave_tpu_torch — the jwave_tpu wavelet engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

Same public names, argument contracts and output layouts as ``jwave_tpu``
for the parts ported so far: the 67 filter banks, the FWT (1D, 2D, 3D) and
the MODWT forward/inverse, and the ``Transform``/``TransformBuilder`` facade
for both. On CUDA tensors the MODWT runs the cascade kernels K1/K2 and the
FWT the pyramid kernels K3/K4 (``jwave_tpu_torch.ops``); they build with
``nvcc`` at first use. Importing the package builds nothing.
"""

__version__ = "0.1.0"

from . import config
from .api import (
    BasicTransform,
    FastWaveletTransform,
    MODWTTransform,
    Transform,
    TransformBuilder,
    WaveletTransform,
)
from .exceptions import (
    JWaveError,
    JWaveException,
    JWaveFailure,
    JWaveNotAllocated,
    JWaveNotFound,
    JWaveNotImplemented,
    JWaveNotKnown,
    JWaveNotValid,
)
from .filters import (
    FilterBank,
    available_filters,
    bank_from_arrays,
    get_filter,
    junit_passing_filters,
)
from .transforms import (
    ConvolutionMethod,
    fwt,
    fwt2d,
    fwt_decompose,
    fwt_max_level,
    fwt_merge,
    fwt_recompose,
    fwt_split,
    ifwt,
    ifwt2d,
    imodwt,
    imodwt_1d,
    modwt,
    modwt_1d,
)

__all__ = [
    "config",
    "Transform", "TransformBuilder", "BasicTransform", "WaveletTransform",
    "FastWaveletTransform", "MODWTTransform",
    "FilterBank", "get_filter", "available_filters", "junit_passing_filters",
    "bank_from_arrays",
    "fwt", "fwt2d", "ifwt2d", "ifwt", "fwt_max_level", "fwt_decompose",
    "fwt_recompose", "fwt_split", "fwt_merge",
    "modwt", "imodwt", "modwt_1d", "imodwt_1d", "ConvolutionMethod",
    "JWaveException", "JWaveError", "JWaveFailure", "JWaveNotAllocated",
    "JWaveNotFound", "JWaveNotImplemented", "JWaveNotKnown", "JWaveNotValid",
]
