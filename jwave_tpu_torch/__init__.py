"""jwave_tpu_torch — the jwave_tpu wavelet engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

Same public names, argument contracts and output layouts as ``jwave_tpu``
for the parts ported so far: the 67 filter banks, the FWT (1D, 2D, 3D), the
MODWT forward/inverse, the FFT/DFT, the continuous layer (six mother
wavelets, CWT, synchrosqueezed CWT with its inverse and ridges), and the
``Transform``/``TransformBuilder`` facade for all of them. On CUDA tensors
the MODWT runs the cascade kernels K1/K2, the FWT the pyramid kernels K3/K4
and their inverse K5, and the synchrosqueezing reassignment K6
(``jwave_tpu_torch.ops``); they build with ``nvcc`` at first use. Importing
the package builds nothing.
"""

__version__ = "0.1.0"

from . import config
from .api import (
    BasicTransform,
    ContinuousWaveletTransform,
    DiscreteFourierTransform,
    FastFourierTransform,
    FastWaveletTransform,
    MODWTTransform,
    Transform,
    TransformBuilder,
    WaveletTransform,
)
from .cwavelets import (
    DOGWavelet,
    MexicanHatWavelet,
    MeyerWavelet,
    MorletWavelet,
    MorseWavelet,
    PaulWavelet,
    get_continuous_wavelet,
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
    CWTResult,
    PaddingType,
    SSQResult,
    cwt,
    cwt_chunked,
    cwt_direct,
    extract_ridge,
    fft,
    generate_linear_scales,
    generate_log_scales,
    icwt,
    ifft,
    issq_cwt,
    ridge_tube_mask,
    ssq_cwt,
    wavelet_coherence,
    xwt,
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
    "FastWaveletTransform", "MODWTTransform", "DiscreteFourierTransform",
    "FastFourierTransform", "ContinuousWaveletTransform",
    "MorletWavelet", "MexicanHatWavelet", "PaulWavelet", "DOGWavelet",
    "MeyerWavelet", "MorseWavelet", "get_continuous_wavelet",
    "FilterBank", "get_filter", "available_filters", "junit_passing_filters",
    "bank_from_arrays",
    "fwt", "fwt2d", "ifwt2d", "ifwt", "fwt_max_level", "fwt_decompose",
    "fwt_recompose", "fwt_split", "fwt_merge",
    "modwt", "imodwt", "modwt_1d", "imodwt_1d", "ConvolutionMethod",
    "cwt", "cwt_chunked", "cwt_direct", "icwt", "xwt",
    "wavelet_coherence", "CWTResult", "PaddingType",
    "ssq_cwt", "issq_cwt", "SSQResult", "extract_ridge", "ridge_tube_mask",
    "generate_log_scales", "generate_linear_scales",
    "fft", "ifft",
    "JWaveException", "JWaveError", "JWaveFailure", "JWaveNotAllocated",
    "JWaveNotFound", "JWaveNotImplemented", "JWaveNotKnown", "JWaveNotValid",
]
