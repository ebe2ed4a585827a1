"""jwave_tpu_torch — the jwave_tpu wavelet engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

Same public names, argument contracts and output layouts as ``jwave_tpu``
for the parts ported so far: the 67 filter banks, the FWT (1D, 2D, 3D), the
MODWT with its analysis layer (2D MODWT, multiresolution analyses, wavelet
variance/covariance/correlation, logscale diagram and Hurst estimator,
denoising, the sliding MODWT), the FFT/DFT, the continuous layer (six
mother wavelets, CWT, synchrosqueezed CWT with its inverse and ridges,
analytic signal, superlets, EWT, Wigner-Ville, VMD, matching pursuit), and
the ``Transform``/``TransformBuilder`` facade. On CUDA tensors the MODWT
runs the cascade kernels K1/K2, the FWT the pyramid kernels K3/K4 and their
inverse K5, and the synchrosqueezing reassignment K6
(``jwave_tpu_torch.ops``); gradients flow through all of them. They build
with ``nvcc`` at first use; importing the package builds nothing.
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
from .denoise import (
    bayes_threshold,
    denoise,
    denoise_2d,
    hard_threshold,
    mad_sigma,
    soft_threshold,
    sure_threshold,
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
    modwt_2d,
    imodwt_2d,
    modwt_mra,
    modwt_mra_2d,
    modwt_variance,
    modwt_variance_ci,
    modwt_covariance,
    modwt_correlation,
    wavelet_log_spectrum,
    hurst_exponent,
    SlidingMODWT,
    SlidingState,
    sliding_modwt_init,
    sliding_modwt_update,
    analytic_signal,
    envelope,
    instantaneous_frequency,
    superlet,
    EWTResult,
    ewt,
    ewt_boundaries,
    ewt_filter_bank,
    iewt,
    wigner_ville,
    VMDResult,
    vmd,
    GaborDictionary,
    MPResult,
    gabor_dictionary,
    matching_pursuit,
)
from .utils.select import median_abs

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
    "modwt_2d", "imodwt_2d", "modwt_mra", "modwt_mra_2d", "modwt_variance",
    "modwt_variance_ci", "modwt_covariance", "modwt_correlation",
    "wavelet_log_spectrum", "hurst_exponent",
    "SlidingMODWT", "SlidingState", "sliding_modwt_init", "sliding_modwt_update",
    "denoise", "denoise_2d", "soft_threshold", "hard_threshold", "mad_sigma",
    "sure_threshold", "bayes_threshold", "median_abs",
    "analytic_signal", "envelope", "instantaneous_frequency", "superlet",
    "EWTResult", "ewt", "iewt", "ewt_boundaries", "ewt_filter_bank", "wigner_ville",
    "VMDResult", "vmd", "GaborDictionary", "MPResult", "gabor_dictionary",
    "matching_pursuit",
    "cwt", "cwt_chunked", "cwt_direct", "icwt", "xwt",
    "wavelet_coherence", "CWTResult", "PaddingType",
    "ssq_cwt", "issq_cwt", "SSQResult", "extract_ridge", "ridge_tube_mask",
    "generate_log_scales", "generate_linear_scales",
    "fft", "ifft",
    "JWaveException", "JWaveError", "JWaveFailure", "JWaveNotAllocated",
    "JWaveNotFound", "JWaveNotImplemented", "JWaveNotKnown", "JWaveNotValid",
]
