from .aed import aed_forward, aed_reverse
from .analytic import analytic_signal, envelope, instantaneous_frequency
from .cwt import (
    CWTResult,
    PaddingType,
    cwt,
    cwt_chunked,
    cwt_direct,
    generate_linear_scales,
    generate_log_scales,
    icwt,
    wavelet_coherence,
    xwt,
)
from .dtcwt import DTCWT2DResult, DTCWTResult, dtcwt, dtcwt2d, idtcwt, idtcwt2d
from .ewt import EWTResult, ewt, ewt_boundaries, ewt_filter_bank, iewt
from .fft import (
    bluestein_fft,
    dft,
    dft_interleaved,
    fft,
    fft_interleaved,
    idft,
    idft_interleaved,
    ifft,
    ifft_interleaved,
)
from .fwt import (
    fwt,
    fwt2d,
    fwt_decompose,
    fwt_max_level,
    fwt_merge,
    fwt_recompose,
    fwt_split,
    ifwt,
    ifwt2d,
)
from .lifting import (
    LiftingScheme,
    get_scheme,
    lifting_dwt,
    lifting_fwt,
    lifting_idwt,
    lifting_ifwt,
    lifting_schemes,
)
from .modwt import (
    DEFAULT_FFT_THRESHOLD,
    MAX_DECOMPOSITION_LEVEL,
    ConvolutionMethod,
    hurst_exponent,
    imodwt,
    imodwt_1d,
    imodwt_2d,
    modwt,
    modwt_1d,
    modwt_2d,
    modwt_correlation,
    modwt_covariance,
    modwt_mra,
    modwt_mra_2d,
    modwt_variance,
    modwt_variance_ci,
    wavelet_log_spectrum,
)
from .ndim import forward_2d, forward_3d, reverse_2d, reverse_3d
from .pursuit import GaborDictionary, MPResult, gabor_dictionary, matching_pursuit
from .shifting import shifting_forward, shifting_reverse
from .sliding import SlidingMODWT, SlidingState, sliding_modwt_init, sliding_modwt_update
from .ssq import (
    SSQResult,
    extract_ridge,
    issq_cwt,
    one_integral_constant,
    ridge_tube_mask,
    ssq_cwt,
)
from .superlet import superlet
from .vmd import VMDResult, vmd
from .wpt import (
    BestBasis,
    BestBasis2D,
    best_basis,
    best_basis_2d,
    best_basis_2d_reconstruct,
    best_basis_reconstruct,
    iwpt,
    wpt,
    wpt_interleaved_to_subband,
    wpt_subband_to_interleaved,
)
from .wvd import wigner_ville

__all__ = [
    "fwt", "ifwt", "fwt2d", "ifwt2d", "fwt_decompose", "fwt_recompose",
    "fwt_split", "fwt_merge", "fwt_max_level",
    "wpt", "iwpt", "wpt_interleaved_to_subband", "wpt_subband_to_interleaved",
    "BestBasis", "best_basis", "best_basis_reconstruct",
    "BestBasis2D", "best_basis_2d", "best_basis_2d_reconstruct",
    "ConvolutionMethod", "DEFAULT_FFT_THRESHOLD", "MAX_DECOMPOSITION_LEVEL",
    "modwt", "imodwt", "modwt_1d", "imodwt_1d", "modwt_2d", "imodwt_2d",
    "modwt_mra", "modwt_mra_2d", "modwt_variance", "modwt_variance_ci",
    "modwt_covariance", "modwt_correlation", "wavelet_log_spectrum", "hurst_exponent",
    "SlidingState", "SlidingMODWT", "sliding_modwt_init", "sliding_modwt_update",
    "forward_2d", "reverse_2d", "forward_3d", "reverse_3d",
    "fft", "ifft", "fft_interleaved", "ifft_interleaved", "bluestein_fft",
    "dft", "idft", "dft_interleaved", "idft_interleaved",
    "cwt", "cwt_chunked", "cwt_direct", "icwt", "xwt", "wavelet_coherence",
    "CWTResult", "PaddingType", "generate_log_scales", "generate_linear_scales",
    "ssq_cwt", "issq_cwt", "SSQResult", "extract_ridge", "ridge_tube_mask",
    "one_integral_constant",
    "analytic_signal", "envelope", "instantaneous_frequency", "superlet",
    "EWTResult", "ewt", "iewt", "ewt_boundaries", "ewt_filter_bank", "wigner_ville",
    "VMDResult", "vmd", "GaborDictionary", "MPResult", "gabor_dictionary", "matching_pursuit",
    "dtcwt", "idtcwt", "dtcwt2d", "idtcwt2d", "DTCWTResult", "DTCWT2DResult",
    "LiftingScheme", "get_scheme", "lifting_schemes",
    "lifting_dwt", "lifting_idwt", "lifting_fwt", "lifting_ifwt",
    "aed_forward", "aed_reverse", "shifting_forward", "shifting_reverse",
]
