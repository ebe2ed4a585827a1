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
from .ndim import forward_2d, forward_3d, forward_complex, reverse_2d, reverse_3d, reverse_complex
from .pursuit import GaborDictionary, MPResult, gabor_dictionary, matching_pursuit
from .scattering import (
    Scattering2DResult,
    ScatteringResult,
    scattering1d,
    scattering2d,
    scattering_filter_bank,
    scattering_filter_bank_2d,
)
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

# the JAX package's list: the other names above are attributes, not exports
__all__ = [
    "fwt", "fwt2d", "ifwt", "ifwt2d", "fwt_max_level", "fwt_decompose", "fwt_recompose",
    "fwt_split", "fwt_merge",
    "wpt", "iwpt", "wpt_interleaved_to_subband", "wpt_subband_to_interleaved",
    "modwt", "imodwt", "modwt_1d", "imodwt_1d", "modwt_2d", "imodwt_2d", "ConvolutionMethod",
    "SlidingMODWT", "SlidingState", "sliding_modwt_init", "sliding_modwt_update",
    "cwt", "cwt_chunked", "cwt_direct", "icwt", "CWTResult", "generate_log_scales",
    "generate_linear_scales", "PaddingType",
    "scattering1d", "scattering_filter_bank", "ScatteringResult",
    "scattering2d", "scattering_filter_bank_2d", "Scattering2DResult",
    "vmd", "VMDResult",
    "matching_pursuit", "gabor_dictionary", "GaborDictionary", "MPResult",
    "dtcwt", "idtcwt", "dtcwt2d", "idtcwt2d", "DTCWTResult", "DTCWT2DResult",
    "superlet",
    "analytic_signal", "envelope", "instantaneous_frequency",
    "ewt", "iewt", "ewt_boundaries", "ewt_filter_bank", "EWTResult",
    "wigner_ville",
    "LiftingScheme", "get_scheme", "lifting_schemes",
    "lifting_dwt", "lifting_idwt", "lifting_fwt", "lifting_ifwt",
    "fft", "ifft", "dft", "idft", "fft_interleaved", "ifft_interleaved",
    "aed_forward", "aed_reverse",
    "shifting_forward", "shifting_reverse",
    "forward_2d", "reverse_2d", "forward_3d", "reverse_3d", "forward_complex", "reverse_complex",
]
