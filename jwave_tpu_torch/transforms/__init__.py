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
from .modwt import (
    DEFAULT_FFT_THRESHOLD,
    MAX_DECOMPOSITION_LEVEL,
    ConvolutionMethod,
    imodwt,
    imodwt_1d,
    modwt,
    modwt_1d,
)
from .ndim import forward_2d, forward_3d, reverse_2d, reverse_3d
from .ssq import (
    SSQResult,
    extract_ridge,
    issq_cwt,
    one_integral_constant,
    ridge_tube_mask,
    ssq_cwt,
)

__all__ = [
    "fwt", "ifwt", "fwt2d", "ifwt2d", "fwt_decompose", "fwt_recompose",
    "fwt_split", "fwt_merge", "fwt_max_level",
    "ConvolutionMethod", "DEFAULT_FFT_THRESHOLD", "MAX_DECOMPOSITION_LEVEL",
    "modwt", "imodwt", "modwt_1d", "imodwt_1d",
    "forward_2d", "reverse_2d", "forward_3d", "reverse_3d",
    "fft", "ifft", "fft_interleaved", "ifft_interleaved", "bluestein_fft",
    "dft", "idft", "dft_interleaved", "idft_interleaved",
    "cwt", "cwt_chunked", "cwt_direct", "icwt", "xwt", "wavelet_coherence",
    "CWTResult", "PaddingType", "generate_log_scales", "generate_linear_scales",
    "ssq_cwt", "issq_cwt", "SSQResult", "extract_ridge", "ridge_tube_mask",
    "one_integral_constant",
]
