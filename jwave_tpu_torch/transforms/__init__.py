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

__all__ = [
    "fwt", "ifwt", "fwt2d", "ifwt2d", "fwt_decompose", "fwt_recompose",
    "fwt_split", "fwt_merge", "fwt_max_level",
    "ConvolutionMethod", "DEFAULT_FFT_THRESHOLD", "MAX_DECOMPOSITION_LEVEL",
    "modwt", "imodwt", "modwt_1d", "imodwt_1d",
    "forward_2d", "reverse_2d", "forward_3d", "reverse_3d",
]
