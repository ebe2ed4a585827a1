"""User-facing facade: Transform + TransformBuilder (reference jwave/
Transform.java, TransformBuilder.java), with the JAX package's names and
contracts: the Fast Wavelet, Wavelet Packet, Shifting and Lifting Wavelet
Transforms, the MODWT, the Discrete and Fast Fourier Transforms, the
Continuous Wavelet Transform, and the Ancient Egyptian Decomposition around
any of the discrete ones.

Any leading axes of an input are batch axes. A tensor is computed on the
device where it lies; any other input (numpy, lists) becomes a tensor on the
facade's ``device``, the card ("cuda") unless one is given: a caller asks for
the CPU with CPU tensors or ``device="cpu"``. Errors raise.
"""
from __future__ import annotations

import torch

from .exceptions import JWaveFailure, JWaveNotKnown
from .filters import FilterBank, get_filter
from .cwavelets import get_continuous_wavelet
from .transforms import aed as _aed
from .transforms import ndim as _ndim
from .transforms import shifting as _shifting
from .transforms.cwt import CWTResult, PaddingType, cwt, cwt_direct
from .transforms.fft import (
    dft,
    dft_interleaved,
    fft,
    fft_interleaved,
    idft,
    idft_interleaved,
    ifft,
    ifft_interleaved,
)
from .transforms.fwt import decompose_row, fwt, fwt2d, fwt3d, fwt_decompose, fwt_recompose, \
    ifwt, ifwt2d, ifwt3d
from .transforms.lifting import LiftingScheme, get_scheme, lifting_fwt, lifting_ifwt
from .transforms.modwt import (
    DEFAULT_FFT_THRESHOLD,
    ConvolutionMethod,
    imodwt,
    imodwt_1d,
    imodwt_2d,
    modwt,
    modwt_1d,
    modwt_2d,
)
from .transforms.wpt import iwpt, iwpt2d, wpt, wpt2d
from .utils.host import as_tensor
from .utils.numerics import exponent_of_two
from .utils.profiling import spanned


class BasicTransform:
    """Base of all transform objects held by :class:`Transform`."""

    name = "Basic Transform"

    def __init__(self, device=None):
        self.device = torch.device(device if device is not None else "cuda")

    def _in(self, x) -> torch.Tensor:
        return as_tensor(x, self.device)

    # -- core 1D ops on the last axis; subclasses override ------------------
    def _forward_core(self, x, level=None):
        raise JWaveFailure(f"{self.name} - forward not implemented")

    def _reverse_core(self, y, level=None):
        raise JWaveFailure(f"{self.name} - reverse not implemented")

    def get_wavelet(self):
        return getattr(self, "wavelet", None)

    def forward(self, x, level=None):
        """1D forward along the last axis (batched over leading axes)."""
        x = self._in(x)
        if x.is_complex():
            return _ndim.forward_complex(self._forward_core, x, level)
        return self._forward_core(x, level)

    def reverse(self, y, level=None):
        """1D inverse along the last axis."""
        y = self._in(y)
        if y.is_complex():
            return _ndim.reverse_complex(self._reverse_core, y, level)
        return self._reverse_core(y, level)

    def forward_2d(self, mat, level_rows=None, level_cols=None):
        """Separable 2D forward (BasicTransform.java:336-399)."""
        return _ndim.forward_2d(self._forward_core, self._in(mat), level_rows, level_cols)

    def reverse_2d(self, mat, level_rows=None, level_cols=None):
        return _ndim.reverse_2d(self._reverse_core, self._in(mat), level_rows, level_cols)

    def forward_3d(self, spc, level_p=None, level_q=None, level_r=None):
        """Separable 3D forward (BasicTransform.java:487-566)."""
        return _ndim.forward_3d(self._forward_core, self._in(spc), level_p, level_q, level_r)

    def reverse_3d(self, spc, level_p=None, level_q=None, level_r=None):
        return _ndim.reverse_3d(self._reverse_core, self._in(spc), level_p, level_q, level_r)

    def decompose(self, x):
        raise JWaveFailure(f"{self.name} - decompose is not implemented for this transform type")

    def recompose(self, mat, level=None):
        raise JWaveFailure(f"{self.name} - recompose is not implemented for this transform type")


class WaveletTransform(BasicTransform):
    """Common base for wavelet transforms holding a filter bank."""

    def __init__(self, wavelet, device=None):
        super().__init__(device)
        self.wavelet: FilterBank = get_filter(wavelet)

    def get_wavelet(self) -> FilterBank:
        return self.wavelet

    def decompose(self, x):
        """All-level decomposition matrix: row l = forward at level l
        (WaveletTransform.java:136-146)."""
        a = self._in(x)
        steps = exponent_of_two(a.shape[-1])
        rows = [a] + [self._forward_core(a, l) for l in range(1, steps + 1)]
        return torch.stack(rows, dim=-2)

    def recompose(self, mat, level=None):
        """Reconstruct from one decomposition row (highest by default)."""
        mat = self._in(mat)
        if level is None:
            level = mat.shape[-2] - 1
        return self._reverse_core(decompose_row(mat, level), level)


class FastWaveletTransform(WaveletTransform):
    """FWT facade (FastWaveletTransform.java)."""

    name = "Fast Wavelet Transform"

    def _forward_core(self, x, level=None):
        return fwt(x, self.wavelet, level)

    def _reverse_core(self, y, level=None):
        return ifwt(y, self.wavelet, level)

    def forward_2d(self, mat, level_rows=None, level_cols=None):
        """2D forward via transforms.fwt.fwt2d (two K4 passes on CUDA)."""
        return fwt2d(self._in(mat), self.wavelet, level_rows, level_cols)

    def reverse_2d(self, mat, level_rows=None, level_cols=None):
        return ifwt2d(self._in(mat), self.wavelet, level_rows, level_cols)

    def forward_3d(self, spc, level_p=None, level_q=None, level_r=None):
        """3D forward via transforms.fwt.fwt3d (three rotated K3 passes on
        CUDA)."""
        return fwt3d(self._in(spc), self.wavelet, level_p, level_q, level_r)

    def reverse_3d(self, spc, level_p=None, level_q=None, level_r=None):
        return ifwt3d(self._in(spc), self.wavelet, level_p, level_q, level_r)

    def decompose(self, x):
        """(..., p+1, N) all-level decomposition (WaveletTransform.java:136-146)."""
        return fwt_decompose(self._in(x), self.wavelet)

    def recompose(self, mat, level=None):
        return fwt_recompose(self._in(mat), self.wavelet, level)


class WaveletPacketTransform(WaveletTransform):
    """WPT facade (WaveletPacketTransform.java)."""

    name = "Wavelet Packet Transform"

    def _forward_core(self, x, level=None):
        return wpt(x, self.wavelet, level)

    def _reverse_core(self, y, level=None):
        return iwpt(y, self.wavelet, level)

    @spanned("wpt2d")
    def forward_2d(self, mat, level_rows=None, level_cols=None):
        """2D forward over the last two axes via transforms.wpt.wpt2d (one
        ``wpt2d`` span): two rotated K8 passes on CUDA, else separable."""
        return wpt2d(self._in(mat), self.wavelet, level_rows, level_cols)

    @spanned("iwpt2d")
    def reverse_2d(self, mat, level_rows=None, level_cols=None):
        return iwpt2d(self._in(mat), self.wavelet, level_rows, level_cols)


class LiftingWaveletTransform(BasicTransform):
    """Lifting-scheme FWT facade: runs the CDF banks the reference's builder
    refuses to create (WaveletBuilder.java:363-385); see
    transforms/lifting.py. Shares the FWT pyramid layout, so 2D/3D,
    compression and decompose/recompose compose unchanged."""

    name = "Lifting Wavelet Transform"

    def __init__(self, scheme="CDF 9/7", device=None):
        super().__init__(device)
        self.scheme: LiftingScheme = get_scheme(scheme)

    def get_wavelet(self) -> LiftingScheme:
        return self.scheme

    def _forward_core(self, x, level=None):
        return lifting_fwt(x, self.scheme, level)

    def _reverse_core(self, y, level=None):
        return lifting_ifwt(y, self.scheme, level)

    # the generic all-level bundle only touches _forward/_reverse_core
    decompose = WaveletTransform.decompose
    recompose = WaveletTransform.recompose


class ShiftingWaveletTransform(WaveletTransform):
    """Shifting WT facade (ShiftingWaveletTransform.java)."""

    name = "Shifting Wavelet Transform"

    def _forward_core(self, x, level=None):
        return _shifting.shifting_forward(x, self.wavelet)

    def _reverse_core(self, y, level=None):
        return _shifting.shifting_reverse(y, self.wavelet)


class MODWTTransform(WaveletTransform):
    """MODWT facade (MODWTTransform.java). 1D forward/reverse use the
    flattened (J+1)*N layout; forward_modwt/inverse_modwt expose the
    (..., J+1, N) stack."""

    name = "Maximal Overlap Discrete Wavelet Transform"

    def __init__(self, wavelet, method: ConvolutionMethod = ConvolutionMethod.AUTO,
                 fft_threshold: int = DEFAULT_FFT_THRESHOLD, device=None):
        super().__init__(wavelet, device)
        self.method = method
        self.fft_threshold = fft_threshold

    def _kw(self):
        return dict(method=self.method, fft_threshold=self.fft_threshold)

    def _forward_core(self, x, level=None):
        return modwt_1d(x, self.wavelet, level, **self._kw())

    def _reverse_core(self, y, level=None):
        return imodwt_1d(y, self.wavelet, level, **self._kw())

    def forward_modwt(self, x, level: int):
        """(..., N) -> (..., level+1, N) [W_1..W_J, V_J] (MODWTTransform.java:256-306)."""
        return modwt(self._in(x), self.wavelet, level, **self._kw())

    def inverse_modwt(self, coeffs):
        """(..., J+1, N) -> (..., N) (MODWTTransform.java:337-375). Empty or
        degenerate stacks give an empty signal, as the reference does."""
        if coeffs is None:
            return torch.zeros((0,), device=self.device)
        coeffs = self._in(coeffs)
        if coeffs.dim() < 2:
            return torch.zeros((0,), dtype=coeffs.dtype, device=coeffs.device)
        if coeffs.shape[-2] == 0 or coeffs.shape[-1] == 0:
            return torch.zeros(coeffs.shape[:-2] + (0,), dtype=coeffs.dtype, device=coeffs.device)
        return imodwt(coeffs, self.wavelet, **self._kw())

    def forward_modwt_2d(self, mat, level: int):
        """Separable 2D MODWT: (..., R, C) -> (..., J+1, J+1, R, C) subband
        grid (see transforms.modwt.modwt_2d)."""
        return modwt_2d(self._in(mat), self.wavelet, level, **self._kw())

    def inverse_modwt_2d(self, coeffs):
        return imodwt_2d(self._in(coeffs), self.wavelet, **self._kw())

    def set_convolution_method(self, method: ConvolutionMethod):
        self.method = method

    def decompose(self, x):
        raise JWaveFailure(
            "MODWTTransform.decompose - use forward_modwt(x, level) for the "
            "(level+1, N) coefficient stack"
        )


class DiscreteFourierTransform(BasicTransform):
    """Naive O(N^2) DFT on the interleaved real format
    (DiscreteFourierTransform.java:73-117); complex input is taken as it is,
    also by the separable 2D/3D drivers."""

    name = "Discrete Fourier Transform"

    def _forward_core(self, x, level=None):
        return dft(x) if x.is_complex() else dft_interleaved(x)

    def _reverse_core(self, y, level=None):
        return idft(y) if y.is_complex() else idft_interleaved(y)

    def forward(self, x, level=None):
        return self._forward_core(self._in(x))

    def reverse(self, y, level=None):
        return self._reverse_core(self._in(y))


class FastFourierTransform(DiscreteFourierTransform):
    """FFT with NumPy normalization (FastFourierTransform.java:205-211);
    ``torch.fft`` takes any N (the reference needs Bluestein chirp-z,
    FastFourierTransform.java:259-324)."""

    name = "Fast Fourier Transform"

    def _forward_core(self, x, level=None):
        return fft(x) if x.is_complex() else fft_interleaved(x)

    def _reverse_core(self, y, level=None):
        return ifft(y) if y.is_complex() else ifft_interleaved(y)


class AncientEgyptianDecomposition(BasicTransform):
    """Arbitrary-length driver splitting into power-of-two chunks
    (AncientEgyptianDecomposition.java:97-185). Non-tensor input goes to
    ``device``, the inner transform's unless one is given."""

    name = "Ancient Egyptian Decomposition"

    def __init__(self, inner: BasicTransform, initial_wavelet_space_size: int = 0,
                 device=None):
        super().__init__(inner.device if device is None else device)
        self.inner = inner
        # stored-but-unused in the reference too (AncientEgyptianDecomposition.java:77-85)
        self.initial_wavelet_space_size = initial_wavelet_space_size

    def get_wavelet(self):
        return self.inner.get_wavelet()

    def _forward_core(self, x, level=None):
        return _aed.aed_forward(x, lambda c: self.inner._forward_core(c, level))

    def _reverse_core(self, y, level=None):
        return _aed.aed_reverse(y, lambda c: self.inner._reverse_core(c, level))


class ContinuousWaveletTransform(BasicTransform):
    """CWT facade (ContinuousWaveletTransform.java). Like the reference,
    plain forward/reverse raise: use :meth:`transform` /
    :meth:`transform_fft` with explicit scales."""

    name = "Continuous Wavelet Transform"

    def __init__(self, wavelet="morlet", padding: PaddingType = PaddingType.SYMMETRIC,
                 device=None):
        super().__init__(device)
        self.cwavelet = get_continuous_wavelet(wavelet)
        self.padding = padding

    def forward(self, x, level=None):
        raise JWaveFailure("CWT requires scale parameters. Use transform() method instead.")

    def reverse(self, y, level=None):
        raise JWaveFailure("CWT inverse requires scale parameters and is not fully implemented.")

    def transform(self, signal, scales, sampling_rate: float = 1.0) -> CWTResult:
        """Direct-convolution CWT (ContinuousWaveletTransform.java:146-172)."""
        return cwt_direct(self._in(signal), scales, self.cwavelet, sampling_rate)

    def transform_fft(self, signal, scales, sampling_rate: float = 1.0) -> CWTResult:
        """FFT-based CWT (ContinuousWaveletTransform.java:183-229): the scale
        loop, which the reference spreads over a thread pool (:511-565), is
        one batched product, so this is also the "parallel" variant."""
        return cwt(self._in(signal), scales, self.cwavelet, sampling_rate, self.padding)

    # the reference's thread-pool variants are the same batched product
    transform_parallel = transform_fft
    transform_fft_parallel = transform_fft


class Transform:
    """Type-dispatching facade (reference jwave/Transform.java:43-451):
    1D/2D/3D dispatch keys off the input rank."""

    def __init__(self, basic: BasicTransform):
        if not isinstance(basic, BasicTransform):
            raise JWaveFailure("Transform - given object is not a BasicTransform")
        self._basic = basic

    def get_basic_transform(self) -> BasicTransform:
        return self._basic

    def get_wavelet(self):
        return self._basic.get_wavelet()

    @spanned("Transform.forward")
    def forward(self, data, *levels):
        """1D/2D/3D forward dispatch (Transform.java:81-388)."""
        data = self._basic._in(data)
        if data.dim() == 1:
            return self._basic.forward(data, *(levels or (None,)))
        if data.dim() == 2:
            lr, lc = (levels + (None, None))[:2]
            return self._basic.forward_2d(data, lr, lc)
        if data.dim() == 3:
            lp, lq, lr = (levels + (None, None, None))[:3]
            return self._basic.forward_3d(data, lp, lq, lr)
        raise JWaveFailure(f"Transform.forward - unsupported rank {data.dim()}")

    @spanned("Transform.reverse")
    def reverse(self, data, *levels):
        """1D/2D/3D inverse dispatch."""
        data = self._basic._in(data)
        if data.dim() == 1:
            return self._basic.reverse(data, *(levels or (None,)))
        if data.dim() == 2:
            lr, lc = (levels + (None, None))[:2]
            return self._basic.reverse_2d(data, lr, lc)
        if data.dim() == 3:
            lp, lq, lr = (levels + (None, None, None))[:3]
            return self._basic.reverse_3d(data, lp, lq, lr)
        raise JWaveFailure(f"Transform.reverse - unsupported rank {data.dim()}")

    def decompose(self, x):
        """1D -> (p+1, N) all-level decomposition (Transform.java:401-420)."""
        return self._basic.decompose(x)

    def recompose(self, mat, level=None):
        """Reconstruct from a decomposition row (Transform.java:422-451)."""
        return self._basic.recompose(mat, level)


class TransformBuilder:
    """String -> Transform factory (TransformBuilder.java:40-110) covering
    every transform, unlike the reference's stale registry."""

    _NAMES = {
        "fast wavelet transform": lambda w, device=None, **kw: FastWaveletTransform(w, device),
        "wavelet packet transform":
            lambda w, device=None, **kw: WaveletPacketTransform(w, device),
        "shifting wavelet transform":
            lambda w, device=None, **kw: ShiftingWaveletTransform(w, device),
        "lifting wavelet transform":
            lambda w, device=None, **kw: LiftingWaveletTransform(w, device),
        "maximal overlap discrete wavelet transform":
            lambda w, device=None, **kw: MODWTTransform(w, device=device, **kw),
        "modwt": lambda w, device=None, **kw: MODWTTransform(w, device=device, **kw),
        "discrete fourier transform":
            lambda w, device=None, **kw: DiscreteFourierTransform(device),
        "fast fourier transform": lambda w, device=None, **kw: FastFourierTransform(device),
        "continuous wavelet transform":
            lambda w, device=None, **kw: ContinuousWaveletTransform(w, device=device, **kw),
    }

    @classmethod
    def create(cls, transform_name: str, wavelet=None, device=None, **kwargs) -> Transform:
        """``device`` receives non-tensor inputs ("cuda" by default). The
        wavelet defaults to Haar, and to Morlet for the CWT. A name prefixed
        by "Ancient Egyptian Decomposition" wraps that transform (the FWT
        when nothing follows) in :class:`AncientEgyptianDecomposition`."""
        key = str(transform_name).lower().strip()
        if wavelet is None:
            wavelet = "morlet" if key == "continuous wavelet transform" else "Haar"
        if key.startswith("ancient egyptian decomposition"):
            rest = key[len("ancient egyptian decomposition"):].strip() or "fast wavelet transform"
            inner = cls.create(rest, wavelet, device=device, **kwargs).get_basic_transform()
            return Transform(AncientEgyptianDecomposition(inner))
        if key not in cls._NAMES:
            raise JWaveNotKnown(
                f"TransformBuilder.create - unknown transform {transform_name!r}; "
                f"available: {sorted(cls._NAMES)} (optionally prefixed by "
                f"'Ancient Egyptian Decomposition')"
            )
        return Transform(cls._NAMES[key](wavelet, device=device, **kwargs))

    @staticmethod
    def identify(transform: Transform) -> str:
        """Transform -> name (TransformBuilder.java:105-110)."""
        return transform.get_basic_transform().name
