"""Performance-variant and parallel-variant facades (reference API parity).

The reference ships JVM-specific performance variants whose *capabilities*
carry over but whose *mechanisms* do not, as in ``jwave_tpu.variants``:

  * buffer pooling / in-place APIs -> torch's caching allocator, and an
    in-place FWT that writes its result into the input tensor's storage,
  * ForkJoinPool task trees -> batched tensor axes in one call,
  * runtime filter caches -> host constants.

Each class keeps the reference name so migrating code keeps working, and
delegates to the batched core.
"""
from __future__ import annotations

import torch

from .api import (
    BasicTransform,
    FastFourierTransform,
    FastWaveletTransform,
    MODWTTransform,
    Transform,
    WaveletPacketTransform,
)
from .exceptions import JWaveFailure
from .transforms.fwt import fwt, ifwt
from .transforms.modwt import _validate_level


class InPlaceFastWaveletTransform(FastWaveletTransform):
    """Reference InPlaceFastWaveletTransform.java:70-90: an "in-place" API
    that in the reference still copies. Here forward_in_place and
    reverse_in_place write the result into the input tensor's storage and
    return that tensor, as the JAX package donates the input buffer."""

    name = "In-place Fast Wavelet Transform"

    def _in_place(self, x, fn):
        x = self._in(x)
        y = fn(x, self.wavelet)
        if y.dtype != x.dtype:  # an integer input cannot hold the result
            return y
        return x.copy_(y)

    def forward_in_place(self, x):
        """FWT of ``x`` (all levels); the input is consumed: its storage holds
        the result afterwards (floating-point input)."""
        return self._in_place(x, fwt)

    def reverse_in_place(self, y):
        """Inverse FWT of ``y``; the input is consumed as in forward_in_place."""
        return self._in_place(y, ifwt)


class PooledWaveletPacketTransform(WaveletPacketTransform):
    """Reference PooledWaveletPacketTransform.java:24-71: WPT with pooled
    scratch buffers. torch's caching allocator reuses buffers; this alias
    exists for API parity."""

    name = "Pooled Wavelet Packet Transform"


class PooledFastFourierTransform(FastFourierTransform):
    """Reference PooledFastFourierTransform.java:17-57: pooled FFT bridges.
    Alias; see PooledWaveletPacketTransform."""

    name = "Pooled Fast Fourier Transform"


class PooledMODWTTransform(MODWTTransform):
    """Reference PooledMODWTTransform.java:69-102: MODWT with pooled
    convolution buffers. Alias: on CUDA float32 it runs K1/K2."""

    name = "Pooled Maximal Overlap Discrete Wavelet Transform"


class EfficientMODWTTransform(MODWTTransform):
    """Reference EfficientMODWTTransform.java:131-180: single backing
    (J+1, N) array with zero-copy views, which is this package's MODWT
    output. The reference *declares* a streaming-chunk API but throws
    UnsupportedOperation (EfficientMODWTTransform.java:245-253); here, as in
    the JAX package, streaming is implemented: a long signal is processed in
    chunks whose coefficients match the full transform exactly."""

    name = "Efficient Maximal Overlap Discrete Wavelet Transform"

    def forward_streaming(self, x, level: int, chunk: int):
        """Chunked forward MODWT over a 1-D signal of arbitrary length.

        Each chunk is transformed with the cascade's left context of
        (M-1)(2^J - 1) samples before it (circular at the signal's start,
        as the whole transform's periodic boundary), gathered by a device
        index, and only its own columns are kept.
        """
        x = self._in(x)
        n = x.shape[-1]
        if x.dim() != 1:
            raise JWaveFailure("forward_streaming expects a 1-D signal")
        _validate_level(n, level, "forward_streaming")
        # the level-J cascade is causal with total support (M-1)(2^J - 1) + 1
        # (sum of per-level upsampled supports), so only LEFT context is needed
        context = (self.wavelet.length - 1) * ((1 << level) - 1)
        if chunk <= 0:
            raise JWaveFailure("chunk must be positive")
        if context >= n:
            return self.forward_modwt(x, level)  # too short to stream
        out = []
        for start in range(0, n, chunk):
            stop = min(start + chunk, n)
            idx = torch.arange(start - context, stop, device=x.device) % n
            out.append(self.forward_modwt(x[idx], level)[..., context:])
        return torch.cat(out, dim=-1)


class ParallelWaveletPacketTransform(WaveletPacketTransform):
    """Reference ParallelWaveletPacketTransform.java:36-305: ForkJoinPool
    over packets with size thresholds and pool lifecycle. Here the packet
    axis is a tensor dimension of one call: this alias IS the parallel
    variant, with no thresholds and nothing to shut down."""

    name = "Parallel Wavelet Packet Transform"

    def shutdown(self):  # reference pool lifecycle (no-op)
        return None


class ParallelDiscreteFourierTransform(FastFourierTransform):
    """Reference ParallelDiscreteFourierTransform.java:16-52: fork-join
    O(N^2) DFT. Subsumed by the FFT; alias kept for migration."""

    name = "Parallel Discrete Fourier Transform"


class ParallelTransform(Transform):
    """Reference ParallelTransform.java:23-160: decorator parallelizing any
    BasicTransform's 2D rows/columns (and 3D slices) over a ForkJoinPool.
    The separable drivers are already batched over rows/columns in one call,
    so this decorator wraps the same Transform."""

    def __init__(self, basic: BasicTransform, min_size: int = 16):
        super().__init__(basic)
        self.min_size = min_size  # reference threshold, kept for parity
