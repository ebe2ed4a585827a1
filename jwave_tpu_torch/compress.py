"""Coefficient compression (threshold-to-zero).

Reference: jwave/compressions/Compressor.java:97-191,
CompressorMagnitude.java:73-134, CompressorPeaksAverage.java:66-125, as
``jwave_tpu.compress`` implements them: every variant is one ``where`` over
the whole tensor. A tensor is thresholded where it lies; other input becomes
a tensor on the card.
"""
from __future__ import annotations

import torch

from .exceptions import JWaveFailure
from .ops.butterfly import ensure_float
from .utils.host import as_tensor


class Compressor:
    """Keep coefficients with |c| >= magnitude * threshold, zero the rest
    (Compressor.java:97-170). ``magnitude`` is supplied by subclasses."""

    def __init__(self, threshold: float = 1.0):
        if threshold <= 0.0:
            raise JWaveFailure("Compressor - given threshold should be larger than zero!")
        self.threshold = float(threshold)
        self.magnitude = 0.0

    def _magnitude(self, data: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def compress(self, data) -> torch.Tensor:
        """Threshold any-rank coefficient tensor (1D/2D/3D in the reference)."""
        data = ensure_float(as_tensor(data))
        mag = self._magnitude(data)
        self.magnitude = mag
        return torch.where(torch.abs(data) >= mag * self.threshold, data, 0.0)

    @staticmethod
    def compression_rate(data) -> torch.Tensor:
        """Percentage of exact zeros (Compressor.java:182-191), in float64 for
        float64 data and float32 otherwise."""
        data = as_tensor(data)
        dt = torch.float64 if data.dtype == torch.float64 else torch.float32
        return torch.mean((data == 0.0).to(dt)) * 100.0


class CompressorMagnitude(Compressor):
    """magnitude = mean(|c|) (CompressorMagnitude.java:73-134)."""

    def _magnitude(self, data):
        return torch.mean(torch.abs(data))


class CompressorPeaksAverage(Compressor):
    """magnitude = (max(|c|) - min_peak)/2 with the reference's min_peak
    semantics: it starts at 0 and |c| can never go below it, so min_peak is
    always 0 and magnitude = max(|c|)/2 (CompressorPeaksAverage.java:66-125)."""

    def _magnitude(self, data):
        return 0.5 * torch.amax(torch.abs(data))
