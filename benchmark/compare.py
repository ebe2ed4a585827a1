"""The arithmetic that judges an output against the reference: the largest
absolute error over the largest reference magnitude, in float64."""
from __future__ import annotations

import torch


class RelErr:
    """max |got - ref| / max |ref| over the blocks of one answer; a NaN in
    ``got`` reads as an infinite error."""

    def __init__(self):
        self.err = 0.0
        self.scale = 0.0

    def add(self, got: torch.Tensor, ref: torch.Tensor) -> "RelErr":
        ref = ref.to(torch.float64)
        diff = (got.to(device=ref.device, dtype=torch.float64) - ref).abs()
        self.err = max(self.err, float(torch.nan_to_num(diff, nan=float("inf")).max()))
        self.scale = max(self.scale, float(ref.abs().max()))
        return self

    @property
    def value(self) -> float:
        return self.err / self.scale if self.scale > 0 else float("inf")
