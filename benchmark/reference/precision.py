"""Precisions of the reference: float64, and TF32 for the control.

A :class:`Precision` rounds the operands of each step (``operand``) and its
results (``result``); the arithmetic between stays float64. TF32 is what a
tensor core does to float32 operands: 10 mantissa bits kept, rounded to
nearest even, products summed and stored in float32. It is the nearest
precision below the float32 with TF32 off that the configurations state,
so a reference computed in it has to fail the comparison.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Precision(NamedTuple):
    name: str
    operand: Callable
    result: Callable


def _keep(t: torch.Tensor) -> torch.Tensor:
    return t


def to_float32(t: torch.Tensor) -> torch.Tensor:
    """Round to float32, keep float64 storage."""
    return t.to(torch.float32).to(torch.float64)


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round to TF32 (float32 with the low 13 mantissa bits cleared, to
    nearest even), keep float64 storage. Finite inputs only."""
    bits = t.to(torch.float32).view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32).to(torch.float64)


FLOAT64 = Precision("float64", _keep, _keep)
TF32 = Precision("tf32", to_tf32, to_float32)
