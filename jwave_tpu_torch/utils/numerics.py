"""Small integer helpers for shape bookkeeping (reference MathUtils.java:46-59,
MathToolKit.getExponent)."""
from __future__ import annotations

from ..exceptions import JWaveFailure


def is_power_of_two(n: int) -> bool:
    """MathUtils.isPowerOfTwo (MathUtils.java:46-51)."""
    return n > 0 and (n & (n - 1)) == 0


def next_power_of_two(n: int) -> int:
    """MathUtils.nextPowerOfTwo (MathUtils.java:53-59)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def exponent_of_two(n: int) -> int:
    """floor(log2 n) — MathToolKit.getExponent."""
    if n <= 0:
        raise JWaveFailure(f"exponent_of_two: n must be positive, got {n}")
    return n.bit_length() - 1
