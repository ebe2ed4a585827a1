"""Small numeric helpers for shape bookkeeping, run on the host in Python and
numpy (reference MathUtils.java:46-59, MathToolKit.java:57-273)."""
from __future__ import annotations

import math

import numpy as np

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


def scalb(f: float, exp: int) -> float:
    """f * 2**exp — MathToolKit.scalb."""
    return math.ldexp(f, exp)


def ancient_egyptian_decompose(n: int) -> list[int]:
    """Binary (ancient Egyptian) decomposition of ``n`` into exponents.

    Returns the exponents p_k, largest first, with n = sum(2**p_k).
    Reference: MathToolKit.decompose (MathToolKit.java:57).
    """
    if n < 1:
        raise JWaveFailure(f"ancient_egyptian_decompose: n must be >= 1, got {n}")
    exps = []
    p = n.bit_length() - 1
    while n > 0:
        if n >= (1 << p):
            exps.append(p)
            n -= 1 << p
        p -= 1
    return exps


def ancient_egyptian_decompose_blocked(n: int, block_size: int) -> list[int]:
    """Split ``n`` into ``block_size`` chunks plus a binary-decomposed rest.

    Returns chunk SIZES uniformly (the reference's MathToolKit.decompose
    (int, int) (MathToolKit.java:102-140) mixes units: block values followed
    by exponents of the rest; sizes convert via exponent_of_two).
    """
    if not is_power_of_two(block_size):
        raise JWaveFailure(f"block size {block_size} is not 2^p")
    if n < block_size:
        raise JWaveFailure(f"block size {block_size} is greater than n {n}")
    blocks = n // block_size
    rest = n - blocks * block_size
    sizes = [block_size] * blocks
    if rest:
        sizes += [1 << p for p in ancient_egyptian_decompose(rest)]
    return sizes


def ancient_egyptian_compose(exps: list[int]) -> int:
    """Inverse of :func:`ancient_egyptian_decompose` (MathToolKit.compose)."""
    return sum(1 << p for p in exps)


def create_sine_oscillation(samples: int, periods: float = 1.0) -> np.ndarray:
    """Sine test signal — MathToolKit.createSineOscillation (MathToolKit.java:156+)."""
    t = np.arange(samples, dtype=np.float64)
    return np.sin(2.0 * np.pi * periods * t / samples)


def create_cosine_oscillation(samples: int, periods: float = 1.0) -> np.ndarray:
    """Cosine test signal — MathToolKit.createCosineOscillation."""
    t = np.arange(samples, dtype=np.float64)
    return np.cos(2.0 * np.pi * periods * t / samples)
