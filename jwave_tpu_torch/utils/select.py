"""Order statistics of non-negative values: radix-select on the float bits,
and the exact median.

For NON-NEGATIVE floats the sign bit is 0, so the bit pattern read as a
signed integer of the same width is monotone in the value: the k-th
smallest element can be built bit by bit from the highest value bit, one
compare-and-count pass per bit, and is an element of the input (even-N
medians average the same two middle elements as a sort). Signed views
(int16/int32/int64) are used because torch's unsigned types are thin; the
sign bit is skipped, as it is 0 for every non-negative value. NaNs sort
above every finite value.

:func:`median_abs` takes the exact median by default on every device (the
mean of the two middle ``kthvalue``s when N is even, as ``jnp.median``;
``torch.median`` would return the lower one); ``force=True`` takes the
radix-select route, which returns the same value.
"""
from __future__ import annotations

import torch

_INT_OF = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def kth_smallest_nonneg(a: torch.Tensor, ks) -> tuple:
    """k-th smallest (0-indexed) of non-negative ``a`` along the last axis,
    for each static k of ``ks``; one radix descent per k, sharing each pass's
    read of ``a``. Returns a tuple of (...,) tensors of ``a``'s dtype."""
    nbits = a.element_size() * 8
    idt = _INT_OF[a.element_size()]
    bits = a.contiguous().view(idt)
    prefixes = [torch.zeros(a.shape[:-1], dtype=idt, device=a.device) for _ in ks]
    for b in reversed(range(nbits - 1)):  # the sign bit is 0
        for i, k in enumerate(ks):
            cand = prefixes[i] | (1 << b)
            below = torch.sum(bits < cand[..., None], dim=-1)
            prefixes[i] = torch.where(below <= k, cand, prefixes[i])
    return tuple(p.view(a.dtype) for p in prefixes)


def _middle_ks(n: int) -> tuple:
    return (n // 2,) if n % 2 else ((n - 1) // 2, n // 2)


class _MedianNonneg(torch.autograd.Function):
    """Radix-select median with the sort median's gradient: the gradient of
    each selected order statistic is spread evenly over the elements equal
    to it (the mean subgradient under ties)."""

    @staticmethod
    def forward(ctx, a):
        stats = kth_smallest_nonneg(a, _middle_ks(a.shape[-1]))
        ctx.save_for_backward(a, *stats)
        return stats[0] if len(stats) == 1 else (stats[0] + stats[1]) / 2

    @staticmethod
    def backward(ctx, g):
        a, *stats = ctx.saved_tensors
        grad = torch.zeros_like(a)
        for v in stats:
            m = (a == v[..., None]).to(a.dtype)
            grad = grad + m / m.sum(dim=-1, keepdim=True)
        return grad * (g[..., None] / len(stats))


def median_nonneg(a: torch.Tensor) -> torch.Tensor:
    """Median of non-negative ``a`` along the last axis by radix-select, with
    ``jnp.median`` semantics (even N averages the two middle elements)."""
    return _MedianNonneg.apply(a)


def _median_exact(m: torch.Tensor) -> torch.Tensor:
    n = m.shape[-1]
    if n % 2:
        return torch.kthvalue(m, n // 2 + 1, dim=-1).values
    lo = torch.kthvalue(m, n // 2, dim=-1).values
    hi = torch.kthvalue(m, n // 2 + 1, dim=-1).values
    return (lo + hi) / 2


def median_abs(a: torch.Tensor, force: bool | None = None) -> torch.Tensor:
    """``median(|a|)`` along the last axis: the exact median by selection
    (``kthvalue``) unless ``force`` is true, which takes the radix-select
    route (tests pin the two routes against each other)."""
    m = torch.abs(a)
    return median_nonneg(m) if force else _median_exact(m)
