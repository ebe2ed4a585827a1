"""Ancient Egyptian Decomposition: arbitrary lengths for pow-2 transforms.

Reference: jwave/transforms/AncientEgyptianDecomposition.java:97-185, as
``jwave_tpu.transforms.aed`` implements it: the signal is split on the host
into power-of-two chunks by the binary decomposition of N, largest first, and
each chunk is transformed independently (on CUDA float32 an FWT chunk with a
level to do is one K3 launch).
"""
from __future__ import annotations

import torch

from ..utils.host import as_tensor
from ..utils.numerics import ancient_egyptian_decompose


def _chunks(n: int):
    offs, sizes, off = [], [], 0
    for p in ancient_egyptian_decompose(n):
        offs.append(off)
        sizes.append(1 << p)
        off += 1 << p
    return offs, sizes


def _apply(x, fn):
    x = as_tensor(x)
    offs, sizes = _chunks(x.shape[-1])
    parts = [fn(x[..., o: o + s]) for o, s in zip(offs, sizes)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def aed_forward(x, transform_fn):
    """Apply ``transform_fn`` to each power-of-two chunk along the last axis.

    ``transform_fn(chunk)`` must transform the last axis and preserve shape
    (e.g. ``lambda c: fwt(c, "db4")``).
    """
    return _apply(x, transform_fn)


def aed_reverse(y, inverse_fn):
    """Inverse of :func:`aed_forward` with the matching inverse transform."""
    return _apply(y, inverse_fn)
