"""1/2/3-D value containers (dense and sparse) + Complex interop.

Reference: jwave/datatypes/ — ``Super ⊃ {SuperLine, Line/LineFull/LineHash,
Block/BlockFull/BlockHash, Space/SpaceFull/SpaceHash}`` (dense arrays and
HashMap-sparse variants with an alloc/erase lifecycle,
datatypes/Super.java:36-100, BlockFull.java:36, BlockHash.java:39-47) and
the mutable ``Complex`` scalar (datatypes/natives/Complex.java:34-418).

These containers are dormant in the reference (unused by any transform);
they are provided, as in ``jwave_tpu.datatypes``, for API-parity
migrations. Dense variants wrap numpy storage (a tensor via
``.to_torch(device)``, the card by default); sparse variants store a dict
keyed by index tuples. ``Complex`` is served by torch's complex dtypes: use
:func:`complex_to_interleaved` / :func:`interleaved_to_complex` to bridge the
reference's interleaved double[] layout.
"""
from __future__ import annotations

import numpy as np

from .exceptions import JWaveNotAllocated, JWaveNotValid
from .utils.host import host_array


def complex_to_interleaved(z):
    """complex (..., N) -> real (..., 2N) [re0, im0, ...] (Complex bridging)."""
    z = host_array(z)
    out = np.empty(z.shape[:-1] + (2 * z.shape[-1],), dtype=np.float64)
    out[..., 0::2] = z.real
    out[..., 1::2] = z.imag
    return out


def interleaved_to_complex(x):
    """real (..., 2N) -> complex (..., N)."""
    x = host_array(x)
    return x[..., 0::2] + 1j * x[..., 1::2]


class _Container:
    """Shared alloc/erase lifecycle (reference Super.java:36-100)."""

    def __init__(self, *dims: int, offsets: tuple[int, ...] | None = None):
        if any(d <= 0 for d in dims):
            raise JWaveNotValid(f"container dims must be positive, got {dims}")
        self.dims = dims
        self.offsets = offsets or (0,) * len(dims)
        self._data = None

    @property
    def is_allocated(self) -> bool:
        return self._data is not None

    def alloc(self):
        raise NotImplementedError

    def erase(self):
        self._data = None

    def _check(self, idx):
        if self._data is None:
            raise JWaveNotAllocated("container memory is not allocated; call alloc()")
        for i, (p, d, o) in enumerate(zip(idx, self.dims, self.offsets)):
            if not (o <= p < o + d):
                raise JWaveNotValid(f"index {p} out of range [{o}, {o + d}) in dim {i}")
        return tuple(p - o for p, o in zip(idx, self.offsets))


class _Dense(_Container):
    """Dense storage (reference *Full variants)."""

    def alloc(self):
        self._data = np.zeros(self.dims, dtype=np.float64)
        return self

    def get(self, *idx) -> float:
        return float(self._data[self._check(idx)])

    def set(self, *idx_and_value):
        *idx, value = idx_and_value
        self._data[self._check(tuple(idx))] = value

    def to_numpy(self) -> np.ndarray:
        if self._data is None:
            raise JWaveNotAllocated("container memory is not allocated")
        return self._data

    def to_torch(self, device=None):
        """The values as a float64 tensor on ``device`` ("cuda" by default)."""
        import torch

        return torch.tensor(self.to_numpy(), device=device or "cuda")


class _Sparse(_Container):
    """Hash-sparse storage (reference *Hash variants)."""

    def alloc(self):
        self._data = {}
        return self

    def get(self, *idx) -> float:
        key = self._check(idx)  # before the dict is read: raises if not allocated
        return self._data.get(key, 0.0)

    def set(self, *idx_and_value):
        *idx, value = idx_and_value
        key = self._check(tuple(idx))
        if value == 0.0:
            self._data.pop(key, None)
        else:
            self._data[key] = float(value)

    @property
    def stored(self) -> int:
        if self._data is None:
            raise JWaveNotAllocated("container memory is not allocated")
        return len(self._data)

    def to_numpy(self) -> np.ndarray:
        if self._data is None:
            raise JWaveNotAllocated("container memory is not allocated")
        out = np.zeros(self.dims, dtype=np.float64)
        for k, v in self._data.items():
            out[k] = v
        return out


class LineFull(_Dense):
    """Dense 1-D container (reference datatypes/lines/LineFull.java)."""

    def __init__(self, n: int, offset: int = 0):
        super().__init__(n, offsets=(offset,))


class LineHash(_Sparse):
    """Sparse 1-D container (reference datatypes/lines/LineHash.java)."""

    def __init__(self, n: int, offset: int = 0):
        super().__init__(n, offsets=(offset,))


class BlockFull(_Dense):
    """Dense 2-D container (reference datatypes/blocks/BlockFull.java:36)."""

    def __init__(self, rows: int, cols: int, off_rows: int = 0, off_cols: int = 0):
        super().__init__(rows, cols, offsets=(off_rows, off_cols))


class BlockHash(_Sparse):
    """Sparse 2-D container (reference datatypes/blocks/BlockHash.java:39-47)."""

    def __init__(self, rows: int, cols: int, off_rows: int = 0, off_cols: int = 0):
        super().__init__(rows, cols, offsets=(off_rows, off_cols))


class SpaceFull(_Dense):
    """Dense 3-D container (reference datatypes/spaces/SpaceFull.java)."""

    def __init__(self, p: int, q: int, r: int, op: int = 0, oq: int = 0, orr: int = 0):
        super().__init__(p, q, r, offsets=(op, oq, orr))


class SpaceHash(_Sparse):
    """Sparse 3-D container (reference datatypes/spaces/SpaceHash.java)."""

    def __init__(self, p: int, q: int, r: int, op: int = 0, oq: int = 0, orr: int = 0):
        super().__init__(p, q, r, offsets=(op, oq, orr))


# reference naming: Line/Block/Space are the abstract bases; default to dense
Line = LineFull
Block = BlockFull
Space = SpaceFull
