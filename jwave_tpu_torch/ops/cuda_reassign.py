"""K6: the synchrosqueezing reassignment (``csrc/reassign.cu``), with plain
versions and its gradient.

Replaces ``jwave_tpu/ops/pallas_reassign.py`` (``_reassign_kernel``, driven
by ``reassign_pallas``). For contributions ``c`` (..., S, N) and bin indices
``k_idx`` (..., S, N):

    T[..., k, t] = sum over s with k_idx[..., s, t] == k of c[..., s, t]

for k in [0, n_bins); an index outside that range (negative, or the
sentinel n_bins) is dropped. :func:`reassign` launches the kernel for CUDA
tensors and takes :func:`reassign_torch` only for tensors on the CPU. The
map is linear in ``c``, so its gradient is the gather ``ct[k_idx]``, zero
where dropped, as the JAX package's custom VJP computes it
(``pallas_reassign.py:77-86``) outside the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..exceptions import JWaveFailure
from . import cuda_build

#: launches of the kernel since the last :func:`reset_launch_counts`
launch_counts = {"reassign": 0}

#: bins one block accumulates (``kChunk`` in the source)
BIN_CHUNK = 64
#: the block's plan (``csrc/reassign.cu``): time columns (= threads) a
#: block, s-rows a ring stage, ring stages
K6_TILE = 128
K6_STAGE_ROWS = 4
K6_STAGES = 4


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _flat(contrib: torch.Tensor, k_idx: torch.Tensor):
    lead = contrib.shape[:-2]
    s, n = contrib.shape[-2:]
    return lead, contrib.reshape(-1, s, n), k_idx.reshape(-1, s, n)


# ----------------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------------

def reassign_torch(contrib: torch.Tensor, k_idx: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Scatter form: out-of-range indices go to an extra row n_bins, the
    re/im planes are scatter-added into n_bins + 1 rows, the extra row is
    dropped."""
    lead, c, k = _flat(contrib, k_idx)
    g, s, n = c.shape
    k = k.long()
    k = torch.where((k >= 0) & (k < n_bins), k, n_bins)
    parts = torch.view_as_real(c.resolve_conj()) if c.is_complex() else c[..., None]
    w = parts.shape[-1]  # 2 for (re, im), 1 for real input
    out = torch.zeros((g, n_bins + 1, n, w), dtype=parts.dtype, device=c.device)
    out.scatter_add_(1, k[..., None].expand(g, s, n, w), parts)
    out = out[:, :n_bins]
    out = torch.view_as_complex(out.contiguous()) if c.is_complex() else out[..., 0]
    return out.reshape(lead + (n_bins, n))


def reassign_dense_torch(contrib: torch.Tensor, k_idx: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Bin loop: per bin row one masked sum over the scale axis (no (K, S, N)
    mask is ever built)."""
    lead, c, k = _flat(contrib, k_idx)
    out = torch.empty((c.shape[0], n_bins, c.shape[2]), dtype=c.dtype, device=c.device)
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    for kk in range(n_bins):
        out[:, kk] = torch.where(k == kk, c, zero).sum(dim=1)
    return out.reshape(lead + (n_bins, c.shape[2]))


# ----------------------------------------------------------------------------
# kernel wrapper
# ----------------------------------------------------------------------------

def k6_smem_bytes(n_bins: int) -> int:
    """Shared bytes of a K6 block (``csrc/reassign.cu`` smem_bytes): the
    complex64 plane of min(n_bins, BIN_CHUNK) bin rows of ``K6_TILE``
    columns, the ring of ``K6_STAGES`` stages of ``K6_STAGE_ROWS`` s-rows
    (8 B of contribution and 4 B of index a column) and one 8-byte mbarrier
    a stage."""
    return (min(n_bins, BIN_CHUNK) * K6_TILE * 8 + K6_STAGES * K6_STAGE_ROWS * K6_TILE * 12
            + K6_STAGES * 8)


def _launch(contrib: torch.Tensor, k_idx: torch.Tensor, n_bins: int) -> torch.Tensor:
    if contrib.device.type != "cuda":
        raise JWaveFailure(f"reassign - tensor on {contrib.device}; "
                           "the kernel runs on CUDA tensors")
    if k_idx.device != contrib.device or k_idx.shape != contrib.shape:
        raise JWaveFailure("reassign - k_idx must match contrib in shape and device")
    if contrib.dtype != torch.complex64:
        raise JWaveFailure(f"reassign - dtype {contrib.dtype}; the kernel takes complex64")
    if contrib.dim() < 2:
        raise JWaveFailure("reassign - expected (..., S, N) contributions")
    if not 1 <= n_bins <= 65535 * BIN_CHUNK:
        raise JWaveFailure(f"reassign - n_bins {n_bins} out of range")
    lead, c, k = _flat(contrib.resolve_conj().contiguous(), k_idx.to(torch.int32).contiguous())
    g, s, n = c.shape
    out = torch.empty((g, n_bins, n), dtype=torch.complex64, device=c.device)
    if g * n == 0:
        return out.reshape(lead + (n_bins, n))
    if s == 0:
        return out.zero_().reshape(lead + (n_bins, n))
    if g * -(-n // K6_TILE) >= 2**31:
        raise JWaveFailure(f"reassign - {g} x {n} columns exceed one launch")
    lib = cuda_build.library("reassign")
    fn = lib.jw_reassign
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    err = fn(c.data_ptr(), k.data_ptr(), out.data_ptr(), g, s, n, n_bins,
             cuda_build.stream_handle(c.device))
    cuda_build.check(lib, err, "reassign")
    launch_counts["reassign"] += 1
    return out.reshape(lead + (n_bins, n))


class _Reassign(torch.autograd.Function):
    """Forward: the kernel on CUDA, the scatter form on the CPU. Backward:
    the gather ``ct[k_idx]``, zero where the index was dropped."""

    @staticmethod
    def forward(ctx, contrib, k_idx, n_bins):
        ctx.save_for_backward(k_idx)
        ctx.n_bins = n_bins
        if contrib.device.type == "cpu":
            return reassign_torch(contrib, k_idx, n_bins)
        return _launch(contrib, k_idx, n_bins)

    @staticmethod
    def backward(ctx, ct):
        (k_idx,) = ctx.saved_tensors
        k = k_idx.long()
        valid = (k >= 0) & (k < ctx.n_bins)
        g = torch.gather(ct, -2, k.clamp(0, ctx.n_bins - 1))
        return torch.where(valid, g, torch.zeros((), dtype=g.dtype, device=g.device)), None, None


def reassign(contrib: torch.Tensor, k_idx: torch.Tensor, n_bins: int) -> torch.Tensor:
    """K6: (..., S, N) complex64 contributions and integer bin indices ->
    (..., n_bins, N) complex64 squeezed plane. Computes in float32, as the
    TPU kernel does: 64-bit input raises rather than being cut silently."""
    if contrib.dtype in (torch.complex128, torch.float64):
        raise JWaveFailure(
            "reassign_pallas - the Pallas kernel computes in float32; use "
            "reassign='dense' or 'scatter' for 64-bit inputs"
        )
    return _Reassign.apply(contrib, k_idx, n_bins)
