"""Multi-level fused WPT via composite (noble-identity) filter banks.

The reference applies the butterfly level by level, reading and writing the
whole array once per level (WaveletPacketTransform.java:96-124). The noble
identities collapse L levels into ONE circular convolution: the packet at
path (c_1, ..., c_L) (c = lo|hi per level) is

    out_b[i] = sum_m x[(2^L i + m) mod N] * F_b[m],
    F_b = c_1 (*) U_2(c_2) (*) U_4(c_3) (*) ... (*) U_{2^{L-1}}(c_L),

with U_k = upsample-by-k and (*) linear convolution (made on the host in
float64). The fused form reads the input once: one ``conv1d`` with 2^L
output channels and stride 2^L over the circularly extended signal
(``conv1d`` correlates, as the formula does, so the bank is not flipped).
The inverse is its adjoint: ``conv_transpose1d`` with the synthesis bank
and stride 2^L, then the full linear result folded modulo N.

Packet ordering matches the reference: the level-1 choice is the most
significant bit of the output block index.

Routing: on a CUDA float32 tensor :func:`wpt_fused_forward` and
:func:`wpt_fused_inverse` run the hand kernels K8 and K9
(``ops.cuda_wpt.wpt_rows``, ``iwpt_rows``: the level cascade in shared
memory, the interleaved layout stored and read in place). The conv form
(:func:`wpt_conv_forward`, :func:`wpt_conv_inverse`) runs everywhere else:
the CPU, float64, bf16 and f16.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .. import config
from . import cuda_wpt
from .butterfly import ensure_float


def _upsample_k(f: np.ndarray, k: int) -> np.ndarray:
    if k <= 1:
        return f
    out = np.zeros((f.shape[0] - 1) * k + 1, dtype=np.float64)
    out[::k] = f
    return out


def composite_filters(dec_lo: np.ndarray, dec_hi: np.ndarray, levels: int) -> np.ndarray:
    """(2^L, M_L) composite analysis bank, M_L = (M-1)(2^L - 1) + 1."""
    banks = [np.array([1.0])]
    for l in range(levels):
        lo = _upsample_k(np.asarray(dec_lo, dtype=np.float64), 1 << l)
        hi = _upsample_k(np.asarray(dec_hi, dtype=np.float64), 1 << l)
        banks = [np.convolve(f, c) for f in banks for c in (lo, hi)]
    m = max(f.shape[0] for f in banks)
    return np.stack([np.pad(f, (0, m - f.shape[0])) for f in banks])


def _wrap_bank(bank: np.ndarray, n: int) -> np.ndarray:
    """Accumulate each filter's taps modulo ``n`` where it is longer than ``n``."""
    if bank.shape[1] <= n:
        return bank
    out = np.zeros((bank.shape[0], n), dtype=np.float64)
    idx = np.arange(bank.shape[1]) % n
    for r in range(bank.shape[0]):
        np.add.at(out[r], idx, bank[r])
    return out


@lru_cache(maxsize=64)
def _device_bank(lo: bytes, hi: bytes, levels: int, n: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """(2^L, 1, M) wrapped composite bank on ``device``, made once per key, so
    that a call uploads nothing."""
    bank = _wrap_bank(composite_filters(np.frombuffer(lo), np.frombuffer(hi), levels), n)
    return torch.as_tensor(bank[:, None, :], dtype=dtype, device=device)


def _bank(lo, hi, levels: int, n: int, like: torch.Tensor) -> torch.Tensor:
    as_bytes = [np.ascontiguousarray(f, dtype=np.float64).tobytes() for f in (lo, hi)]
    return _device_bank(*as_bytes, levels, n, like.dtype, like.device)


def _on_kernel(x: torch.Tensor) -> bool:
    return x.device.type == "cuda" and x.dtype == torch.float32


def _to_interleaved(y: torch.Tensor, levels: int) -> torch.Tensor:
    """Subband-major (..., N) coefficients in the interleaved layout:
    position i of subband s at i * 2^L + s."""
    n = y.shape[-1]
    s = 1 << levels
    return y.reshape(-1, s, n // s).transpose(1, 2).reshape(y.shape)


def _to_subband(y: torch.Tensor, levels: int) -> torch.Tensor:
    """Inverse of :func:`_to_interleaved`."""
    n = y.shape[-1]
    s = 1 << levels
    return y.reshape(-1, n // s, s).transpose(1, 2).reshape(y.shape)


def wpt_fused_forward(x: torch.Tensor, dec_lo, dec_hi, levels: int,
                      interleaved: bool = False) -> torch.Tensor:
    """L levels of WPT on the last axis of (..., N), subband-major or
    ``interleaved``: K8 on a CUDA float32 tensor, else the conv form."""
    x = ensure_float(x)
    n = x.shape[-1]
    if _on_kernel(x):
        flat = x.reshape(-1, n).contiguous()
        return cuda_wpt.wpt_rows(flat, dec_lo, dec_hi, levels,
                                 interleaved=interleaved).reshape(x.shape)
    out = wpt_conv_forward(x, dec_lo, dec_hi, levels)
    return _to_interleaved(out, levels) if interleaved else out


def wpt_fused_inverse(y: torch.Tensor, rec_lo, rec_hi, levels: int, recon_gain: float = 1.0,
                      interleaved: bool = False) -> torch.Tensor:
    """Adjoint of :func:`wpt_fused_forward` with the synthesis pair, times
    ``recon_gain ** levels``, reading either layout: K9 on a CUDA float32
    tensor, else the conv form."""
    y = ensure_float(y)
    n = y.shape[-1]
    if _on_kernel(y):
        flat = y.reshape(-1, n).contiguous()
        return cuda_wpt.iwpt_rows(flat, rec_lo, rec_hi, levels, recon_gain,
                                  interleaved).reshape(y.shape)
    return wpt_conv_inverse(_to_subband(y, levels) if interleaved else y, rec_lo, rec_hi, levels,
                            recon_gain)


def wpt_conv_forward(x: torch.Tensor, dec_lo, dec_hi, levels: int) -> torch.Tensor:
    """L levels of WPT in one strided circular conv. x: (..., N)."""
    x = ensure_float(x)
    n = x.shape[-1]
    w = _bank(dec_lo, dec_hi, levels, n, x)
    pad = w.shape[-1] - 1
    ext = torch.cat([x] * (-(-pad // n) + 1), dim=-1)[..., :n + pad] if pad else x
    with config.dial():
        out = F.conv1d(ext.reshape(-1, 1, n + pad), w, stride=1 << levels)  # (B, 2^L, N/2^L)
    return out.reshape(x.shape)


def wpt_conv_inverse(y: torch.Tensor, rec_lo, rec_hi, levels: int,
                     recon_gain: float = 1.0) -> torch.Tensor:
    """Adjoint of :func:`wpt_conv_forward` (synthesis bank, transposed conv)."""
    y = ensure_float(y)
    n = y.shape[-1]
    stride = 1 << levels
    w = _bank(rec_lo, rec_hi, levels, n, y)
    blocks = y.reshape(-1, stride, n // stride)
    # full[q] = sum_b sum_i blocks[b, i] F_b[q - stride*i], length n - stride + M
    with config.dial():
        full = F.conv_transpose1d(blocks, w, stride=stride)[:, 0]
    total = full.shape[-1]
    folds = -(-total // n)
    # the circular result: x[k] = sum over q = k mod n of full[q]
    res = F.pad(full, (0, folds * n - total)).reshape(-1, folds, n).sum(dim=1).reshape(y.shape)
    gain = recon_gain ** levels
    if gain != 1.0:
        res = res * gain
    return res
