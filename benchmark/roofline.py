"""The least time the card could take for each kernel's work.

The work of one call of a kernel is counted from its shapes: each input
byte read once and each output byte written once, whatever the kernel
reads again, and the multiply-adds its definition needs. The bound is the
larger of bytes over the card's memory rate and operations over its
float32 rate outside the tensor cores: NVIDIA's data sheet of the H100 SXM
(3.35 TB/s of HBM3, 67 TFLOP/s float32), which assumes the full 700 W; the
card's own power limit is printed beside every run (:func:`card_line`).

Kernels are named as the port's launch counters name them (K1..K9), with
the symbols by which a profiler trace lists their device work.
"""
from __future__ import annotations

import re
import subprocess

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

#: kernel -> the symbols of its device functions in a trace
SYMBOLS = {
    "K1": ("modwt_fwd_kernel",),
    "K2": ("modwt_inv_kernel",),
    "K3": ("pyramid_tile_kernel", "pyramid_tail_kernel"),
    "K4": ("pyramid_rows_t_kernel",),
    "K5": ("ipyramid_rows_t_kernel",),
    "K6": ("reassign_kernel",),
    "K7": ("ipyramid_tile_kernel",),
    "K8": ("wpt_analysis_kernel",),
    "K9": ("wpt_synthesis_kernel",),
}


def kernel_of(trace_name: str) -> str | None:
    """The kernel (K1..K9) whose device function a trace event names."""
    for k, syms in SYMBOLS.items():
        for s in syms:
            if re.search(rf"(?<![A-Za-z0-9_]){s}(?=[<(])", trace_name):
                return k
    return None


def _steps(n: int, levels: int) -> list[int]:
    """Lengths h = n, n/2, ... of the pyramid's steps (h >= 2)."""
    hs, h = [], n
    while h >= 2 and len(hs) < levels:
        hs.append(h)
        h //= 2
    return hs


def modwt_cascade(rows: int, n: int, level: int, taps: int, itemsize: int = 4):
    """K1 (or its inverse K2, the same counts): (rows, n) in, (rows,
    level+1, n) out; per sample and level two filters of ``taps``
    multiply-adds. Returns (bytes, flops)."""
    return itemsize * rows * n * (level + 2), 2 * 2 * taps * rows * n * level


def pyramid_rows(rows: int, n: int, levels: int, taps: int, itemsize: int = 4):
    """K3, K4, K5 or K7: one pyramid (or its inverse) along rows of ``n``;
    (rows, n) in and out; a step on h samples makes h outputs of ``taps``
    multiply-adds. Returns (bytes, flops)."""
    return 2 * itemsize * rows * n, sum(2 * taps * h for h in _steps(n, levels)) * rows


def bound_s(nbytes: float, flops: float) -> float:
    """Seconds: the larger of the byte time and the operation time."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip() or out.stderr.strip()
