"""K1/K2: the fused MODWT cascade (``csrc/modwt.cu``), with plain versions.

Replaces ``jwave_tpu/ops/pallas_modwt.py`` (``_modwt_kernel``,
``_imodwt_kernel``). For levels j with gap 2^(j-1):

    forward  W_j[t] = sum_m h0[m] V_{j-1}[(t - m*gap) mod N],  V_j likewise with g0
    inverse  V_{j-1}[t] = sum_m g0[m] V_j[(t + m*gap) mod N] + h0[m] W_j[(t + m*gap) mod N]

``g0, h0`` are the MODWT base filters (unit L2 norm, then / sqrt(2)).
Storage is float32 or bfloat16; the kernels accumulate in float32.

:func:`modwt_cascade` and :func:`imodwt_cascade` launch the kernels for a
CUDA tensor and take the plain versions only for a tensor on the CPU. The
plain versions are public so that tests and ``chip_smoke.py`` can call them
by name.
"""
from __future__ import annotations

import ctypes

import torch

from ..exceptions import JWaveFailure
from . import cuda_build

#: launches of each kernel since the last :func:`reset_launch_counts`
launch_counts = {"modwt_cascade": 0, "imodwt_cascade": 0}

MAX_TAPS = 64
#: outputs of one row per block, and the f32 samples one shared buffer holds
TILE = 2048
BUF_FLOATS = 8192

_STORAGE = (torch.float32, torch.bfloat16)


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


# ----------------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------------

def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def modwt_cascade_torch(x: torch.Tensor, g0, h0, level: int) -> torch.Tensor:
    """(B, N) -> (B, level+1, N) rows [W_1..W_J, V_J] by rolls and FMAs."""
    v = x.to(_acc_dtype(x))
    rows = []
    for j in range(1, level + 1):
        gap = 1 << (j - 1)
        w = torch.zeros_like(v)
        vn = torch.zeros_like(v)
        for m in range(len(g0)):
            r = torch.roll(v, m * gap, dims=-1)  # r[t] = v[(t - m*gap) mod N]
            w = w + float(h0[m]) * r
            vn = vn + float(g0[m]) * r
        rows.append(w)
        v = vn
    rows.append(v)
    return torch.stack(rows, dim=-2).to(x.dtype)


def imodwt_cascade_torch(coeffs: torch.Tensor, g0, h0) -> torch.Tensor:
    """(B, J+1, N) -> (B, N) by rolls and FMAs."""
    c = coeffs.to(_acc_dtype(coeffs))
    level = c.shape[-2] - 1
    v = c[..., level, :]
    for j in range(level, 0, -1):
        gap = 1 << (j - 1)
        w = c[..., j - 1, :]
        acc = torch.zeros_like(v)
        for m in range(len(g0)):
            # roll by -m*gap: r[t] = v[(t + m*gap) mod N]
            acc = acc + float(g0[m]) * torch.roll(v, -m * gap, dims=-1)
            acc = acc + float(h0[m]) * torch.roll(w, -m * gap, dims=-1)
        v = acc
    return v.to(coeffs.dtype)


# ----------------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------------

def level_groups(n: int, m: int, level: int) -> list[tuple[int, int, bool]]:
    """Split levels 1..level into runs (j0, j1, staged) whose tile plus halo
    (M-1)(2^j1 - 2^(j0-1)) fits one shared buffer; a level whose halo alone
    does not fit runs unstaged, straight from device memory."""
    tl = min(TILE, n)
    groups = []
    j = 1
    while j <= level:
        if tl + (m - 1) * (1 << (j - 1)) > BUF_FLOATS:
            groups.append((j, j, False))
            j += 1
            continue
        k = j
        while k < level and tl + (m - 1) * ((1 << (k + 1)) - (1 << (j - 1))) <= BUF_FLOATS:
            k += 1
        groups.append((j, k, True))
        j = k + 1
    return groups


def _check_cuda(t: torch.Tensor, ndim: int, what: str):
    if t.device.type != "cuda":
        raise JWaveFailure(f"{what} - tensor on {t.device}; the kernel runs on CUDA tensors")
    if t.dtype not in _STORAGE:
        raise JWaveFailure(f"{what} - dtype {t.dtype}; the kernel takes float32 or bfloat16")
    if t.dim() != ndim:
        raise JWaveFailure(f"{what} - expected a {ndim}-D tensor, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise JWaveFailure(f"{what} - tensor must be contiguous")
    if t.requires_grad:
        raise JWaveFailure(f"{what} - gradients through the CUDA kernel are not available "
                           "yet; they come with a torch.autograd.Function in a later release")


def _check_filters(g0, h0, level: int, what: str):
    if len(g0) != len(h0) or not 1 <= len(g0) <= MAX_TAPS:
        raise JWaveFailure(f"{what} - filters must have equal length in [1, {MAX_TAPS}]")
    if not 1 <= level <= 13:
        raise JWaveFailure(f"{what} - level must be in [1, 13], got {level}")


def _entry(lib, name, dtype):
    fn = getattr(lib, f"{name}_{'f32' if dtype == torch.float32 else 'bf16'}")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "jw_modwt_fwd":
            fn.argtypes = [p, i, p, p, p, i, i, i, i, i, i, i, i, p]
        else:
            fn.argtypes = [p, p, i, ctypes.c_longlong, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def modwt_cascade(x: torch.Tensor, g0, h0, level: int) -> torch.Tensor:
    """K1: forward MODWT cascade (B, N) -> (B, level+1, N)."""
    if x.device.type == "cpu":
        return modwt_cascade_torch(x, g0, h0, level)
    _check_cuda(x, 2, "modwt_cascade")
    _check_filters(g0, h0, level, "modwt_cascade")
    b, n = x.shape
    m = len(g0)
    out = torch.empty((b, level + 1, n), dtype=x.dtype, device=x.device)
    if b == 0 or n == 0:
        return out
    lib = cuda_build.library("modwt")
    fn = _entry(lib, "jw_modwt_fwd", x.dtype)
    taps = cuda_build.device_taps(g0, h0, x.device)
    stream = cuda_build.stream_handle(x.device)
    groups = level_groups(n, m, level)
    scratch = [torch.empty((b, n), dtype=torch.float32, device=x.device)
               for _ in range(min(len(groups) - 1, 2))]
    src, src_f32 = x, 0
    for gi, (j0, j1, staged) in enumerate(groups):
        vnext = scratch[gi % 2] if j1 < level else None
        err = fn(src.data_ptr(), src_f32, out.data_ptr(),
                 vnext.data_ptr() if vnext is not None else None, taps.data_ptr(),
                 b, n, m, level, j0, j1, TILE, int(staged), stream)
        cuda_build.check(lib, err, "modwt_cascade")
        launch_counts["modwt_cascade"] += 1
        src, src_f32 = vnext, 1
    return out


def imodwt_cascade(coeffs: torch.Tensor, g0, h0) -> torch.Tensor:
    """K2: inverse MODWT cascade (B, J+1, N) -> (B, N)."""
    if coeffs.device.type == "cpu":
        return imodwt_cascade_torch(coeffs, g0, h0)
    _check_cuda(coeffs, 3, "imodwt_cascade")
    b, jp1, n = coeffs.shape
    level = jp1 - 1
    _check_filters(g0, h0, level, "imodwt_cascade")
    m = len(g0)
    out = torch.empty((b, n), dtype=coeffs.dtype, device=coeffs.device)
    if b == 0 or n == 0:
        return out
    lib = cuda_build.library("modwt")
    fn = _entry(lib, "jw_imodwt", coeffs.dtype)
    taps = cuda_build.device_taps(g0, h0, coeffs.device)
    stream = cuda_build.stream_handle(coeffs.device)
    groups = level_groups(n, m, level)[::-1]
    scratch = [torch.empty((b, n), dtype=torch.float32, device=coeffs.device)
               for _ in range(min(len(groups) - 1, 2))]
    # V_J is row `level` of the coefficients; later groups read f32 scratch
    vsrc_ptr, vsrc_f32, vstride = coeffs.data_ptr() + level * n * coeffs.element_size(), 0, jp1 * n
    for gi, (j0, j1, staged) in enumerate(groups):
        vnext = scratch[gi % 2] if j0 > 1 else None
        err = fn(coeffs.data_ptr(), vsrc_ptr, vsrc_f32, vstride, out.data_ptr(),
                 vnext.data_ptr() if vnext is not None else None, taps.data_ptr(),
                 b, n, m, level, j0, j1, TILE, int(staged), stream)
        cuda_build.check(lib, err, "imodwt_cascade")
        launch_counts["imodwt_cascade"] += 1
        if vnext is not None:
            vsrc_ptr, vsrc_f32, vstride = vnext.data_ptr(), 1, n
    return out
