"""SPMD sharded transforms over a device mesh, on ``torch.distributed``.

The JAX package's patterns (``jwave_tpu/parallel/sharded.py``), one process
per device:

  * all_to_all: the distributed transpose of the separable 2D/3D
    transforms and the 2D MODWT;
  * a ring shift (``ppermute``): neighbour halo exchange of filter-support
    samples for the time-sharded MODWT and FWT;
  * none at all: CWT scales and signal batches shard embarrassingly;
  * the distributed four-step FFT (:mod:`.pfft`) under the MODWT and CWT of
    signals larger than one device holds.

Each function takes the global value (the same on every rank, or a DTensor
on the mesh) and returns a DTensor laid out as the JAX function's
``out_specs`` (see :mod:`._layout`). Every check that the JAX package makes
before its program runs is made on every rank before the first collective,
so every rank raises the same :class:`JWaveFailure`. The local bodies are
the port's single-device functions, so on the card the kernels run inside
them: K3 in the 2D/3D FWT passes and the halo FWT's tail, K6 in the
synchrosqueezing squeeze, K1/K2 in a batch-sharded MODWT.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from .. import config
from ..cwavelets import get_continuous_wavelet
from ..exceptions import JWaveFailure
from ..filters import get_filter
from ..ops.butterfly import ensure_float, taps
from ..transforms.cwt import CWTResult, PaddingType, _signal, _time_axis, cwt
from ..transforms.fwt import _check_pow2, fwt, ifwt
from ..transforms.modwt import _level_filters, _modwt_base_filters, _validate_level, imodwt, modwt
from ..transforms.ssq import SSQResult, _cwt_and_derivative, _default_bins, _log_measure, \
    _squeeze_plane
from ..transforms.wpt import _check as _wpt_check, iwpt, wpt
from ..utils.host import host_array
from ..utils.numerics import exponent_of_two, is_power_of_two
from ._collectives import all_gather, all_to_all, axis_index, axis_size, pmax, psum, ring_shift
from ._layout import global_input, local_block, mesh_device, sharded_output
from .pfft import _check_geometry, pfft_local, pifft_local


def _fb_key(fb) -> tuple:
    """A bank's cache key: its coefficient bytes, never its name alone, so a
    custom FilterBank that shares a builtin's name gets its own constants."""
    return (fb.name, fb.dec_lo.tobytes(), fb.dec_hi.tobytes(), fb.rec_lo.tobytes(),
            fb.rec_hi.tobytes(), float(fb.recon_gain))


# --------------------------------------------------------------------------
# batch sharding (pure data parallelism)
# --------------------------------------------------------------------------

def batch_sharded(fn, mesh: DeviceMesh, axis_name: str | None = None):
    """Wrap ``fn(x)`` so the leading axis of input and output shards across
    the mesh: each rank transforms its own rows, with no communication."""
    axis_name = axis_name or mesh.mesh_dim_names[0]

    def run(x):
        x = global_input(x, mesh)
        y = fn(local_block(x, mesh, {axis_name: 0}))
        return sharded_output(y, mesh, {axis_name: 0}, (x.shape[0],) + tuple(y.shape[1:]))

    return run


# --------------------------------------------------------------------------
# CWT and synchrosqueezing: scales sharded across ranks
# --------------------------------------------------------------------------

def _scale_block(scales: np.ndarray, mesh: DeviceMesh, axis: str) -> slice:
    s_loc = scales.shape[0] // axis_size(mesh, axis)
    r = axis_index(mesh, axis)
    return slice(r * s_loc, (r + 1) * s_loc)


def cwt_scale_sharded(
    signal,
    scales,
    wavelet,
    mesh: DeviceMesh,
    sampling_rate: float = 1.0,
    padding: PaddingType = PaddingType.SYMMETRIC,
    axis_name: str | None = None,
) -> CWTResult:
    """FFT-based CWT with the scales axis sharded over the mesh: every rank
    takes the FFT of the whole signal and applies its own block of wavelet
    spectra, with no collective. Coefficients (..., S, N) sharded on S."""
    axis_name = axis_name or mesh.mesh_dim_names[0]
    n_dev = axis_size(mesh, axis_name)
    wav = get_continuous_wavelet(wavelet)
    scales = np.atleast_1d(host_array(scales, np.float64))
    if scales.shape[0] % n_dev != 0:
        raise JWaveFailure(
            f"cwt_scale_sharded - number of scales {scales.shape[0]} must divide "
            f"evenly over {n_dev} devices"
        )
    signal = global_input(signal, mesh)
    n = signal.shape[-1]
    fs = float(sampling_rate)
    local = cwt(local_block(signal, mesh, {}), scales[_scale_block(scales, mesh, axis_name)],
                wav, fs, padding).coefficients
    coeffs = sharded_output(local, mesh, {axis_name: signal.dim() - 1},
                            tuple(signal.shape[:-1]) + (scales.shape[0], n))
    return CWTResult(coeffs, torch.as_tensor(scales, device=local.device),
                     _time_axis(n, fs, local), fs, wav.name)


def ssq_scale_sharded(
    signal,
    scales,
    wavelet,
    mesh: DeviceMesh,
    sampling_rate: float = 1.0,
    padding: PaddingType = PaddingType.SYMMETRIC,
    frequencies=None,
    gamma: float | None = None,
    out_of_range: str = "clip",
    reassign: str = "auto",
    axis_name: str | None = None,
) -> SSQResult:
    """Synchrosqueezed CWT with the scales axis sharded over the mesh.

    Each rank evaluates its block of wavelet and derivative spectra and
    squeezes it into the full frequency-bin grid (K6 on the card for a
    float32 signal); one ``psum`` adds the planes, since reassignment is a
    per-scale scatter. The default |W| threshold needs the global maximum,
    one ``pmax``. ``Tx`` is replicated. Matches :func:`ssq_cwt` (same
    weights, same grid) up to the order of the sum.
    """
    axis_name = axis_name or mesh.mesh_dim_names[0]
    n_dev = axis_size(mesh, axis_name)
    wav = get_continuous_wavelet(wavelet)
    if not wav.is_analytic:
        raise JWaveFailure(
            f"ssq_scale_sharded - synchrosqueezing needs an analytic wavelet "
            f"(Morlet, Paul, Morse); got {wav.name!r}"
        )
    scales_np = np.atleast_1d(host_array(scales, np.float64))
    if scales_np.shape[0] % n_dev != 0:
        raise JWaveFailure(
            f"ssq_scale_sharded - number of scales {scales_np.shape[0]} must "
            f"divide evenly over {n_dev} devices"
        )
    if scales_np.shape[0] < 2:
        raise JWaveFailure("ssq_scale_sharded - need at least 2 scales")
    freqs_np = _default_bins(scales_np, wav.center_frequency, frequencies)
    # the log measure needs neighbour scales: computed on the global grid
    wgt_np = scales_np ** -0.5 * _log_measure(scales_np)
    fs = float(sampling_rate)
    signal = _signal(local_block(global_input(signal, mesh), mesh, {}))
    dev = signal.device
    blk = _scale_block(scales_np, mesh, axis_name)
    wgt = torch.as_tensor(wgt_np[blk], device=dev)
    W, dW = _cwt_and_derivative(signal, scales_np[blk], wav, fs, padding)
    if gamma is None:
        mag2 = W.real ** 2 + W.imag ** 2
        gmax = pmax(torch.amax(mag2, dim=(-2, -1), keepdim=True), mesh, axis_name)
        eps = torch.finfo(W.real.dtype).eps
        gamma_abs = 10.0 * math.sqrt(eps) * torch.sqrt(gmax)
    else:
        gamma_abs = torch.as_tensor(gamma, dtype=W.real.dtype, device=dev)
    tx = psum(_squeeze_plane(W, dW, wgt, freqs_np, gamma_abs, out_of_range, reassign),
              mesh, axis_name)
    return SSQResult(sharded_output(tx, mesh, {}, tx.shape), torch.as_tensor(freqs_np, device=dev),
                     torch.as_tensor(scales_np, device=dev), _time_axis(signal.shape[-1], fs, tx),
                     fs, wav.name)


def cwt_batch_scale_sharded(
    signals,
    scales,
    wavelet,
    mesh: DeviceMesh,
    sampling_rate: float = 1.0,
    padding: PaddingType = PaddingType.SYMMETRIC,
    batch_axis: str | None = None,
    scale_axis: str | None = None,
) -> CWTResult:
    """CWT over a 2D mesh: signals data-parallel on one axis, scales on the
    other. ``signals`` is (B, N); the coefficients (B, S, N) are sharded
    (batch_axis, scale_axis, None). No collective."""
    names = mesh.mesh_dim_names
    if len(names) < 2:
        raise JWaveFailure("cwt_batch_scale_sharded - needs a 2D mesh (batch, scale axes)")
    batch_axis = batch_axis or names[0]
    scale_axis = scale_axis or names[1]
    nb, ns = axis_size(mesh, batch_axis), axis_size(mesh, scale_axis)
    wav = get_continuous_wavelet(wavelet)
    scales = np.atleast_1d(host_array(scales, np.float64))
    signals = global_input(signals, mesh)
    if signals.dim() != 2:
        raise JWaveFailure("cwt_batch_scale_sharded - signals must be (B, N)")
    if signals.shape[0] % nb or scales.shape[0] % ns:
        raise JWaveFailure(
            f"cwt_batch_scale_sharded - batch {signals.shape[0]} and scales "
            f"{scales.shape[0]} must divide over mesh {nb}x{ns}"
        )
    n = signals.shape[-1]
    fs = float(sampling_rate)
    local = cwt(local_block(signals, mesh, {batch_axis: 0}),
                scales[_scale_block(scales, mesh, scale_axis)], wav, fs, padding).coefficients
    coeffs = sharded_output(local, mesh, {batch_axis: 0, scale_axis: 1},
                            (signals.shape[0], scales.shape[0], n))
    return CWTResult(coeffs, torch.as_tensor(scales, device=local.device),
                     _time_axis(n, fs, local), fs, wav.name)


# --------------------------------------------------------------------------
# separable 2D and 3D transforms: row (slab) shards + all_to_all transposes
# --------------------------------------------------------------------------

_PASSES = {"fwt": fwt, "ifwt": ifwt, "wpt": wpt, "iwpt": iwpt}


def _check_pass(kind: str, n: int, level):
    """The checks of one local pass along an axis of length ``n``."""
    if kind in ("wpt", "iwpt"):
        _wpt_check(torch.empty(0, n), level, "subband", kind)
        return
    _check_pow2(n, kind)
    steps = exponent_of_two(n)
    if level is not None and not 0 <= level <= steps:
        raise JWaveFailure(f"{kind} - level {level} out of range [0, {steps}]")


def _sharded_2d(kind, mat, wavelet, mesh: DeviceMesh, level_rows, level_cols, axis_name):
    """Rows-local pass -> all_to_all transpose -> columns-local pass ->
    all_to_all back: each element crosses the interconnect twice."""
    fb = get_filter(wavelet)
    fwd = _PASSES[kind]
    axis_name = axis_name or mesh.mesh_dim_names[0]
    n_dev = axis_size(mesh, axis_name)
    mat = global_input(mat, mesh)
    rows, cols = mat.shape
    if rows % n_dev or cols % n_dev:
        raise JWaveFailure(
            f"sharded 2D transform - matrix {rows}x{cols} must tile evenly "
            f"over {n_dev} devices on both axes"
        )
    _check_pass(kind, cols, level_cols)
    _check_pass(kind, rows, level_rows)
    y = fwd(local_block(mat, mesh, {axis_name: 0}), fb, level_cols)  # (R/D, C)
    r, c = y.shape[0], cols // n_dev
    y = all_to_all(y.reshape(r, n_dev, c), mesh, axis_name, 1, 0)  # (D, r, c)
    y = y.reshape(n_dev * r, c)  # (R, c): this rank now owns a column chunk
    y = fwd(y.transpose(0, 1), fb, level_rows).transpose(0, 1)
    y = all_to_all(y.reshape(n_dev, r, c), mesh, axis_name, 0, 1)  # (r, D, c)
    return sharded_output(y.reshape(r, cols), mesh, {axis_name: 0}, (rows, cols))


def fwt2d_sharded(mat, wavelet, mesh: DeviceMesh, level_rows=None, level_cols=None,
                  axis_name=None):
    """2D FWT with the matrix row-sharded across the mesh; the result is
    row-sharded too."""
    return _sharded_2d("fwt", mat, wavelet, mesh, level_rows, level_cols, axis_name)


def ifwt2d_sharded(mat, wavelet, mesh: DeviceMesh, level_rows=None, level_cols=None,
                   axis_name=None):
    return _sharded_2d("ifwt", mat, wavelet, mesh, level_rows, level_cols, axis_name)


def wpt2d_sharded(mat, wavelet, mesh: DeviceMesh, level_rows=None, level_cols=None,
                  axis_name=None):
    return _sharded_2d("wpt", mat, wavelet, mesh, level_rows, level_cols, axis_name)


def iwpt2d_sharded(mat, wavelet, mesh: DeviceMesh, level_rows=None, level_cols=None,
                   axis_name=None):
    return _sharded_2d("iwpt", mat, wavelet, mesh, level_rows, level_cols, axis_name)


def _sharded_3d(kind, vol, wavelet, mesh: DeviceMesh, level_p, level_q, level_r, axis_name):
    """The volume's leading axis sharded into slabs: the two local axes
    transform as batched passes, and the sharded axis is brought local by
    one all_to_all transpose pair."""
    fb = get_filter(wavelet)
    fwd = _PASSES[kind]
    axis_name = axis_name or mesh.mesh_dim_names[0]
    n_dev = axis_size(mesh, axis_name)
    vol = global_input(vol, mesh)
    pp, qq, rr = vol.shape
    if pp % n_dev or qq % n_dev:
        raise JWaveFailure(
            f"sharded 3D transform - volume {pp}x{qq}x{rr} must tile evenly "
            f"over {n_dev} devices on its first two axes"
        )
    for n, level in ((rr, level_r), (qq, level_q), (pp, level_p)):
        _check_pass(kind, n, level)
    y = fwd(local_block(vol, mesh, {axis_name: 0}), fb, level_r)  # along R
    y = fwd(y.transpose(-1, -2), fb, level_q).transpose(-1, -2)  # along Q
    p, q = y.shape[0], qq // n_dev
    y = all_to_all(y.reshape(p, n_dev, q, rr), mesh, axis_name, 1, 0)  # (D, p, q, R)
    y = y.reshape(n_dev * p, q, rr)  # (P, q, R): this rank owns a Q chunk
    y = fwd(y.movedim(0, -1), fb, level_p).movedim(-1, 0)  # along P
    y = all_to_all(y.reshape(n_dev, p, q, rr), mesh, axis_name, 0, 1)  # (p, D, q, R)
    return sharded_output(y.reshape(p, qq, rr), mesh, {axis_name: 0}, (pp, qq, rr))


def fwt3d_sharded(vol, wavelet, mesh: DeviceMesh, level_p=None, level_q=None, level_r=None,
                  axis_name=None):
    """3D FWT with the volume slab-sharded across the mesh."""
    return _sharded_3d("fwt", vol, wavelet, mesh, level_p, level_q, level_r, axis_name)


def ifwt3d_sharded(vol, wavelet, mesh: DeviceMesh, level_p=None, level_q=None, level_r=None,
                   axis_name=None):
    return _sharded_3d("ifwt", vol, wavelet, mesh, level_p, level_q, level_r, axis_name)


def wpt3d_sharded(vol, wavelet, mesh: DeviceMesh, level_p=None, level_q=None, level_r=None,
                  axis_name=None):
    return _sharded_3d("wpt", vol, wavelet, mesh, level_p, level_q, level_r, axis_name)


def iwpt3d_sharded(vol, wavelet, mesh: DeviceMesh, level_p=None, level_q=None, level_r=None,
                   axis_name=None):
    return _sharded_3d("iwpt", vol, wavelet, mesh, level_p, level_q, level_r, axis_name)


# --------------------------------------------------------------------------
# MODWT: time axis sharded with halo exchange
# --------------------------------------------------------------------------

def _conv_valid_1d(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Valid correlation of a 1D tensor with ``kernel`` (as ``conv1d``)."""
    with config.dial():
        return F.conv1d(x[None, None], taps(kernel, x)[None, None])[0, 0]


def modwt_halo_sharded(signal, wavelet, level: int, mesh: DeviceMesh,
                       axis_name: str | None = None):
    """Forward MODWT with the time axis sharded across the mesh.

    Per level each rank convolves its local chunk after one ring shift
    brings the level filter's support (L_j - 1 samples) from its left
    neighbour. Requires that halo <= local chunk; beyond that depth use
    :func:`modwt_fft_sharded`. Returns the (J+1, N) stack sharded on N.
    """
    axis_name = axis_name or mesh.mesh_dim_names[0]
    n_dev = axis_size(mesh, axis_name)
    signal = global_input(signal, mesh)
    n = signal.shape[-1]
    if signal.dim() != 1:
        raise JWaveFailure(
            "modwt_halo_sharded - expects a 1D signal (use batch_sharded for batches)")
    if n % n_dev:
        raise JWaveFailure(f"modwt_halo_sharded - length {n} must divide over {n_dev} devices")
    _validate_level(n, level, "modwt_halo_sharded")
    n_loc = n // n_dev
    filters = _level_filters(wavelet, level, n)
    for gj, _ in filters:
        if gj.shape[0] - 1 > n_loc:
            raise JWaveFailure(
                f"modwt_halo_sharded - level filter support {gj.shape[0]} exceeds local "
                f"chunk {n_loc}; lower the level or use fewer devices"
            )
    v = ensure_float(local_block(signal, mesh, {axis_name: 0}))
    rows = []
    for gj, hj in filters:
        halo = gj.shape[0] - 1
        ext = torch.cat([ring_shift(v[-halo:], mesh, axis_name, 1), v]) if halo > 0 else v
        rows.append(_conv_valid_1d(ext, hj[::-1]))
        v = _conv_valid_1d(ext, gj[::-1])
    rows.append(v)
    return sharded_output(torch.stack(rows), mesh, {axis_name: 1}, (level + 1, n))


def imodwt_halo_sharded(coeffs, wavelet, mesh: DeviceMesh, axis_name: str | None = None):
    """Inverse MODWT of time-sharded (J+1, N) coefficients: the adjoint
    convolution needs the right neighbour's head, one ring shift per level
    and row in the opposite direction."""
    axis_name = axis_name or mesh.mesh_dim_names[0]
    n_dev = axis_size(mesh, axis_name)
    coeffs = global_input(coeffs, mesh)
    level = coeffs.shape[-2] - 1
    n = coeffs.shape[-1]
    if n % n_dev:
        raise JWaveFailure(f"imodwt_halo_sharded - length {n} must divide over {n_dev} devices")
    n_loc = n // n_dev
    filters = _level_filters(wavelet, level, n)
    for gj, _ in filters:
        if gj.shape[0] - 1 > n_loc:
            raise JWaveFailure(
                f"imodwt_halo_sharded - level filter support {gj.shape[0]} exceeds local "
                f"chunk {n_loc}"
            )
    c = ensure_float(local_block(coeffs, mesh, {axis_name: coeffs.dim() - 1}))
    v = c[level]
    for j in range(level, 0, -1):
        gj, hj = filters[j - 1]
        halo = gj.shape[0] - 1
        w = c[j - 1]
        if halo > 0:
            v = torch.cat([v, ring_shift(v[:halo], mesh, axis_name, -1)])
            w = torch.cat([w, ring_shift(w[:halo], mesh, axis_name, -1)])
        v = _conv_valid_1d(v, gj) + _conv_valid_1d(w, hj)
    return sharded_output(v, mesh, {axis_name: 0}, (n,))


# --------------------------------------------------------------------------
# FWT: time axis sharded with halo exchange (distributed pyramid)
# --------------------------------------------------------------------------

def _butterfly_halo(v: torch.Tensor, dec_lo, dec_hi, mesh: DeviceMesh, axis: str):
    """One analysis butterfly on a time-sharded block (last axis, batched
    over leading axes): each rank computes its contiguous share of approx
    and detail from its samples and an M-2 right halo from the next rank."""
    lead, n_loc = v.shape[:-1], v.shape[-1]
    halo = max(int(dec_lo.shape[0]) - 2, 0)
    ext = torch.cat([v, ring_shift(v[..., :halo], mesh, axis, -1)], dim=-1) if halo else v
    if n_loc == 2:
        # conv1d sums a single output in another order on the CPU; two
        # outputs keep the single-device butterfly's arithmetic
        ext = F.pad(ext, (0, 2))
    w = taps(np.stack([dec_lo, dec_hi])[:, None, :], v)  # (2, 1, M)
    with config.dial():
        out = F.conv1d(ext.reshape(-1, 1, ext.shape[-1]), w, stride=2)[..., :n_loc // 2]
    out = out.reshape(lead + (2, n_loc // 2))
    return out[..., 0, :], out[..., 1, :]


def _halo_level_split(n: int, n_dev: int, fb, level: int):
    """How many pyramid levels run fully sharded (each rank's chunk of the
    shrinking prefix keeps at least a filter length) and how many are
    finished on every rank after an all_gather of the small prefix left."""
    sharded_levels = 0
    h = n
    m = fb.length
    while sharded_levels < level and h >= fb.transform_wavelength and (h // n_dev) >= max(m, 2):
        sharded_levels += 1
        h >>= 1
    tail_levels = 0
    while sharded_levels + tail_levels < level and h >= fb.transform_wavelength:
        tail_levels += 1
        h >>= 1
    return sharded_levels, tail_levels


def _fwt_axis_halo_local(v: torch.Tensor, fb, sharded_levels: int, tail_levels: int,
                         mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Multi-level FWT along the last axis of a sharded block: this rank's
    slice of the distributed pyramid layout [D_1^c | D_2^c | ... | tail].
    The tail runs through :func:`fwt` (K3 on the card) on every rank."""
    details = []
    for _ in range(sharded_levels):
        v, d = _butterfly_halo(v, fb.dec_lo, fb.dec_hi, mesh, axis)
        details.append(d)
    if tail_levels:
        full = fwt(all_gather(v, mesh, axis, -1), fb, tail_levels)
        loc = full.shape[-1] // axis_size(mesh, axis)
        v = full.narrow(-1, axis_index(mesh, axis) * loc, loc)
    return torch.cat(details + [v], dim=-1) if details else v


def fwt_halo_sharded(signal, wavelet, mesh: DeviceMesh, level: int | None = None,
                     axis_name=None):
    """Multi-level FWT with the signal's time axis sharded across the mesh,
    one ring shift of an (M-2)-sample right halo per level. When the
    shrinking prefix no longer spans every rank with a filter length each,
    the small rest is gathered and finished on every rank.

    Returns the *distributed pyramid layout*: rank c's block is
    ``[D_1^c | D_2^c | ... | A_L^c]`` (finest detail first); use
    :func:`gather_pyramid` for the reference's ``[A_L | D_L | ... | D_1]``.
    """
    fb = get_filter(wavelet)
    axis_name = axis_name or mesh.mesh_dim_names[0]
    n_dev = axis_size(mesh, axis_name)
    signal = global_input(signal, mesh)
    n = signal.shape[-1]
    if signal.dim() != 1:
        raise JWaveFailure("fwt_halo_sharded - expects a 1D signal")
    if not is_power_of_two(n) or n % n_dev:
        raise JWaveFailure(
            f"fwt_halo_sharded - length {n} must be 2^p and divide over {n_dev} chips")
    if level is None:
        level = exponent_of_two(n)
    sharded_levels, tail_levels = _halo_level_split(n, n_dev, fb, level)
    v = ensure_float(local_block(signal, mesh, {axis_name: 0}))
    out = _fwt_axis_halo_local(v, fb, sharded_levels, tail_levels, mesh, axis_name)
    return sharded_output(out, mesh, {axis_name: 0}, (n,))


def _pyramid_permutation(n: int, n_dev: int, fb, level: int) -> np.ndarray:
    """Source indices taking a gathered distributed-pyramid axis (blocks
    [D_1^c | D_2^c | ... | tail], concatenated) to the reference's layout
    [A_L | D_L | ... | D_1]: out = arr[idx]."""
    sharded_levels, _ = _halo_level_split(n, n_dev, fb, level)
    n_loc = n // n_dev
    idx = np.empty(n, dtype=np.int64)
    offset_local = 0
    for lev in range(1, sharded_levels + 1):
        d_len = n // (2**lev) // n_dev
        base = n // (2**lev)  # detail region of level lev: [n/2^lev, n/2^(lev-1))
        for c in range(n_dev):
            idx[base + c * d_len: base + (c + 1) * d_len] = (
                c * n_loc + offset_local + np.arange(d_len))
        offset_local += d_len
    tail_len = n_loc - offset_local
    for c in range(n_dev):
        idx[c * tail_len: (c + 1) * tail_len] = c * n_loc + offset_local + np.arange(tail_len)
    return idx


def _host(x) -> np.ndarray:
    """A DTensor (gathered), tensor or array as a host numpy array."""
    return host_array(x.full_tensor() if isinstance(x, DTensor) else x)


def gather_pyramid(dist, wavelet, level: int, n_dev: int):
    """The output of :func:`fwt_halo_sharded` (gathered) in the reference's
    global layout ``[A_L | D_L | ... | D_1]``: a host-side permutation."""
    arr = _host(dist)
    return arr[_pyramid_permutation(arr.shape[-1], n_dev, get_filter(wavelet), level)]


def fwt2d_tile_sharded(
    mat,
    wavelet,
    mesh: DeviceMesh,
    level_rows: int | None = None,
    level_cols: int | None = None,
    row_axis: str | None = None,
    col_axis: str | None = None,
):
    """Multi-level 2D FWT with the matrix tile-sharded over a 2D mesh: each
    rank owns one (M/Dr, N/Dc) tile; the column pass runs the halo pyramid
    of :func:`fwt_halo_sharded` along the col axis, the row pass along the
    row axis, each level shifting (M-2) samples per tile edge. Output in the
    distributed pyramid layout per axis; :func:`gather_pyramid_2d` gives the
    reference's layout. Both axes must be powers of two dividing their mesh
    axes."""
    names = mesh.mesh_dim_names
    if len(names) < 2:
        raise JWaveFailure("fwt2d_tile_sharded - needs a 2D mesh (rows x cols)")
    row_axis = row_axis or names[0]
    col_axis = col_axis or names[1]
    n_dev_r, n_dev_c = axis_size(mesh, row_axis), axis_size(mesh, col_axis)
    fb = get_filter(wavelet)
    mat = global_input(mat, mesh)
    if mat.dim() != 2:
        raise JWaveFailure("fwt2d_tile_sharded - expects a 2D matrix")
    rows, cols = mat.shape
    for n, d, who in ((rows, n_dev_r, "rows"), (cols, n_dev_c, "cols")):
        if not is_power_of_two(n) or n % d:
            raise JWaveFailure(
                f"fwt2d_tile_sharded - {who} length {n} must be 2^p and divide over {d} chips"
            )
    if level_rows is None:
        level_rows = exponent_of_two(rows)
    if level_cols is None:
        level_cols = exponent_of_two(cols)
    sl_r, tl_r = _halo_level_split(rows, n_dev_r, fb, level_rows)
    sl_c, tl_c = _halo_level_split(cols, n_dev_c, fb, level_cols)
    dims = {row_axis: 0, col_axis: 1}
    y = _fwt_axis_halo_local(ensure_float(local_block(mat, mesh, dims)), fb, sl_c, tl_c, mesh,
                             col_axis)
    y = _fwt_axis_halo_local(y.transpose(-1, -2), fb, sl_r, tl_r, mesh, row_axis)
    return sharded_output(y.transpose(-1, -2), mesh, dims, (rows, cols))


def gather_pyramid_2d(dist, wavelet, level_rows: int, level_cols: int, n_dev_r: int,
                      n_dev_c: int):
    """A gathered :func:`fwt2d_tile_sharded` output in the reference's
    global 2D layout (a host-side index permutation per axis)."""
    fb = get_filter(wavelet)
    arr = _host(dist)
    idx_r = _pyramid_permutation(arr.shape[-2], n_dev_r, fb, level_rows)
    idx_c = _pyramid_permutation(arr.shape[-1], n_dev_c, fb, level_cols)
    return arr[..., idx_r, :][..., :, idx_c]


# --------------------------------------------------------------------------
# MODWT, 2D MODWT and CWT with the time axis sharded over the four-step FFT
# --------------------------------------------------------------------------

_RESPONSES: OrderedDict = OrderedDict()
_RESPONSES_MAX = 4  # (J+1) x N/D complex each: 235 MB for J=6 on 2^22 complex64 samples


def _local_freq_bins(n: int, n_dev: int, rank: int, device) -> torch.Tensor:
    """Global frequency index of each element of this rank's (D, L/D) block
    of the (D, L) spectrum layout: k = i*(L/D) + off + L*k1."""
    l = n // n_dev
    k1 = torch.arange(n_dev, device=device)[:, None]
    k2 = rank * (l // n_dev) + torch.arange(l // n_dev, device=device)[None, :]
    return k2 + l * k1  # (D, L/D)


def _filter_dft_at(coeffs: np.ndarray, t: torch.Tensor, n: int, cdtype) -> torch.Tensor:
    """DFT of an M-tap filter at phase indices ``t``: sum_m coeffs[m] *
    exp(-2i*pi*((t*m) mod n)/n). The index is built by cumulative modular
    addition, exact in integers (no t*m overflow)."""
    phase = torch.tensor(-2j * np.pi / n, dtype=cdtype, device=t.device)
    acc = torch.full(t.shape, complex(coeffs[0]), dtype=cdtype, device=t.device)  # m=0: phase 0
    u = torch.zeros_like(t)
    for m in range(1, coeffs.shape[0]):
        u = u + t
        u = torch.where(u >= n, u - n, u)
        acc = acc + complex(coeffs[m]) * torch.exp(phase * u.to(cdtype))
    return acc


def _cascade_responses_local(wavelet, level: int, n: int, k: torch.Tensor, cdtype) -> torch.Tensor:
    """The telescoped cascade responses W_1..W_J, V_J evaluated on the
    device at global frequency bins ``k``, so each rank computes only its
    own N/D bins and nothing of length N exists anywhere. The length-N DFT
    of the level-j upsampled (wrapped) filter at bin k is the M-tap base
    filter's DFT at (2^(j-1) * k) mod N, the power built by modular
    doubling. Evaluated in complex128 and cast to ``cdtype``."""
    g0, h0 = _modwt_base_filters(wavelet)
    t = k
    g_acc = torch.ones(k.shape, dtype=torch.complex128, device=k.device)
    rows = []
    for _ in range(level):
        rows.append(_filter_dft_at(h0, t, n, torch.complex128) * g_acc)
        g_acc = g_acc * _filter_dft_at(g0, t, n, torch.complex128)
        t2 = t + t
        t = torch.where(t2 >= n, t2 - n, t2)
    rows.append(g_acc)
    return torch.stack(rows).to(cdtype)  # (J+1, *k.shape)


def _responses(fb, level: int, n: int, mesh: DeviceMesh, axis: str, cdtype, device):
    """:func:`_cascade_responses_local` at this rank's bins, cached per bank
    coefficients, level, geometry, rank, dtype and device."""
    n_dev, rank = axis_size(mesh, axis), axis_index(mesh, axis)
    key = (_fb_key(fb), level, n, n_dev, rank, cdtype, str(device))
    fil = _RESPONSES.get(key)
    if fil is None:
        fil = _cascade_responses_local(fb, level, n, _local_freq_bins(n, n_dev, rank, device),
                                       cdtype)
        _RESPONSES[key] = fil
        while len(_RESPONSES) > _RESPONSES_MAX:
            _RESPONSES.popitem(last=False)
    else:
        _RESPONSES.move_to_end(key)
    return fil


def modwt_fft_sharded(signal, wavelet, level: int, mesh: DeviceMesh, axis_name: str | None = None):
    """Forward MODWT with the time axis sharded, any decomposition depth:
    one forward pFFT of the signal, J+1 local spectrum products with the
    cascade responses evaluated at this rank's bins, one inverse pFFT
    batched over the rows. Each rank only ever holds O((J+1) * N/D)
    samples. Returns the (J+1, N) stack [W_1..W_J, V_J] sharded on N."""
    axis_name = axis_name or mesh.mesh_dim_names[0]
    n_dev = axis_size(mesh, axis_name)
    signal = ensure_float(global_input(signal, mesh))
    if signal.dim() != 1:
        raise JWaveFailure(
            "modwt_fft_sharded - expects a 1D signal (use batch_sharded for batches)")
    n = signal.shape[-1]
    _check_geometry(n, n_dev, "modwt_fft_sharded")
    _validate_level(n, level, "modwt_fft_sharded")
    v = local_block(signal, mesh, {axis_name: 0})
    spec = pfft_local(v, mesh, axis_name)  # (D, L/D)
    fil = _responses(get_filter(wavelet), level, n, mesh, axis_name, spec.dtype, spec.device)
    out = pifft_local(fil * spec[None], mesh, axis_name).real.to(v.dtype)  # (J+1, L)
    return sharded_output(out, mesh, {axis_name: 1}, (level + 1, n))


def imodwt_fft_sharded(coeffs, wavelet, mesh: DeviceMesh, axis_name: str | None = None):
    """Inverse of :func:`modwt_fft_sharded` from a time-sharded (J+1, N)
    stack: a batched forward pFFT of the rows, the conjugate-weighted sum,
    one inverse pFFT."""
    axis_name = axis_name or mesh.mesh_dim_names[0]
    n_dev = axis_size(mesh, axis_name)
    coeffs = ensure_float(global_input(coeffs, mesh))
    if coeffs.dim() != 2:
        raise JWaveFailure("imodwt_fft_sharded - expects a (J+1, N) stack")
    level = coeffs.shape[-2] - 1
    n = coeffs.shape[-1]
    if level < 1:
        raise JWaveFailure("imodwt_fft_sharded - need at least level 1 (2 rows)")
    _check_geometry(n, n_dev, "imodwt_fft_sharded")
    c = local_block(coeffs, mesh, {axis_name: 1})
    spec = pfft_local(c, mesh, axis_name)  # (J+1, D, L/D)
    fil = _responses(get_filter(wavelet), level, n, mesh, axis_name, spec.dtype, spec.device)
    v_hat = torch.sum(spec * torch.conj(fil), dim=0)  # (D, L/D)
    out = pifft_local(v_hat, mesh, axis_name).real.to(c.dtype)
    return sharded_output(out, mesh, {axis_name: 0}, (n,))


def modwt2d_sharded(mat, wavelet, level: int, mesh: DeviceMesh, axis_name: str | None = None,
                    **kw):
    """Separable 2D MODWT with the matrix row-sharded across the mesh: the
    column-direction transforms are local (each rank holds whole rows), the
    row-direction pass is brought local by one all_to_all pair. The
    (J+1, J+1, R, C) subband grid of :func:`modwt_2d`, sharded on R."""
    axis_name = axis_name or mesh.mesh_dim_names[0]
    n_dev = axis_size(mesh, axis_name)
    mat = global_input(mat, mesh)
    if mat.dim() != 2:
        raise JWaveFailure("modwt2d_sharded - expects a 2D matrix (R, C)")
    r, c = mat.shape
    if r % n_dev or c % n_dev:
        raise JWaveFailure(
            f"modwt2d_sharded - matrix {r}x{c} must divide over {n_dev} devices on both axes"
        )
    _validate_level(min(r, c), level, "modwt2d_sharded")
    y = modwt(local_block(mat, mesh, {axis_name: 0}), wavelet, level, **kw)  # (R/D, J+1, C)
    y = y.movedim(-2, -3)  # (jc, R/D, C)
    j1, r_loc, c_full = y.shape
    y = y.reshape(j1, r_loc, n_dev, c_full // n_dev)
    y = all_to_all(y, mesh, axis_name, 2, 1)  # (jc, D, R/D, C/D)
    y = y.reshape(j1, n_dev * r_loc, c_full // n_dev).transpose(-1, -2)  # (jc, C/D, R)
    y = modwt(y, wavelet, level, **kw)  # (jc, C/D, jr, R)
    y = y.movedim(-2, -4).transpose(-1, -2)  # (jr, jc, R, C/D)
    y = y.reshape(j1, j1, n_dev, r_loc, c_full // n_dev)
    y = all_to_all(y, mesh, axis_name, 2, 3)  # (jr, jc, R/D, D, C/D)
    return sharded_output(y.reshape(j1, j1, r_loc, c_full), mesh, {axis_name: 2},
                          (j1, j1, r, c))


def imodwt2d_sharded(coeffs, wavelet, mesh: DeviceMesh, axis_name: str | None = None, **kw):
    """Inverse of :func:`modwt2d_sharded`: the row-sharded (J+1, J+1, R, C)
    grid back to the (R, C) matrix."""
    axis_name = axis_name or mesh.mesh_dim_names[0]
    n_dev = axis_size(mesh, axis_name)
    coeffs = global_input(coeffs, mesh)
    if coeffs.dim() != 4:
        raise JWaveFailure("imodwt2d_sharded - expects a (J+1, J+1, R, C) grid")
    j1, j1b, r, c = coeffs.shape
    if j1 != j1b:
        raise JWaveFailure("imodwt2d_sharded - level grid must be square")
    if r % n_dev or c % n_dev:
        raise JWaveFailure(
            f"imodwt2d_sharded - matrix {r}x{c} must divide over {n_dev} devices on both axes"
        )
    g = local_block(coeffs, mesh, {axis_name: 2})  # (jr, jc, R/D, C)
    r_loc, c_loc = g.shape[-2], c // n_dev
    # undo the row-direction transform first: it needs all of R
    y = g.reshape(j1, j1, r_loc, n_dev, c_loc)
    y = all_to_all(y, mesh, axis_name, 3, 2)  # (jr, jc, D, R/D, C/D)
    y = y.reshape(j1, j1, n_dev * r_loc, c_loc).transpose(-1, -2)  # (jr, jc, C/D, R)
    y = imodwt(y.movedim(-4, -2), wavelet, **kw)  # (jc, C/D, R)
    y = y.transpose(-1, -2).reshape(j1, n_dev, r_loc, c_loc)
    y = all_to_all(y, mesh, axis_name, 1, 2)  # (jc, R/D, D, C/D)
    y = y.reshape(j1, r_loc, c).movedim(-3, -2)  # (R/D, jc, C)
    return sharded_output(imodwt(y, wavelet, **kw), mesh, {axis_name: 0}, (r, c))


def cwt_time_sharded(
    signal,
    scales,
    wavelet,
    mesh: DeviceMesh,
    sampling_rate: float = 1.0,
    axis_name: str | None = None,
) -> CWTResult:
    """FFT-based CWT with the *time axis* sharded across the mesh: one
    forward pFFT, a local per-scale product with conj(psi_hat(a*omega))
    evaluated at this rank's own frequencies of the (D, L) layout, one
    inverse pFFT batched over scales. The signal is never replicated.
    Needs a power-of-two length (no padding, so the result is the padded
    single-device CWT's). Coefficients (S, N) sharded on N."""
    axis_name = axis_name or mesh.mesh_dim_names[0]
    n_dev = axis_size(mesh, axis_name)
    wav = get_continuous_wavelet(wavelet)
    scales = np.atleast_1d(host_array(scales, np.float64))
    signal = ensure_float(global_input(signal, mesh))
    if signal.dim() != 1:
        raise JWaveFailure("cwt_time_sharded - expects a 1D signal (shard batches separately)")
    n = signal.shape[-1]
    if not is_power_of_two(n):
        raise JWaveFailure(
            f"cwt_time_sharded - length {n} must be a power of two (padding "
            "would force a resharding; use cwt/cwt_scale_sharded instead)"
        )
    _check_geometry(n, n_dev, "cwt_time_sharded")
    fs = float(sampling_rate)
    dev = mesh_device(mesh)
    spec = pfft_local(local_block(signal, mesh, {axis_name: 0}), mesh, axis_name)  # (D, L/D)
    k = _local_freq_bins(n, n_dev, axis_index(mesh, axis_name), dev)
    omega = 2.0 * np.pi * k.to(torch.float64) * fs / n
    omega = torch.where(k > n // 2, omega - 2.0 * np.pi * fs, omega)
    a = torch.as_tensor(scales, dtype=torch.float64, device=dev)
    w_hat = torch.conj(wav.psi_hat_scaled(omega[None], a[:, None, None]))  # (S, D, L/D)
    out = pifft_local(w_hat.to(spec.dtype) * spec[None], mesh, axis_name)  # (S, L)
    coeffs = sharded_output(out, mesh, {axis_name: 1}, (scales.shape[0], n))
    return CWTResult(coeffs, a, _time_axis(n, fs, out), fs, wav.name)
