"""Variational mode decomposition (Dragomiretskiy & Zosso 2014).

Decomposes a signal into K narrowband modes u_k with learned center
frequencies omega_k by ADMM on the positive half-spectrum: every update is
elementwise over a (K, F) grid (Wiener filtering ``1 / (1 + alpha (w -
w_k)^2)``, a power-weighted centroid for omega_k, a dual ascent), with one
inverse FFT at the end. A fixed number of iterations runs, with the
relative change of each one reported rather than branched on; the K modes
update Gauss-Seidel style. The signal is mirror-extended to 2N (the
reference MATLAB implementation's boundary treatment) and the modes are
cropped back to the center N samples.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..exceptions import JWaveFailure
from ..ops.butterfly import ensure_fft_float
from ..utils.host import as_tensor
from .analytic import real_signal


@dataclass
class VMDResult:
    """``modes``: (..., K, N) real narrowband components, sorted by
    ascending center frequency; ``omegas``: (..., K) center frequencies in
    cycles/sample; ``convergence``: (..., n_iter) per-iteration relative
    change of the mode spectra."""

    modes: torch.Tensor
    omegas: torch.Tensor
    convergence: torch.Tensor

    @property
    def n_modes(self) -> int:
        return self.modes.shape[-2]

    def frequencies(self, sampling_rate: float = 1.0):
        return self.omegas * sampling_rate


def vmd(
    signal,
    n_modes: int,
    alpha: float = 2000.0,
    tau: float = 0.0,
    init: str = "uniform",
    n_iter: int = 300,
    dc: bool = False,
) -> VMDResult:
    """Variational mode decomposition of (..., N) real signals.

    ``alpha`` bandwidth penalty; ``tau`` dual-ascent step (0 disables the
    Lagrangian update); ``init`` "uniform", "log" or "zero" initial center
    frequencies; ``n_iter`` ADMM iterations; ``dc`` locks the first mode's
    center frequency at 0. Returns a :class:`VMDResult`.
    """
    x = as_tensor(signal)
    if x.dim() == 0:
        raise JWaveFailure("vmd - signal must have at least 1 axis")
    x = real_signal(x, "vmd")
    n = x.shape[-1]
    if n < 4:
        raise JWaveFailure("vmd - need at least 4 samples")
    if n_modes < 1:
        raise JWaveFailure("vmd - n_modes must be >= 1")
    if init not in ("uniform", "log", "zero"):
        raise JWaveFailure(f"vmd - unknown init {init!r}")
    if n_iter < 1:
        raise JWaveFailure("vmd - n_iter must be >= 1")

    out_dtype = x.dtype  # half precision computes in float32; modes and omegas are cast back
    x = ensure_fft_float(x)
    rdtype = x.dtype
    # mirror-extend to 2N: [x[N/2-1::-1], x, x[:N/2-1:-1]] (paper/MATLAB)
    half = n // 2
    ext = torch.cat([torch.flip(x[..., :half], dims=(-1,)), x,
                     torch.flip(x[..., half:], dims=(-1,))], dim=-1)
    t = ext.shape[-1]
    nf = t // 2 + 1
    fpos = torch.as_tensor(np.arange(t, dtype=np.float64)[:nf] / t, dtype=rdtype,
                           device=x.device)  # (F,)
    f_hat = torch.fft.fft(ext, dim=-1)[..., :nf]  # (..., F)

    if init == "uniform":
        om0 = 0.5 * (np.arange(n_modes) + 0.5) / n_modes
    elif init == "log":
        om0 = np.exp(np.log(0.5 / t) + (np.log(0.5) - np.log(0.5 / t))
                     * np.arange(n_modes) / max(n_modes - 1, 1))
    else:
        om0 = np.zeros(n_modes)
    if dc:
        om0[0] = 0.0
    lead = x.shape[:-1]
    omega = torch.as_tensor(np.sort(om0), dtype=rdtype, device=x.device).expand(
        lead + (n_modes,)).clone()

    u_hat = f_hat.new_zeros(lead + (n_modes, nf))
    lam = torch.zeros_like(f_hat)
    conv = []
    for _ in range(n_iter):
        u_prev = u_hat.clone()
        acc = torch.sum(u_hat, dim=-2)  # running sum of all modes
        for k in range(n_modes):
            acc = acc - u_hat[..., k, :]
            # Wiener denominator in the MATLAB convention 1 + alpha (w - w_k)^2
            denom = 1.0 + alpha * (fpos - omega[..., k : k + 1]) ** 2
            uk_new = (f_hat - acc - lam / 2.0) / denom
            if not (dc and k == 0):
                p = torch.abs(uk_new) ** 2
                omega[..., k] = torch.sum(fpos * p, dim=-1) / (torch.sum(p, dim=-1) + 1e-30)
            acc = acc + uk_new
            u_hat[..., k, :] = uk_new
        lam = lam + tau * (acc - f_hat)
        num = torch.sum(torch.abs(u_hat - u_prev) ** 2, dim=(-2, -1))
        den = torch.sum(torch.abs(u_prev) ** 2, dim=(-2, -1)) + 1e-30
        conv.append(num / den)

    # Hermitian completion, inverse FFT, crop the mirror extension
    full = torch.cat([u_hat, torch.conj(torch.flip(u_hat[..., 1 : (t + 1) // 2], dims=(-1,)))],
                     dim=-1)
    modes = torch.fft.ifft(full, dim=-1).real[..., half : half + n].to(rdtype)
    omega, order = torch.sort(omega, dim=-1, stable=True)
    modes = torch.gather(modes, -2, order[..., None].expand(modes.shape))
    return VMDResult(modes.to(out_dtype), omega.to(out_dtype), torch.stack(conv, dim=-1))
