"""Discrete wavelet filter-bank registry (the same 67 banks as
``jwave_tpu.filters``).

Every bank is a plain record of four float64 numpy vectors; transforms turn
them into tensors on the device of the data they filter. Names match the
reference's WaveletBuilder strings ("Haar", "Daubechies 4", ...), and short
PyWavelets-style aliases ("haar", "db4", "sym8", "bior3.5") are accepted.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..exceptions import JWaveNotKnown
from .data import FILTERS


@dataclass(frozen=True)
class FilterBank:
    """One discrete wavelet filter bank (analysis + synthesis filters).

    ``dec_lo[j]`` multiplies ``x[(2i+j) mod h]`` in the analysis butterfly
    (reference Wavelet.java:236-260); ``rec_lo``/``rec_hi`` drive the adjoint
    synthesis butterfly (Wavelet.java:277-303). ``recon_gain`` is a per-level
    correction applied in synthesis (0.5 for "Haar orthogonal", else 1.0).
    """

    name: str
    family: str
    dec_lo: np.ndarray
    dec_hi: np.ndarray
    rec_lo: np.ndarray
    rec_hi: np.ndarray
    transform_wavelength: int = 2
    recon_gain: float = 1.0
    in_builder: bool = True
    junit_passing: bool = True

    @property
    def length(self) -> int:
        """Filter length (the reference's ``_motherWavelength``)."""
        return int(self.dec_lo.shape[0])

    def __post_init__(self):
        for f in ("dec_lo", "dec_hi", "rec_lo", "rec_hi"):
            object.__setattr__(self, f, np.asarray(getattr(self, f), dtype=np.float64))


def bank_from_arrays(name, dec_lo, dec_hi, rec_lo, rec_hi, transform_wavelength=2,
                     recon_gain=1.0, family="custom") -> FilterBank:
    """A :class:`FilterBank` from raw coefficient arrays, e.g. the numpy
    fields of a ``jwave_tpu`` bank, so one custom bank runs through both
    packages."""
    return FilterBank(
        name=str(name), family=family,
        dec_lo=np.array(dec_lo, dtype=np.float64), dec_hi=np.array(dec_hi, dtype=np.float64),
        rec_lo=np.array(rec_lo, dtype=np.float64), rec_hi=np.array(rec_hi, dtype=np.float64),
        transform_wavelength=int(transform_wavelength), recon_gain=float(recon_gain),
        in_builder=False, junit_passing=False,
    )


_REGISTRY = {
    name: FilterBank(
        name=name,
        family=e["family"],
        dec_lo=np.array(e["dec_lo"]),
        dec_hi=np.array(e["dec_hi"]),
        rec_lo=np.array(e["rec_lo"]),
        rec_hi=np.array(e["rec_hi"]),
        transform_wavelength=e["transform_wavelength"],
        recon_gain=e["recon_gain"],
        in_builder=e["in_builder"],
        junit_passing=e["junit_passing"],
    )
    for name, e in FILTERS.items()
}


def _aliases() -> dict[str, str]:
    al = {}
    for name, e in FILTERS.items():
        fam = e["family"]
        if name == "Haar":
            al["haar"] = al["haar1"] = al["db1"] = name
        elif name == "Haar orthogonal":
            al["haarorthogonal"] = name
        elif fam == "daubechies":
            al["db" + name.split()[-1]] = name
        elif fam == "symlets":
            al["sym" + name.split()[-1]] = name
        elif fam == "coiflet":
            al["coif" + name.split()[-1]] = name
        elif fam == "legendre":
            al["legendre" + name.split()[-1]] = name
        elif fam == "biorthogonal":
            a, b = name.split()[-1].split("/")
            al[f"bior{a}.{b}"] = name
        elif name == "Discrete Meyer":
            al["dmey"] = name
        elif name == "CDF 5/3":
            al["cdf5.3"] = name
        elif name == "CDF 9/7":
            al["cdf9.7"] = name
        elif name == "Battle 23":
            al["battle23"] = name
    return al


_ALIASES = _aliases()


def get_filter(name) -> FilterBank:
    """Look up a filter bank by reference name or PyWavelets-style alias."""
    if isinstance(name, FilterBank):
        return name
    if name in _REGISTRY:
        return _REGISTRY[name]
    key = str(name).lower().replace(" ", "").replace("_", "")
    if key in _ALIASES:
        return _REGISTRY[_ALIASES[key]]
    raise JWaveNotKnown(
        f"unknown wavelet {name!r}; available: {sorted(_REGISTRY)} "
        f"or aliases like 'db4', 'sym8', 'coif2', 'bior3.5'"
    )


def available_filters() -> list[str]:
    """All registered filter-bank names."""
    return sorted(_REGISTRY)


def junit_passing_filters() -> list[FilterBank]:
    """The perfect-reconstruction banks of the reference's JUnit sweep
    (WaveletBuilder.java:430-504)."""
    return [fb for fb in _REGISTRY.values() if fb.junit_passing]
