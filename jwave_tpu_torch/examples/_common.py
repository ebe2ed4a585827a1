"""What the example modules share: the command line and host copies."""
from __future__ import annotations

import argparse

import numpy as np

from ..utils.host import host_array


def host(t) -> np.ndarray:
    """A tensor (or DTensor, gathered) as a numpy array on the host."""
    return host_array(t.full_tensor() if hasattr(t, "full_tensor") else t)


def run(*entries):
    """``python -m jwave_tpu_torch.examples.<name> [--device cpu]``: run each
    entry on the device asked for (the card by default)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None, help='"cuda" (the default) or "cpu"')
    device = parser.parse_args().device
    for entry in entries:
        entry(device)
