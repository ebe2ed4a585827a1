"""Tests of the benchmark: ``python -m pytest benchmark/tests``, from the
root of a checkout. Tests marked ``cuda`` need a CUDA card and skip without
one; on a card they run the cells' checks at the cells' own sizes."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_addoption(parser, pluginmanager):
    if not pluginmanager.hasplugin("xdist"):
        # the repository's addopts carry `-n auto`: accept it as a no-op
        # where pytest-xdist is not installed, and run serially
        group = parser.getgroup("xdist", "no-op stand-ins (pytest-xdist absent)")
        group._addoption("-n", "--numprocesses", action="store", default=None,
                         help="ignored: pytest-xdist is not installed")
        group._addoption("--dist", action="store", default=None,
                         help="ignored: pytest-xdist is not installed")


@pytest.fixture
def card():
    """The CUDA device; skips the test without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
