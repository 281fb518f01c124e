"""navbench's own tests: `python -m pytest navbench/tests -q` from the
repository root (CPU); `-m card` runs the ones that need the GPU."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU (skips without one; run on "
        "the card with `python -m pytest navbench/tests -m card`)")


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present (decided here, at
    run time, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the test runs on the card only")
    return torch.device("cuda")
