"""The harness's tests: `python -m pytest benchmark/tests -q` from the repo's root.

Tests that need a CUDA card take the `card` fixture, which skips without
one (decided when the test runs, never at import)."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))


def pytest_configure(config):
    import torch

    torch.set_num_threads(2)  # pytest-xdist runs several workers on the host's cores
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
