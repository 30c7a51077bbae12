"""Pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests``): the benchmark's folder, its tests' helpers and the root
of the checkout (the port) on the import path, and the one
marker of the tests that need a card, which skip elsewhere."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(HERE, "tests"), os.path.dirname(HERE)]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The first CUDA card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card")
    return torch.device("cuda", 0)
