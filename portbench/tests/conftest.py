"""Tests of the benchmark harness: ``python3 -m pytest portbench/tests``.

Tests marked ``card`` need an NVIDIA card and skip without one; on the
chip: ``python3 -m pytest portbench/tests -m card``."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_card():
    """The first CUDA device; skips the test where there is none."""

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip with -m card)")
    return torch.device("cuda", 0)
