"""CPU tests of the benchmark: ``python -m pytest -q benchmark/tests``.

Tests marked ``card`` need a CUDA card and skip without one; on the card
run ``python -m pytest -q benchmark/tests -m card``."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return "cuda"
