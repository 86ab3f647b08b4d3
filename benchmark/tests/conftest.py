"""CPU tests of the benchmark harness: ``python -m pytest benchmark/tests``
from the repository root. Tests marked ``cuda`` need a card and skip
where torch.cuda.is_available() is False."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where "
        "torch.cuda.is_available() is False")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def port_env():
    """Leave the process environment as it was: run.run sets the port's
    variables for the run."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)
