"""The benchmark's CPU tests, and its card-only tests (marked ``chip``),
which skip here and run on a machine with an NVIDIA GPU:

    python3 -m pytest -m chip bench/tests
"""
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (runs on the machine with the "
        "card: python3 -m pytest -m chip bench/tests)")


@pytest.fixture
def cuda():
    """The CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the machine with the card")
    return torch.device("cuda")
