"""Pytest bootstrap: make sibling helper modules (hypothesis_shim) importable
regardless of pytest's import mode, since tests/ is not a package."""
import os
import sys

_HERE = os.path.dirname(__file__)
if _HERE not in sys.path:
    sys.path.insert(0, _HERE)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (multi-host simulation etc.)")
    config.addinivalue_line(
        "markers", "soak: randomized service soak (step count bounded by "
        "the REPRO_SOAK_STEPS env knob)")
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (runs on the machine with the "
        "card)")
