"""Test set-up for the benchmark's own tests: the checkout's root and
``src/`` on the path, the ``cuda`` marker, and a fixture that skips a test
on a host without a card (decided when the test runs, never at import)."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped on hosts without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device on this host")
    return torch.device("cuda", 0)
