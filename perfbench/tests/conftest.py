"""The benchmark's own tests.  ``card`` marks the tests that need an
NVIDIA GPU; they skip elsewhere, decided in the ``cuda`` fixture."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
