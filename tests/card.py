"""The card tests' ``cuda`` fixture: a test module imports it (``from
card import cuda``) and marks its tests ``card``."""

import pytest


@pytest.fixture
def cuda():
    """The card tests' device: ``cuda``, or a skip where there is none."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
