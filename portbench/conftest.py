"""pytest settings of the benchmark's own tests (``pytest portbench/tests``):
the ``card`` marker for tests that need an NVIDIA GPU, and the fixture
that decides at run time whether one is present."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)
