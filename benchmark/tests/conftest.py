"""The benchmark's own pytest settings: the ``card`` marker of tests that
need an NVIDIA card, and the fixture that skips them without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped on the CPU")


@pytest.fixture
def card():
    """The card's device, or a skip on a machine without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return "cuda:0"
