"""The benchmark's tests: ``python -m pytest port_bench/tests`` from the
root of the repository (on the card: ``-m card``)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures only on one")
    return torch.device("cuda", 0)
