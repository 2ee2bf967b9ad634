"""The benchmark's tests. Those marked `card` need a CUDA card and skip
without one; run them on the card with

    python -m pytest perfbench/tests -m card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    """Two CPU threads a test process: the tests run several at a time."""
    import torch

    torch.set_num_threads(2)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
