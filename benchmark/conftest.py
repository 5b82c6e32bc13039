"""pytest settings of the benchmark's own tests (benchmark/tests/).

Tests that need a CUDA card carry the `card` marker and decide inside the
test, through the `cuda` fixture, whether a card is present: they skip on
a machine without one. Run them on the card with

    python3 -m pytest benchmark/tests -m card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips where there is none)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
