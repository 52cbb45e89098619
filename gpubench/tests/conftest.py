"""The benchmark's own tests: CPU tests at tiny sizes, and ``gpu`` tests
that need a CUDA card and skip without one.

    python -m pytest gpubench/tests -q            # here, on the CPU
    python -m pytest gpubench/tests -q -m gpu     # on a machine with a card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where there is none")


@pytest.fixture
def cuda():
    """The card's device; skips the test where torch sees none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny():
    """Configuration keys for a holder of 3 shards of 2048 columns."""
    return {"shards": 3, "shard_width": 2048, "chunk_shards": 2}
