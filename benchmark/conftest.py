"""pytest settings of the benchmark's own tests: the harness's folder and
the repository root on the path, and the `card` marker for tests that
need an NVIDIA GPU (they skip inside a fixture where there is none)."""
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
for path in (HERE, os.path.dirname(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the test runs on the card")
    return torch.device("cuda")
