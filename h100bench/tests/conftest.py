"""CPU tests of the benchmark (python -m pytest h100bench/tests). Tests
that need the card carry the `cuda` marker and decide inside a fixture
whether there is one."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs an NVIDIA GPU (runs on the card, skips '
        'elsewhere)')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
