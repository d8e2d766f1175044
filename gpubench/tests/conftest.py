"""Tests of the benchmark itself, on the CPU; those marked ``cuda`` need
the card and skip without it.  Run from the repository's root:
``python -m pytest gpubench/tests -q -p no:cacheprovider``."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line('markers', 'cuda: needs an NVIDIA GPU (skips without)')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return 'cuda'
