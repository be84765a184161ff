"""The benchmark's own tests: ``python -m pytest qpbench/tests -q`` on the
CPU; those marked ``cuda`` run on the card (``-m cuda``) and skip here.
Whether there is a card is decided inside the ``card`` fixture."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
