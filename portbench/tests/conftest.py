"""Tests of the benchmark itself, on the CPU at tiny sizes (``pytest
portbench/tests``). Tests marked ``card`` need a CUDA card; they skip here,
decided inside the ``card`` fixture."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (run on the chip)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def kept_copy(tmp_path_factory):
    """(root, portbench/) of a copy of the benchmark that also holds the
    cells kept out of BENCHMARK.json (``kept.py``)."""
    from portbench.tests import kept

    return kept.copy(tmp_path_factory.mktemp("kept"), kept.bench())
