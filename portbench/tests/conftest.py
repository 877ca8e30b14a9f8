"""Fixtures of the benchmark's tests.  A test that needs the card takes
the ``card`` fixture and carries the ``card`` marker: it decides inside
the fixture, never at import, and skips on a host without CUDA."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (CUDA); skipped without one")


@pytest.fixture(autouse=True)
def few_threads():
    """The suite runs beside other test processes: two threads each."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs the cell's own sizes on the chip")
    return torch
