"""CPU tests of the benchmark's harness (run with the repository's tests).

Tests that need a CUDA card carry the ``card`` marker and take the
``card`` fixture, which skips them where there is none. Whether a card is
there is decided inside the fixture, never while a module is imported.
"""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for path in (str(ROOT / "src"), str(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (a benchmark run on the chip); "
                                       "skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="session")
def root():
    return ROOT
