"""pytest settings of the benchmark's own tests (run from the repository's
root: ``python -m pytest port_bench/tests -q``).

Tests marked ``chip`` need a CUDA card; they skip inside a fixture, never
while a module is imported.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    return torch.device("cuda", 0)
