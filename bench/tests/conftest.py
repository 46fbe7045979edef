"""The benchmark's tests: ``python -m pytest -q bench/tests`` from the root
of the checkout.  Tests marked ``chip`` need a CUDA card and skip without
one (the ``card`` fixture decides inside the test run)."""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (HERE, HERE.parent, HERE.parents[1] / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card (runs on the chip)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
