"""The benchmark's own tests: ``python -m pytest bench/tests``.  Tests
marked ``cuda`` need a card and decide in a fixture whether there is
one."""
import os
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (BENCH, BENCH.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from run import ALLOC_CONF  # noqa: E402

# the card tests run the cells at their own size, as a run does
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", ALLOC_CONF)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the chip")
    return torch.device("cuda")
