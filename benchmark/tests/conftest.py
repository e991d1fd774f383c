"""The benchmark's tests: ``python -m pytest benchmark/tests -q`` from the
repository's root (the CPU; the tests marked ``cuda`` run on a card and
skip without one)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
