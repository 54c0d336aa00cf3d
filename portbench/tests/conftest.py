"""Shared fixtures of the benchmark's tests.  Tests that need a CUDA card
carry the ``cuda`` marker and take the ``card`` fixture, which decides at
fixture time, never at import, whether one is there."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
for p in (str(ROOT), str(ROOT / "src"), str(Path(__file__).resolve().parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with -m cuda")
    return "cuda"


@pytest.fixture(autouse=True)
def few_threads():
    """Few intra-op threads: the suite runs beside other work."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
