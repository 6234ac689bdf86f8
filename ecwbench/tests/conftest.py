"""The harness's own tests: CPU tests at a tiny size (C2H2/STO-3G), and
tests marked `gpu` (the repository's marker for tests that need a CUDA
card), which skip without one.

    python -m pytest ecwbench/tests            # here, on the CPU
    python -m pytest -m gpu ecwbench/tests     # on the card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """Skips the test without a CUDA card (decided here, at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
