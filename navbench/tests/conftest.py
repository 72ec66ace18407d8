"""Shared fixtures of the benchmark's tests.  They import no JAX."""
from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def cpu():
    import torch

    torch.set_num_threads(4)
    return torch.device("cpu")

