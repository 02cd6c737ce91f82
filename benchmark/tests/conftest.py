"""Shared fixtures of the benchmark's tests. The card is looked for inside
a fixture, never while a module is imported."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# cells shrunk to a size the CPU runs in seconds; widths unchanged
TINY = {"config": {"n": 8192, "quantizer": {"train_rows": 4096, "iters": 5,
                                            "coarse_k": 64,
                                            "coarse_iters": 5}},
        "traffic": {"batch": 128, "pool": 4096, "sample": 256}}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.fixture
def tiny():
    import copy
    return copy.deepcopy(TINY)
