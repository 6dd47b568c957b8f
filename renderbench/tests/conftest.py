"""The harness's own tests: on the CPU at small sizes, and the ``card``
tests, which skip without a CUDA card.

    python -m pytest renderbench/tests -q
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skipped without one)")


def shrink(run):
    """A configuration and mix small enough for the CPU."""
    run["cfg"] = dict(run["cfg"])
    run["cfg"]["heightfield"] = dict(run["cfg"]["heightfield"], grid=10)
    run["cfg"]["resolution"] = [16, 16]
    run["mix"] = dict(run["mix"], check_pixels=64, samples_per_step=2,
                      chunk=2, reference_block=128)


@pytest.fixture
def tiny():
    return shrink


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)
