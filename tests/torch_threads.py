"""One share of the host's cores for each xdist worker, in the port's
tests and in the processes they start.

torch's intra-op pool has ``os.cpu_count()`` threads by default, and the
suite runs one such pool in each of its xdist workers, which
oversubscribes the cores many times over.  Importing this module (every
``tests/test_torch_*.py`` does, first) sets this process's pool to the
worker's share, the rule ``parallel/dryrun.py`` uses for its ranks.  A
test that starts the port in another process hands it the same count
through ``OMP_NUM_THREADS``: ``child_env()`` for a command's
environment, ``children()`` around a spawn that inherits this
process's.
"""

import contextlib
import os

import pytest
import torch

THREADS = max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
torch.set_num_threads(THREADS)


def child_env(**extra) -> dict:
    """This process's environment with ``OMP_NUM_THREADS`` = THREADS
    and ``extra``."""
    return {**os.environ, "OMP_NUM_THREADS": str(THREADS), **extra}


@contextlib.contextmanager
def children():
    """``OMP_NUM_THREADS`` = THREADS in this process's environment, for
    the processes spawned inside the block."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", str(THREADS))
        yield
