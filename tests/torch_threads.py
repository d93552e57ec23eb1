"""One torch thread per pytest-xdist worker, for the port's CPU tests.

Under ``pytest -n N`` each worker is a process of its own, and torch's CPU
operators would each run on a pool of as many threads as the machine has
cores: N such pools on those cores make every small operator wait on the
others. With six workers busy on eight cores, a depth-20 DRF on 400 rows
trained in 21.7 s at torch's default of 8 threads and in 1.2 s at one.
Run alone (no xdist), the tests keep torch's default. One thread also
makes a worker's float reductions independent of the machine's core
count.

A module whose tolerances were set at torch's default thread count (its
float sums split among the threads as they were then) imports
:func:`torch_default_threads`, which runs its tests at that count.
"""

import os

import pytest
import torch

DEFAULT_THREADS = torch.get_num_threads()


def share_cores() -> None:
    """Set torch to one intra-op thread inside an xdist worker."""
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def torch_default_threads():
    """The importing module's tests at torch's default thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    yield
    torch.set_num_threads(n)
