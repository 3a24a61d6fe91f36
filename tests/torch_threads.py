"""One torch thread for each test module of the port.

The CPU suite runs in several processes at once (pytest-xdist, one process a
worker), and torch gives its CPU operators a thread for every core in each
of them. With six workers on eight cores those threads outnumber the cores
several times over and spend most of their time waiting for one another. A
module imports `one_torch_thread`, which pytest then applies to each of its
tests; `child_env` gives a subprocess the same count.
tests/test_torch_depth_net.py keeps the default count (its float32 step's
bound depends on it).
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch's CPU operators on one thread while the module's tests run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def child_env() -> dict:
    """This process's environment, with torch's thread count for a child."""
    return dict(os.environ, OMP_NUM_THREADS=str(torch.get_num_threads()))
