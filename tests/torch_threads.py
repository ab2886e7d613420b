"""One intra-op torch thread for a test module of the port.

The port's CPU tests step plain fused and generic envs at B = 16-64, where
torch's intra-op thread pool has nothing to split: its threads only spin,
and under several pytest-xdist workers the pools of the workers take the
cores from one another. A test module opts in with

    from torch_threads import one_torch_thread  # noqa: F401

which makes this module-scoped autouse fixture its own: torch runs that
module's tests at one thread and gets its previous count back after them.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
