"""One torch intra-op thread for the port's CPU tests (tests only).

The suite runs in several worker processes at once.  With torch's default
pool (one thread per core) in each of them, the port's many small ops spin
on oversubscribed cores: on 8 cores, four port test files in four workers
took 698 s together and 47 s with one thread each.  Each port test file
imports ``one_torch_thread``, an autouse fixture that holds the count at 1
for the file's tests and restores it after, so a file computes both sides
of every comparison with the same pool.
"""

import pytest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
