"""A module fixture for the port's test files: one intra-op torch thread.

The suite runs several pytest workers at once; torch's default thread
pools, one per worker, oversubscribe the cores and spin, and small-op
tests then run many times slower (six concurrent copies of one
closed-loop test: 889 s with the default thread count, 44 s with one, on
an 8-core host).  A test file imports the fixture to use it::

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
