"""A module fixture for the port's test files: one intra-op torch thread,
and one BLAS thread for numpy and scipy.

The suite runs several pytest workers at once; torch's default thread
pools, one per worker, oversubscribe the cores and spin, and small-op
tests then run many times slower (six concurrent copies of one
closed-loop test: 889 s with the default thread count, 44 s with one, on
an 8-core host).  OpenBLAS does the same under scipy's host solvers on
small matrices (one trust-constr tick of the double integrator h8: 19.9 s
with its eight threads, 3.0 s with one).  A test file imports the fixture
to use it::

    from torch_threads import one_torch_thread  # noqa: F401
"""

import contextlib

import pytest
import torch

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # BLAS keeps its own threads where the package is missing
    threadpool_limits = None


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    blas = threadpool_limits(1, user_api="blas") if threadpool_limits else contextlib.nullcontext()
    with blas:
        yield
    torch.set_num_threads(n)
