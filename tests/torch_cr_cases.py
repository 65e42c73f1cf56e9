"""Cases and helpers of the ``test_torch_cr*.py`` test files (a module of
helpers, not of tests)."""

from optimal_control_problem_tpu.ops import banded_cr_kernel as jcrk
from tests.test_torch_banded_kernel import SET, run_jax_chunk

CR = SET.replace(banded_solver="cr")


def run_jax_cr(args, kw):
    return run_jax_chunk(args, kw, jcrk.banded_admm_chunk_cr)
