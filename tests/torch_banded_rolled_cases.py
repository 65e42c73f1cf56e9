"""Cases and helpers of the ``test_torch_banded_rolled*.py`` test files (a module of
helpers, not of tests)."""

from optimal_control_problem_tpu.ops.banded_rolled_kernel import (
    banded_admm_chunk_rolled as j_rolled,
)
from tests.test_torch_banded_kernel import run_jax_chunk

# At the quadrotor's width (w=16, r=12) random stage QPs are worse
# conditioned still: each f32 program (the port's plain chunk, one-way or
# two-way, and JAX's kernel) sits ~1e-3 from a float64 run of the same
# chunk after one iteration, so they are held to each other at WIDE and
# the port is also held to its own float64 run.
WIDE_ATOL, WIDE_RTOL = 4e-3, 1e-2


def run_jax_rolled(args, kw):
    return run_jax_chunk(args, kw, j_rolled)


def cr1_of(N):
    return N % 2 == 0 and N >= 16


def to_f64(args):
    return [
        {k: v.double() for k, v in a.items()} if isinstance(a, dict)
        else (a.double() if a.is_floating_point() else a)
        for a in args
    ]
