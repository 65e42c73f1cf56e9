"""The port's problem front end as users build it, against the JAX package
on the same numpy inputs:

* the reference's 8 golden cases (``tests/test_sqp_cases.py``), written in
  ``Sym`` on both formulations: the port's ``x`` within 2e-3 of JAX's (the
  JAX test's own tolerance) at the cases' settings, and under a forced
  budget (a tolerance no residual meets: every QP runs whole check blocks)
  equal ``qp_iters``;
* the parity preset, the merit line search (its step rule too: ties, NaN
  merits and infinite bounds), the early exit, and the rest of
  ``test_sqp_cases.py``'s solver semantics;
* ``test_problem.py``'s ``Sym`` problem, constraint bookkeeping and solver
  statistics; the port's solver continuing from JAX's iterate.

The shipped configs, the controller's closed loops and the batched ticks
of the augmented formulation: ``test_torch_frontend_ticks.py``.

Split over this file (the golden cases) and ``test_torch_frontend_sqp.py`` (the
rest), so that two test workers carry them; their helpers are in
``torch_frontend_cases.py``.
"""

import numpy as np
import pytest
from torch_frontend_cases import FORCED, GOLDEN, JAX, OPTS, PORT, iters, solve
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("formulation", ["augmented", "reduced"])
@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_golden_case_matches_jax(case, formulation):
    nlp_of, arg, want, tol = GOLDEN[case]
    jx, _ = solve(JAX, nlp_of, arg, formulation=formulation, **OPTS)
    tx, tsolver = solve(PORT, nlp_of, arg, formulation=formulation, **OPTS)
    n_p = len(arg["p"]) if formulation == "augmented" else 0
    assert tsolver._qp_n == n_p + len(arg["lbx"])
    np.testing.assert_allclose(tx, jx, atol=2e-3)
    if want is not None:
        np.testing.assert_allclose(tx, want, atol=tol)
    else:  # case 8: feasible for the ball of radius sqrt(2), objective not raised
        assert tx[0] ** 2 + tx[1] ** 2 <= 2.0 + 1e-2
        assert tx[0] ** 2 - tx[1] ** 2 <= 1e-3
    jx, jsolver = solve(JAX, nlp_of, arg, formulation=formulation, **dict(FORCED))
    tx, tsolver = solve(PORT, nlp_of, arg, formulation=formulation, **dict(FORCED))
    assert iters(tsolver) == iters(jsolver) == [50] * 12
    np.testing.assert_allclose(tx, jx, atol=2e-3)
