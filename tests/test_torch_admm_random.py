"""The dense ``admm_solve`` against JAX's on random convex QPs (both methods,
with and without adaptive rho) and with polish (the random cases of
``test_torch_admm.py``; helpers in ``torch_admm_cases.py``).
"""

import numpy as np
import pytest
from torch_admm_cases import both, random_qp
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("method", ["kkt", "condensed"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_convex_qp_matches_jax(seed, method, adaptive):
    qp = random_qp(seed)
    js, ts = both(*qp, method=method, adaptive_rho=adaptive)
    assert bool(ts.converged) and bool(js.converged)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), atol=2e-3)
    np.testing.assert_allclose(ts.z.numpy(), np.asarray(js.z), atol=2e-3)
    P, q, A, l, u = qp
    Ax = A @ ts.x.numpy()
    assert np.all(Ax >= l - 5e-3) and np.all(Ax <= u + 5e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_polish_matches_jax(seed):
    qp = random_qp(seed, shift=0.5)
    _, plain = both(*qp, method="kkt")
    js, ts = both(*qp, method="kkt", polish=True)
    assert bool(ts.converged)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), atol=5e-4)
    assert float(ts.r_prim) <= float(plain.r_prim) and float(ts.r_dual) <= float(plain.r_dual)
