"""The dense batch's ``backend="pallas"`` (the device loop's plain version on
the CPU) against ``"xla"``: random, ``+-inf``/equality, adaptive-rho and
infeasible QPs, the ``condensed`` requirement and JAX's size guard (the
pallas cases of ``test_torch_admm_kernel.py``; helpers in
``torch_admm_kernel_cases.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.solvers import admm as jadmm
from optimal_control_problem_tpu_torch.solvers import admm as tadmm
from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings
from torch_admm_kernel_cases import PALLAS, XLA, inf_eq_qp, random_qp, t
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pallas_matches_xla(seed):
    qp = [t(a) for a in random_qp(seed)]
    ref = tadmm.admm_solve(*qp, XLA)
    ker = tadmm.admm_solve(*qp, PALLAS)
    assert bool(ref.converged) and bool(ker.converged)
    np.testing.assert_allclose(ker.x.numpy(), ref.x.numpy(), atol=2e-3)
    assert int(ker.iters) == int(ref.iters)


def test_pallas_with_inf_bounds_and_equalities():
    qp = [t(a) for a in inf_eq_qp()]
    ref = tadmm.admm_solve(*qp, XLA)
    ker = tadmm.admm_solve(*qp, PALLAS)
    assert bool(ker.converged)
    np.testing.assert_allclose(ker.x.numpy(), ref.x.numpy(), atol=2e-3)


def test_pallas_requires_condensed():
    with pytest.raises(ValueError, match="condensed"):
        tadmm.admm_solve(*[t(a) for a in random_qp(0)], PALLAS.replace(method="kkt"))


@pytest.mark.parametrize("seed", [0, 1])
def test_pallas_adaptive_rho_matches_xla(seed):
    """Kernel re-entry with rho refactorization between rounds: the "xla"
    loop's adapt-every-interval semantics."""
    st = XLA.replace(adaptive_rho=True, adaptive_rho_interval=50, rho=1e-4)
    qp = [t(a) for a in random_qp(seed)]
    before = tadmm._iterate_dense.entries
    ker = tadmm.admm_solve(*qp, st.replace(backend="pallas"))
    assert tadmm._iterate_dense.entries - before > 1  # re-entered after adapting
    ref = tadmm.admm_solve(*qp, st)
    assert bool(ref.converged) and bool(ker.converged)
    assert int(ker.iters) == int(ref.iters)
    np.testing.assert_allclose(ker.x.numpy(), ref.x.numpy(), atol=2e-3)
    assert np.isfinite(float(ker.r_prim)) and np.isfinite(float(ker.r_dual))


def test_pallas_infeasible_qp_certificate():
    P = (2 * np.eye(2)).astype(np.float32)
    A = np.array([[1.0, 1.0], [1.0, 1.0]], np.float32)
    lu = np.array([1.0, 3.0], np.float32)
    sol = tadmm.admm_solve(t(P), torch.zeros(2), t(A), t(lu), t(lu),
                           PALLAS.replace(max_iter=500))
    assert not bool(sol.converged)
    assert bool(sol.prim_inf)


@pytest.mark.parametrize("n,m", [(1619, 1619), (10, 440_000)])
def test_pallas_size_guard_raises_where_jax_raises(n, m):
    """Above the JAX package's 40 MiB operator budget both packages refuse
    backend="pallas" with a ValueError before any work; the "xla" backend is
    not guarded (not run here: the problems are large)."""
    P = np.eye(n, dtype=np.float32)
    q = np.zeros(n, np.float32)
    A = np.zeros((m, n), np.float32)
    l = np.full(m, -1.0, np.float32)
    u = np.full(m, 1.0, np.float32)
    with pytest.raises(ValueError, match="VMEM"):
        jadmm.admm_solve(*map(jnp.asarray, (P, q, A, l, u)),
                         jadmm.ADMMSettings(method="condensed", backend="pallas"))
    st = ADMMSettings(method="condensed", backend="pallas")
    with pytest.raises(ValueError, match="VMEM"):
        tadmm.admm_solve(*map(t, (P, q, A, l, u)), st)
    with pytest.raises(ValueError, match="VMEM"):
        tadmm.admm_solve_batch(*(t(a)[None] for a in (P, q, A, l, u)), st)


def test_pallas_size_guard_boundary():
    """The guard's boundary is JAX's formula: 4 (2 n^2 + 2 m n + 4 (n + m))
    bytes against 40 MiB (n = m = 1618 passes, 1619 does not)."""
    tadmm.check_pallas_size(1618, 1618)
    tadmm.check_pallas_size(120, 236)
    with pytest.raises(ValueError, match=r"n=1619, m=1619"):
        tadmm.check_pallas_size(1619, 1619)
