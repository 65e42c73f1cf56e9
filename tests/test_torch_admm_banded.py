"""Port's per-scenario banded ADMM (``optimal_control_problem_tpu_torch/
solvers/admm_banded.py``) against the JAX package on the same inputs.

Ruiz equilibration agrees to f32 roundoff.  The solver is compared under
a forced iteration budget (eps = 0: both run exactly max_iter iterations
with the same rho-adaptation points), with the iterate tolerances of
``tests/test_banded_batch.py``'s forced-budget test."""

import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.solvers.admm import ADMMSettings as JSettings
from optimal_control_problem_tpu.solvers.admm_banded import (
    admm_solve_banded as j_solve,
    ruiz_equilibrate_banded as j_ruiz,
)
from optimal_control_problem_tpu_torch.interop import (
    banded_qp_from_numpy,
    settings_from_jax_dict,
)
from optimal_control_problem_tpu_torch.solvers.admm_banded import (
    _apply_A,
    _apply_AT,
    admm_solve_banded,
    apply_scalings,
    ruiz_equilibrate_banded,
)
from tests.test_admm_banded import random_stage_qp

import dataclasses
from torch_threads import one_torch_thread  # noqa: F401

SET = JSettings(eps_abs=1e-4, eps_rel=1e-4, method="banded", scaling_iters=10)


def both(seed, **kw):
    jqp = random_stage_qp(seed, **kw)
    return jqp, banded_qp_from_numpy(jqp._asdict(), device="cpu")


def port_settings(st):
    return settings_from_jax_dict(dataclasses.asdict(st))


@pytest.mark.parametrize("seed,r2", [(0, 1), (1, 1), (2, 0)])
def test_ruiz_matches_jax(seed, r2):
    jqp, tqp = both(seed, r2=r2)
    scaled, D, E, c = ruiz_equilibrate_banded(tqp, 10)
    jscaled, jD, jE, jc = j_ruiz(jqp, 10)
    for a, b in zip(scaled, jscaled):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(D.numpy(), np.asarray(jD), rtol=1e-5)
    np.testing.assert_allclose(E.numpy(), np.asarray(jE), rtol=1e-5)
    np.testing.assert_allclose(float(c), float(jc), rtol=1e-5)
    # identity-row pin: Ex * D == 1 exactly as computed
    n = D.shape[0]
    np.testing.assert_allclose((E[:n] * D).numpy(), 1.0, rtol=1e-6)
    # precomputed scalings reproduce the scaled QP
    again = apply_scalings(tqp, D, E, c)
    for a, b in zip(again, scaled):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_structural_products_are_adjoint():
    _, tqp = both(3)
    rng = np.random.default_rng(3)
    N, w = tqp.Hb.shape[0], tqp.Hb.shape[1]
    x = torch.as_tensor(rng.normal(size=(N, w)), dtype=torch.float32)
    t = torch.as_tensor(rng.normal(size=tqp.l.shape), dtype=torch.float32)
    lhs = torch.dot(_apply_A(tqp, x), t)
    rhs = torch.dot(x.reshape(-1), _apply_AT(tqp, t).reshape(-1))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-4)


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("seed", [0, 5])
def test_solve_matches_jax_forced_budget(adaptive, seed):
    st = SET.replace(
        adaptive_rho=adaptive, eps_abs=0.0, eps_rel=0.0, max_iter=100,
        check_infeasibility=False,
    )
    jqp, tqp = both(seed)
    ref = j_solve(jqp, st)
    sol = admm_solve_banded(tqp, port_settings(st))
    assert int(sol.iters) == int(ref.iters) == 100
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(ref.x), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(sol.y.numpy(), np.asarray(ref.y), atol=1e-3, rtol=1e-2)


def test_solve_warm_start_and_polish_match_jax():
    st = SET.replace(polish=True)
    jqp, tqp = both(11)
    rng = np.random.default_rng(11)
    x0 = (0.1 * rng.normal(size=tqp.q.shape)).astype(np.float32)
    y0 = (0.1 * rng.normal(size=tqp.l.shape)).astype(np.float32)
    import jax.numpy as jnp

    ref = j_solve(jqp, st, x0=jnp.asarray(x0), y0=jnp.asarray(y0))
    sol = admm_solve_banded(
        tqp, port_settings(st), x0=torch.as_tensor(x0), y0=torch.as_tensor(y0)
    )
    assert bool(sol.converged) and bool(ref.converged)
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(ref.x), atol=5e-3, rtol=1e-2)
    assert float(sol.r_prim) <= 1e-3 and float(sol.r_dual) <= 1e-3


def test_primal_infeasible_certificate_matches_jax():
    jqp, _ = both(3)
    N, w = jqp.Hb.shape[0], jqp.Hb.shape[1]
    r = jqp.J0.shape[1]
    J0 = np.zeros((N - 1, r, w), np.float32)
    J0[0, 0, 0] = J0[0, 1, 0] = 1.0
    l, u = np.asarray(jqp.l).copy(), np.asarray(jqp.u).copy()
    n = N * w
    l[n] = u[n] = 1.0
    l[n + 1] = u[n + 1] = 2.0
    import jax.numpy as jnp

    bad = jqp._replace(J0=jnp.asarray(J0), J1=jnp.zeros_like(jqp.J1),
                       l=jnp.asarray(l), u=jnp.asarray(u))
    st = SET.replace(max_iter=2000)
    ref = j_solve(bad, st)
    sol = admm_solve_banded(banded_qp_from_numpy(bad._asdict(), device="cpu"), port_settings(st))
    assert bool(ref.prim_inf) and bool(sol.prim_inf)
    assert not bool(sol.converged)
