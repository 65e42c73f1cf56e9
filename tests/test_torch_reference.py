"""The port's host backends (``solvers/reference.py``: scipy trust-constr /
SLSQP over float64 ``torch.func`` evaluations) and the ``MIXED`` / ``IPOPT``
/ ``SQP`` dispatch of ``problem.py`` against the JAX package — mirrors
``tests/test_cross_backend.py`` and the host cases of
``tests/test_problem.py``.

Tolerances.  Both host backends run the same scipy methods on float64
derivatives of the same functions, so the port's solutions are held to
JAX's at 1e-6 (the host solvers' tolerances are 1e-8 to 1e-12) and to the
golden values at JAX's 1e-4.  The device SQP engine is held to the golden
values at JAX's 3e-3, closed-loop trajectories of the two packages at
JAX's 5e-3 (IPOPT vs SQP) and 1e-2 (MIXED's host tick vs its device
tick).
"""

import numpy as np
import pytest
import torch

from optimal_control_problem_tpu import sym as JS
from optimal_control_problem_tpu.models import double_integrator as jdi
from optimal_control_problem_tpu.solvers.reference import solve_nlp_host as j_host
from optimal_control_problem_tpu.solvers.sqp import normalize_nlp as j_normalize
from optimal_control_problem_tpu_torch import SQPOptimizationSolver, SQPOptions, SolverType
from optimal_control_problem_tpu_torch import sym as S
from optimal_control_problem_tpu_torch.models import double_integrator as di
from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings
from optimal_control_problem_tpu_torch.solvers.reference import solve_nlp_host
from optimal_control_problem_tpu_torch.solvers.sqp import normalize_nlp
from torch_threads import one_torch_thread  # noqa: F401


def _nlp(sym, name):
    """The golden NLPs of tests/test_cross_backend.py, built with either
    package's ``sym`` module."""
    x = sym.sym("x", 2)
    if name == "equality_qp":
        return {"x": x, "f": x[0] ** 2 + x[1] ** 2, "g": x[0] + x[1] - 1.0}
    if name == "unconstrained":
        return {"x": x, "f": (x[0] - 3.0) ** 2 + (x[1] + 2.0) ** 2, "g": x[0] - x[1] + 5.0}
    if name == "active_ineq":
        return {"x": x, "f": x[0] ** 2 + x[1] ** 2, "g": sym.vertcat(x[0], x[1])}
    if name == "box_clipped":
        return {"x": x, "f": (x[0] - 3.0) ** 2 + (x[1] - 4.0) ** 2, "g": x[0] - x[1]}
    p = sym.sym("p", 1)
    return {"x": x, "f": (x[0] - p[0]) ** 2 + x[1] ** 2, "g": x[0] - x[1], "p": p}


# (name, expected, lbx, ubx, lbg, ubg, p) as in tests/test_cross_backend.py.
CASES = [
    ("equality_qp", [0.5, 0.5], [-50, -100], [50, 100], [0.0], [0.0], []),
    ("unconstrained", [3.0, -2.0], [-50, -100], [50, 100], [0.0], [10.0], []),
    ("active_ineq", [1.0, 2.0], [-100, -100], [100, 100], [1.0, 2.0], [np.inf, np.inf], []),
    ("box_clipped", [2.0, 3.0], [0, 0], [2, 3], [-10.0], [10.0], []),
    ("parameterized", [5.0, 0.0], [-100, -100], [100, 100], [-10.0], [10.0], [5.0]),
]


@pytest.mark.parametrize("name,expected,lbx,ubx,lbg,ubg,p", CASES, ids=[c[0] for c in CASES])
def test_all_backends_agree(name, expected, lbx, ubx, lbg, ubg, p):
    arrs = {k: np.asarray(v, np.float64) for k, v in
            dict(lbx=lbx, ubx=ubx, lbg=lbg, ubg=ubg, p=p).items()}
    # 1) the device SQP engine (here on the CPU).
    solver = SQPOptimizationSolver(
        _nlp(S, name),
        SQPOptions(max_iter=12, alpha=1.0, admm=ADMMSettings(eps_abs=1e-4, eps_rel=1e-4)),
        device="cpu",
    )
    res = solver.get_optimal_solution(arrs)["x"].numpy()
    np.testing.assert_allclose(res, expected, atol=3e-3, err_msg="TPU_SQP vs expected")
    # 2+3) both host methods on the same functions, in both packages.
    f_fn, g_fn, n_x, _, _ = normalize_nlp(_nlp(S, name))
    jf, jg, _, _, _ = j_normalize(_nlp(JS, name))
    for method in ("trust-constr", "SLSQP"):
        args = (np.zeros(n_x), arrs["p"], arrs["lbx"], arrs["ubx"], arrs["lbg"], arrs["ubg"])
        got = solve_nlp_host(f_fn, g_fn, *args, method=method)
        ref = j_host(jf, jg, *args, method=method)
        assert got["success"] == ref["success"]
        np.testing.assert_allclose(got["x"], expected, atol=1e-4, err_msg=method)
        np.testing.assert_allclose(got["x"], ref["x"], atol=1e-6, err_msg=f"{method} vs JAX")
        np.testing.assert_allclose(float(got["f"]), float(ref["f"]), atol=1e-6)


def test_host_evaluators_are_float64_on_the_cpu():
    """The evaluators see float64 CPU tensors, whatever the problem's
    device: a host backend by design."""
    seen = []

    def f(x, p):
        seen.append((x.dtype, x.device.type, p.dtype))
        return torch.sum((x - 1.0) ** 2)

    out = solve_nlp_host(f, None, np.zeros(3), np.zeros(0), -np.ones(3) * 5, np.ones(3) * 5,
                         np.zeros(0), np.zeros(0), method="SLSQP")
    np.testing.assert_allclose(out["x"], np.ones(3), atol=1e-6)
    assert set(seen) == {(torch.float64, "cpu", torch.float64)}


def small_config(mod, solve_method="TPU_SQP", **kw):
    return mod.make_config(horizon=8, dt=0.05, solve_method=solve_method, alpha=1.0,
                           step_num=6, **kw)


def test_ipopt_backend_matches_tpu_sqp():
    """tests/test_problem.py::test_ipopt_backend_matches_tpu_sqp: the host
    interior point against the device SQP engine after 4 ticks, and the
    port's IPOPT tick against JAX's."""
    frame = di.initial_state(pos=(0.2, -0.1))
    ref = np.tile([0.0, 0.0], 8)
    ocp_t = di.build(small_config(di, ADMM_settings={"eps_abs": 1e-4, "eps_rel": 1e-4}),
                     device="cpu")
    for _ in range(4):
        ocp_t.compute_optimal_trajectory(frame, ref)
    xt = ocp_t.get_optimal_trajectory().numpy()
    ocp_h = di.build(small_config(di, solve_method="IPOPT"), device="cpu")
    assert ocp_h.solver is None  # the host backend alone
    ocp_h.compute_optimal_trajectory(frame, ref)
    xh = ocp_h.get_optimal_trajectory().numpy()
    np.testing.assert_allclose(xt, xh, atol=5e-3)
    jocp = jdi.build(small_config(jdi, solve_method="IPOPT"))
    jocp.compute_optimal_trajectory(frame, ref)
    np.testing.assert_allclose(xh, np.asarray(jocp.get_optimal_trajectory()), atol=1e-5)


def test_sqp_host_backend_ticks():
    """``SQP`` is the host SLSQP (CasADi sqpmethod's stand-in) every tick,
    with the device engine built beside it, as in JAX."""
    frame = di.initial_state(pos=(0.2, -0.1))
    ref = np.zeros(16)
    ocp = di.build(small_config(di, solve_method="SQP"), device="cpu")
    assert ocp.solver is not None
    ocp.compute_optimal_trajectory(frame, ref)
    assert ocp.get_solver_stats() == {}  # no device solve ran
    jocp = jdi.build(small_config(jdi, solve_method="SQP"))
    jocp.compute_optimal_trajectory(frame, ref)
    np.testing.assert_allclose(ocp.get_optimal_trajectory().numpy(),
                               np.asarray(jocp.get_optimal_trajectory()), atol=1e-5)


def test_mixed_backend_switches():
    """Tick 1 on the host, tick 2 on the device engine, seeded with the
    host solution (the hand-off): consistent plans, as in JAX."""
    ocp = di.build(small_config(di, solve_method="MIXED"), device="cpu")
    frame, ref = di.initial_state(), np.zeros(16)
    ocp.compute_optimal_trajectory(frame, ref)
    first = ocp.get_optimal_trajectory().numpy().copy()
    assert torch.equal(ocp.solver._result_x, ocp.get_optimal_trajectory())
    ocp.compute_optimal_trajectory(frame, ref)
    second = ocp.get_optimal_trajectory().numpy()
    assert first.shape == second.shape
    np.testing.assert_allclose(first, second, atol=1e-2)


def test_mixed_reference_dispatch_always_sqp_after_tick1():
    """Default MIXED: every tick after the first runs the device engine,
    even when the objective stays large (the reference's actual
    behavior)."""
    frame = di.initial_state(pos=(5.0, -5.0))
    ref = np.tile([4.0, 4.0], 8)
    ocp = di.build(small_config(di, solve_method="MIXED"), device="cpu")
    assert ocp.get_solver_type() == SolverType.MIXED
    ocp.compute_optimal_trajectory(frame, ref)
    assert ocp.get_solver_stats() == {}
    ocp.compute_optimal_trajectory(frame, ref)
    assert ocp.get_solver_stats() != {}
    # Not compared with JAX's ticks here: from this far frame (objective
    # ~5.9e3) trust-constr stops before its tolerance, and the two
    # packages' host solutions already differ by 0.42 (objectives 5886.46
    # and 5886.02) on float64 rounding; the near frame of
    # test_ipopt_backend_matches_tpu_sqp agrees to 1e-5.
    assert np.isfinite(ocp.get_optimal_trajectory().numpy()).all()


def test_mixed_intent_dispatch_uses_host_on_large_objective():
    """mixed_dispatch='intent' keeps the host while the last objective
    exceeds 1e-6."""
    frame = di.initial_state(pos=(5.0, -5.0))
    ref = np.tile([4.0, 4.0], 8)
    ocp = di.build(small_config(di, solve_method="MIXED", mixed_dispatch="intent"),
                   device="cpu")
    ocp.compute_optimal_trajectory(frame, ref)
    ocp.compute_optimal_trajectory(frame, ref)
    assert ocp.get_solver_stats() == {}


def test_mixed_dispatch_validation():
    with pytest.raises(ValueError, match="mixed_dispatch"):
        di.build(small_config(di, solve_method="MIXED", mixed_dispatch="bogus"), device="cpu")
