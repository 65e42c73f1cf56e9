"""The port's imperative ``TpuQP`` / ``CuCaQP`` (``solvers/qp_interface.py``)
against the JAX package's — mirrors ``tests/test_qp_interface.py``.

Both wrap their package's ``admm_solve`` with the same settings, so each
solution is held to the golden value at the JAX test's tolerance and to
JAX's solution at 2e-3 (the converged tolerance of ``tests/test_torch_admm.py``:
two f32 programs whose inverses come from different LAPACK front-ends).
"""

import numpy as np
import pytest

from optimal_control_problem_tpu.solvers.qp_interface import TpuQP as JQP
from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings
from optimal_control_problem_tpu_torch.solvers.qp_interface import CuCaQP, TpuQP
from torch_threads import one_torch_thread  # noqa: F401


def both(setup):
    """Run ``setup`` (which calls setters and solve) on a port and a JAX
    object; returns the two."""
    qp, jqp = TpuQP(device="cpu"), JQP()
    for obj in (qp, jqp):
        setup(obj)
    return qp, jqp


def test_full_workflow_snake_case():
    def setup(qp):
        assert qp.set_dimension(2, 1)
        assert qp.set_hessian_matrix(2 * np.eye(2))
        assert qp.set_gradient(np.zeros(2))
        assert qp.set_linear_constraints_matrix(np.array([[1.0, 1.0]]))
        assert qp.set_lower_bound([1.0])
        assert qp.set_upper_bound([1.0])
        qp.set_absolute_tolerance(1e-4)
        qp.set_relative_tolerance(1e-4)
        assert qp.init_solver()
        assert qp.solve()

    qp, jqp = both(setup)
    np.testing.assert_allclose(qp.get_solution(), [0.5, 0.5], atol=1e-3)
    np.testing.assert_allclose(qp.get_solution(), jqp.get_solution(), atol=2e-3)
    np.testing.assert_allclose(qp.get_dual_solution(), jqp.get_dual_solution(), atol=2e-3)
    assert qp.get_status() == jqp.get_status() == "solved"


def test_reference_camel_case_api():
    def setup(qp):
        assert qp.setDimension(3, 2)
        assert qp.setHessianMatrix(np.diag([2.0, 2.0, 2.0]))
        assert qp.setGradient(np.array([-1.0, -2.0, 0.0]))
        assert qp.setLinearConstraintsMatrix(np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 1.0]]))
        assert qp.setLowerBound(np.array([0.0, 0.0]))
        assert qp.setUpperBound(np.array([10.0, 10.0]))
        qp.setVerbosity(False)
        qp.setWarmStart(True)
        qp.setAbsoluteTolerance(1e-4)
        qp.setRelativeTolerance(1e-4)
        qp.setMaxIteration(10000)
        assert qp.initSolver()
        assert qp.solve()

    assert CuCaQP is TpuQP
    qp, jqp = both(setup)
    np.testing.assert_allclose(qp.getSolutionAsDM(), [0.5, 1.0, 0.0], atol=2e-3)
    np.testing.assert_allclose(qp.getSolution(), jqp.getSolution(), atol=2e-3)


def test_dimension_mismatch_returns_false():
    qp = TpuQP(device="cpu")
    qp.set_dimension(2, 1)
    assert not qp.set_hessian_matrix(np.eye(3))
    assert not qp.set_gradient(np.zeros(3))
    assert not qp.set_linear_constraints_matrix(np.zeros((2, 2)))
    assert not qp.set_lower_bound(np.zeros(2))


def test_setters_before_dimension_fail():
    qp = TpuQP(device="cpu")
    assert not qp.set_hessian_matrix(np.eye(2))
    assert not qp.init_solver()
    assert not qp.solve()


def test_update_and_resolve_with_warm_start():
    def setup(qp):
        qp.set_dimension(2, 2)
        qp.set_system((2 * np.eye(2), np.array([-2.0, -4.0]), np.eye(2), np.zeros(2),
                       10 * np.ones(2)))
        qp.set_absolute_tolerance(1e-4)
        qp.set_relative_tolerance(1e-4)
        assert qp.solve()
        qp.first = qp.get_solution().copy()
        assert qp.update_gradient(np.array([-4.0, -2.0]))
        assert qp.solve()

    qp, jqp = both(setup)
    np.testing.assert_allclose(qp.first, [1.0, 2.0], atol=1e-3)
    np.testing.assert_allclose(qp.get_solution(), [2.0, 1.0], atol=1e-3)
    np.testing.assert_allclose(qp.get_solution(), jqp.get_solution(), atol=2e-3)
    assert int(qp.last_result.iters) == int(jqp.last_result.iters)


def test_get_solution_before_solve_raises():
    with pytest.raises(RuntimeError):
        TpuQP(device="cpu").get_solution()


def test_device_loop_settings_and_status():
    """``set_settings`` reaches every ADMM setting: the dense device loop
    (``backend="pallas"``; its plain version here) solves the same QP, and
    an infeasible QP reports JAX's status string."""
    qp = TpuQP(device="cpu")
    qp.set_dimension(2, 1)
    qp.set_system((2 * np.eye(2), np.zeros(2), np.array([[1.0, 1.0]]), [1.0], [1.0]))
    qp.set_settings(ADMMSettings(eps_abs=1e-4, eps_rel=1e-4, method="condensed",
                                 backend="pallas"))
    assert qp.solve()
    np.testing.assert_allclose(qp.get_solution(), [0.5, 0.5], atol=1e-3)

    def infeasible(q):
        q.set_dimension(1, 2)
        q.set_system((np.eye(1), np.zeros(1), np.array([[1.0], [1.0]]), [1.0, -3.0],
                      [2.0, -2.0]))
        assert not q.solve()

    qp, jqp = both(infeasible)
    assert qp.get_status() == jqp.get_status() == "primal_infeasible"
