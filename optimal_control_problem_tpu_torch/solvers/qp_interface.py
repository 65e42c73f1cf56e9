"""Imperative standalone QP-solver interface — the ``CuCaQP`` API surface;
port of ``optimal_control_problem_tpu/solvers/qp_interface.py``.

The reference documents (``sqp_solver/SQP_readme.md:23-197``) and implements
(its ``src/sqp_solver/CuCaQP.{h,cpp}``) an imperative QP object:
``setDimension``, ``setHessianMatrix``, ``setGradient``,
``setLinearConstraintsMatrix``, ``setLower/UpperBound``, ``update*``
variants, solver settings, ``initSolver``/``solve``/``getSolution``.  This
module provides the same surface over the port's ADMM solver
(:func:`.admm.admm_solve`, on ``device``: ``cuda`` unless the caller asks
for the CPU) so standalone-QP users of the reference can migrate without
restructuring, with the same dimension validation semantics
(``CuCaQP.cpp:48-103``: mismatches are reported and the setter returns
False).  With ``backend="pallas"`` settings a solve runs the dense
device-loop kernel.

Pythonic snake_case is primary; the reference's camelCase methods are
provided as aliases.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .admm import ADMMSettings, QPSolution, admm_solve, f32_matmuls

__all__ = ["TpuQP", "CuCaQP"]


class TpuQP:
    """Imperative wrapper over :func:`admm_solve` (OSQP standard form) on
    ``device`` (``cuda`` unless given)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._n: Optional[int] = None
        self._m: Optional[int] = None
        self._P = None
        self._q = None
        self._A = None
        self._l = None
        self._u = None
        self._settings = ADMMSettings()
        self._verbose = False
        self._warm_start = True
        self._initialized = False
        self._solution: Optional[QPSolution] = None

    # -- problem setup (setDimension must come first, CuCaQP.cpp:38-46) ----
    def set_dimension(self, num_variables: int, num_constraints: int) -> bool:
        if num_variables <= 0 or num_constraints < 0:
            return False
        self._n, self._m = int(num_variables), int(num_constraints)
        self._initialized = False
        self._solution = None
        return True

    def _check(self, arr, rows, cols=None, name=""):
        a = np.asarray(arr, dtype=np.float32)
        if cols is None:
            a = a.reshape(-1)
            if a.shape[0] != rows:
                self._warn(f"{name} has {a.shape[0]} entries, expected {rows}")
                return None
        else:
            if a.shape != (rows, cols):
                self._warn(f"{name} has shape {a.shape}, expected {(rows, cols)}")
                return None
        return a

    def _warn(self, msg):
        if self._verbose:
            print(f"[TpuQP] {msg}")

    def set_hessian_matrix(self, hessian) -> bool:
        if self._n is None:
            return False
        a = self._check(hessian, self._n, self._n, "hessian")
        if a is None:
            return False
        self._P = a
        return True

    def set_gradient(self, q) -> bool:
        if self._n is None:
            return False
        a = self._check(q, self._n, name="gradient")
        if a is None:
            return False
        self._q = a
        return True

    def set_linear_constraints_matrix(self, A) -> bool:
        if self._n is None or self._m is None:
            return False
        a = self._check(A, self._m, self._n, "constraint matrix")
        if a is None:
            return False
        self._A = a
        return True

    def set_lower_bound(self, l) -> bool:
        if self._m is None:
            return False
        a = self._check(l, self._m, name="lower bound")
        if a is None:
            return False
        self._l = a
        return True

    def set_upper_bound(self, u) -> bool:
        if self._m is None:
            return False
        a = self._check(u, self._m, name="upper bound")
        if a is None:
            return False
        self._u = a
        return True

    # update* = set* for a live solver (CuCaQP.cpp:105-181): nothing is
    # built ahead of a solve, so there is no re-initialization to avoid.
    update_hessian_matrix = set_hessian_matrix
    update_gradient = set_gradient
    update_linear_constraints_matrix = set_linear_constraints_matrix
    update_lower_bound = set_lower_bound
    update_upper_bound = set_upper_bound

    def set_system(self, system) -> bool:
        """Set (H, q, A, l, u) at once (``setSystem``, CuCaQP.cpp:271-288)."""
        H, q, A, l, u = system
        return (
            self.set_hessian_matrix(H)
            and self.set_gradient(q)
            and self.set_linear_constraints_matrix(A)
            and self.set_lower_bound(l)
            and self.set_upper_bound(u)
        )

    # -- settings (CuCaQP setVerbosity/setWarmStart/tolerances/maxIter) ----
    def set_verbosity(self, verbosity: bool) -> None:
        self._verbose = bool(verbosity)

    def set_warm_start(self, warm_start: bool) -> None:
        self._warm_start = bool(warm_start)

    def set_absolute_tolerance(self, tol: float) -> None:
        self._settings = self._settings.replace(eps_abs=float(tol))

    def set_relative_tolerance(self, tol: float) -> None:
        self._settings = self._settings.replace(eps_rel=float(tol))

    def set_max_iteration(self, max_iter: int) -> None:
        self._settings = self._settings.replace(max_iter=int(max_iter))

    def set_polish(self, polish: bool) -> None:
        self._settings = self._settings.replace(polish=bool(polish))

    def set_settings(self, settings: ADMMSettings) -> None:
        """Every ADMM setting at once (e.g. ``backend="pallas"``,
        ``method="condensed"`` for the device-loop kernel)."""
        self._settings = settings

    # -- solve -------------------------------------------------------------
    def init_solver(self) -> bool:
        """Validate the problem is fully specified (``initSolver``,
        CuCaQP.cpp:183-197).  Unlike OsqpEigen there is no workspace to
        build."""
        ok = all(
            v is not None for v in (self._n, self._m, self._P, self._q)
        ) and (self._m == 0 or all(v is not None for v in (self._A, self._l, self._u)))
        self._initialized = bool(ok)
        if not ok:
            self._warn("initSolver: problem data incomplete")
        return self._initialized

    @f32_matmuls
    def solve(self) -> bool:
        if not self._initialized and not self.init_solver():
            return False
        prev = self._solution if self._warm_start else None
        A = self._A if self._A is not None else np.zeros((0, self._n), np.float32)
        l = self._l if self._l is not None else np.zeros((0,), np.float32)
        u = self._u if self._u is not None else np.zeros((0,), np.float32)
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=self.device)  # noqa: E731
        sol = admm_solve(
            t(self._P),
            t(self._q),
            t(A),
            t(l),
            t(u),
            self._settings,
            x0=prev.x if prev is not None else None,
            y0=prev.y if prev is not None else None,
        )
        self._solution = sol
        if self._verbose:
            print(
                f"[TpuQP] iters={int(sol.iters)} converged={bool(sol.converged)} "
                f"r_prim={float(sol.r_prim):.2e} r_dual={float(sol.r_dual):.2e} "
                f"status={self.get_status()}"
            )
        return bool(sol.converged)

    def get_status(self) -> str:
        """OSQP-style status string for the last solve.

        One of ``"solved"``, ``"primal_infeasible"``, ``"dual_infeasible"``,
        ``"max_iter_reached"`` (OSQP's solver-status enum as surfaced by
        OsqpEigen after ``solveProblem``).
        """
        if self._solution is None:
            return "unsolved"
        sol = self._solution
        if bool(sol.converged):
            return "solved"
        if bool(sol.prim_inf):
            return "primal_infeasible"
        if bool(sol.dual_inf):
            return "dual_infeasible"
        return "max_iter_reached"

    def get_solution(self) -> np.ndarray:
        """``getSolutionAsDM`` analog (CuCaQP.cpp:213-224)."""
        if self._solution is None:
            raise RuntimeError("no solution available; call solve() first")
        return self._solution.x.cpu().numpy()

    def get_dual_solution(self) -> np.ndarray:
        if self._solution is None:
            raise RuntimeError("no solution available; call solve() first")
        return self._solution.y.cpu().numpy()

    @property
    def last_result(self) -> Optional[QPSolution]:
        return self._solution

    def print_solver_data(self) -> None:
        """Debug dump (``printSolverData``, CuCaQP.cpp:226-269)."""
        print(f"n={self._n} m={self._m}")
        for name, v in (
            ("P", self._P),
            ("q", self._q),
            ("A", self._A),
            ("l", self._l),
            ("u", self._u),
        ):
            print(f"{name} =\n{v}")

    # -- reference-style camelCase aliases --------------------------------
    setDimension = set_dimension
    setHessianMatrix = set_hessian_matrix
    setGradient = set_gradient
    setLinearConstraintsMatrix = set_linear_constraints_matrix
    setLowerBound = set_lower_bound
    setUpperBound = set_upper_bound
    updateHessianMatrix = set_hessian_matrix
    updateGradient = set_gradient
    updateLinearConstraintsMatrix = set_linear_constraints_matrix
    updateLowerBound = set_lower_bound
    updateUpperBound = set_upper_bound
    setSystem = set_system
    setVerbosity = set_verbosity
    setWarmStart = set_warm_start
    setAbsoluteTolerance = set_absolute_tolerance
    setRelativeTolerance = set_relative_tolerance
    setMaxIteration = set_max_iteration
    initSolver = init_solver
    getStatus = get_status
    getSolution = get_solution
    getSolutionAsDM = get_solution
    printSolverData = print_solver_data


CuCaQP = TpuQP  # migration alias
