"""User-facing problem builder + MPC front-end — port of
``optimal_control_problem_tpu/problem.py`` (the reference's
``OptimalControlProblem``).

Kept: the solver-settings parsing and validation with the YAML schema, the
cost/constraint registries (``add_scalar_cost``, ``add_vector_cost`` —
``c^T diag(w) c`` —, ``add_inequality_constraint``,
``add_equation_constraint``) whose terms are :class:`Sym` expressions or
torch callables ``fn(X, P)``, the stage structure and ``gen_solver``'s
automatic switch to the banded QP method, the reference-parity preset
(``SQP_settings.parity``: the dense augmented path, cold QPs), the per-tick
solve with first-frame pinning and cross-tick warm start, input validation
and the per-tick solver statistics; and the solver menu: ``TPU_SQP`` (the
device SQP engine), the host backends ``IPOPT`` and ``SQP``
(:func:`.solvers.reference.solve_nlp_host`, scipy over float64 CPU
evaluations of the same functions) and ``MIXED`` (the host on the first
tick, the device engine after it, per ``mixed_dispatch``).

The problem lives on one device, chosen at construction: ``cuda`` unless
the caller passes ``device="cpu"`` (:func:`..device.resolve_device`).  The
host backends evaluate the problem's functions on float64 CPU copies
whatever that device is, and hand their solution back to it.
"""

from __future__ import annotations

import enum
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .config import OCPConfig, load_config
from .device import resolve_device
from .solvers.admm import ADMMSettings
from .solvers.reference import solve_nlp_host
from .solvers.sqp import SQPOptimizationSolver, SQPOptions
from .sym import Sym, evaluate, sym
from .utils.logging import ocp_warn

__all__ = ["SolverType", "SolverSettings", "OptimalControlProblem"]


class SolverType(enum.Enum):
    """Solver menu (``OptimalControlProblem.h:17-22``).  ``TPU_SQP`` is the
    device hot path; ``CUDA_SQP`` is accepted as its alias."""

    IPOPT = "IPOPT"
    SQP = "SQP"
    TPU_SQP = "TPU_SQP"
    MIXED = "MIXED"


class SolverSettings:
    """Parsed ``solver_settings`` (``OptimalControlProblem.h:15-37``)."""

    def __init__(self, node: Dict[str, Any]):
        required = [
            "max_iter",
            "warm_start",
            "SQP_settings",
            "verbose",
            "gen_code",
            "load_lib",
            "solve_method",
        ]
        for key in required:
            if key not in node:
                raise ValueError(f"Invalid configuration file: missing solver_settings.{key}")
        sqp_node = node["SQP_settings"]
        for key in ("alpha", "step_num"):
            if key not in sqp_node:
                raise ValueError(f"Invalid configuration file: missing SQP_settings.{key}")

        self.max_iter = int(node["max_iter"])
        self.warm_start = bool(node["warm_start"])
        self.verbose = bool(node["verbose"])
        self.gen_code = bool(node["gen_code"])
        self.load_lib = bool(node["load_lib"])
        self.recompile = bool(node.get("recompile", False))
        self.alpha = float(sqp_node["alpha"])
        self.step_num = int(sqp_node["step_num"])
        self.line_search = str(sqp_node.get("line_search", "none"))
        self.ls_num = int(sqp_node.get("ls_num", 8))
        self.ls_alpha_max = float(sqp_node.get("ls_alpha_max", 1.0))
        self.ls_merit_mu = float(sqp_node.get("ls_merit_mu", 10.0))
        self.parity = bool(sqp_node.get("parity", False))
        hr = sqp_node.get("hessian_reg", 0.0 if self.parity else "auto")
        self.hessian_reg = hr if isinstance(hr, str) else float(hr)
        ee = sqp_node.get("early_exit", None)
        self.early_exit = None if ee is None else bool(ee)
        self.early_exit_tol = float(sqp_node.get("early_exit_tol", 1e-6))
        # MIXED tick-2+ dispatch: "reference" = always SQP after the first
        # tick (what the reference's OptimalControlProblem.cpp:92,153-161
        # does: `res` is freshly default-constructed each call, so the
        # f-based IPOPT branch never fires); "intent" = the comment's
        # intent (IPOPT whenever the previous objective stayed above 1e-6).
        self.mixed_dispatch = str(node.get("mixed_dispatch", "reference"))
        if self.mixed_dispatch not in ("reference", "intent"):
            raise ValueError(
                f"mixed_dispatch must be 'reference' or 'intent', got {self.mixed_dispatch!r}"
            )

        method = str(node["solve_method"])
        if method == "CUDA_SQP":  # accepted alias (readme.md:58)
            method = "TPU_SQP"
        try:
            self.solver_type = SolverType(method)
        except ValueError:
            raise ValueError(f"Unknown solver type: {method}") from None

        self.formulation = str(node.get("formulation", "augmented"))
        self.qp_warm_start_explicit = "qp_warm_start" in node
        self.qp_warm_start = bool(node.get("qp_warm_start", True))
        ss = node.get("shared_system", None)
        self.shared_system = None if ss is None else bool(ss)
        self.dtype = torch.float64 if node.get("precision", "f32") == "f64" else torch.float32
        admm_node = node.get("ADMM_settings", {})
        self.admm = ADMMSettings(
            rho=float(admm_node.get("rho", 0.1)),
            sigma=float(admm_node.get("sigma", 1e-6)),
            alpha=float(admm_node.get("alpha", 1.6)),
            eps_abs=float(admm_node.get("eps_abs", 1e-3)),
            eps_rel=float(admm_node.get("eps_rel", 1e-3)),
            max_iter=int(admm_node.get("max_iter", 10000)),
            check_every=int(admm_node.get("check_every", 25)),
            scaling_iters=int(admm_node.get("scaling_iters", 10)),
            scaling_refresh=str(admm_node.get("scaling_refresh", "step")),
            adaptive_rho=bool(admm_node.get("adaptive_rho", True)),
            method=str(admm_node.get("method", "kkt")),
            banded_solver=str(admm_node.get("banded_solver", "thomas")),
            backend=str(admm_node.get("backend", "xla")),
            precision=str(admm_node.get("precision", "highest")),
            fused_gemm=bool(admm_node.get("fused_gemm", False)),
            polish=bool(admm_node.get("polish", False)),
            check_infeasibility=bool(admm_node.get("check_infeasibility", True)),
            eps_prim_inf=float(admm_node.get("eps_prim_inf", 1e-4)),
            eps_dual_inf=float(admm_node.get("eps_dual_inf", 1e-4)),
        )
        # When the user did not pin the QP method, gen_solver picks "banded"
        # for stage-structured problems.
        self.admm_method_explicit = "method" in admm_node

    @classmethod
    def default_node(cls, solve_method: str = "TPU_SQP") -> Dict[str, Any]:
        """A complete solver_settings mapping with reference defaults
        (``OptimalControlProblem.h:24-36``: alpha=0.1, step_num=10)."""
        return {
            "max_iter": 1000,
            "warm_start": True,
            "verbose": False,
            "gen_code": False,
            "load_lib": False,
            "solve_method": solve_method,
            "SQP_settings": {"alpha": 0.1, "step_num": 10},
        }


CostLike = Union[Sym, Callable]
ExprLike = Union[Sym, Callable]


class OptimalControlProblem:
    """Build a discretized OCP and solve it each MPC tick.

    Usage::

        ocp = OptimalControlProblem(config_dict, device="cuda")  # or subclass
        ocp.set_reference(ref_size)
        ocp.set_stage_structure(structure)
        ocp.gen_solver()
        ocp.compute_optimal_trajectory(frame, reference)   # per tick
        traj = ocp.get_optimal_trajectory()
    """

    def __init__(self, config_node: Any, device=None):
        self.device = resolve_device(device)
        node = load_config(config_node)
        if "solver_settings" not in node:
            raise ValueError("Invalid configuration file: missing solver_settings")
        self.solver_settings = SolverSettings(node["solver_settings"])
        self.ocp_config = OCPConfig(node)
        self._config_node = node

        self._costs: List[CostLike] = []
        self._constraints: List[ExprLike] = []
        self._constraint_names: List[str] = []
        self._constraint_sizes: List[int] = []
        self._constraint_lower: List[np.ndarray] = []
        self._constraint_upper: List[np.ndarray] = []

        self._reference: Optional[Sym] = None
        self._stage_structure = None
        self._first_time = True
        self._optimal_trajectory: Optional[torch.Tensor] = None
        self._last_f: Optional[float] = None
        self._solver: Optional[SQPOptimizationSolver] = None
        self._nlp_fns = None  # (f_fn, g_fn)
        self._generated = False

    # ------------------------------------------------------------------
    def deploy_constraints_and_add_cost(self) -> None:
        """Override in subclasses to define dynamics, costs, constraints."""
        raise NotImplementedError

    def set_reference(self, reference: Union[Sym, int]) -> None:
        """Define the parameter (reference-trajectory) vector ``p``: a leaf
        :class:`Sym` or an int size (a leaf named ``"P"`` is created)."""
        if isinstance(reference, int):
            reference = sym("P", reference)
        if not isinstance(reference, Sym) or reference.name is None:
            raise ValueError("reference must be a leaf Sym or an int size")
        self._reference = reference

    def get_reference(self) -> Optional[Sym]:
        return self._reference

    @property
    def reference_size(self) -> int:
        return 0 if self._reference is None else self._reference.size1()

    # -- cost / constraint registries (cpp:444-489, 574-600) --------------
    def add_scalar_cost(self, cost: CostLike) -> None:
        if isinstance(cost, Sym) and cost.size1() != 1:
            raise ValueError("scalar cost must have size 1")
        self._costs.append(cost)

    def add_vector_cost(self, weights: Sequence[float], cost: ExprLike) -> None:
        """Quadratic-form cost ``sum_i w_i * c_i(X, P)^2`` (cpp:574-600)."""
        w = np.asarray(weights, dtype=np.float64).reshape(-1)
        if isinstance(cost, Sym):
            if w.shape[0] != cost.size1():
                raise ValueError("weight vector and cost expression dimensions differ")
            self._costs.append(_sym_quadform(w, cost))
        else:
            def quadform(X, P, c=cost):
                v = torch.as_tensor(c(X, P)).reshape(-1)
                return torch.sum(torch.as_tensor(w, dtype=v.dtype, device=v.device)
                                 * torch.square(v))

            self._costs.append(quadform)

    def get_cost_function(self) -> Callable:
        """Total cost as a callable ``f(X, P) -> scalar`` (cpp:491-497)."""
        costs = list(self._costs)
        leaf = self._leaf_names()

        def f_fn(X, P):
            total = torch.zeros((), dtype=X.dtype, device=X.device)
            for c in costs:
                total = total + _eval_term(c, X, P, leaf)
            return total

        return f_fn

    def add_inequality_constraint(
        self,
        constraint_name: str,
        lower_bound: Sequence[float],
        expression: ExprLike,
        upper_bound: Sequence[float],
    ) -> None:
        lb = np.atleast_1d(np.asarray(lower_bound, dtype=np.float64))
        ub = np.atleast_1d(np.asarray(upper_bound, dtype=np.float64))
        size = self._expr_size(expression)
        if lb.shape[0] != size or ub.shape[0] != size:
            raise ValueError("inequality constraint bounds/expression dimensions differ")
        self._constraints.append(expression)
        self._constraint_names.extend([constraint_name] * size)
        self._constraint_sizes.append(size)
        self._constraint_lower.append(lb)
        self._constraint_upper.append(ub)

    def add_equation_constraint(
        self, constraint_name: str, left: ExprLike, right: Optional[ExprLike] = None
    ) -> None:
        """``left == right`` (or ``left == 0``), as ``0 <= left-right <= 0``
        (cpp:467-489)."""
        if right is None:
            expr = left
        elif isinstance(left, Sym) and isinstance(right, Sym):
            if left.size1() != right.size1():
                raise ValueError("equation constraint sides have different dimensions")
            expr = left - right
        elif callable(left) and callable(right):
            def expr(X, P, l=left, r=right):
                return (torch.as_tensor(l(X, P)).reshape(-1)
                        - torch.as_tensor(r(X, P)).reshape(-1))
        elif isinstance(left, Sym):
            expr = left - np.asarray(right, dtype=np.float64)
        else:
            raise ValueError("unsupported equation constraint operand types")
        size = self._expr_size(expr)
        self._constraints.append(expr)
        self._constraint_names.extend([constraint_name] * size)
        self._constraint_sizes.append(size)
        self._constraint_lower.append(np.zeros(size))
        self._constraint_upper.append(np.zeros(size))

    def _expr_size(self, expr) -> int:
        """Static output size of a constraint term (a callable's from one
        CPU evaluation)."""
        if isinstance(expr, Sym):
            return expr.size1()
        X = torch.zeros((self.ocp_config.num_variables,), dtype=torch.float64)
        P = torch.zeros((self.reference_size,), dtype=torch.float64)
        return int(torch.as_tensor(expr(X, P)).reshape(-1).shape[0])

    def get_constraints(self) -> List[ExprLike]:
        return list(self._constraints)

    def get_constraint_names(self) -> List[str]:
        return list(self._constraint_names)

    def get_constraint_lower_bounds(self) -> np.ndarray:
        if self._stage_structure is not None and hasattr(self, "_structure_lbg"):
            return self._structure_lbg
        return np.concatenate(self._constraint_lower) if self._constraint_lower else np.zeros(0)

    def get_constraint_upper_bounds(self) -> np.ndarray:
        if self._stage_structure is not None and hasattr(self, "_structure_ubg"):
            return self._structure_ubg
        return np.concatenate(self._constraint_upper) if self._constraint_upper else np.zeros(0)

    @property
    def num_constraints(self) -> int:
        if self._stage_structure is not None:
            return self._stage_structure.n_g
        return sum(self._constraint_sizes)

    # ------------------------------------------------------------------
    def _leaf_names(self):
        x_name = self.ocp_config.get_variables().name
        p_name = self._reference.name if self._reference is not None else None
        return x_name, p_name

    def _build_nlp_fns(self):
        """``(f_fn, g_fn)`` from the registries: the sum of the costs and
        the concatenated constraint terms, as callables of ``(X, P)``."""
        f_fn = self.get_cost_function()
        constraints = list(self._constraints)
        leaf = self._leaf_names()

        def g_fn(X, P):
            return torch.cat([_eval_term(c, X, P, leaf, scalar=False) for c in constraints])

        return f_fn, (g_fn if constraints else None)

    def set_stage_structure(self, structure) -> None:
        """Declare the problem's stage-separable structure (stagewise.py).
        ``gen_solver`` then derives the NLP functions and the banded QP
        path from it; the cost/constraint registries are not used."""
        from .stagewise import StageStructure

        if not isinstance(structure, StageStructure):
            raise TypeError("expected a StageStructure")
        cfg = self.ocp_config
        if structure.horizon != cfg.get_horizon() or (
            structure.frame_size != cfg.get_frame_size()
        ):
            raise ValueError("stage structure does not match the config's horizon/frame")
        self._stage_structure = structure

    def gen_solver(self) -> None:
        """Build the NLP functions and the selected backend (``genSolver``,
        cpp:224-442)."""
        if self.ocp_config.num_variables == 0:
            raise RuntimeError("Status or input variables are empty")
        st = self.solver_settings
        if self._stage_structure is None and not self._constraints:
            raise RuntimeError("Constraints are empty")  # cpp:230-233
        ss = self._stage_structure
        parts = None
        if ss is not None:
            from .stagewise import build_stagewise_fns, build_stagewise_parts

            f_fn, g_fn, lbg, ubg = build_stagewise_fns(ss)
            self._structure_lbg = lbg
            self._structure_ubg = ubg
            # Under the parity preset the structure defines the NLP
            # functions only: the reference's dense augmented flow solves.
            if not st.parity:
                st.formulation = "reduced"
                parts = build_stagewise_parts(ss, st.dtype, "auto")
                # The block-tridiagonal QP path is the default whenever a
                # stage structure is registered and the user did not pin a
                # method.
                if not st.admm_method_explicit and st.admm.method == "kkt":
                    st.admm = st.admm.replace(method="banded")
        else:
            f_fn, g_fn = self._build_nlp_fns()
        self._nlp_fns = (f_fn, g_fn)
        # IPOPT is the host backend alone: no device engine to build.
        if st.solver_type != SolverType.IPOPT:
            self._build_engine(st, f_fn, g_fn, parts, ss)
        self._generated = True
        if st.verbose:
            print(
                "Problem dimensions:\n"
                f"Variables: {self.ocp_config.num_variables}\n"
                f"Constraints: {self.num_constraints}\n"
                f"Parameters: {self.reference_size}"
            )

    def _build_engine(self, st, f_fn, g_fn, parts, ss) -> None:
        """The device SQP engine (TPU_SQP, and MIXED's later ticks; SQP
        builds it too, as JAX does)."""
        nlp = {
            "x": self.ocp_config.get_variables(),
            "f": f_fn,
            "g": g_fn,
            "p": self.reference_size,
        }
        kw = dict(
            max_iter=st.step_num,
            alpha=st.alpha,
            verbose=st.verbose,
            qp_warm_start=st.qp_warm_start,
            dtype=st.dtype,
            admm=st.admm,
            early_exit=st.early_exit,
            early_exit_tol=st.early_exit_tol,
        )
        if st.parity:
            # The preset pins formulation, hessian_reg, line_search and
            # shared_system; QPs start cold unless the config set
            # qp_warm_start itself.
            if not st.qp_warm_start_explicit:
                kw.pop("qp_warm_start")
            options = SQPOptions.parity(**kw)
        else:
            options = SQPOptions(
                formulation=st.formulation,
                shared_system=st.shared_system,
                hessian_reg=st.hessian_reg,
                line_search=st.line_search,
                ls_num=st.ls_num,
                ls_alpha_max=st.ls_alpha_max,
                ls_merit_mu=st.ls_merit_mu,
                **kw,
            )
        self._solver = SQPOptimizationSolver(
            nlp, options, local_system_parts=parts, stage_structure=ss,
            device=self.device,
        )

    # ------------------------------------------------------------------
    def solver_input_check(self, arg: Dict[str, Any]) -> bool:
        """Dimension validation (``solverInputCheck``, cpp:511-552)."""
        checks = [
            ("lbg", self.num_constraints),
            ("ubg", self.num_constraints),
            ("lbx", self.ocp_config.num_variables),
            ("ubx", self.ocp_config.num_variables),
            ("x0", self.ocp_config.num_variables),
            ("p", self.reference_size),
        ]
        for name, expected in checks:
            actual = int(np.asarray(arg[name]).reshape(-1).shape[0])
            if actual != expected:
                ocp_warn(f"{name} has wrong dimension: expected {expected}, got {actual}")
                return False
        return True

    def compute_optimal_trajectory(self, frame, reference=None) -> None:
        """One MPC tick (``computeOptimalTrajectory``, cpp:78-222): the
        measured ``frame`` is imposed by pinning the first-frame bounds."""
        if not self._generated:
            raise RuntimeError("gen_solver() must be called before solving")
        cfg = self.ocp_config
        frame = np.asarray(frame, dtype=np.float64).reshape(-1)
        if frame.shape[0] != cfg.get_frame_size():
            raise ValueError(
                f"State dimension mismatch: received {frame.shape[0]}, "
                f"expected {cfg.get_frame_size()}"
            )
        if reference is None:
            reference = np.zeros(0)
        reference = np.asarray(reference, dtype=np.float64).reshape(-1)
        if reference.shape[0] != self.reference_size:
            raise ValueError(
                f"Reference dimension mismatch: received {reference.shape[0]}, "
                f"expected {self.reference_size}"
            )
        lbx = cfg.lower_bounds_flat().copy()
        ubx = cfg.upper_bounds_flat().copy()
        fs = cfg.get_frame_size()
        lbx[:fs] = frame  # first-frame pinning (cpp:95-96)
        ubx[:fs] = frame
        if self._first_time:
            ig = cfg.get_initial_guess()
            x0 = ig if ig is not None else np.zeros(cfg.num_variables)
        else:
            x0 = self._optimal_trajectory.cpu().numpy()
        arg = {
            "lbx": lbx,
            "ubx": ubx,
            "lbg": self.get_constraint_lower_bounds(),
            "ubg": self.get_constraint_upper_bounds(),
            "x0": x0,
            "p": reference,
        }
        if not self.solver_input_check(arg):
            raise RuntimeError("Solver input validation failed")
        st = self.solver_settings
        stype = st.solver_type
        if stype == SolverType.MIXED:
            # "reference": the host on the first tick, the device engine on
            # every later one; "intent": the host also while the last
            # objective stayed above 1e-6 (a debugging aid, not a hot path).
            host = self._first_time or self._optimal_trajectory is None or (
                st.mixed_dispatch == "intent" and self._last_f is not None
                and self._last_f > 1e-6
            )
            stype = SolverType.IPOPT if host else SolverType.TPU_SQP
        if stype == SolverType.TPU_SQP:
            res = self._solver.get_optimal_solution(arg)
            x_sol, f_sol = res["x"], float(res["f"])
        else:
            f_fn, g_fn = self._nlp_fns
            method = "trust-constr" if stype == SolverType.IPOPT else "SLSQP"
            res = solve_nlp_host(f_fn, g_fn, x0, reference, lbx, ubx, arg["lbg"], arg["ubg"],
                                 method=method)
            x_sol = torch.as_tensor(res["x"], dtype=st.dtype, device=self.device)
            f_sol = float(res["f"])
            if self._solver is not None:
                # Seed the device engine's persistent iterate so a MIXED
                # hand-off continues from the host solution.
                self._solver._result_x = x_sol
        self._first_time = False
        self._optimal_trajectory = x_sol
        self._last_f = f_sol
        if self.solver_settings.verbose:
            print("=================== result ===================")
            print(f"objective: {self._last_f}")

    def get_optimal_trajectory(self):
        """Latest full-horizon solution (``getOptimalTrajectory``)."""
        return self._optimal_trajectory

    def get_solver_stats(self) -> Dict[str, Any]:
        """Statistics of the last solve: ``objective``, ``f_history``
        (objective after each SQP step), ``qp_iters`` (ADMM iterations per
        step), ``step_norms`` (``||alpha*dx||`` per step) and the per-step
        QP status flags ``qp_converged``, ``qp_prim_inf``, ``qp_dual_inf``,
        as numpy arrays.  Empty before the first solve."""
        res = self._solver.last_result if self._solver is not None else None
        if res is None:
            return {}
        np_ = lambda t: t.cpu().numpy()  # noqa: E731
        out = {
            "objective": float(res.f),
            "f_history": np_(res.f_history),
            "qp_iters": np_(res.qp_iters),
            "step_norms": np_(res.step_norms),
        }
        if res.qp_converged.numel():
            out["qp_converged"] = np_(res.qp_converged)
            out["qp_prim_inf"] = np_(res.qp_prim_inf)
            out["qp_dual_inf"] = np_(res.qp_dual_inf)
        return out

    def get_optimal_frames(self) -> np.ndarray:
        """Solution reshaped to ``(horizon, frame_size)``."""
        if self._optimal_trajectory is None:
            raise RuntimeError("no solution available")
        cfg = self.ocp_config
        return self._optimal_trajectory.cpu().numpy().reshape(
            cfg.get_horizon(), cfg.get_frame_size()
        )

    # convenience passthroughs ------------------------------------------
    def get_variable(self, step: int, name: str) -> Sym:
        return self.ocp_config.get_variable(step, name)

    def set_solver_type(self, stype: SolverType) -> None:
        self.solver_settings.solver_type = stype

    def get_solver_type(self) -> SolverType:
        return self.solver_settings.solver_type

    @property
    def solver(self) -> Optional[SQPOptimizationSolver]:
        return self._solver

    @property
    def nlp_functions(self):
        """(f_fn, g_fn) after gen_solver()."""
        return self._nlp_fns


# ----------------------------------------------------------------------
def _sym_quadform(w: np.ndarray, cost: Sym) -> Sym:
    """``sum_i w_i c_i^2`` as a Sym (addVectorCost, cpp:574-586)."""

    def fn(env, memo):
        c = cost._ev(env, memo)
        wt = torch.as_tensor(w, dtype=c.dtype, device=c.device)
        return torch.sum(wt * torch.square(c)).reshape(1)

    return Sym(fn, (1,), (cost,))


def _eval_term(term, X, P, leaf_names, scalar: bool = True):
    """One registry term at ``(X, P)``: a Sym evaluated with ``X``/``P``
    bound to the leaf names, or a callable called."""
    x_name, p_name = leaf_names
    if isinstance(term, Sym):
        env = {x_name: X}
        if p_name is not None:
            env[p_name] = P
        out = evaluate(term, env)
        return out[0] if scalar else out
    out = torch.as_tensor(term(X, P))
    return out.reshape(()) if scalar else out.reshape(-1)
