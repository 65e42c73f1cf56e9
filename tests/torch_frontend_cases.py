"""Cases and helpers of ``test_torch_frontend.py`` and
``test_torch_frontend_sqp.py`` (a module of helpers, not of tests)."""

import numpy as np
import torch

from optimal_control_problem_tpu import SQPOptimizationSolver as JSolver
from optimal_control_problem_tpu import SQPOptions as JOptions
from optimal_control_problem_tpu import sym as JS
from optimal_control_problem_tpu.solvers.admm import ADMMSettings as JADMM
from optimal_control_problem_tpu_torch import SQPOptimizationSolver as TSolver
from optimal_control_problem_tpu_torch import SQPOptions as TOptions
from optimal_control_problem_tpu_torch import sym as TS
from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings as TADMM

INF = np.inf
# One side of each comparison per package: (sym module, solver, options,
# ADMM settings, extra constructor keywords).
JAX = (JS, JSolver, JOptions, JADMM, {})
PORT = (TS, TSolver, TOptions, TADMM, {"device": "cpu"})


def arg_of(lbx, ubx, lbg=(), ubg=(), p=()):
    return {k: np.asarray(v, np.float64)
            for k, v in dict(lbx=lbx, ubx=ubx, lbg=lbg, ubg=ubg, p=p).items()}


def solve(side, nlp_of, arg, **opts):
    """Build the problem ``nlp_of(sym_module)`` in one package, solve once;
    returns ``(x as numpy, solver)``."""
    S, Solver, Options, ADMM, kw = side
    admm = opts.pop("admm", {})
    options = Options(**opts, admm=ADMM(**admm))
    solver = Solver(nlp_of(S), options, **kw)
    res = solver.get_optimal_solution(arg)
    x = res["x"]
    return np.asarray(x.cpu() if torch.is_tensor(x) else x), solver


def iters(solver):
    q = solver.last_result.qp_iters
    return np.asarray(q.cpu() if torch.is_tensor(q) else q).tolist()


# ---- the 8 golden cases ------------------------------------------------------

def case1(S):  # min x^2 + y^2  s.t. x + y = 1
    x = S.sym("x", 2)
    return {"x": x, "f": x[0] ** 2 + x[1] ** 2, "g": x[0] + x[1] - 1.0}


def case2(S):  # min (x-3)^2 + (y+2)^2
    x = S.sym("x", 2)
    return {"x": x, "f": (x[0] - 3.0) ** 2 + (x[1] + 2.0) ** 2}


def case3(S):  # min (x-2)^2 + (y-3)^2  s.t. x + y >= 1
    x = S.sym("x", 2)
    return {"x": x, "f": (x[0] - 2.0) ** 2 + (x[1] - 3.0) ** 2, "g": x[0] + x[1] - 1.0}


def case4(S):  # min x^2 + y^2  s.t. x >= 1, y >= 2
    x = S.sym("x", 2)
    return {"x": x, "f": x[0] ** 2 + x[1] ** 2, "g": S.vertcat(x[0], x[1])}


def case5(S):  # min sum (x_i - i)^2  s.t. sum x = 5, x >= 0
    x = S.sym("x", 3)
    return {"x": x, "f": (x[0] - 1.0) ** 2 + (x[1] - 2.0) ** 2 + (x[2] - 3.0) ** 2,
            "g": x[0] + x[1] + x[2] - 5.0}


def case6(S):  # min (x-p)^2 + y^2, p = 5
    x, p = S.sym("x", 2), S.sym("p", 1)
    return {"x": x, "f": (x[0] - p[0]) ** 2 + x[1] ** 2, "p": p}


def case7(S):  # min (x-3)^2 + (y-4)^2, box-clipped
    x = S.sym("x", 2)
    return {"x": x, "f": (x[0] - 3.0) ** 2 + (x[1] - 4.0) ** 2}


def case8(S):  # min x^2 - y^2  s.t. x^2 + y^2 <= 2 (nonconvex; saddle start)
    x = S.sym("x", 2)
    return {"x": x, "f": x[0] ** 2 - x[1] ** 2, "g": x[0] ** 2 + x[1] ** 2 - 1.0}


# (problem, arguments, the reference's answer or None, its tolerance)
GOLDEN = {
    "case1": (case1, arg_of([-50, -100], [50, 100], [0.0], [0.0]), [0.5, 0.5], 2e-3),
    "case2": (case2, arg_of([-50, -100], [50, 100]), [3.0, -2.0], 2e-3),
    "case3": (case3, arg_of([-100, -100], [100, 100], [1.0], [INF]), [2.0, 3.0], 2e-3),
    "case4": (case4, arg_of([-100, -100], [100, 100], [1.0, 2.0], [INF, INF]), [1.0, 2.0], 2e-3),
    "case5": (case5, arg_of([0, 0, 0], [INF, INF, INF], [0.0], [0.0]),
              [2 / 3, 5 / 3, 8 / 3], 3e-3),
    "case6": (case6, arg_of([-100, -100], [100, 100], p=[5.0]), [5.0, 0.0], 2e-3),
    "case7": (case7, arg_of([0, 0], [2, 3]), [2.0, 3.0], 2e-3),
    "case8": (case8, arg_of([-100, -100], [100, 100], [-INF], [1.0]), None, None),
}
OPTS = dict(max_iter=12, alpha=1.0, admm=dict(eps_abs=1e-4, eps_rel=1e-4))
# Every QP runs 50 iterations (two check blocks of 25): a negative
# tolerance no residual meets (eps 0 is met where a residual is exactly 0).
FORCED = dict(max_iter=12, alpha=1.0,
              admm=dict(eps_abs=-1.0, eps_rel=0.0, max_iter=40, check_infeasibility=False))


def sqrt_case(S):
    x = S.sym("x", 1)
    return {"x": x, "f": (1.0 + (x[0] - 2.0) ** 2) ** 0.5}


# ---- test_problem.py ---------------------------------------------------------

def small_config(mod, **kw):
    return mod.make_config(horizon=8, dt=0.05, alpha=1.0, step_num=6, **kw)


def sym_problem(ocp_cls, cfg, **kw):
    """test_problem.py's problem through the CasADi-style API: get_variable
    slices, add_vector_cost, Sym add_equation_constraint."""
    ocp = ocp_cls(cfg, **kw)
    occfg = ocp.ocp_config
    H, dt = occfg.get_horizon(), occfg.get_dt()
    ocp.set_reference(2)
    P = ocp.get_reference()
    for k in range(H):
        ocp.add_vector_cost([10.0, 10.0], ocp.get_variable(k, "pos") - P)
        ocp.add_vector_cost([1e-3, 1e-3], occfg.get_variable(k, "acc"))
    for k in range(H - 1):
        pos, vel, acc = (occfg.get_variable(k, n) for n in ("pos", "vel", "acc"))
        pos1, vel1 = (occfg.get_variable(k + 1, n) for n in ("pos", "vel"))
        ocp.add_equation_constraint(f"dyn_p{k}", pos1, pos + dt * vel)
        ocp.add_equation_constraint(f"dyn_v{k}", vel1, vel + dt * acc)
    ocp.gen_solver()
    return ocp
