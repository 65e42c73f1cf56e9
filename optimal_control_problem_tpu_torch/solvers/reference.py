"""Host-side reference NLP backends — port of
``optimal_control_problem_tpu/solvers/reference.py`` (the reference's
CasADi ``nlpsol`` IPOPT and ``sqpmethod``+qpOASES backends).

These are validation backends, not the hot path: they solve the same NLP
with scipy on the host to convergence.

* ``IPOPT``  -> ``scipy.optimize.minimize(method="trust-constr")`` (an
  interior-point method), with an SLSQP run kept where it is better;
* ``SQP``    -> ``scipy.optimize.minimize(method="SLSQP")``.

Derivatives come from ``torch.func`` (``grad`` of the objective,
``jacfwd`` of the constraints) on the same callables the device path
uses, evaluated on float64 CPU copies of the point and the parameters:
the host solvers' 1e-8 tolerances are out of reach of float32 gradients.
torch needs no x64 switch.  The problem's own device is not touched: a
problem built for ``cuda`` is evaluated here on the CPU by design (a host
backend), not as a fallback.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from scipy.optimize import Bounds, NonlinearConstraint, minimize

__all__ = ["solve_nlp_host"]

_F64 = dict(dtype=torch.float64, device="cpu")


def _make_f64_evaluators(f_fn: Callable, g_fn: Optional[Callable], p: np.ndarray):
    """float64 CPU evaluators for f, grad f, g and jac g, numpy in and out."""
    pt = torch.as_tensor(p, **_F64)
    f_grad = torch.func.grad(lambda x: f_fn(x, pt))

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), **_F64)

    def fun(x):
        return float(f_fn(t(x), pt))

    def grad(x):
        return f_grad(t(x)).numpy().astype(np.float64)

    if g_fn is None:
        return fun, grad, None, None
    g_jac = torch.func.jacfwd(lambda x: g_fn(x, pt))

    def gv(x):
        return g_fn(t(x), pt).numpy().astype(np.float64)

    def gj(x):
        return g_jac(t(x)).numpy().astype(np.float64)

    return fun, grad, gv, gj


def _slsqp(fun, grad, gv, gj, x0, lbx, ubx, lbg, ubg, tol, max_iter):
    bounds = Bounds(lbx, ubx, keep_feasible=False)
    cons = []
    if gv is not None and lbg.size:
        eq_mask = np.isfinite(lbg) & (lbg == ubg)
        ineq_lb = np.isfinite(lbg) & ~eq_mask
        ineq_ub = np.isfinite(ubg) & ~eq_mask
        if eq_mask.any():
            cons.append({"type": "eq", "fun": lambda x, m=eq_mask: (gv(x) - lbg)[m],
                         "jac": lambda x, m=eq_mask: gj(x)[m]})
        if ineq_lb.any():
            cons.append({"type": "ineq", "fun": lambda x, m=ineq_lb: (gv(x) - lbg)[m],
                         "jac": lambda x, m=ineq_lb: gj(x)[m]})
        if ineq_ub.any():
            cons.append({"type": "ineq", "fun": lambda x, m=ineq_ub: (ubg - gv(x))[m],
                         "jac": lambda x, m=ineq_ub: -gj(x)[m]})
    return minimize(fun, x0, jac=grad, bounds=bounds, constraints=cons, method="SLSQP",
                    options={"maxiter": max_iter, "ftol": tol})


def solve_nlp_host(
    f_fn: Callable,
    g_fn: Optional[Callable],
    x0: np.ndarray,
    p: np.ndarray,
    lbx: np.ndarray,
    ubx: np.ndarray,
    lbg: np.ndarray,
    ubg: np.ndarray,
    method: str = "trust-constr",
    tol: float = 1e-8,
    max_iter: int = 1000,
) -> Dict[str, np.ndarray]:
    """Solve ``min f(x,p) s.t. lbx<=x<=ubx, lbg<=g(x,p)<=ubg`` on the host.

    ``f_fn(x, p)`` / ``g_fn(x, p)`` are torch callables (the problem's own
    NLP functions).  Returns ``{"x": solution, "f": objective, "success",
    "status"}`` like the CasADi result map.
    """
    p = np.asarray(p, dtype=np.float64).reshape(-1)
    x0 = np.asarray(x0, dtype=np.float64).reshape(-1)
    lbx = np.asarray(lbx, dtype=np.float64).reshape(-1)
    ubx = np.asarray(ubx, dtype=np.float64).reshape(-1)
    lbg = np.asarray(lbg, dtype=np.float64).reshape(-1)
    ubg = np.asarray(ubg, dtype=np.float64).reshape(-1)

    fun, grad, gv, gj = _make_f64_evaluators(f_fn, g_fn, p)

    def _violation(x):
        v = max(float(np.maximum(lbx - x, 0).max(initial=0.0)),
                float(np.maximum(x - ubx, 0).max(initial=0.0)))
        if gv is not None and lbg.size:
            gx = gv(x)
            v = max(v, float(np.maximum(lbg - gx, 0).max(initial=0.0)),
                    float(np.maximum(gx - ubg, 0).max(initial=0.0)))
        return v

    if method == "SLSQP":
        res = _slsqp(fun, grad, gv, gj, x0, lbx, ubx, lbg, ubg, tol, max_iter)
    else:
        # MPC problems pin the first frame with lbx == ubx: an empty
        # interior that makes pure interior-point methods stop early on
        # xtol.  Run both host methods and keep the best feasible solution;
        # this is a validation backend, accuracy beats speed.
        constraints = ([NonlinearConstraint(gv, lbg, ubg, jac=gj)]
                       if gv is not None and lbg.size else [])
        res = minimize(fun, x0, jac=grad, bounds=Bounds(lbx, ubx, keep_feasible=False),
                       constraints=constraints, method="trust-constr",
                       options={"maxiter": max_iter, "gtol": tol, "xtol": 1e-12})
        res_fb = _slsqp(fun, grad, gv, gj, x0, lbx, ubx, lbg, ubg, 1e-12, max_iter)
        if res_fb.success and _violation(res_fb.x) < 1e-6 and (
            not res.success or _violation(res.x) > 1e-6 or res_fb.fun < res.fun
        ):
            res = res_fb

    return {
        "x": np.asarray(res.x, dtype=np.float64),
        "f": np.asarray(res.fun, dtype=np.float64),
        "success": bool(res.success),
        "status": res.status,
    }
