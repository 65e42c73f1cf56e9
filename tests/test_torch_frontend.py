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
  statistics; the four shipped ``configs/*.yaml`` (one tick each, the
  quadrotor on its stage structure), trajectories within 5e-3 (the f32
  floor of PARITY.md);
* ``test_controller.py``'s closed loops (closed-loop states within 2e-2 of
  JAX's, the final state within 1e-3);
* batched ticks of the augmented formulation: dense cart-pole (both
  backends; the parity preset, which diverges to NaN in both packages on
  this nonconvex cost, with equal flags), the double integrator through
  the shared factorization at n = n_p + n_x; and a dense method, a shared
  system and a banded solve without parts on a stage structure.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu import OptimalControlProblem as JOCP
from optimal_control_problem_tpu import SQPOptimizationSolver as JSolver
from optimal_control_problem_tpu import SQPOptions as JOptions
from optimal_control_problem_tpu import sym as JS
from optimal_control_problem_tpu.controller import MPCController as JController
from optimal_control_problem_tpu.models import cartpole as jcp
from optimal_control_problem_tpu.models import double_integrator as jdi
from optimal_control_problem_tpu.models import quadrotor as jqr
from optimal_control_problem_tpu.models import unicycle as jun
from optimal_control_problem_tpu.parallel import BatchedSolver as JBatched
from optimal_control_problem_tpu.solvers.admm import ADMMSettings as JADMM
from optimal_control_problem_tpu_torch import OptimalControlProblem as TOCP
from optimal_control_problem_tpu_torch import SQPOptimizationSolver as TSolver
from optimal_control_problem_tpu_torch import SQPOptions as TOptions
from optimal_control_problem_tpu_torch import sym as TS
from optimal_control_problem_tpu_torch.controller import MPCController as TController
from optimal_control_problem_tpu_torch.interop import (
    batch_state_from_numpy,
    settings_from_jax_dict,
    sqp_iterate_from_numpy,
)
from optimal_control_problem_tpu_torch.models import cartpole as tcp
from optimal_control_problem_tpu_torch.models import double_integrator as tdi
from optimal_control_problem_tpu_torch.models import quadrotor as tqr
from optimal_control_problem_tpu_torch.models import unicycle as tun
from optimal_control_problem_tpu_torch.parallel import BatchedSolver as TBatched
from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings as TADMM
from torch_threads import one_torch_thread  # noqa: F401

INF = np.inf
CONFIGS = Path(__file__).resolve().parents[1] / "configs"
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


# ---- the rest of test_sqp_cases.py -------------------------------------------

def test_callable_nlp_and_reference_semantics():
    """Callables (reduced), the damped 1 - 0.9^10 factor, warm start across
    calls and reset, the two formulations' agreement, input validation."""
    for side in (JAX, PORT):
        cat = jnp.atleast_1d if side is JAX else torch.atleast_1d
        nlp = {"x": 2, "f": lambda x, p: (x[0] - 1.0) ** 2 + (x[1] + 1.0) ** 2,
               "g": lambda x, p, cat=cat: cat(x[0] + x[1])}
        x, _ = solve(side, lambda S: nlp, arg_of([-10, -10], [10, 10], [0.0], [0.0]),
                     formulation="reduced", **OPTS)
        np.testing.assert_allclose(x, [1.0, -1.0], atol=2e-3)
    arg = arg_of([-50, -100], [50, 100], [0.0], [0.0])
    xs = [solve(side, case1, arg, max_iter=10, alpha=0.1, admm=OPTS["admm"])[0]
          for side in (JAX, PORT)]
    np.testing.assert_allclose(xs[1], xs[0], atol=2e-3)
    np.testing.assert_allclose(xs[1], [0.5 * (1 - 0.9 ** 10)] * 2, atol=5e-3)
    x1, solver = solve(PORT, case1, arg, max_iter=5, alpha=0.3, admm=OPTS["admm"])
    x2 = solver.get_optimal_solution(arg)["x"].numpy()
    assert np.abs(x2 - 0.5).max() < np.abs(x1 - 0.5).max()
    solver.reset()
    np.testing.assert_allclose(solver.get_optimal_solution(arg)["x"].numpy(), x1, atol=1e-5)
    with pytest.raises(ValueError):
        solver.get_optimal_solution(arg_of([0], [0], [0.0], [0.0]))
    with pytest.raises(ValueError):
        solver.get_optimal_solution(arg_of([0, 0], [0, 0], [], []))
    with pytest.raises(ValueError):
        TSolver({"f": lambda x, p: 0.0}, device="cpu")
    with pytest.raises(ValueError):
        TSolver({"x": 2}, device="cpu")

    def eq(S):
        x, p = S.sym("x", 3), S.sym("p", 2)
        f = (x[0] - p[0]) ** 2 + (x[1] - p[1]) ** 2 + 0.5 * x[2] ** 2 + x[0] * x[1]
        return {"x": x, "f": f, "p": p,
                "g": S.vertcat(x[0] + x[1] + x[2] - 1.0, x[0] - x[2])}

    arg = arg_of([-5, -5, -5], [5, 5, 5], [0.0, -1.0], [0.0, 1.0], p=[1.0, -2.0])
    xa, sa = solve(PORT, eq, arg, formulation="augmented", **OPTS)
    xr, sr = solve(PORT, eq, arg, formulation="reduced", **OPTS)
    assert (sa._qp_n, sa._qp_m, sr._qp_n, sr._qp_m) == (5, 7, 3, 5)
    assert sa.last_result.qp_x.shape == (5,) and sa.last_result.qp_y.shape == (7,)
    np.testing.assert_allclose(xa, xr, atol=5e-3)


def test_parity_preset_matches_jax():
    """SQPOptions.parity pins the reference semantics in both packages
    (field for field); its damped trajectory hits 1 - 0.9^10 as JAX's."""
    assert dataclasses.asdict(TOptions.parity(verbose=True, max_iter=4)) == {
        **dataclasses.asdict(settings_from_jax_dict(dataclasses.asdict(
            JOptions.parity(verbose=True, max_iter=4)))),
    }
    opt = TOptions.parity()
    assert (opt.formulation, opt.hessian_reg, opt.line_search, opt.alpha, opt.max_iter,
            opt.shared_system, opt.qp_warm_start) == ("augmented", 0.0, "none", 0.1, 10,
                                                      False, False)
    arg = arg_of([-50, -100], [50, 100], [0.0], [0.0])
    admm = dict(eps_abs=1e-5, eps_rel=1e-5)
    xs = []
    for S, Solver, Options, ADMM, kw in (JAX, PORT):
        solver = Solver(case1(S), Options.parity(admm=ADMM(**admm)), **kw)
        x = solver.get_optimal_solution(arg)["x"]
        xs.append(np.asarray(x.cpu() if torch.is_tensor(x) else x))
    np.testing.assert_allclose(xs[1], xs[0], atol=2e-3)
    np.testing.assert_allclose(xs[1], [0.5 * (1 - 0.9 ** 10)] * 2, atol=5e-4)


def sqrt_case(S):
    x = S.sym("x", 1)
    return {"x": x, "f": (1.0 + (x[0] - 2.0) ** 2) ** 0.5}


@pytest.mark.parametrize("settings", ["cases", "forced"])
def test_merit_converges_where_full_fixed_step_diverges(settings):
    """f = sqrt(1 + (x-2)^2): full fixed steps ping-pong between the box
    bounds, the merit search converges to 2, in both packages alike."""
    arg = arg_of([-100.0], [100.0])
    admm = OPTS["admm"] if settings == "cases" else FORCED["admm"]
    out = {}
    for ls in ("none", "merit"):
        kw = dict(alpha=1.0, max_iter=12, hessian_reg=0.0, admm=admm, line_search=ls,
                  ls_num=8, ls_alpha_max=1.0)
        jx, js = solve(JAX, sqrt_case, arg, **dict(kw))
        tx, ts = solve(PORT, sqrt_case, arg, **dict(kw))
        np.testing.assert_allclose(tx, jx, atol=2e-3)
        if settings == "forced":
            assert iters(ts) == iters(js) == [50] * 12
        out[ls] = tx
    assert abs(out["none"][0] - 2.0) > 50.0
    assert abs(out["merit"][0] - 2.0) < 1e-2


def test_merit_step_rule_picks_as_jax():
    """The merit rule's candidate choice in both packages: the first
    smallest merit on ties, a NaN merit counted as smallest, and infinite
    bounds adding no violation."""

    def nlp_of(S):
        x = S.sym("x", 2)
        return {"x": x, "f": S.sqrt(x[0] - 1.0) + 0.0 * x[1], "g": x[1] * 1.0}

    cases = [  # (x, dx, lbx, ubx, lbg, ubg)
        ([2.0, 0.0], [-4.0, 0.0], [-INF, -INF], [INF, INF], [-INF], [INF]),  # NaN merits
        ([5.0, 0.0], [0.0, 1.0], [-INF, -INF], [INF, INF], [-INF], [INF]),  # all tie
        ([5.0, 0.0], [-3.0, 2.0], [-INF, -INF], [INF, 1.0], [-INF], [0.5]),  # bounds
        ([5.0, 0.0], [-3.0, 2.0], [-INF, 0.2], [INF, INF], [0.1], [INF]),
    ]
    rules = [Solver(nlp_of(S), Options(line_search="merit", ls_num=6), **kw)._make_step_rule()
             for S, Solver, Options, _, kw in (JAX, PORT)]
    for x, dx, lbx, ubx, lbg, ubg in cases:
        p = np.zeros(0, np.float32)
        args = [np.asarray(a, np.float32) for a in (x, dx)] + [p] + [
            np.asarray(a, np.float32) for a in (lbx, ubx, lbg, ubg)]
        jx, jn = rules[0](*(jnp.asarray(a) for a in args))
        tx, tn = rules[1](*(torch.as_tensor(a) for a in args))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    # NaN merits: the full step (a = 1) is taken, as jnp.argmin takes it.
    tx, _ = rules[1](*(torch.as_tensor(np.asarray(a, np.float32))
                       for a in ([2.0, 0.0], [-4.0, 0.0], [], [-INF, -INF], [INF, INF],
                                 [-INF], [INF])))
    np.testing.assert_array_equal(tx.numpy(), [-2.0, 0.0])


def test_merit_line_search_accelerates_nonlinear():
    """Cart-pole h10 (reduced): 6 merit steps end lower than 6 fixed steps
    of alpha 0.1, with objectives as JAX's (rtol 1e-3)."""
    frame = tcp.initial_state(th=0.3)
    ref = np.array([np.pi])
    objs = {}
    for name, mod, kw in (("jax", jcp, {}), ("port", tcp, {"device": "cpu"})):
        for ls in (False, True):
            sqp = {"alpha": 0.1, "step_num": 6}
            if ls:
                sqp.update({"line_search": "merit", "ls_num": 8, "ls_alpha_max": 1.0})
            cfg = mod.make_config(horizon=10, dt=0.04, SQP_settings=sqp, formulation="reduced")
            ocp = mod.build(cfg, **kw)
            ocp.compute_optimal_trajectory(frame, ref)
            objs[name, ls] = ocp.get_solver_stats()["objective"]
    assert np.isfinite(objs["port", True]) and objs["port", True] < objs["port", False]
    for ls in (False, True):
        np.testing.assert_allclose(objs["port", ls], objs["jax", ls], rtol=1e-3)
    bad = tdi.make_config(horizon=6, dt=0.01,
                          SQP_settings={"alpha": 0.1, "step_num": 2, "line_search": "wolfe"})
    with pytest.raises(ValueError, match="line_search"):
        tdi.build(bad, device="cpu")


def test_line_search_none_bit_identical():
    def nlp_of(S):
        x = S.sym("x", 2)
        return {"x": x, "f": (x[0] - 1.0) ** 2 + x[0] * x[1] + x[1] ** 2,
                "g": x[0] + 2.0 * x[1] - 0.5}

    arg = arg_of([-5, -5], [5, 5], [0.0], [0.0])
    xb, _ = solve(PORT, nlp_of, arg, alpha=0.1, max_iter=6)
    xe, _ = solve(PORT, nlp_of, arg, alpha=0.1, max_iter=6, line_search="none", ls_num=4,
                  ls_alpha_max=0.7, ls_merit_mu=3.0)
    np.testing.assert_array_equal(xb, xe)
    xj, _ = solve(JAX, nlp_of, arg, alpha=0.1, max_iter=6)
    np.testing.assert_allclose(xb, xj, atol=2e-3)


def test_early_exit_matches_jax(capsys):
    """The ||alpha*dx|| < 1e-6 break, tied to verbose unless forced: the
    same steps taken as JAX, frozen steps report 0 QP iterations."""
    nlp_of = lambda S: case2(S)  # noqa: E731
    arg = arg_of([-50, -50], [50, 50])
    kw = dict(max_iter=8, alpha=1.0, admm=dict(eps_abs=1e-6, eps_rel=1e-6))
    for opts in (dict(), dict(verbose=True), dict(early_exit=True),
                 dict(verbose=True, early_exit=False)):
        jx, js = solve(JAX, nlp_of, arg, **kw, **opts)
        tx, ts = solve(PORT, nlp_of, arg, **kw, **opts)
        taken = int(ts.last_result.steps_taken)
        assert taken == int(js.last_result.steps_taken)
        np.testing.assert_allclose(tx, jx, atol=1e-5)
        np.testing.assert_allclose(tx, [3.0, -2.0], atol=1e-3)
        early = opts.get("early_exit", opts.get("verbose", False))
        assert (taken < 8) == early
        if early:
            assert all(i == 0 for i in iters(ts)[taken + 1:])
    assert "early exit" in capsys.readouterr().out


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


def test_sym_api_problem():
    jo = sym_problem(JOCP, small_config(jdi))
    to = sym_problem(TOCP, small_config(tdi), device="cpu")
    assert to.solver._qp_n == 2 + 48 and to.num_constraints == 7 * 4
    frame = tdi.initial_state(pos=(0.3, 0.3))
    for _ in range(3):
        jo.compute_optimal_trajectory(frame, np.array([0.3, 0.3]))
        to.compute_optimal_trajectory(frame, np.array([0.3, 0.3]))
    traj = to.get_optimal_frames()
    np.testing.assert_allclose(traj, jo.get_optimal_frames(), atol=5e-3)
    np.testing.assert_allclose(traj[0, 0:2], [0.3, 0.3], atol=5e-3)
    np.testing.assert_allclose(traj[-1, 0:2], [0.3, 0.3], atol=5e-2)
    # The registries evaluate as JAX's at one random point.
    rng = np.random.default_rng(0)
    X = rng.normal(size=(48,)).astype(np.float32)
    P = np.float32([0.2, -0.1])
    (jf, jg), (tf, tg) = jo.nlp_functions, to.nlp_functions
    np.testing.assert_allclose(float(tf(torch.as_tensor(X), torch.as_tensor(P))),
                               float(jf(jnp.asarray(X), jnp.asarray(P))), rtol=1e-6)
    np.testing.assert_allclose(tg(torch.as_tensor(X), torch.as_tensor(P)).numpy(),
                               np.asarray(jg(jnp.asarray(X), jnp.asarray(P))), atol=1e-6)
    assert to.get_constraint_names() == jo.get_constraint_names()
    assert len(to.get_constraints()) == 2 * 7
    assert to.get_solver_type().value == jo.get_solver_type().value == "TPU_SQP"
    with pytest.raises(ValueError, match="dimensions differ"):
        to.add_vector_cost([1.0], to.get_variable(0, "pos"))
    with pytest.raises(ValueError, match="size 1"):
        to.add_scalar_cost(to.get_variable(0, "pos"))


def test_constraint_bookkeeping():
    ocp = tdi.DoubleIntegratorOCP(small_config(tdi), device="cpu")
    n_dyn = 7 * 4
    assert ocp.num_constraints == n_dyn
    assert len(ocp.get_constraint_names()) == n_dyn
    assert ocp.get_constraint_lower_bounds().shape == (n_dyn,)
    np.testing.assert_allclose(ocp.get_constraint_upper_bounds(), 0.0)
    jocp = jdi.DoubleIntegratorOCP(small_config(jdi))
    assert ocp.get_constraint_names() == jocp.get_constraint_names()


def test_get_solver_stats():
    """Per-tick stats after a solve, as JAX's: shapes, objective (rtol
    1e-3), and the per-step QP flags on the per-scenario path."""
    for kw in ({}, {"shared_system": False}):
        stats = []
        for mod, extra in ((jdi, {}), (tdi, {"device": "cpu"})):
            ocp = mod.build(mod.make_config(horizon=8, dt=0.01, step_num=4, **kw), **extra)
            assert ocp.get_solver_stats() == {}
            ocp.compute_optimal_trajectory(np.zeros(tdi.FRAME, np.float32),
                                           np.zeros(ocp.reference_size, np.float32))
            stats.append(ocp.get_solver_stats())
        js, ts = stats
        assert set(ts) == set(js)
        for k in ("qp_iters", "f_history", "step_norms"):
            assert ts[k].shape == (4,)
        np.testing.assert_allclose(ts["objective"], js["objective"], rtol=1e-3)
        if kw:
            assert ts["qp_converged"].all() and not ts["qp_prim_inf"].any()
            assert not ts["qp_dual_inf"].any()


# ---- the shipped configs -----------------------------------------------------

YAMLS = {
    "double_integrator": (jdi, tdi, lambda m: m.initial_state(pos=(0.3, -0.2)),
                          lambda m: m.reference_circle(20, 0.005), {}),
    "cartpole": (jcp, tcp, lambda m: m.initial_state(th=0.3), lambda m: np.array([np.pi]), {}),
    "unicycle": (jun, tun, lambda m: m.initial_state(y=0.1), lambda m: m.reference_line(50, 0.05),
                 {}),
    "quadrotor": (jqr, tqr, lambda m: m.initial_state(), lambda m: m.reference_hover(100),
                  {"stagewise": True}),
}


@pytest.mark.parametrize("name", sorted(YAMLS))
def test_yaml_config_builds_and_ticks(name):
    """Each shipped config builds in the port from its defaults (the
    augmented formulation where the file sets none; the quadrotor on its
    stage structure) and one tick matches JAX's within 5e-3."""
    jmod, tmod, frame_of, ref_of, kw = YAMLS[name]
    path = str(CONFIGS / f"{name}.yaml")
    jo = jmod.build(path, **kw)
    to = tmod.build(path, device="cpu", **kw)
    assert to.solver_settings.formulation == jo.solver_settings.formulation
    assert to.solver._qp_n == jo.solver._qp_n
    to.compute_optimal_trajectory(frame_of(tmod), ref_of(tmod))
    jo.compute_optimal_trajectory(frame_of(jmod), ref_of(jmod))
    x = to.get_optimal_trajectory().numpy()
    assert np.isfinite(x).all()
    np.testing.assert_allclose(x, np.asarray(jo.get_optimal_trajectory()), atol=5e-3)


# ---- test_controller.py ------------------------------------------------------

def rollout(Controller, mod, shift, **kw):
    """test_controller.py's closed loop: 40 steps of the double integrator
    h10 towards (1, 0.5); returns the position errors, the states
    (positions, velocities) and the controls by step."""
    H, dt = 10, 0.05
    ocp = mod.build(mod.make_config(horizon=H, dt=dt, alpha=0.7, step_num=8), **kw)
    ctl = Controller(ocp, mod.CONTROL_SLICE, shift_warm_start=shift)
    target = np.array([1.0, 0.5])
    ref = np.tile(target, H)
    pos, vel, acc = np.zeros(2), np.zeros(2), np.zeros(2)
    errs, states, us = [], [], []
    for _ in range(40):
        u = ctl.step(np.concatenate([pos, vel, acc]), ref)
        pos = pos + dt * vel
        vel = vel + dt * u
        acc = u
        errs.append(np.linalg.norm(pos - target))
        states.append(np.r_[pos, vel])
        us.append(u)
    return np.array(errs), np.array(states), np.array(us)


@pytest.mark.parametrize("shift", [True, False], ids=["shift", "reference_style"])
def test_controller_closes_loop(shift):
    """The loop closes as in JAX.  The controls are the double
    integrator's accelerations (range +-50, weight 1e-3 against 10 on the
    positions): QPs stopped at eps 1e-3 leave them loose, so one step's
    control can differ by up to 0.7% of its range from JAX's (0.34 with the
    shift, 0.03 without; ROADMAP Queue C records the same knife edge
    between JAX's own backends).  Held: controls within 1% of the range
    (0.5), closed-loop positions and velocities within 2e-2, the final
    state within 1e-3."""
    errs, states, us = rollout(TController, tdi, shift, device="cpu")
    _, jstates, jus = rollout(JController, jdi, shift)
    assert errs[-1] < (0.4 if shift else 0.5) * errs[0]
    np.testing.assert_allclose(us, jus, atol=0.5)
    np.testing.assert_allclose(states, jstates, atol=2e-2)
    np.testing.assert_allclose(states[-1], jstates[-1], atol=1e-3)


def test_controller_plan_and_control_slices():
    assert tdi.CONTROL_SLICE == slice(4, 6) and tcp.CONTROL_SLICE == slice(4, 5)
    assert tun.CONTROL_SLICE == slice(3, 5) and tqr.CONTROL_SLICE == slice(12, 16)
    ocp = tdi.DoubleIntegratorOCP(tdi.make_config(horizon=6, dt=0.05), device="cpu")
    with pytest.raises(ValueError, match="gen_solver"):
        TController(ocp, tdi.CONTROL_SLICE)
    ocp.gen_solver()
    ctl = TController(ocp, tdi.CONTROL_SLICE)
    assert ctl.plan is None
    u = ctl.step(tdi.initial_state(), np.zeros(12))
    assert u.shape == (2,) and ctl.plan.shape == (6, tdi.FRAME)
    with pytest.raises(ValueError, match="size"):
        ocp.solver.set_iterate(np.zeros(5))


# ---- batched ticks of the augmented formulation --------------------------------

DENSE_ADMM = {"method": "condensed", "max_iter": 500, "adaptive_rho": False, "rho": 0.05}


def cart_frames_refs(B, seed=0):
    rng = np.random.default_rng(seed)
    frames = np.zeros((B, tcp.FRAME), np.float32)
    frames[:, 2] = rng.uniform(-0.5, 0.5, B).astype(np.float32)
    return frames, np.full((B, 1), np.pi, np.float32)


def batch_ticks(jocp, tocp, frames, refs, ticks):
    """Both packages' batched ticks from the same zero state."""
    jb, tb = JBatched(jocp), TBatched(tocp, device="cpu")
    jst = jb.init_state(frames.shape[0])
    tst = batch_state_from_numpy(jst._asdict(), device="cpu")
    for _ in range(ticks):
        jx, jf, jst = jb.solve(frames, refs, jst)
        tx, tf, tst = tb.solve(frames, refs, tst)
        yield tx.numpy(), np.asarray(jx), tf.numpy(), np.asarray(jf), tb, jb


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("parity", [False, True], ids=["augmented", "parity"])
def test_cartpole_dense_augmented_tick_matches_jax(backend, parity):
    """Cart-pole h6 with no formulation set (the augmented default; QP
    n = 1 + 30, m = 31 + 26), B=3, two ticks from the same state (JAX's
    device loop in interpret mode on "pallas"): trajectories within 5e-3,
    equal per-scenario qp_iters and flags.  With the parity preset (raw
    Hessian, cold QPs) the nonconvex local QPs diverge in both packages:
    NaN in the same places, the same flags (none converged, no
    certificate) and the same iteration counts."""
    def cfg(mod):
        c = mod.make_config(horizon=6, dt=0.02, alpha=0.3, step_num=3,
                            ADMM_settings={**DENSE_ADMM, "backend": backend})
        c["solver_settings"]["SQP_settings"]["parity"] = parity
        return c

    frames, refs = cart_frames_refs(3)
    tocp = tcp.build(cfg(tcp), device="cpu")
    assert tocp.solver._qp_n == 31 and tocp.solver._qp_m == 57
    assert tocp.solver.options.qp_warm_start is not parity
    for tx, jx, tf, jf, tb, jb in batch_ticks(jcp.build(cfg(jcp)), tocp, frames, refs, 2):
        np.testing.assert_array_equal(np.isfinite(tx), np.isfinite(jx))
        np.testing.assert_allclose(tx, jx, atol=5e-3)
        np.testing.assert_allclose(tf, jf, rtol=1e-3)
        tres, jres = tb.last_result, jb.last_result
        for name in ("qp_iters", "qp_converged", "qp_prim_inf", "qp_dual_inf"):
            np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                          np.asarray(getattr(jres, name)), err_msg=name)
    assert tres.qp_x.shape == (3, 31)
    if parity:
        assert not np.isfinite(tx).any() and not bool(tres.qp_converged.any())
    else:
        assert np.isfinite(tx).all() and bool(tres.qp_converged.all())


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_double_integrator_augmented_shared_tick_matches_jax(backend):
    """The double integrator h8 with no formulation set: the shared
    factorization at n = n_p + n_x = 16 + 48, m = 64 + 28, B=3, under a
    forced budget (150 iterations, one rho adaptation): equal qp_iters,
    trajectories within 5e-3."""
    admm = {"method": "condensed", "eps_abs": 1e-7, "eps_rel": 1e-7, "max_iter": 150,
            "adaptive_rho": True, "backend": backend}

    def cfg(mod):
        return mod.make_config(horizon=8, dt=0.005, alpha=0.1, step_num=3, ADMM_settings=admm)

    rng = np.random.default_rng(0)
    frames = np.zeros((3, tdi.FRAME), np.float32)
    frames[:, 0:2] = rng.uniform(-1, 1, size=(3, 2)).astype(np.float32)
    refs = np.tile(tdi.reference_circle(8, 0.005)[None, :], (3, 1)).astype(np.float32)
    tocp = tdi.build(cfg(tdi), device="cpu")
    assert tocp.solver.shared_system and tocp.solver._qp_n == 64 and tocp.solver._qp_m == 92
    for tx, jx, tf, jf, tb, jb in batch_ticks(jdi.build(cfg(jdi)), tocp, frames, refs, 2):
        np.testing.assert_array_equal(tb.last_result.qp_iters.numpy(),
                                      np.asarray(jb.last_result.qp_iters))
        np.testing.assert_allclose(tx, jx, atol=5e-3)
    assert tb.last_result.qp_x.shape == (3, 64)


@pytest.mark.parametrize("method", ["condensed", "kkt"])
def test_stage_structure_under_a_dense_method(method):
    """Cart-pole h6 on its stage structure with a dense method pinned: the
    QPs take the stage-wise dense assembly (per problem and, batched, the
    per-scenario dense path); two ticks each against JAX within 5e-3."""
    kw = dict(horizon=6, dt=0.04, alpha=0.3, step_num=3, formulation="reduced",
              ADMM_settings={"method": method, "max_iter": 1000})
    jo = jcp.build(jcp.make_config(**kw), stagewise=True)
    to = tcp.build(tcp.make_config(**kw), stagewise=True, device="cpu")
    assert to.solver.options.admm.method == method and to.solver.solve_batch_dense_fn
    frame, ref = tcp.initial_state(th=0.4), np.array([np.pi])
    for _ in range(2):
        jo.compute_optimal_trajectory(frame, ref)
        to.compute_optimal_trajectory(frame, ref)
    np.testing.assert_allclose(to.get_optimal_trajectory().numpy(),
                               np.asarray(jo.get_optimal_trajectory()), atol=5e-3)
    frames, refs = cart_frames_refs(2)
    for tx, jx, *_ in batch_ticks(jcp.build(jcp.make_config(**kw), stagewise=True),
                                  tcp.build(tcp.make_config(**kw), stagewise=True,
                                            device="cpu"), frames, refs, 2):
        np.testing.assert_allclose(tx, jx, atol=5e-3)


def test_stage_structure_shared_system_and_banded_without_parts():
    """``shared_system: true`` with the banded method (the batch takes the
    shared factorization of the stage-wise dense assembly at the zero
    point, as JAX's does), and a banded solver built from a stage
    structure with no local-system parts (its QPs take ``vectors`` and
    ``stack_bounds`` of the dense parts): each against JAX within 5e-3."""
    from optimal_control_problem_tpu.stagewise import build_stagewise_fns as jfns
    from optimal_control_problem_tpu_torch.stagewise import build_stagewise_fns as tfns

    H = 6
    kw = dict(horizon=H, dt=0.04, alpha=0.3, step_num=2, formulation="reduced",
              shared_system=True, ADMM_settings={"method": "banded", "max_iter": 1000})
    tocp = tcp.build(tcp.make_config(**kw), stagewise=True, device="cpu")
    assert tocp.solver.shared_system and tocp.solver.solve_batch_fn is not None
    assert TBatched(tocp, device="cpu")._solve_batch is tocp.solver.solve_batch_fn
    frames, refs = cart_frames_refs(2)
    for tx, jx, *_ in batch_ticks(jcp.build(jcp.make_config(**kw), stagewise=True), tocp,
                                  frames, refs, 2):
        np.testing.assert_allclose(tx, jx, atol=5e-3)

    frame = tcp.initial_state(th=0.4)
    outs = []
    for mod, fns, Solver, Options, ADMM, extra in (
            (jcp, jfns, JSolver, JOptions, JADMM, {}),
            (tcp, tfns, TSolver, TOptions, TADMM, {"device": "cpu"})):
        ss = mod.stage_structure(H, 0.04)
        f_fn, g_fn, lbg, ubg = fns(ss)
        cfg = mod.make_config(horizon=H, dt=0.04)
        ocp = mod.CartPoleOCP(cfg, **extra)
        lbx, ubx = ocp.ocp_config.lower_bounds_flat(), ocp.ocp_config.upper_bounds_flat()
        lbx[:5] = ubx[:5] = frame
        solver = Solver({"x": ocp.ocp_config.get_variables(), "f": f_fn, "g": g_fn, "p": 1},
                        Options(max_iter=3, alpha=0.3, formulation="reduced",
                                admm=ADMM(method="banded", max_iter=1000)),
                        stage_structure=ss, **extra)
        x = solver.get_optimal_solution({"lbx": lbx, "ubx": ubx, "lbg": lbg, "ubg": ubg,
                                         "p": [np.pi]})["x"]
        outs.append(np.asarray(x.cpu() if torch.is_tensor(x) else x))
    assert np.isfinite(outs[1]).all()
    np.testing.assert_allclose(outs[1], outs[0], atol=5e-3)


def test_sqp_iterate_carried_from_jax():
    """sqp_iterate_from_numpy: the port's solver continues from JAX's
    iterate and QP warm start and lands where JAX's next call does."""
    arg = arg_of([-50, -100], [50, 100], [0.0], [0.0])
    _, js = solve(JAX, case1, arg, max_iter=3, alpha=0.3, admm=OPTS["admm"])
    _, ts = solve(PORT, case1, arg, max_iter=3, alpha=0.3, admm=OPTS["admm"])
    sqp_iterate_from_numpy(ts, *(np.asarray(a) for a in (js._result_x, js._qp_x, js._qp_y)))
    jx = np.asarray(js.get_optimal_solution(arg)["x"])
    tx = ts.get_optimal_solution(arg)["x"].numpy()
    np.testing.assert_allclose(tx, jx, atol=2e-3)
    with pytest.raises(ValueError, match="qp_x"):
        sqp_iterate_from_numpy(ts, np.zeros(2), np.zeros(3), np.zeros(3))
