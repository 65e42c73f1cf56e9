"""The problem front end against the JAX package beyond the golden cases of
``test_torch_frontend.py``: callable NLPs and reference semantics, the
parity preset, the merit line search and its step rule, the early exit,
the ``Sym`` problem API, constraint bookkeeping, solver stats and the SQP
iterate carried over from JAX (helpers in ``torch_frontend_cases.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu import OptimalControlProblem as JOCP
from optimal_control_problem_tpu import SQPOptions as JOptions
from optimal_control_problem_tpu.models import cartpole as jcp
from optimal_control_problem_tpu.models import double_integrator as jdi
from optimal_control_problem_tpu_torch import OptimalControlProblem as TOCP
from optimal_control_problem_tpu_torch import SQPOptimizationSolver as TSolver
from optimal_control_problem_tpu_torch import SQPOptions as TOptions
from optimal_control_problem_tpu_torch.interop import (
    settings_from_jax_dict,
    sqp_iterate_from_numpy,
)
from optimal_control_problem_tpu_torch.models import cartpole as tcp
from optimal_control_problem_tpu_torch.models import double_integrator as tdi
from torch_frontend_cases import (
    FORCED,
    INF,
    JAX,
    OPTS,
    PORT,
    arg_of,
    case1,
    case2,
    iters,
    small_config,
    solve,
    sqrt_case,
    sym_problem,
)
from torch_threads import one_torch_thread  # noqa: F401


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
