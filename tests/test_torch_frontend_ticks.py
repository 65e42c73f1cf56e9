"""The port's problem front end as users build it, against the JAX package
on the same numpy inputs (split out of ``test_torch_frontend.py``, whose
other cases stay there, so that two test workers can carry them):

* the four shipped ``configs/*.yaml`` (one tick each, the quadrotor on its
  stage structure), trajectories within 5e-3 (the f32 floor of
  PARITY.md);
* ``test_controller.py``'s closed loops (closed-loop states within 2e-2 of
  JAX's, the final state within 1e-3);
* batched ticks of the augmented formulation: dense cart-pole (both
  backends; the parity preset, which diverges to NaN in both packages on
  this nonconvex cost, with equal flags), the double integrator through
  the shared factorization at n = n_p + n_x; and a dense method, a shared
  system and a banded solve without parts on a stage structure.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from optimal_control_problem_tpu import SQPOptimizationSolver as JSolver
from optimal_control_problem_tpu import SQPOptions as JOptions
from optimal_control_problem_tpu.controller import MPCController as JController
from optimal_control_problem_tpu.models import cartpole as jcp
from optimal_control_problem_tpu.models import double_integrator as jdi
from optimal_control_problem_tpu.models import quadrotor as jqr
from optimal_control_problem_tpu.models import unicycle as jun
from optimal_control_problem_tpu.parallel import BatchedSolver as JBatched
from optimal_control_problem_tpu.solvers.admm import ADMMSettings as JADMM
from optimal_control_problem_tpu_torch import SQPOptimizationSolver as TSolver
from optimal_control_problem_tpu_torch import SQPOptions as TOptions
from optimal_control_problem_tpu_torch.controller import MPCController as TController
from optimal_control_problem_tpu_torch.interop import batch_state_from_numpy
from optimal_control_problem_tpu_torch.models import cartpole as tcp
from optimal_control_problem_tpu_torch.models import double_integrator as tdi
from optimal_control_problem_tpu_torch.models import quadrotor as tqr
from optimal_control_problem_tpu_torch.models import unicycle as tun
from optimal_control_problem_tpu_torch.parallel import BatchedSolver as TBatched
from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings as TADMM
from torch_threads import one_torch_thread  # noqa: F401

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


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
