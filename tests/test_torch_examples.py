"""The port's single-device example twins (``examples/torch/``) against
the JAX examples' loops, on the CPU at small sizes.

Each twin's function runs on ``device="cpu"``; the JAX side is the JAX
example's own function where it takes sizes (``cartpole_swingup.simulate``)
and otherwise the example's loop written out here from the JAX package at
the same sizes.  Closed-loop trajectories are held to the f32 closed-loop
floor of 5e-3 (``PARITY.md``).  The twins keep their originals' asserts
as gates, and every size here passes them.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.controller import MPCController as JController
from optimal_control_problem_tpu.models import double_integrator as jdi
from optimal_control_problem_tpu.models import quadrotor as jquad
from optimal_control_problem_tpu.models import unicycle as juni
from optimal_control_problem_tpu.utils.diagnostics import kkt_residuals as jkkt
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLOOR = 5e-3
QUAD_RATE_FLOOR = 8.03e-3
TWINS = ("cartpole_swingup", "closed_loop_mpc", "quadrotor_hover", "unicycle_obstacles",
         "scenario_mpc", "seq_parallel_mpc")


def load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def twin(name: str):
    return load(ROOT / "examples" / "torch" / f"{name}.py", f"torch_example_{name}")


def quiet(*_):
    pass


def test_every_jax_example_has_a_twin_that_needs_a_gpu_unless_cpu_is_asked(monkeypatch):
    jax_examples = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
    assert jax_examples == sorted(TWINS)
    assert sorted(p.stem for p in (ROOT / "examples" / "torch").glob("*.py")) == sorted(TWINS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in TWINS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            twin(name).main([])


def test_closed_loop_twin_matches_jax():
    H, ticks, dt = 20, 5, 0.005
    pos_t, u_t, printed = twin("closed_loop_mpc").run(ticks=ticks, horizon=H, device="cpu",
                                                      out=quiet)
    ocp = jdi.build(jdi.make_config(horizon=H, dt=dt, alpha=0.5, step_num=10))
    pos, vel, acc = np.array([1.5, 0.0]), np.zeros(2), np.zeros(2)
    pos_j, u_j = [], []
    for tick in range(ticks):
        ref = jdi.reference_circle(H, dt, t0=tick * dt)
        ocp.compute_optimal_trajectory(np.concatenate([pos, vel, acc]), ref)
        u = np.asarray(ocp.get_optimal_frames()[1, 4:6], dtype=np.float64)
        pos, vel, acc = pos + dt * vel, vel + dt * u, u
        pos_j.append(pos)
        u_j.append(u)
    assert pos_t.shape == (ticks, 2) and len(printed) == 1
    np.testing.assert_allclose(pos_t, np.array(pos_j), atol=FLOOR)
    np.testing.assert_allclose(u_t, np.array(u_j), atol=FLOOR)


@pytest.mark.parametrize("line_search", ["merit", "none"])
def test_swingup_twin_matches_jax_simulate(line_search):
    ths = twin("cartpole_swingup").simulate(ticks=5, line_search=line_search, device="cpu")
    ref = load(ROOT / "examples" / "cartpole_swingup.py", "jax_cartpole_swingup").simulate(
        ticks=5, line_search=line_search)
    assert ths.shape == (5,)
    np.testing.assert_allclose(ths, ref, atol=FLOOR)


def test_swingup_twin_prints_both_errors():
    lines = []
    th_m, th_f, err_m, err_f = twin("cartpole_swingup").run(ticks=2, device="cpu",
                                                            out=lines.append)
    assert err_m == abs(np.pi - th_m[-1]) and err_f == abs(np.pi - th_f[-1])
    assert f"merit={err_m:.3f}" in lines[0] and f"{err_f:.3f} rad" in lines[0]


def test_quadrotor_twin_matches_jax():
    H, ticks = 16, 2
    plan, errors, stats = twin("quadrotor_hover").run(horizon=H, ticks=ticks, device="cpu",
                                                      out=quiet)
    cfg = jquad.make_config(horizon=H, dt=0.02, alpha=0.3, step_num=5, formulation="reduced",
                            ADMM_settings={"method": "banded", "max_iter": 250})
    ocp = jquad.build(cfg, stagewise=True)
    frame = jquad.initial_state(pos=(0.5, -0.3, 0.8))
    target = np.array([0.0, 0.0, 1.0])
    ref = jquad.reference_hover(H, tuple(target))
    errs = []
    for _ in range(ticks):
        ocp.compute_optimal_trajectory(frame, ref)
        errs.append(np.linalg.norm(ocp.get_optimal_frames()[-1, 0:3] - target))
    jplan = ocp.get_optimal_frames()
    # Positions, velocities and attitude to the closed-loop floor; body
    # rates and the four controls to the quadrotor's own floor in ROADMAP
    # Queue C (JAX's two eliminations end 8.03e-3 apart on a body rate:
    # the rates amplify torque rounding by 100).  Seen here: 7.33e-3 on a
    # body rate, 4.71e-3 on a control.
    np.testing.assert_allclose(plan[:, :9], jplan[:, :9], atol=FLOOR)
    np.testing.assert_allclose(plan[:, 9:], jplan[:, 9:], atol=QUAD_RATE_FLOOR)
    np.testing.assert_allclose(errors, errs, atol=FLOOR)
    lbx, ubx = ocp.ocp_config.lower_bounds_flat().copy(), ocp.ocp_config.upper_bounds_flat().copy()
    lbx[: jquad.FRAME] = frame
    ubx[: jquad.FRAME] = frame
    jstats = jkkt(*ocp.nlp_functions, np.asarray(ocp.get_optimal_trajectory()), ref, lbx, ubx,
                  ocp.get_constraint_lower_bounds(), ocp.get_constraint_upper_bounds())
    assert set(stats) == set(jstats)
    for k in stats:
        assert abs(stats[k] - jstats[k]) <= FLOOR * max(1.0, abs(jstats[k])), k
    assert stats["constraint_violation"] < 0.05


def test_unicycle_twin_matches_jax():
    H, ticks, dt = 10, 5, 0.05
    states, controls, max_y = twin("unicycle_obstacles").run(ticks=ticks, horizon=H,
                                                             device="cpu", out=quiet)
    cfg = juni.make_config(horizon=H, dt=dt, alpha=0.4, step_num=8)
    ocp = juni.build(cfg, halfspaces=(((0.0, -1.0), -0.3),), stagewise=True)
    assert ocp._solver.options.admm.method == "banded"
    ctl = JController(ocp, control_slice=slice(3, 5))
    s = juni.initial_state(y=-0.2)
    js, ju = [], []
    for tick in range(ticks):
        tt = tick * dt + dt * np.arange(H)
        ref = np.stack([tt, 0.2 + 0.5 * tt], axis=1).reshape(-1)
        u = ctl.step(np.asarray(s, np.float64), ref)
        v, om = float(u[0]), float(u[1])
        s = np.array([s[0] + dt * v * np.cos(s[2]), s[1] + dt * v * np.sin(s[2]),
                      s[2] + dt * om, v, om])
        js.append(s)
        ju.append((v, om))
    np.testing.assert_allclose(states, np.array(js), atol=FLOOR)
    np.testing.assert_allclose(controls, np.array(ju), atol=FLOOR)
    assert max_y == max(s[1] for s in states) < 0.35
