"""The port's horizon-sharded MPC front end (``parallel/sharded_solver.py``)
against the JAX package — mirrors ``tests/test_sharded_solver.py`` case
for case: cart-pole from the shipped YAML (horizon 20), built the way a
user builds it, over 4 shards of ``"h"`` (JAX: 4 of its 8 virtual CPU
devices; the port: the in-process mesh on the CPU).

* One tick equals the single-device front end to JAX's 5e-2 and JAX's
  sharded tick to 5e-3 (the f32 closed-loop floor), with the same ADMM
  counts and QP flags; first-frame pinning holds; the flat accessor is the
  frames.
* The warm-started second tick moves less than the first, and equals JAX's.
* The (2, 4) ``("b", "h")`` mesh gives per-scenario trajectories and QP
  flags ``(B, 3, 3)``, equal to JAX's.
* A horizon that does not split, an unknown axis and a problem without a
  stage structure are refused.
"""

import os

import jax
import numpy as np
import pytest

from optimal_control_problem_tpu.models import cartpole as jcp
from optimal_control_problem_tpu.parallel import HorizonShardedSolver as JHorizonShardedSolver
from optimal_control_problem_tpu.parallel import make_mesh as jmake_mesh
from optimal_control_problem_tpu_torch.config import load_config
from optimal_control_problem_tpu_torch.models import cartpole as tcp
from optimal_control_problem_tpu_torch.parallel import HorizonShardedSolver, make_mesh
from test_sharded_solver import yaml_ocp as jyaml_ocp
from torch_threads import one_torch_thread  # noqa: F401

YAML = os.path.join(os.path.dirname(__file__), "..", "configs", "cartpole.yaml")


def yaml_ocp(step_num=6, max_iter=800):
    """The port's twin of JAX's ``yaml_ocp``: the shipped YAML with the
    test's SQP and ADMM settings, stage structure registered."""
    node = load_config(YAML)
    node["solver_settings"]["SQP_settings"] = {"alpha": 0.3, "step_num": step_num}
    node["solver_settings"]["ADMM_settings"] = {
        "method": "banded", "max_iter": max_iter, "adaptive_rho": False, "rho": 0.05,
        "eps_abs": 1e-4, "eps_rel": 1e-4,
    }
    return tcp.build(node, stagewise=True, device="cpu")


def h4():
    return make_mesh(("h",), shape=(4,), devices="cpu")


def jh4():
    return jmake_mesh(("h",), shape=(4,), devices=jax.devices()[:4])


def test_yaml_built_ocp_horizon_sharded():
    sharded = HorizonShardedSolver(yaml_ocp(), h4())
    frame = tcp.initial_state(th=0.4)
    ref = np.array([np.pi])
    traj = sharded.compute_optimal_trajectory(frame, ref).numpy()
    assert traj.shape == (20, tcp.FRAME)
    assert np.isfinite(traj).all()
    pin_tol = (1 - 0.3) ** 6 * np.abs(frame).max() * 1.5 + 1e-3
    assert np.abs(traj[0] - frame).max() < pin_tol

    ocp_ref = yaml_ocp()
    ocp_ref.compute_optimal_trajectory(frame, ref)
    np.testing.assert_allclose(traj, ocp_ref.get_optimal_frames(), atol=5e-2)

    stats = sharded.get_solver_stats()
    assert stats["qp_iters"].shape == (6,)
    assert stats["qp_status"].shape == (6, 3)
    assert not stats["qp_status"][:, 1:].any()
    np.testing.assert_array_equal(sharded.get_optimal_trajectory().numpy(), traj.reshape(-1))

    jsharded = JHorizonShardedSolver(jyaml_ocp(), jh4())
    jtraj = np.asarray(jsharded.compute_optimal_trajectory(frame, ref))
    np.testing.assert_allclose(traj, jtraj, atol=5e-3)
    jstats = jsharded.get_solver_stats()
    np.testing.assert_array_equal(stats["qp_iters"], jstats["qp_iters"])
    np.testing.assert_array_equal(stats["qp_status"], jstats["qp_status"])


def test_second_tick_warm_start():
    sharded = HorizonShardedSolver(yaml_ocp(step_num=4), h4())
    jsharded = JHorizonShardedSolver(jyaml_ocp(step_num=4), jh4())
    frame = tcp.initial_state(th=0.3)
    ref = np.array([np.pi])
    ticks = []
    for _ in range(2):
        t = sharded.compute_optimal_trajectory(frame, ref).numpy()
        np.testing.assert_allclose(
            t, np.asarray(jsharded.compute_optimal_trajectory(frame, ref)), atol=5e-3)
        ticks.append(t)
    t1, t2 = ticks
    assert np.isfinite(t2).all()
    assert np.linalg.norm(t2 - t1) < np.linalg.norm(t1) + 1e-6


def test_batched_scenarios_2d_mesh():
    sharded = HorizonShardedSolver(yaml_ocp(step_num=3, max_iter=400),
                                   make_mesh(("b", "h"), shape=(2, 4), devices="cpu"),
                                   axis="h", batch_axis="b")
    B = 4
    frames = np.stack([tcp.initial_state(th=0.2 + 0.1 * b) for b in range(B)])
    refs = np.full((B, 1), np.pi)
    trajs = sharded.compute_optimal_trajectory(frames, refs).numpy()
    assert trajs.shape == (B, 20, tcp.FRAME)
    assert np.isfinite(trajs).all()
    pin_tol = (1 - 0.3) ** 3 * np.abs(frames).max() * 1.5 + 1e-3
    for b in range(B):
        assert np.abs(trajs[b, 0] - frames[b]).max() < pin_tol
    stats = sharded.get_solver_stats()
    assert stats["qp_status"].shape == (B, 3, 3)

    jsharded = JHorizonShardedSolver(jyaml_ocp(step_num=3, max_iter=400),
                                     jmake_mesh(("b", "h"), shape=(2, 4)),
                                     axis="h", batch_axis="b")
    jtrajs = np.asarray(jsharded.compute_optimal_trajectory(frames, refs))
    np.testing.assert_allclose(trajs, jtrajs, atol=5e-3)
    np.testing.assert_array_equal(stats["qp_status"], jsharded.get_solver_stats()["qp_status"])


def test_validation_errors():
    ocp = yaml_ocp()
    with pytest.raises(ValueError, match="split into"):
        HorizonShardedSolver(ocp, make_mesh(("h",), shape=(8,), devices="cpu"))  # 20 % 8
    with pytest.raises(ValueError, match="no axis"):
        HorizonShardedSolver(ocp, h4(), axis="z")
    plain = tcp.build(tcp.make_config(horizon=20, dt=0.02), stagewise=False, device="cpu")
    with pytest.raises(ValueError, match="stage-structured"):
        HorizonShardedSolver(plain, h4())
    # The JAX package refuses the same three.
    with pytest.raises(ValueError, match="stage-structured"):
        JHorizonShardedSolver(jcp.build(jcp.make_config(horizon=20, dt=0.02), stagewise=False),
                              jh4())
