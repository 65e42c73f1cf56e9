"""The port's multi-device example twins (``examples/torch/scenario_mpc.py``,
``seq_parallel_mpc.py``) against the JAX examples' loops on JAX's 8
virtual CPU devices (``tests/conftest.py``).

The twins run at 8 in-process shards on ``device="cpu"``, the port's
counterpart of those 8 devices.  ``seq_parallel_mpc`` runs at its own
settings (both layouts) and uses the JAX example's ``build_ocp``;
``scenario_mpc`` runs 16 scenarios for 15 ticks, enough for its own gate
(the final position within 0.5 of the target).  Trajectories are held to
the f32 closed-loop floor of 5e-3 (``PARITY.md``), ADMM iteration counts
exactly (the horizon-sharded loop checks every 25 iterations, far from
the knife edge here).
"""

import jax
import numpy as np

from optimal_control_problem_tpu.models import cartpole as jcart
from optimal_control_problem_tpu.models import double_integrator as jdi
from optimal_control_problem_tpu.parallel import (
    BatchedSolver,
    DistributedSolver,
    HorizonShardedSolver,
    make_mesh,
)
from test_torch_examples import FLOOR, ROOT, load, quiet, twin
from torch_threads import one_torch_thread  # noqa: F401


def test_scenario_twin_matches_jax_on_8_devices():
    B, ticks, H, dt = 16, 15, 10, 0.02
    pos_t, u_t = twin("scenario_mpc").run(ticks=ticks, batch=B, shards=8, device="cpu",
                                          out=quiet)
    assert len(jax.devices()) == 8
    dist = DistributedSolver(BatchedSolver(jdi.build(
        jdi.make_config(horizon=H, dt=dt, alpha=0.5, step_num=8))))
    rng = np.random.default_rng(0)
    pos, vel, acc = np.array([1.0, -0.5]), np.zeros(2), np.zeros(2)
    refs = np.zeros((B, 2 * H), np.float32)
    state = dist.init_state(B)
    pos_j, u_j = [], []
    for _ in range(ticks):
        frames = np.tile(np.concatenate([pos, vel, acc])[None, :], (B, 1)).astype(np.float32)
        frames[:, 0:4] += 0.05 * rng.normal(size=(B, 4)).astype(np.float32)
        trajs, _, state = dist.solve(frames, refs, state)
        u = np.asarray(dist.consensus_first_control(trajs[:, jdi.FRAME:2 * jdi.FRAME],
                                                    slice(4, 6)))
        pos, vel, acc = pos + dt * vel, vel + dt * u, u
        pos_j.append(pos)
        u_j.append(u)
    np.testing.assert_allclose(pos_t, np.array(pos_j), atol=FLOOR)
    np.testing.assert_allclose(u_t, np.array(u_j), atol=FLOOR)
    assert np.linalg.norm(pos_t[-1]) < 0.5


def test_seq_parallel_twin_matches_jax_on_8_devices():
    xb, traj, qp_iters = twin("seq_parallel_mpc").run(horizon=16, shards=8, device="cpu",
                                                      out=quiet)
    ocp = load(ROOT / "examples" / "seq_parallel_mpc.py", "jax_seq_parallel_mpc").build_ocp(
        16, 0.04)
    ref = np.array([np.pi])
    mesh2 = make_mesh(("b", "h"), shape=(2, 4))
    frames = np.stack([jcart.initial_state(th=0.2 + 0.15 * b) for b in range(4)])
    jxb = np.asarray(HorizonShardedSolver(ocp, mesh2, axis="h", batch_axis="b")
                     .compute_optimal_trajectory(frames, np.tile(ref[None], (4, 1))))
    sharded = HorizonShardedSolver(ocp, make_mesh(("h",), devices=jax.devices()[:4]))
    jtraj = np.asarray(sharded.compute_optimal_trajectory(jcart.initial_state(th=0.5), ref))
    assert xb.shape == jxb.shape == (4, 16, 5) and traj.shape == jtraj.shape == (16, 5)
    np.testing.assert_allclose(xb, jxb, atol=FLOOR)
    np.testing.assert_allclose(traj, jtraj, atol=FLOOR)
    np.testing.assert_array_equal(qp_iters, sharded.get_solver_stats()["qp_iters"])
