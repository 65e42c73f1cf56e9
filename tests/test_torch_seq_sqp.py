"""The port's end-to-end sequence-parallel SQP (``parallel/seq_sqp.py``)
against the JAX package — mirrors ``tests/test_seq_sqp.py`` case for case
on JAX's cart-pole problem (``problem()``: h16, per-stage references), plus
the quadrotor.

JAX runs on its 8 virtual CPU devices, the port on the in-process mesh of
the same layout; JAX's results are shared through module fixtures.

* 1-D ``"h"`` of 8: the port's trajectory equals JAX's single-device
  banded SQP to JAX's 5e-2 and JAX's sharded SQP to 5e-3 (the f32
  closed-loop floor), with the same QP flags (converged after the cold
  first QP, no certificate).
* 2-D ``("b", "h")`` of (2, 4): each scenario equals its own 1-D solve to
  JAX's 5e-3, and the port equals JAX's 2-D solve with the same ADMM
  iteration counts per scenario and step (termination synced over both
  axes, each local scenario on its own, as JAX's ``vmap``).
* The merit line search: at least as good in merit as the fixed step
  (JAX's rule) and equal to JAX's line-searched SQP (5e-3, same counts).
* The quadrotor h16 over ``"h"`` of 4 (no stage constraints), one tick of
  ``HorizonShardedSolver`` under a forced ADMM budget against JAX's
  single-device front end: 5e-2.  JAX's own sequence-parallel path does
  not run this model: its ``shard_map`` value typing rejects the empty
  stage-constraint carry (ROADMAP Queue C).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.models import quadrotor as jqr
from optimal_control_problem_tpu.parallel import make_mesh as jmake_mesh
from optimal_control_problem_tpu.parallel.seq_sqp import sqp_solve_seq_parallel as jseq_sqp
from optimal_control_problem_tpu_torch.interop import mesh_from_jax_layout, settings_from_jax_dict
from optimal_control_problem_tpu_torch.models import cartpole as tcp
from optimal_control_problem_tpu_torch.models import quadrotor as tqr
from optimal_control_problem_tpu_torch.parallel import HorizonShardedSolver, make_mesh
from optimal_control_problem_tpu_torch.parallel.seq_sqp import sqp_solve_seq_parallel
from test_seq_sqp import ADMM, ALPHA, DT, H, SQP_ITERS, problem, single_device_reference
from torch_threads import one_torch_thread  # noqa: F401

TADMM = settings_from_jax_dict(dataclasses.asdict(ADMM))


def port_ss():
    return dataclasses.replace(tcp.stage_structure(H, DT), ref_frame_size=1)


@pytest.fixture(scope="module")
def prob():
    return problem()


@pytest.fixture(scope="module")
def jax_1d(prob):
    """JAX's sharded SQP on 8 devices, fixed step and merit search."""
    ss, lx, ux, ref = prob
    x0 = np.zeros((H, tcp.FRAME), np.float32)
    mesh = jmake_mesh(("h",))
    out = {}
    for ls in ("none", "merit"):
        x, its, st = jseq_sqp(ss, jnp.asarray(x0), jnp.asarray(ref), jnp.asarray(lx),
                              jnp.asarray(ux), sqp_iters=SQP_ITERS, alpha=ALPHA, admm=ADMM,
                              mesh=mesh, axis="h", line_search=ls)
        out[ls] = (np.asarray(x), np.asarray(its), np.asarray(st))
    return out


def port_1d(prob, line_search="none", mesh=None):
    _, lx, ux, ref = prob
    x0 = torch.zeros((H, tcp.FRAME))
    mesh = mesh or make_mesh(("h",), shape=(8,), devices="cpu")
    x, its, st = sqp_solve_seq_parallel(
        port_ss(), x0, torch.tensor(ref), torch.tensor(lx), torch.tensor(ux),
        sqp_iters=SQP_ITERS, alpha=ALPHA, admm=TADMM, mesh=mesh, axis="h",
        line_search=line_search,
    )
    return x.numpy(), its.numpy(), st.numpy()


def test_seq_sqp_matches_single_device(prob, jax_1d):
    x_seq, its, qp_status = port_1d(prob)
    assert its.shape == (SQP_ITERS,)
    assert qp_status.shape == (SQP_ITERS, 3)
    assert qp_status[1:, 0].all()
    assert not qp_status[:, 1:].any()
    assert np.isfinite(x_seq).all()
    x_ref = single_device_reference(*prob)
    np.testing.assert_allclose(x_seq, x_ref, atol=5e-2)
    jx, _, jst = jax_1d["none"]
    np.testing.assert_array_equal(qp_status, jst)
    np.testing.assert_allclose(x_seq, jx, atol=5e-3)


def test_seq_sqp_2d_mesh_batch_by_horizon(prob):
    """Scenarios x horizon on (2, 4): each scenario equals its own 1-D
    horizon-sharded solve; the port equals JAX's 2-D solve."""
    ss, lx, ux, ref = prob
    B = 4
    x0 = np.zeros((B, H, tcp.FRAME), np.float32)
    lxb = np.tile(lx[None], (B, 1, 1))
    uxb = np.tile(ux[None], (B, 1, 1))
    for b in range(B):
        fr = tcp.initial_state(th=0.2 + 0.1 * b).astype(np.float32)
        lxb[b, 0] = fr
        uxb[b, 0] = fr
    refb = np.tile(ref[None], (B, 1, 1))
    jmesh2d = jmake_mesh(("b", "h"), shape=(2, 4))
    jx2d, jits, jst = jseq_sqp(ss, jnp.asarray(x0), jnp.asarray(refb), jnp.asarray(lxb),
                               jnp.asarray(uxb), sqp_iters=4, alpha=ALPHA, admm=ADMM,
                               mesh=jmesh2d, axis="h", batch_axis="b")
    mesh2d = mesh_from_jax_layout(jmesh2d.shape, device="cpu")
    t = torch.tensor
    x2d, its, st2d = sqp_solve_seq_parallel(
        port_ss(), t(x0), t(refb), t(lxb), t(uxb), sqp_iters=4, alpha=ALPHA, admm=TADMM,
        mesh=mesh2d, axis="h", batch_axis="b",
    )
    assert x2d.shape == (B, H, tcp.FRAME)
    assert np.isfinite(x2d.numpy()).all()
    np.testing.assert_array_equal(its.numpy(), np.asarray(jits))
    np.testing.assert_array_equal(st2d.numpy(), np.asarray(jst))
    np.testing.assert_allclose(x2d.numpy(), np.asarray(jx2d), atol=5e-3)

    mesh1d = make_mesh(("h",), shape=(4,), devices="cpu")
    for b in range(B):
        x1d, _, _ = sqp_solve_seq_parallel(
            port_ss(), t(x0[b]), t(refb[b]), t(lxb[b]), t(uxb[b]), sqp_iters=4, alpha=ALPHA,
            admm=TADMM, mesh=mesh1d, axis="h",
        )
        # The 2-D run syncs QP termination across scenarios, so its ADMM
        # counts differ from the 1-D runs: QP-tolerance agreement.
        np.testing.assert_allclose(x2d[b].numpy(), x1d.numpy(), atol=5e-3,
                                   err_msg=f"scenario {b}")


def test_seq_sqp_merit_line_search(prob, jax_1d):
    """The distributed merit search: at least as good in merit as the
    fixed step at the same SQP budget, finite, and JAX's."""
    ss, lx, ux, ref = prob
    x_fixed, _, _ = port_1d(prob)
    x_ls, its, _ = port_1d(prob, line_search="merit")
    assert np.isfinite(x_ls).all()

    def merit(x):
        frames = jnp.asarray(x)
        ks = jnp.arange(H)
        fv = jnp.sum(jax.vmap(ss.stage_cost)(frames, jnp.asarray(ref), ks))
        dynres = jax.vmap(ss.dynamics)(frames[:-1], frames[1:])
        viol = jnp.sum(jnp.abs(dynres))
        viol += jnp.sum(jnp.maximum(jnp.asarray(lx) - frames, 0)
                        + jnp.maximum(frames - jnp.asarray(ux), 0))
        return float(fv + 10.0 * viol)

    assert merit(x_ls) <= merit(x_fixed) + 1e-3
    jx, jits, _ = jax_1d["merit"]
    np.testing.assert_array_equal(its, jits)
    np.testing.assert_allclose(x_ls, jx, atol=5e-3)


def test_quadrotor_h16_over_four_shards_matches_jax():
    """The quadrotor h16 (frames of 16, 12 dynamics rows, no stage
    constraints) through HorizonShardedSolver over "h" of 4, one tick
    under a forced ADMM budget (eps_abs < 0: 100 iterations a QP), against
    JAX's single-device banded front end on the same inputs."""
    admm = {"method": "banded", "max_iter": 100, "adaptive_rho": False, "rho": 0.1,
            "eps_abs": -1.0, "eps_rel": 1e-4, "check_every": 10}
    cfg = lambda m: m.make_config(horizon=16, dt=0.05, alpha=0.5, step_num=3,  # noqa: E731
                                  ADMM_settings=dict(admm))
    frame = tqr.initial_state(pos=(0.3, -0.2, 0.8))
    ref = tqr.reference_hover(16)
    sharded = HorizonShardedSolver(tqr.build(cfg(tqr), stagewise=True, device="cpu"),
                                   make_mesh(("h",), shape=(4,), devices="cpu"))
    traj = sharded.compute_optimal_trajectory(frame, ref).numpy()
    stats = sharded.get_solver_stats()
    np.testing.assert_array_equal(stats["qp_iters"], [100, 100, 100])
    assert not stats["qp_status"][:, 1:].any()
    assert np.isfinite(traj).all()
    # Damped SQP pins the first frame geometrically from x0 = 0.
    pin_tol = (1 - 0.5) ** 3 * np.abs(frame).max() * 1.5 + 1e-3
    assert np.abs(traj[0] - frame).max() < pin_tol
    jocp = jqr.build(cfg(jqr), stagewise=True)
    jocp.compute_optimal_trajectory(frame, ref)
    np.testing.assert_allclose(traj, np.asarray(jocp.get_optimal_frames()), atol=5e-2)
