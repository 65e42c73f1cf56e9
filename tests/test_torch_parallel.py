"""The port's batched and scenario-sharded solves and their consensus
(``parallel/batch.py``, ``parallel/dist.py``, ``parallel/mesh.py``) against
the JAX package — mirrors ``tests/test_parallel.py`` case for case.

JAX runs on the 8 virtual CPU devices of ``conftest.py``; the port's mesh
is the in-process one with the same layout (``interop.mesh_from_jax_layout``),
every shard on the CPU.  Both packages get the same numpy inputs.

* Batched double-integrator ticks (the shared-factorization path) equal a
  sequence of single solves to JAX's 2e-2 at the MPC fixed point, and the
  port's batch equals JAX's to 5e-3 (the f32 closed-loop floor of
  PARITY.md); the warm-started tick keeps the first frames pinned (5e-3).
* ``DistributedSolver`` over 8 shards equals the unsharded batch to JAX's
  1e-5 (in-process the whole batch is one call: 0 here), and JAX's sharded
  tick to 5e-3.
* ``consensus_mean`` and ``consensus_first_control`` equal the mean taken
  by hand (rtol 1e-6 / 1e-5, JAX's) and JAX's.
* The stage-structured cart-pole routes through the banded batch driver,
  whose results equal the per-scenario banded ``solve_fn`` (equal
  ``qp_iters``, 1e-5), as in JAX; and JAX's batch tick to 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.models import cartpole as jcp
from optimal_control_problem_tpu.models import double_integrator as jdi
from optimal_control_problem_tpu.parallel import BatchedSolver as JBatchedSolver
from optimal_control_problem_tpu.parallel import DistributedSolver as JDistributedSolver
from optimal_control_problem_tpu.parallel import consensus_mean as jconsensus_mean
from optimal_control_problem_tpu.parallel import make_mesh as jmake_mesh
from optimal_control_problem_tpu_torch.interop import mesh_from_jax_layout
from optimal_control_problem_tpu_torch.models import cartpole as tcp
from optimal_control_problem_tpu_torch.models import double_integrator as tdi
from optimal_control_problem_tpu_torch.parallel import (
    BatchedSolver,
    DistributedSolver,
    consensus_mean,
    make_mesh,
)
from torch_threads import one_torch_thread  # noqa: F401


def di_config(module):
    # Tight deterministic QP settings, as JAX's test.
    return module.make_config(
        horizon=8, dt=0.05, alpha=0.7, step_num=6,
        ADMM_settings={"eps_abs": 1e-4, "eps_rel": 1e-4, "adaptive_rho": False,
                       "method": "condensed"},
    )


@pytest.fixture(scope="module")
def jocp():
    return jdi.build(di_config(jdi))


@pytest.fixture(scope="module")
def ocp():
    return tdi.build(di_config(tdi), device="cpu")


@pytest.fixture(scope="module")
def jmesh():
    mesh = jmake_mesh(("batch",))
    assert mesh.shape["batch"] == 8, "conftest must provide 8 virtual devices"
    return mesh


@pytest.fixture(scope="module")
def mesh(jmesh):
    return mesh_from_jax_layout(jmesh.shape, device="cpu")


def _scenarios(B, H):
    rng = np.random.default_rng(7)
    frames = np.zeros((B, jdi.FRAME))
    frames[:, 0:2] = rng.uniform(-1, 1, size=(B, 2))
    refs = np.tile(np.zeros(2), (B, H)).reshape(B, H * 2)
    return frames, refs


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_batched_solver_matches_single(ocp, jocp):
    B, H = 4, 8
    TICKS = 4  # iterate to the MPC fixed point before comparing
    frames, refs = _scenarios(B, H)
    batched = BatchedSolver(ocp, device="cpu")
    state = batched.init_state(B)
    jb = JBatchedSolver(jocp)
    jstate = jb.init_state(B)
    for _ in range(TICKS):
        trajs, objs, state = batched.solve(frames, refs, state)
        jtrajs, _, jstate = jb.solve(frames, refs, jstate)
    assert trajs.shape == (B, ocp.ocp_config.num_variables)
    np.testing.assert_allclose(_np(trajs), _np(jtrajs), atol=5e-3)

    # Scenario 0 against a sequence of single solves (per-scenario vs
    # shared cost scaling: the converged fixed point agrees).
    solver = ocp.solver
    solver.reset()
    lbx = ocp.ocp_config.lower_bounds_flat().copy()
    ubx = ocp.ocp_config.upper_bounds_flat().copy()
    lbx[: tdi.FRAME] = frames[0]
    ubx[: tdi.FRAME] = frames[0]
    for _ in range(TICKS):
        res = solver.get_optimal_solution({
            "lbx": lbx, "ubx": ubx,
            "lbg": ocp.get_constraint_lower_bounds(),
            "ubg": ocp.get_constraint_upper_bounds(),
            "p": refs[0],
        })
    b_fr = _np(trajs[0]).reshape(H, tdi.FRAME)
    s_fr = _np(res["x"]).reshape(H, tdi.FRAME)
    np.testing.assert_allclose(b_fr[:, 0:4], s_fr[:, 0:4], atol=2e-2)


def test_batched_warm_start_persists(ocp):
    B, H = 3, 8
    frames, refs = _scenarios(B, H)
    batched = BatchedSolver(ocp, device="cpu")
    state = batched.init_state(B)
    t1, _, state = batched.solve(frames, refs, state)
    t2, _, state = batched.solve(frames, refs, state)
    np.testing.assert_allclose(_np(t2)[:, : tdi.FRAME], frames, atol=5e-3)
    # solve_jit is the same tick as a function of tensors.
    st0 = batched.init_state(B)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    x, f, qp_x, qp_y = batched.solve_jit(as_t(frames), as_t(refs), *st0)
    np.testing.assert_array_equal(_np(x), _np(t1))


def test_distributed_solver_8_devices(ocp, jocp, mesh, jmesh):
    B, H = 16, 8
    frames, refs = _scenarios(B, H)
    batched = BatchedSolver(ocp, device="cpu")
    dist = DistributedSolver(batched, mesh)
    assert dist.n_devices == 8
    state = dist.init_state(B)
    trajs, objs, state = dist.solve(frames, refs, state)
    assert trajs.shape == (B, ocp.ocp_config.num_variables)
    # Identical to the unsharded batched solve.
    ref_trajs, _, _ = batched.solve(frames, refs, batched.init_state(B))
    np.testing.assert_allclose(_np(trajs), _np(ref_trajs), atol=1e-5)
    jd = JDistributedSolver(JBatchedSolver(jocp), jmesh)
    jtrajs, _, _ = jd.solve(frames, refs, jd.init_state(B))
    np.testing.assert_allclose(_np(trajs), _np(jtrajs), atol=5e-3)


def test_distributed_batch_divisibility(ocp, mesh):
    dist = DistributedSolver(BatchedSolver(ocp, device="cpu"), mesh)
    with pytest.raises(ValueError, match="not divisible"):
        dist.init_state(10)


def test_consensus_mean_collective(mesh, jmesh):
    B, d = 16, 2
    vals = np.arange(B * d, dtype=np.float32).reshape(B, d)
    out = consensus_mean(torch.as_tensor(vals), mesh)
    np.testing.assert_allclose(_np(out), vals.mean(axis=0), rtol=1e-6)
    np.testing.assert_allclose(_np(out), _np(jconsensus_mean(jnp.asarray(vals), jmesh)),
                               rtol=1e-6)


def test_consensus_first_control(ocp, jocp, mesh, jmesh):
    B, H = 8, 8
    frames, refs = _scenarios(B, H)
    dist = DistributedSolver(BatchedSolver(ocp, device="cpu"), mesh)
    trajs, _, _ = dist.solve(frames, refs, dist.init_state(B))
    u = dist.consensus_first_control(trajs, slice(4, 6))
    assert u.shape == (2,)
    np.testing.assert_allclose(_np(u), _np(trajs)[:, 4:6].mean(axis=0), atol=1e-5)
    jd = JDistributedSolver(JBatchedSolver(jocp), jmesh)
    jtrajs, _, _ = jd.solve(frames, refs, jd.init_state(B))
    np.testing.assert_allclose(_np(u), _np(jd.consensus_first_control(jtrajs, slice(4, 6))),
                               atol=5e-3)


def test_batched_banded_routes_and_matches_vmapped():
    """Stage-structured models route BatchedSolver through the batch-native
    banded driver; its results equal the per-scenario banded solve (same
    QP iteration counts, 1e-5), with the per-step QP flags populated."""
    cfg = lambda m: m.make_config(horizon=8, dt=0.04, alpha=0.3, step_num=4)  # noqa: E731
    ocp = tcp.build(cfg(tcp), stagewise=True, device="cpu")
    solver = ocp.solver
    assert solver.solve_batch_banded_fn is not None
    assert solver.solve_batch_fn is None  # nonlinear: no shared-system path

    B = 3
    rng = np.random.default_rng(3)
    frames = np.zeros((B, tcp.FRAME))
    frames[:, 2] = rng.uniform(-0.4, 0.4, size=B)  # theta spread
    refs = np.full((B, 1), np.pi)

    batched = BatchedSolver(ocp, device="cpu")
    trajs, objs, state = batched.solve(frames, refs, batched.init_state(B))
    res_b = batched.last_result
    assert _np(res_b.qp_converged).shape == (4, B)
    assert np.all(_np(res_b.qp_converged))
    assert not np.any(_np(res_b.qp_prim_inf))

    # The per-scenario solve_fn over the same inputs.
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    lbx = np.tile(ocp.ocp_config.lower_bounds_flat(), (B, 1))
    ubx = np.tile(ocp.ocp_config.upper_bounds_flat(), (B, 1))
    lbx[:, : tcp.FRAME] = frames
    ubx[:, : tcp.FRAME] = frames
    lbg, ubg = ocp.get_constraint_lower_bounds(), ocp.get_constraint_upper_bounds()
    for b in range(B):
        ref = solver.solve_fn(torch.zeros(solver.n_x), f32(refs[b]), f32(lbx[b]), f32(ubx[b]),
                              f32(lbg), f32(ubg), torch.zeros(solver._qp_n),
                              torch.zeros(solver._qp_m))
        np.testing.assert_array_equal(_np(ref.qp_iters), _np(res_b.qp_iters)[:, b])
        np.testing.assert_allclose(_np(ref.x), _np(trajs[b]), atol=1e-5, rtol=1e-5)

    jb = JBatchedSolver(jcp.build(cfg(jcp), stagewise=True))
    jtrajs, _, _ = jb.solve(frames, refs, jb.init_state(B))
    np.testing.assert_allclose(_np(trajs), _np(jtrajs), atol=5e-3)


def test_distributed_mesh_needs_a_process_group():
    """Asking for torch.distributed without a process group raises; it
    never falls back to in-process."""
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(("batch",), devices="distributed")
    with pytest.raises(ValueError, match="shape required"):
        make_mesh(("b", "h"), devices="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        make_mesh(("b", "h"), shape=(2,), devices="cpu")
    assert len(jax.devices()) == 8
