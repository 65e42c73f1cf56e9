"""The port's batched ticks end to end against the JAX package's, beyond the
banded cart-pole of ``test_torch_slice.py`` (helpers in
``torch_slice_cases.py``):

* the dense cart-pole tick (``stagewise=False``; ``"xla"`` and ``"pallas"``,
  at the bench's settings and under a forced budget, and per problem) and
  the double integrator's tick (forced budget and bench settings);
* batched quadrotor h16 MPC ticks (B=2, step_num=2, the quadrotor bench's
  settings) through ``BatchedSolver`` in both packages: there JAX runs its
  one-way kernel and the port its rolled two-way kernel with the depth-1
  CR level, so the test also holds the two elimination orders together;
  and the same with ``banded_solver: "cr"`` against JAX's tick on its CR
  kernel.
"""

import numpy as np
import pytest

from optimal_control_problem_tpu.models import cartpole as jcp
from optimal_control_problem_tpu.models import quadrotor as jqr
from optimal_control_problem_tpu.parallel import BatchedSolver as JBatchedSolver
from optimal_control_problem_tpu_torch.interop import batch_state_from_numpy
from optimal_control_problem_tpu_torch.models import cartpole as tcp
from optimal_control_problem_tpu_torch.models import double_integrator as tdi
from optimal_control_problem_tpu_torch.models import quadrotor as tqr
from optimal_control_problem_tpu_torch.ops import banded_cr_kernel as bck
from optimal_control_problem_tpu_torch.ops import banded_rolled_kernel as brk
from optimal_control_problem_tpu_torch.parallel import BatchedSolver
from optimal_control_problem_tpu_torch.solvers import admm_banded_batch as abb
from torch_slice_cases import dense_config, di_ticks, frames_refs
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("forced", [False, True], ids=["bench", "forced"])
def test_cartpole_dense_tick_matches_jax(backend, forced):
    """The per-scenario dense batch path (cart-pole without a stage
    structure; JAX: ``jax.vmap`` of ``solve_fn``), H=6, B=3, step_num 3,
    two ticks from the same state in both packages: trajectories within
    5e-3, objectives to rtol 1e-3, equal flags.  Under a forced budget
    (eps 0, max_iter 60: every QP runs whole check blocks to 75) the
    per-scenario ``qp_iters`` are equal; at the bench's eps 1e-3 they are
    compared at the warm tick, where every QP stops at its first check."""
    B = 3
    frames, refs = frames_refs(B)
    kw = dict(eps_abs=0.0, eps_rel=0.0, max_iter=60, check_infeasibility=False) if forced else {}
    jb = JBatchedSolver(jcp.build(dense_config(jcp, backend, **kw)))
    tb = BatchedSolver(tcp.build(dense_config(tcp, backend, **kw), device="cpu"), device="cpu")
    jst = jb.init_state(B)
    tst = batch_state_from_numpy(jst._asdict(), device="cpu")
    assert tst.qp_x.shape == (B, 30) and tst.qp_y.shape == (B, 30 + 26)
    for _ in range(2):
        jx, jf, jst = jb.solve(frames, refs, jst)
        tx, tf, tst = tb.solve(frames, refs, tst)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=5e-3)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-3)
        tres, jres = tb.last_result, jb.last_result
        for name in ("qp_converged", "qp_prim_inf", "qp_dual_inf"):
            np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                          np.asarray(getattr(jres, name)), err_msg=name)
    assert np.isfinite(tx.numpy()).all()
    assert tres.f_history.shape == tres.qp_iters.shape == (B, 3)
    assert tres.steps_taken.tolist() == [3] * B
    np.testing.assert_array_equal(tres.qp_iters.numpy(), np.asarray(jres.qp_iters))
    if forced:
        assert (tres.qp_iters == 75).all() and not bool(tres.qp_converged.any())
    else:
        assert bool(tres.qp_converged.all()) and (tres.qp_iters == 25).all()


def test_cartpole_dense_per_problem_pallas_matches_batched():
    """compute_optimal_trajectory on the "pallas" backend (the device loop
    with a batch of one) gives the batched tick's scenario 0, and the
    batch went through the device loop once per SQP step."""
    from optimal_control_problem_tpu_torch.solvers import admm as tadmm

    frames, refs = frames_refs(2, seed=3)
    ocp = tcp.build(dense_config(tcp, "pallas"), device="cpu")
    ocp.compute_optimal_trajectory(frames[0], refs[0])
    one = ocp.get_optimal_trajectory().numpy()
    b = BatchedSolver(tcp.build(dense_config(tcp, "pallas"), device="cpu"), device="cpu")
    before = tadmm._iterate_dense.entries
    tx, _, _ = b.solve(frames, refs, b.init_state(2))
    assert tadmm._iterate_dense.entries - before == 3
    np.testing.assert_allclose(one, tx[0].numpy(), atol=5e-3)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_double_integrator_tick_matches_jax_forced_budget(backend):
    """h20, n=120, m=196, every QP run to max_iter = 150 (one rho adaptation
    at 100): equal qp_iters by construction of both drivers' chunk bounds,
    so the trajectories differ only by f32 roundoff (each package factors
    its own operator): within the 5e-3 floor of PARITY.md."""
    kw = dict(backend=backend, step_num=3, eps_abs=1e-7, eps_rel=1e-7, max_iter=150)
    for tx, jx, tf, jf, tres, jres in di_ticks(kw, B=3, ticks=2):
        np.testing.assert_array_equal(tres.qp_iters.numpy(), np.asarray(jres.qp_iters))
        assert tres.qp_iters.tolist() == [150, 150, 150]
        np.testing.assert_allclose(tx, jx, atol=5e-3)
        np.testing.assert_allclose(tf, jf, rtol=1e-4)
    assert np.isfinite(tx).all()
    assert tres.f_history.shape == (3, 3) and tres.qp_converged.shape == (3, 3)
    assert int(tres.steps_taken.min()) == 3


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_double_integrator_tick_matches_jax_bench_settings(backend):
    B, H = 4, 20
    for tx, jx, tf, jf, tres, jres in di_ticks(dict(backend=backend), B=B, ticks=3):
        assert bool(tres.qp_converged.all()) and bool(np.asarray(jres.qp_converged).all())
        assert not bool(tres.qp_prim_inf.any()) and not bool(tres.qp_dual_inf.any())
        d = np.abs(tx - jx).reshape(B, H, tdi.FRAME)
        assert d[..., 0:4].max() <= 5e-3  # positions, velocities
        assert d[..., 4:6].max() <= 0.1  # accelerations (range +-50)
        np.testing.assert_allclose(tf, jf, rtol=1e-3)
    # Warm-started steady state: one check block per step in both.
    assert tres.qp_iters.tolist() == np.asarray(jres.qp_iters).tolist() == [25] * 10


QUAD_ADMM = {
    "method": "banded", "max_iter": 250, "adaptive_rho": False, "rho": 0.05,
    "check_every": 2, "scaling_refresh": "tick",
}


def quad_frames_refs(B, H, seed=0):
    rng = np.random.default_rng(seed)
    frames = np.tile(tqr.initial_state()[None, :], (B, 1)).astype(np.float32)
    frames[:, 0:2] += rng.uniform(-0.5, 0.5, (B, 2)).astype(np.float32)
    refs = np.tile(tqr.reference_hover(H)[None, :], (B, 1)).astype(np.float32)
    return frames, refs


def _jax_quad_ticks(cfg, frames, refs, ticks):
    jb = JBatchedSolver(jqr.build(cfg, stagewise=True))
    st = jb.init_state(frames.shape[0])
    out = []
    for _ in range(ticks):
        x, f, st = jb.solve(frames, refs, st)
        out.append((np.asarray(x), np.asarray(f)))
    return out, jb.init_state(frames.shape[0])


def test_quadrotor_batched_tick_matches_jax(monkeypatch):
    """The port's h16 tick runs the rolled kernel with its CR level.  It is
    held at 5e-3 to JAX's tick on JAX's rolled kernel (same elimination
    order) and at 1e-2 to JAX's default tick on its one-way kernel: JAX's
    own two kernels differ by 8.0e-3 on a body rate of this tick (torque
    rounding times 1/inertia = 100; ROADMAP Queue C).  Four ticks on the
    same frames: after the cold first tick the objective rises in both
    packages (32.9 to 36.9 here) while the warm-started SQP halves the
    dynamics defect each tick."""
    B, H, ticks = 2, 16, 4

    def cfg(module):
        return module.make_config(horizon=H, dt=0.02, alpha=0.3, step_num=2,
                                  formulation="reduced", ADMM_settings=dict(QUAD_ADMM))

    frames, refs = quad_frames_refs(B, H)
    one_way, jst = _jax_quad_ticks(cfg(jqr), frames, refs, ticks)
    # JAX's driver takes its rolled kernel when the one-way tile model
    # finds no tile; clear the jit caches so the batch solve is re-traced.
    import jax

    import optimal_control_problem_tpu.solvers.admm_banded_batch as jabb

    jax.clear_caches()
    monkeypatch.setattr(jabb, "pick_batch_tile", lambda *a, **k: None)
    try:
        rolled, _ = _jax_quad_ticks(cfg(jqr), frames, refs, ticks)
    finally:
        monkeypatch.undo()
        jax.clear_caches()

    tb = BatchedSolver(tqr.build(cfg(tqr), stagewise=True, device="cpu"), device="cpu")
    tst = batch_state_from_numpy(jst._asdict(), device="cpu")
    kernels = []
    real = abb.chunk_kernel

    def spy(*args, **kwargs):
        fn, kw = real(*args, **kwargs)
        kernels.append((fn, kw))
        return fn, kw

    monkeypatch.setattr(abb, "chunk_kernel", spy)
    for (jx, jf), (ux, uf) in zip(rolled, one_way):
        tx, tf, tst = tb.solve(frames, refs, tst)
        np.testing.assert_allclose(tx.numpy(), jx, atol=5e-3)
        np.testing.assert_allclose(tf.numpy(), jf, rtol=1e-3)
        np.testing.assert_allclose(tx.numpy(), ux, atol=1e-2)
        np.testing.assert_allclose(tf.numpy(), uf, rtol=1e-3)
    assert np.isfinite(tx.numpy()).all()
    assert kernels and all(
        fn is brk.banded_admm_chunk_rolled and kw == {"cr1": True} for fn, kw in kernels
    )


def test_quadrotor_cr_tick_matches_jax(monkeypatch):
    """``banded_solver: "cr"`` on the quadrotor h16 tick (B=2, step_num 2):
    the port's tick goes through the cyclic-reduction chunk and is held at
    5e-3 to JAX's tick on JAX's CR kernel (in interpret mode)."""
    B, H, ticks = 2, 16, 2

    def cfg(module):
        return module.make_config(
            horizon=H, dt=0.02, alpha=0.3, step_num=2, formulation="reduced",
            ADMM_settings={**QUAD_ADMM, "banded_solver": "cr"})

    frames, refs = quad_frames_refs(B, H)
    ref, jst = _jax_quad_ticks(cfg(jqr), frames, refs, ticks)
    tb = BatchedSolver(tqr.build(cfg(tqr), stagewise=True, device="cpu"), device="cpu")
    tst = batch_state_from_numpy(jst._asdict(), device="cpu")
    kernels = []
    real = abb.chunk_kernel

    def spy(*args, **kwargs):
        fn, kw = real(*args, **kwargs)
        kernels.append(fn)
        return fn, kw

    monkeypatch.setattr(abb, "chunk_kernel", spy)
    for jx, jf in ref:
        tx, tf, tst = tb.solve(frames, refs, tst)
        np.testing.assert_allclose(tx.numpy(), jx, atol=5e-3)
        np.testing.assert_allclose(tf.numpy(), jf, rtol=1e-3)
    assert np.isfinite(tx.numpy()).all()
    assert len(kernels) == 2 * ticks and all(fn is bck.banded_admm_chunk_cr for fn in kernels)
