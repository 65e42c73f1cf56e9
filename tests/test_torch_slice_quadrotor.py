"""The port's main path end to end against the JAX package on the quadrotor
(split out of ``test_torch_slice.py``, whose other cases stay there, so
that two test workers can carry them):

* batched quadrotor h16 MPC ticks (B=2, step_num=2, the quadrotor bench's
  settings) through ``BatchedSolver`` in both packages: there JAX runs its
  one-way kernel and the port its rolled two-way kernel with the depth-1
  CR level, so the test also holds the two elimination orders together;
* the same with ``banded_solver: "cr"`` against JAX's tick on its CR
  kernel.
"""

import numpy as np

from optimal_control_problem_tpu.models import quadrotor as jqr
from optimal_control_problem_tpu.parallel import BatchedSolver as JBatchedSolver
from optimal_control_problem_tpu_torch.interop import batch_state_from_numpy
from optimal_control_problem_tpu_torch.models import quadrotor as tqr
from optimal_control_problem_tpu_torch.ops import banded_cr_kernel as bck
from optimal_control_problem_tpu_torch.ops import banded_rolled_kernel as brk
from optimal_control_problem_tpu_torch.parallel import BatchedSolver
from optimal_control_problem_tpu_torch.solvers import admm_banded_batch as abb
from torch_threads import one_torch_thread  # noqa: F401


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
