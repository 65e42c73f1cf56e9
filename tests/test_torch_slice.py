"""The port's main path end to end against the JAX package, plus the port's
package rules.

* Batched cart-pole h8 MPC ticks (B=4, step_num=3, the bench's banded
  settings) through ``BatchedSolver`` in both packages: trajectories agree
  to 5e-3 (the f32 closed-loop floor recorded in PARITY.md), objectives to
  rtol 1e-3.  The same for the quadrotor at h16 (B=2, step_num=2, the
  quadrotor bench's settings): there JAX runs its one-way kernel and the
  port its rolled two-way kernel with the depth-1 CR level, so the test
  also holds the two elimination orders together; and with
  ``banded_solver: "cr"`` against JAX's tick on its CR kernel.
* Batched double-integrator h20 ticks (the LTI, shared-factorization path)
  through ``BatchedSolver`` in both packages and on both backends
  (``"xla"``: the matmul loop; ``"pallas"``: JAX's fused kernel in interpret
  mode against the port's plain chunk): under a forced iteration budget,
  equal ``qp_iters`` and trajectories within 5e-3; at the bench's settings
  (eps 1e-3) every QP converges in both and positions and velocities agree
  to 5e-3, while the weakly weighted accelerations (range +-50, weight
  1e-3) are held to 0.1: the termination test sits on a knife edge there
  (JAX's own two backends stop at different counts and end 3.3e-2 apart on
  an acceleration; ROADMAP Queue C).
* Batched cart-pole h6 ticks without a stage structure (the per-scenario
  dense batch path, JAX: ``jax.vmap`` of ``solve_fn``; B=3, step_num 3,
  the ``cartpole_h20_pallas`` bench settings) in both packages and on both
  backends (``"pallas"``: JAX's device-loop kernel in interpret mode
  against the port's plain device loop): trajectories within 5e-3, equal
  flags, equal per-scenario ``qp_iters`` under a forced budget and at the
  warm tick; ``compute_optimal_trajectory`` on ``"pallas"`` gives the
  batched tick's scenario 0.
* The entry points run on the GPU unless told ``device="cpu"``, and raise
  when there is none.
* No module of the port, and no line of ``chip_smoke.py``, imports JAX or
  the JAX package (AST scan).
* Every name in every ``__all__`` of the JAX package resolves in the
  port's module of the same name (AST scan of the JAX package, import of
  the port's), but the TPU kernels' VMEM tile models, which the port does
  not carry over (ROADMAP North star).
"""

import ast
import dataclasses
import importlib
import pathlib

import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.models import cartpole as jcp
from optimal_control_problem_tpu.models import double_integrator as jdi
from optimal_control_problem_tpu.models import quadrotor as jqr
from optimal_control_problem_tpu.parallel import BatchedSolver as JBatchedSolver
from optimal_control_problem_tpu.solvers.admm import ADMMSettings as JSettings
from optimal_control_problem_tpu.solvers.sqp import SQPOptions as JOptions
from optimal_control_problem_tpu_torch import OptimalControlProblem
from optimal_control_problem_tpu_torch.interop import (
    batch_state_from_numpy,
    settings_from_jax_dict,
)
from optimal_control_problem_tpu_torch.models import cartpole as tcp
from optimal_control_problem_tpu_torch.models import double_integrator as tdi
from optimal_control_problem_tpu_torch.models import quadrotor as tqr
from optimal_control_problem_tpu_torch.ops import banded_cr_kernel as bck
from optimal_control_problem_tpu_torch.ops import banded_kernel as bk
from optimal_control_problem_tpu_torch.ops import banded_rolled_kernel as brk
from optimal_control_problem_tpu_torch.parallel import BatchedSolver
from optimal_control_problem_tpu_torch.solvers import admm_banded_batch as abb
from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings
from optimal_control_problem_tpu_torch.solvers.sqp import SQPOptions
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
ADMM = {
    "method": "banded", "max_iter": 500, "adaptive_rho": False, "rho": 0.05,
    "check_every": 2, "scaling_refresh": "tick",
}


def config(module, H=8, step_num=3):
    return module.make_config(horizon=H, dt=0.04, alpha=0.3, step_num=step_num,
                              formulation="reduced", ADMM_settings=dict(ADMM))


def frames_refs(B, seed=0):
    rng = np.random.default_rng(seed)
    frames = np.zeros((B, tcp.FRAME), np.float32)
    frames[:, 2] = rng.uniform(-0.5, 0.5, B).astype(np.float32)
    return frames, np.full((B, 1), np.pi, np.float32)


def test_batched_tick_matches_jax():
    B = 4
    frames, refs = frames_refs(B)
    jb = JBatchedSolver(jcp.build(config(jcp), stagewise=True))
    tb = BatchedSolver(tcp.build(config(tcp), stagewise=True, device="cpu"), device="cpu")
    jst = jb.init_state(B)
    tst = batch_state_from_numpy(jst._asdict(), device="cpu")
    for _ in range(2):
        jx, jf, jst = jb.solve(frames, refs, jst)
        tx, tf, tst = tb.solve(frames, refs, tst)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=5e-3)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-3)
    assert np.isfinite(tx.numpy()).all()
    hist = tb.last_result
    assert hist.f_history.shape == (3, B) and hist.qp_iters.shape == (3, B)
    np.testing.assert_array_equal(
        hist.qp_converged.numpy(), np.asarray(jb.last_result.qp_converged)
    )


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


def test_quadrotor_without_stage_structure_raises():
    """Without a stage structure the quadrotor no longer raises: it builds
    on the augmented default (QP n = n_p + n_x = 12 + 64) and ticks on the
    dense path, as JAX's does (trajectory within 5e-3)."""
    cfg_of = lambda m: m.make_config(horizon=4, step_num=1)  # noqa: E731
    ocp = tqr.build(cfg_of(tqr), stagewise=False, device="cpu")
    assert ocp.solver._qp_n == 12 + 64 and ocp.solver.solve_batch_banded_fn is None
    jo = jqr.build(cfg_of(jqr), stagewise=False)
    frame, ref = tqr.initial_state(), tqr.reference_hover(4)
    ocp.compute_optimal_trajectory(frame, ref)
    jo.compute_optimal_trajectory(frame, ref)
    np.testing.assert_allclose(ocp.get_optimal_trajectory().numpy(),
                               np.asarray(jo.get_optimal_trajectory()), atol=5e-3)


def test_per_scenario_tick_matches_batched():
    """compute_optimal_trajectory (per-scenario banded solver) gives the
    batched tick's trajectory for the same frame."""
    frames, refs = frames_refs(2, seed=3)
    ocp = tcp.build(config(tcp, H=6, step_num=2), stagewise=True, device="cpu")
    ocp.compute_optimal_trajectory(frames[0], refs[0])
    one = ocp.get_optimal_trajectory().numpy()
    assert ocp.get_optimal_frames().shape == (6, tcp.FRAME)
    b = BatchedSolver(tcp.build(config(tcp, H=6, step_num=2), stagewise=True, device="cpu"),
                      device="cpu")
    tx, _, _ = b.solve(frames, refs, b.init_state(2))
    np.testing.assert_allclose(one, tx[0].numpy(), atol=5e-3)


def test_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config(tcp, H=4, step_num=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcp.build(cfg, stagewise=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OptimalControlProblem(cfg)
    ocp = tcp.build(config(tcp, H=4, step_num=1), stagewise=True, device="cpu")
    assert ocp.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedSolver(ocp)
    BatchedSolver(ocp, device="cpu")
    from optimal_control_problem_tpu_torch.solvers.admm_banded import BandedQP

    N, w = 3, 2
    qp = BandedQP(
        torch.eye(w).expand(1, N, w, w).clone(), torch.zeros(1, N - 1, 1, w),
        torch.zeros(1, N - 1, 1, w), torch.zeros(1, N, 0, w), torch.zeros(1, N * w),
        -torch.ones(1, N * w + N - 1), torch.ones(1, N * w + N - 1),
    )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        abb.admm_solve_banded_batch(qp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        abb.admm_solve_banded_batch_T(BandedQP(*(abb._t(a) for a in qp)))
    sol = abb.admm_solve_banded_batch(qp, ADMMSettings(method="banded"), device="cpu")
    assert bool(sol.converged.all())


def test_unported_paths_raise_not_implemented():
    """Nothing of the problem front end raises any more: MIXED (the host
    backend on the first tick, the banded device engine after it, ROADMAP
    A9) builds and ticks finite, and so do the augmented default, the
    parity preset, a dense method on a stage structure and the merit
    search."""
    # The banded method needs a stage structure (a ValueError, as in JAX).
    with pytest.raises(ValueError, match="stage structure"):
        tcp.build(config(tcp, H=4, step_num=1), stagewise=False, device="cpu")
    frame, ref = tcp.initial_state(th=0.2), np.array([np.pi])

    def ticks(ocp):
        ocp.compute_optimal_trajectory(frame, ref)
        assert np.isfinite(ocp.get_optimal_trajectory().numpy()).all()
        return ocp

    mixed = tcp.make_config(horizon=4, solve_method="MIXED", formulation="reduced")
    ocp = ticks(tcp.build(mixed, stagewise=True, device="cpu"))
    assert ocp.get_solver_stats() == {}  # tick 1: the host backend
    assert ticks(ocp).get_solver_stats() != {}  # tick 2: the banded engine
    assert ocp.solver.solve_batch_banded_fn is not None

    # The augmented formulation (the default without a stage structure).
    aug = ticks(tcp.build(tcp.make_config(horizon=4, step_num=1), stagewise=False,
                          device="cpu"))
    assert aug.solver.options.formulation == "augmented" and aug.solver._qp_n == 1 + 20
    # The parity preset: augmented, raw Hessian, cold QPs (on the stage
    # structure's NLP functions too, with the dense path solving).
    for stagewise in (False, True):
        parity = tcp.make_config(horizon=4, step_num=1, alpha=0.1)
        parity["solver_settings"]["SQP_settings"]["parity"] = True
        ocp = tcp.build(parity, stagewise=stagewise, device="cpu")
        opt = ocp.solver.options
        assert (opt.formulation, opt.hessian_reg, opt.qp_warm_start) == ("augmented", 0.0, False)
        assert ocp.solver.solve_batch_banded_fn is None
        ocp.compute_optimal_trajectory(tcp.initial_state(th=3.0), ref)
    # A dense method on a stage-structured problem, and the merit search.
    dense = tcp.make_config(horizon=4, step_num=1, formulation="reduced",
                            ADMM_settings={"method": "condensed"})
    assert ticks(tcp.build(dense, stagewise=True, device="cpu")).solver._parts[0] is not None
    merit = tdi.make_config(horizon=4, step_num=1, formulation="reduced")
    merit["solver_settings"]["SQP_settings"]["line_search"] = "merit"
    ocp = tdi.build(merit, device="cpu")
    assert ocp.solver.shared_system is False
    ocp.compute_optimal_trajectory(tdi.initial_state(pos=(0.1, 0.2)), np.zeros(8))
    assert np.isfinite(ocp.get_optimal_trajectory().numpy()).all()


def test_shared_system_detection_and_batch_routing():
    """(H, A) of the double integrator do not depend on the point: the
    solver builds the shared-factorization batch function and
    ``BatchedSolver`` takes it.  Cart-pole's dense NLP functions do depend
    on it: ``BatchedSolver`` takes the per-scenario dense batch function."""
    di = tdi.build(di_config(tdi, "xla", H=5, step_num=1), device="cpu")
    assert di.solver.shared_system is True
    assert di.solver.solve_batch_fn is not None and di.solver.solve_batch_banded_fn is None
    assert di.solver.solve_batch_dense_fn is None
    assert BatchedSolver(di, device="cpu")._solve_batch is di.solver.solve_batch_fn
    assert jdi.build(di_config(jdi, "xla", H=5, step_num=1)).solver.shared_system is True
    cp = tcp.build(tcp.make_config(horizon=4, step_num=1, formulation="reduced"),
                   stagewise=False, device="cpu")
    assert cp.solver.shared_system is False and cp.solver.solve_batch_fn is None
    assert cp.solver.solve_batch_banded_fn is None
    assert BatchedSolver(cp, device="cpu")._solve_batch is cp.solver.solve_batch_dense_fn
    banded = tcp.build(config(tcp, H=4, step_num=1), stagewise=True, device="cpu")
    assert banded.solver.shared_system is False and banded.solver.solve_batch_dense_fn is None
    assert BatchedSolver(banded, device="cpu")._solve_batch is banded.solver.solve_batch_banded_fn


# The JAX bench's cartpole_h20_pallas settings (bench_models.py:257-283);
# the backend is added per case.
DENSE_ADMM = {"method": "condensed", "max_iter": 500, "adaptive_rho": False, "rho": 0.05}


def dense_config(module, backend, H=6, step_num=3, **admm):
    return module.make_config(horizon=H, dt=0.02, alpha=0.3, step_num=step_num,
                              formulation="reduced",
                              ADMM_settings={**DENSE_ADMM, "backend": backend, **admm})


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


# The JAX bench's double-integrator settings (bench.py:109-124).
DI_ADMM = {"method": "condensed", "eps_abs": 1e-3, "eps_rel": 1e-3, "max_iter": 1000,
           "adaptive_rho": True}


def di_config(module, backend, H=20, step_num=10, **admm):
    return module.make_config(
        horizon=H, dt=0.005, solve_method="TPU_SQP", alpha=0.1, step_num=step_num,
        formulation="reduced", ADMM_settings={**DI_ADMM, "backend": backend, **admm})


def di_frames_refs(B, H=20, seed=0):
    rng = np.random.default_rng(seed)
    frames = np.zeros((B, tdi.FRAME), np.float32)
    frames[:, 0:2] = rng.uniform(-1, 1, size=(B, 2)).astype(np.float32)
    refs = np.tile(tdi.reference_circle(H, 0.005)[None, :], (B, 1)).astype(np.float32)
    return frames, refs


def di_ticks(cfg_kw, B, ticks):
    """Both packages' ticks from the same zero state; yields per tick
    ``(port x, JAX x, port f, JAX f, port result, JAX result)``."""
    frames, refs = di_frames_refs(B)
    jb = JBatchedSolver(jdi.build(di_config(jdi, **cfg_kw)))
    tb = BatchedSolver(tdi.build(di_config(tdi, **cfg_kw), device="cpu"), device="cpu")
    jst = jb.init_state(B)
    tst = batch_state_from_numpy(jst._asdict(), device="cpu")
    assert tst.qp_x.shape == (B, 120) and tst.qp_y.shape == (B, 196)
    for _ in range(ticks):
        jx, jf, jst = jb.solve(frames, refs, jst)
        tx, tf, tst = tb.solve(frames, refs, tst)
        yield (tx.numpy(), np.asarray(jx), tf.numpy(), np.asarray(jf),
               tb.last_result, jb.last_result)


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


def test_double_integrator_compute_optimal_trajectory_matches_jax():
    """One frame through the per-problem path (dense assembly with
    torch.func, then admm_solve), against JAX's, and against the batched
    shared-factorization tick of the same frame."""
    H = 8
    frames, refs = di_frames_refs(2, H=H, seed=4)
    cfg_kw = dict(backend="xla", H=H, step_num=3)
    jo = jdi.build(di_config(jdi, **cfg_kw))
    to = tdi.build(di_config(tdi, **cfg_kw), device="cpu")
    with pytest.raises(ValueError, match="State dimension mismatch"):
        to.compute_optimal_trajectory(frames[0][:4], refs[0])
    for _ in range(2):
        jo.compute_optimal_trajectory(frames[0], refs[0])
        to.compute_optimal_trajectory(frames[0], refs[0])
        d = np.abs(to.get_optimal_trajectory().numpy() - np.asarray(jo.get_optimal_trajectory()))
        d = d.reshape(H, tdi.FRAME)
        assert d[:, 0:4].max() <= 5e-3 and d[:, 4:6].max() <= 0.1
    assert to.get_optimal_frames().shape == (H, tdi.FRAME)
    res = to.solver.last_result
    assert res.qp_iters.shape == (3,) and bool(res.qp_converged.all())
    b = BatchedSolver(tdi.build(di_config(tdi, **cfg_kw), device="cpu"), device="cpu")
    st = b.init_state(2)
    for _ in range(2):
        bx, _, st = b.solve(frames, refs, st)
    # Two QP stacks (per-problem Ruiz and Gershgorin shift; shared scaling
    # and eigenvalue shift), each at eps 1e-3: accelerations to 1% of range.
    d = np.abs(bx[0].numpy() - to.get_optimal_trajectory().numpy()).reshape(H, tdi.FRAME)
    assert d[:, 0:4].max() <= 5e-3 and d[:, 4:6].max() <= 0.5


def test_double_integrator_needs_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdi.build(di_config(tdi, "pallas", H=4, step_num=1))
    ocp = tdi.build(di_config(tdi, "pallas", H=4, step_num=1), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedSolver(ocp)


def test_settings_from_jax_dicts():
    st = JSettings(rho=0.05, check_every=2, method="banded", scaling_refresh="tick")
    ours = settings_from_jax_dict(dataclasses.asdict(st))
    assert dataclasses.asdict(ours) == dataclasses.asdict(st)
    opts = settings_from_jax_dict(dataclasses.asdict(JOptions(max_iter=3, alpha=0.3, admm=st)))
    assert isinstance(opts, SQPOptions) and opts.dtype == torch.float32
    assert opts.admm == ours and opts.max_iter == 3 and opts.alpha == 0.3


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "optimal_control_problem_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    twins = sorted((ROOT / "examples" / "torch").glob("*.py"))
    assert [p.name for p in twins] == sorted(p.name for p in (ROOT / "examples").glob("*.py"))
    files += twins
    assert len(files) > 10
    pkg = ROOT / "optimal_control_problem_tpu_torch"
    for name in ("sym.py", "controller.py", "models/unicycle.py"):
        assert pkg / name in files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "optimal_control_problem_tpu"), (
                f"{path.relative_to(ROOT)} imports {name}"
            )


# The VMEM tile models of the TPU kernels: the port's layout on the card is
# its own (ROADMAP North star, "These TPU-specific parts do not carry over").
TPU_ONLY = {
    ("optimal_control_problem_tpu.solvers.admm_banded_batch", "pick_batch_tile"),
    ("optimal_control_problem_tpu.ops.banded_rolled_kernel", "pick_rolled_tile"),
    ("optimal_control_problem_tpu.ops.banded_cr_kernel", "pick_cr_tile"),
}


def _all_lists():
    """(module, names) for every ``__all__`` of the JAX package."""
    pkg = ROOT / "optimal_control_problem_tpu"
    for path in sorted(pkg.rglob("*.py")):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets
            ):
                mod = ".".join(path.relative_to(ROOT).with_suffix("").parts)
                yield mod.removesuffix(".__init__"), ast.literal_eval(node.value)


def test_jax_all_names_resolve_in_the_port():
    lists = dict(_all_lists())
    assert "optimal_control_problem_tpu.parallel" in lists and len(lists) > 30
    missing = []
    for mod, names in lists.items():
        port = importlib.import_module(mod.replace("optimal_control_problem_tpu",
                                                   "optimal_control_problem_tpu_torch", 1))
        missing += [(mod, n) for n in names if (mod, n) not in TPU_ONLY and not hasattr(port, n)]
    assert not missing
    from optimal_control_problem_tpu_torch import MPCController, admm_solve, sym  # noqa: F401
    from optimal_control_problem_tpu_torch.solvers import ruiz_equilibrate  # noqa: F401
    from optimal_control_problem_tpu_torch.solvers.sqp import build_local_system_fn  # noqa: F401
