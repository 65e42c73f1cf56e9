"""The port's unicycle model (``models/unicycle.py``) and its stage-wise
paths against the JAX package on the same numpy inputs:

* ``test_models.py``'s unicycle case (h12 with one half-space obstacle, the
  default augmented dense path): trajectories within 5e-3 of JAX's (the
  f32 floor of PARITY.md), the obstacle, the reference and the speed
  bound respected;
* ``test_stagewise.py``'s unicycle and ``test_local_system_agrees`` cases:
  the stage-wise NLP functions, bounds and dense ``(H, A)`` assembly agree
  with the generic registry's (atol 1e-4, as the JAX test) and with JAX's;
  the batch-last stage blocks and vectors with JAX's (rtol 1e-5, atol
  1e-6);
* batched banded h10 ticks (B=3, the ``unicycle_h50_banded`` bench
  settings: adaptive rho, check_every 5) with and without the merit line
  search against JAX's (its one-way chunk in interpret mode):
  trajectories within 5e-3, objectives to rtol 1e-3, equal flags, and
  under a forced budget equal per-scenario ``qp_iters``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu import stagewise as jsw
from optimal_control_problem_tpu.models import cartpole as jcp
from optimal_control_problem_tpu.models import unicycle as jun
from optimal_control_problem_tpu.parallel import BatchedSolver as JBatched
from optimal_control_problem_tpu_torch import stagewise as tsw
from optimal_control_problem_tpu_torch.interop import batch_state_from_numpy
from optimal_control_problem_tpu_torch.models import cartpole as tcp
from optimal_control_problem_tpu_torch.models import unicycle as tun
from optimal_control_problem_tpu_torch.ops import banded_kernel as bk
from optimal_control_problem_tpu_torch.parallel import BatchedSolver as TBatched
from optimal_control_problem_tpu_torch.solvers import admm_banded_batch as abb
from torch_threads import one_torch_thread  # noqa: F401

HS = (((0.0, 1.0), -0.4),)


def test_unicycle_tracks_line_and_avoids_halfspace():
    cfg_of = lambda m: m.make_config(horizon=12, dt=0.1, alpha=0.5, step_num=8)  # noqa: E731
    jo = jun.build(cfg_of(jun), halfspaces=HS)
    to = tun.build(cfg_of(tun), halfspaces=HS, device="cpu")
    assert to.solver_settings.formulation == "augmented" and to.solver._qp_n == 24 + 60
    frame = tun.initial_state()
    ref = tun.reference_line(12, 0.1, speed=1.0)
    for _ in range(3):
        jo.compute_optimal_trajectory(frame, ref)
        to.compute_optimal_trajectory(frame, ref)
    traj = to.get_optimal_frames()
    np.testing.assert_allclose(traj, jo.get_optimal_frames(), atol=5e-3)
    assert np.all(traj[:, 1] >= -0.4 - 2e-2)  # the feasible side: y >= -0.4
    assert traj[-1, 0] > 0.1  # moves forward along the reference
    assert np.all(np.abs(traj[:, 3]) <= 2.0 + 1e-2)  # speed bound


def generic_and_staged(mod, Hu, **kw):
    cfg = mod.make_config(horizon=Hu, dt=0.1, alpha=0.4, step_num=5, formulation="reduced",
                          ADMM_settings={"method": "condensed", "max_iter": 500})
    return mod.build(dict(cfg), halfspaces=HS, **kw), mod.build(dict(cfg), halfspaces=HS,
                                                                   stagewise=True, **kw)


def test_unicycle_stagewise_matches_generic():
    Hu = 8
    generic, staged = generic_and_staged(tun, Hu, device="cpu")
    jgeneric, jstaged = generic_and_staged(jun, Hu)
    rng = np.random.default_rng(4)
    X = (rng.normal(size=(Hu * tun.FRAME,)) * 0.3).astype(np.float32)
    P = tun.reference_line(Hu, 0.1).astype(np.float32)
    Xt, Pt = torch.as_tensor(X), torch.as_tensor(P)
    (fg, gg), (fs, gs) = generic.nlp_functions, staged.nlp_functions
    np.testing.assert_allclose(float(fg(Xt, Pt)), float(fs(Xt, Pt)), rtol=1e-5)
    np.testing.assert_allclose(gg(Xt, Pt).numpy(), gs(Xt, Pt).numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(generic.get_constraint_lower_bounds(),
                               staged.get_constraint_lower_bounds())
    np.testing.assert_allclose(staged.get_constraint_upper_bounds(),
                               jstaged.get_constraint_upper_bounds())
    # Generic: the dense torch.func assembly; staged: the stage-wise dense one.
    Hg, Ag = generic.solver._parts[1](Xt, Pt)
    Hs, As = staged.solver._parts[1](Xt, Pt)
    np.testing.assert_allclose(Hs.numpy(), Hg.numpy(), atol=1e-4)
    np.testing.assert_allclose(As.numpy(), Ag.numpy(), atol=1e-4)
    Hj, Aj = jax.jit(jstaged.solver._parts[1])(jnp.asarray(X), jnp.asarray(P))
    np.testing.assert_allclose(Hs.numpy(), np.asarray(Hj), atol=1e-4)
    np.testing.assert_allclose(As.numpy(), np.asarray(Aj), atol=1e-4)
    assert staged.solver.options.admm.method == "condensed"


def test_local_system_agrees():
    """test_stagewise.py's cart-pole pair (h8, reduced, condensed): the
    stage-wise dense assembly (raw and regularized), gradient and
    constraint values against the generic dense path's and JAX's."""
    H = 8
    cfg = tcp.make_config(horizon=H, dt=0.04, alpha=0.3, step_num=6, formulation="reduced",
                          ADMM_settings={"method": "condensed", "max_iter": 1000})
    generic = tcp.build(dict(cfg), device="cpu")
    staged = tcp.build(dict(cfg), stagewise=True, device="cpu")
    jstaged = jcp.build(jcp.make_config(horizon=H, dt=0.04, alpha=0.3, step_num=6,
                                        formulation="reduced",
                                        ADMM_settings={"method": "condensed",
                                                       "max_iter": 1000}), stagewise=True)
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(H * tcp.FRAME,)) * 0.3).astype(np.float32)
    p = np.float32([np.pi])
    xt, pt = torch.as_tensor(x), torch.as_tensor(p)
    for i in (1, 2):  # matrices_raw, vectors
        ours = staged.solver._parts[i](xt, pt)
        gen = generic.solver._parts[i](xt, pt)
        ref = jax.jit(jstaged.solver._parts[i])(jnp.asarray(x), jnp.asarray(p))
        for a, b, c in zip(ours, gen, ref):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)
            np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-5)
    Hr, _ = staged.solver._parts[0](xt, pt)
    Hj, _ = jax.jit(jstaged.solver._parts[0])(jnp.asarray(x), jnp.asarray(p))
    np.testing.assert_allclose(Hr.numpy(), np.asarray(Hj), atol=1e-5)
    # The same assembly mapped over a batch gives each scenario's.
    X = torch.as_tensor(rng.normal(size=(3, H * tcp.FRAME)).astype(np.float32))
    Hb, Ab = torch.func.vmap(staged.solver._parts[0])(X, pt.expand(3, 1))
    H1, A1 = staged.solver._parts[0](X[1], pt)
    assert torch.equal(Hb[1], H1) and torch.equal(Ab[1], A1)


@pytest.mark.parametrize("halfspaces", [HS, ()], ids=["halfspace", "none"])
def test_unicycle_batch_last_blocks_match_jax(halfspaces):
    rng = np.random.default_rng(5)
    B, H = 7, 5
    xT = rng.normal(size=(H * tun.FRAME, B)).astype(np.float32)
    pT = rng.normal(size=(2 * H, B)).astype(np.float32)
    ss_t = tun.stage_structure(H, 0.1, halfspaces=halfspaces)
    ss_j = jun.stage_structure(H, 0.1, halfspaces=halfspaces)
    assert ss_t.n_g == ss_j.n_g == 4 * 3 + H * len(halfspaces)
    for reg in ("auto", 0.0):
        ours = tsw.build_stage_blocks_batch(ss_t, torch.float32, reg)(
            torch.as_tensor(xT), torch.as_tensor(pT))
        ref = jsw.build_stage_blocks_batch(ss_j, jnp.float32, reg)(jnp.asarray(xT),
                                                                    jnp.asarray(pT))
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    ours = tsw.build_stage_vectors_batch(ss_t, torch.float32)(torch.as_tensor(xT),
                                                              torch.as_tensor(pT))
    ref = jsw.build_stage_vectors_batch(ss_j, jnp.float32)(jnp.asarray(xT), jnp.asarray(pT))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


# The unicycle_h50_banded bench settings (bench_models.py:310-333) at h10.
BANDED = {"method": "banded", "max_iter": 500, "check_every": 5}


def banded_config(mod, line_search, **admm):
    cfg = mod.make_config(horizon=10, dt=0.05, alpha=0.3, step_num=3, formulation="reduced",
                          ADMM_settings={**BANDED, **admm})
    if line_search:
        cfg["solver_settings"]["SQP_settings"]["line_search"] = "merit"
    return cfg


@pytest.mark.parametrize("forced", [False, True], ids=["bench", "forced"])
@pytest.mark.parametrize("line_search", [False, True], ids=["fixed", "merit"])
def test_unicycle_banded_tick_matches_jax(line_search, forced, monkeypatch):
    """Batched unicycle h10 ticks (N=10, w=5, r=3, r2=1: a live half-space
    row, lb -0.5, ub +inf), B=3, two ticks from the same state, theta
    uniform +-0.5, through the one-way chunk (JAX's in interpret mode):
    trajectories within 5e-3, objectives to rtol 1e-3, equal flags; under a
    forced budget (a tolerance no residual meets, 60 iterations, no rho
    adaptation) equal per-scenario qp_iters."""
    kw = dict(eps_abs=-1.0, eps_rel=0.0, max_iter=60, adaptive_rho=False,
              check_infeasibility=False) if forced else {}
    B = 3
    rng = np.random.default_rng(0)
    frames = np.zeros((B, tun.FRAME), np.float32)
    frames[:, 2] = rng.uniform(-0.5, 0.5, B).astype(np.float32)
    refs = np.tile(tun.reference_line(10, 0.05)[None, :], (B, 1)).astype(np.float32)
    jb = JBatched(jun.build(banded_config(jun, line_search, **kw), stagewise=True))
    tocp = tun.build(banded_config(tun, line_search, **kw), stagewise=True, device="cpu")
    tb = TBatched(tocp, device="cpu")
    assert tb._solve_batch is tocp.solver.solve_batch_banded_fn
    kernels = []
    real = abb.chunk_kernel

    def spy(*args, **kwargs):
        fn, kw_ = real(*args, **kwargs)
        kernels.append(fn)
        return fn, kw_

    monkeypatch.setattr(abb, "chunk_kernel", spy)
    jst = jb.init_state(B)
    tst = batch_state_from_numpy(jst._asdict(), device="cpu")
    for _ in range(2):
        jx, jf, jst = jb.solve(frames, refs, jst)
        tx, tf, tst = tb.solve(frames, refs, tst)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=5e-3)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-3)
        tres, jres = tb.last_result, jb.last_result
        for name in ("qp_converged", "qp_prim_inf", "qp_dual_inf"):
            np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                          np.asarray(getattr(jres, name)), err_msg=name)
        if forced:
            np.testing.assert_array_equal(tres.qp_iters.numpy(), np.asarray(jres.qp_iters))
            assert (tres.qp_iters == 60).all()
    assert kernels and all(fn is bk.banded_admm_chunk for fn in kernels)
    traj = tx.numpy().reshape(B, 10, tun.FRAME)
    assert np.isfinite(traj).all() and (traj[..., 1] >= -0.5 - 2e-2).all()
    steps, jsteps = tres.step_norms.numpy(), np.asarray(jres.step_norms)
    if line_search:
        # Each step takes one of the candidates a = 2^-k along (nearly) the
        # same direction as JAX's; where two candidates' merits lie within
        # f32 roundoff of each other (late steps, merits ~1e-8 apart) the
        # packages may take neighbours: the ratio is a power of two.
        assert (steps > 0).all()
        k = np.log2(steps / jsteps)
        np.testing.assert_allclose(k, np.round(k), atol=1e-2)
    else:
        np.testing.assert_allclose(steps, jsteps, rtol=1e-3, atol=1e-5)


def test_unicycle_per_scenario_merit_matches_batched():
    """compute_optimal_trajectory with the merit search (the per-scenario
    banded solver) gives the batched tick's scenario 0."""
    frame = tun.initial_state(th=0.3)
    ref = tun.reference_line(10, 0.05)
    ocp = tun.build(banded_config(tun, True), stagewise=True, device="cpu")
    ocp.compute_optimal_trajectory(frame, ref)
    b = TBatched(tun.build(banded_config(tun, True), stagewise=True, device="cpu"),
                 device="cpu")
    tx, _, _ = b.solve(frame[None, :].astype(np.float32), ref[None, :].astype(np.float32),
                       b.init_state(1))
    np.testing.assert_allclose(ocp.get_optimal_trajectory().numpy(), tx[0].numpy(), atol=5e-3)
