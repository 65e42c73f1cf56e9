"""The port's main path end to end against the JAX package, plus the port's
package rules.

* Batched cart-pole h8 MPC ticks (B=4, step_num=3, the bench's banded
  settings) through ``BatchedSolver`` in both packages: trajectories agree
  to 5e-3 (the f32 closed-loop floor recorded in PARITY.md), objectives to
  rtol 1e-3.  The same for the quadrotor: ``test_torch_slice_ticks.py``.
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

Split over this file and ``test_torch_slice_ticks.py`` (the dense cart-pole,
the double integrator's and the quadrotor's ticks against JAX's), so that
two test workers carry them; their helpers are in ``torch_slice_cases.py``.
"""

import dataclasses
import importlib

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
from optimal_control_problem_tpu_torch.parallel import BatchedSolver
from optimal_control_problem_tpu_torch.solvers import admm_banded_batch as abb
from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings
from optimal_control_problem_tpu_torch.solvers.sqp import SQPOptions
from torch_slice_cases import (
    ROOT,
    TPU_ONLY,
    _all_lists,
    _imports,
    config,
    di_config,
    di_frames_refs,
    frames_refs,
)
from torch_threads import one_torch_thread  # noqa: F401


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
