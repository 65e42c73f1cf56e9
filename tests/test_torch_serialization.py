"""The port's checkpoint/resume and solver export (``utils/serialization.py``)
against the JAX package's — mirrors ``tests/test_serialization.py``.

* The warm-start checkpoint is the same ``.npz`` (same keys) in both
  packages, and a resumed solver continues exactly where the first would
  (1e-6, JAX's bound; here it is bitwise).
* ``export_solver`` traces the solver's ``export_form`` (its loop
  conditions on the device) with ``torch.export``; the reloaded program
  equals the direct ``solve_fn`` call to JAX's 1e-6, and both equal JAX's
  exported artifact's answer at the SQP's converged tolerance (2e-3).  A
  solve that reaches a hand kernel (``backend="pallas"``: the dense device
  loop) exports too, the kernel one custom-op node, and so does a direct
  call of the kernel's wrapper; the reloaded programs equal the direct
  calls.
* A stage-structured cart-pole's ``solve_fn`` exports too, on both of its
  paths: the per-scenario banded solve (``method="banded"``, no hand
  kernel) and the dense solve on stage-wise parts (``"condensed"``).  The
  reloaded program gives the direct call's QP iterations and trajectory
  (1e-5; the program holds the operations of the direct call's own
  ``torch.func`` derivatives), and JAX's exported artifact's at 2e-3.  h4,
  one SQP step: the trace is most of the test's time.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu import SQPOptimizationSolver as JSolver
from optimal_control_problem_tpu.models import cartpole as jcp
from optimal_control_problem_tpu import SQPOptions as JOptions
from optimal_control_problem_tpu import sym as JS
from optimal_control_problem_tpu.solvers.admm import ADMMSettings as JSettings
from optimal_control_problem_tpu.utils import serialization as jser
from optimal_control_problem_tpu_torch import SQPOptimizationSolver, SQPOptions
from optimal_control_problem_tpu_torch import sym as S
from optimal_control_problem_tpu_torch.models import cartpole as tcp
from optimal_control_problem_tpu_torch.ops import build
from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings
from optimal_control_problem_tpu_torch.utils.serialization import (
    enable_compilation_cache,
    export_solver,
    import_solver,
    load_solver_state,
    save_solver_state,
)
from torch_threads import one_torch_thread  # noqa: F401

ARG = {
    "lbx": np.array([-50.0, -100.0]),
    "ubx": np.array([50.0, 100.0]),
    "lbg": np.array([0.0]),
    "ubg": np.array([0.0]),
}


def make_solver(sqp_iters=5, **admm):
    x = S.sym("x", 2)
    nlp = {"x": x, "f": x[0] ** 2 + x[1] ** 2, "g": x[0] + x[1] - 1.0}
    return SQPOptimizationSolver(
        nlp, SQPOptions(max_iter=sqp_iters, alpha=0.5,
                        admm=ADMMSettings(eps_abs=1e-4, eps_rel=1e-4, **admm)),
        device="cpu")


def make_jax_solver(sqp_iters=5):
    x = JS.sym("x", 2)
    nlp = {"x": x, "f": x[0] ** 2 + x[1] ** 2, "g": x[0] + x[1] - 1.0}
    return JSolver(nlp, JOptions(max_iter=sqp_iters, alpha=0.5,
                                 admm=JSettings(eps_abs=1e-4, eps_rel=1e-4)))


def test_warm_start_checkpoint_roundtrip(tmp_path):
    s1 = make_solver()
    s1.get_optimal_solution(ARG)
    ckpt = tmp_path / "state.npz"
    save_solver_state(s1, str(ckpt))
    j1 = make_jax_solver()
    j1.get_optimal_solution(ARG)
    jckpt = tmp_path / "jstate.npz"
    jser.save_solver_state(j1, str(jckpt))
    with np.load(ckpt) as a, np.load(jckpt) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape
            np.testing.assert_allclose(a[k], b[k], atol=2e-3)
    s2 = make_solver()
    load_solver_state(s2, str(ckpt))
    r1 = s1.get_optimal_solution(ARG)
    r2 = s2.get_optimal_solution(ARG)
    np.testing.assert_allclose(r1["x"].numpy(), r2["x"].numpy(), atol=1e-6)


def test_export_import_solver_artifact(tmp_path):
    # Two SQP steps: the export unrolls the step loop, one traced ADMM
    # while_loop a step, and the trace's time grows with the steps.
    s = make_solver(sqp_iters=2)
    path = tmp_path / "solver.pt2"
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    args = (torch.zeros(2), torch.zeros(0), f32(ARG["lbx"]), f32(ARG["ubx"]),
            f32(ARG["lbg"]), f32(ARG["ubg"]), torch.zeros(2), torch.zeros(3))
    export_solver(s.solve_fn, args, str(path))
    assert path.stat().st_size > 0
    loaded = import_solver(str(path))
    res_direct = s.solve_fn(*args)
    res_loaded = loaded(*args)
    np.testing.assert_allclose(res_direct.x.numpy(), res_loaded[0].numpy(), atol=1e-6)
    assert torch.equal(res_direct.qp_iters, res_loaded[5])
    # Other inputs through the same program (no re-trace).
    args2 = (f32([0.3, -0.2]),) + args[1:]
    np.testing.assert_allclose(s.solve_fn(*args2).x.numpy(), loaded(*args2)[0].numpy(),
                               atol=1e-6)
    # JAX's exported artifact on the same inputs.
    js = make_jax_solver(sqp_iters=2)
    jargs = tuple(jnp.asarray(a.numpy()) for a in args)
    jpath = tmp_path / "solver.bin"
    jser.export_solver(js.solve_fn, jargs, str(jpath))
    jres = jser.import_solver(str(jpath))(*jargs)
    np.testing.assert_allclose(res_loaded[0].numpy(), np.asarray(jres[0]), atol=2e-3)


def holds_op(program, name):
    """Whether a graph of ``program`` (the top one or a loop body) calls
    the op ``ocp_torch::<name>``."""
    return any(f"ocp_torch.{name}" in gm.code for gm in program.graph_module.modules()
               if isinstance(gm, torch.fx.GraphModule))


def test_export_reaches_hand_kernels(tmp_path):
    """``backend="pallas"`` reaches the dense device loop: the solve exports
    with the kernel as its op node and the reloaded program equals the
    direct call; so does a function that calls the kernel wrapper directly
    (on the CPU the op runs the plain version)."""
    s = make_solver(sqp_iters=1, method="condensed", backend="pallas")
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    args = (f32([0.3, -0.2]), torch.zeros(0), f32(ARG["lbx"]), f32(ARG["ubx"]),
            f32(ARG["lbg"]), f32(ARG["ubg"]), torch.zeros(2), torch.zeros(3))
    path = tmp_path / "pallas.pt2"
    export_solver(s.solve_fn, args, str(path))
    loaded = import_solver(str(path))(*args)
    direct = s.solve_fn(*args)
    assert torch.equal(direct.qp_iters, loaded[5])
    np.testing.assert_allclose(direct.x.numpy(), loaded[0].numpy(), atol=1e-6)
    assert holds_op(torch.export.load(str(path)), "admm_device_loop")  # in the loop body
    from optimal_control_problem_tpu_torch.ops.admm_kernel import admm_device_loop

    def direct_call(OP):
        v = OP[:, 0]  # one QP, n = m = 2: P = A = OP, q = v, bounds +-(v + 1)
        return admm_device_loop(OP, OP, OP, v, -v - 1, v + 1, v + 1, v + 1, v + 1, v[:, 0] + 1,
                                1e-6, 1.6, 1e-3, 1e-3, 0 * v, 0 * v, max_iter=25,
                                check_every=25)

    OP = torch.eye(2)[None]
    export_solver(direct_call, (OP,), str(tmp_path / "y.pt2"))
    assert holds_op(torch.export.load(str(tmp_path / "y.pt2")), "admm_device_loop")
    for a, b in zip(import_solver(str(tmp_path / "y.pt2"))(OP), direct_call(OP)):
        assert torch.equal(a, b)


def test_enable_compilation_cache_moves_the_build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    enable_compilation_cache(str(tmp_path / "kernels"))
    assert build.BUILD_DIR == (tmp_path / "kernels").resolve() and build.BUILD_DIR.is_dir()


def _cartpole_args(ocp):
    s = ocp.solver
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    frame = tcp.initial_state(th=0.3)
    lbx = ocp.ocp_config.lower_bounds_flat().copy()
    ubx = ocp.ocp_config.upper_bounds_flat().copy()
    lbx[: tcp.FRAME] = frame
    ubx[: tcp.FRAME] = frame
    return (torch.zeros(s.n_x), f32(np.full(ocp.reference_size, np.pi)), f32(lbx), f32(ubx),
            f32(ocp.get_constraint_lower_bounds()), f32(ocp.get_constraint_upper_bounds()),
            torch.zeros(s._qp_n), torch.zeros(s._qp_m))


@pytest.mark.parametrize("method", ["banded", "condensed"])
def test_export_import_stage_structured_solver(tmp_path, method):
    cfg = lambda m: m.make_config(  # noqa: E731
        horizon=4, dt=0.05, alpha=0.3, step_num=1,
        ADMM_settings={"method": method, "max_iter": 200, "adaptive_rho": False,
                       "rho": 0.05, "check_every": 10},
    )
    ocp = tcp.build(cfg(tcp), stagewise=True, device="cpu")
    assert ocp.solver.solve_fn.export_form is not None
    args = _cartpole_args(ocp)
    path = tmp_path / "cartpole.pt2"
    export_solver(ocp.solver.solve_fn, args, str(path))
    loaded = import_solver(str(path))(*args)
    direct = ocp.solver.solve_fn(*args)
    assert torch.equal(direct.qp_iters, loaded[5])
    np.testing.assert_allclose(direct.x.numpy(), loaded[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(direct.qp_x.numpy(), loaded[2].numpy(), atol=1e-5)

    jocp = jcp.build(cfg(jcp), stagewise=True)
    jargs = tuple(jnp.asarray(a.numpy()) for a in args)
    jpath = tmp_path / "cartpole.bin"
    jser.export_solver(jocp.solver.solve_fn, jargs, str(jpath))
    jres = jser.import_solver(str(jpath))(*jargs)
    np.testing.assert_allclose(loaded[0].numpy(), np.asarray(jres[0]), atol=2e-3)
