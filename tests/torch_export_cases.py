"""Shared cases of the export round-trip tests (``test_torch_export_*.py``):
each model's tick at h4 and one SQP step in both packages, the batch
function's arguments, and :func:`round_trip`, which exports a port tick,
checks its op nodes and that its trace ran no plain version, reloads it,
holds it to the direct call and to JAX's exported artifact of the same
tick (:func:`double_integrator_round_trip` for the LTI ticks).  A module
of helpers, not of tests."""

import contextlib

import numpy as np
import torch

from optimal_control_problem_tpu.models import cartpole as jcp
from optimal_control_problem_tpu.models import double_integrator as jdi
from optimal_control_problem_tpu.models import quadrotor as jqr
from optimal_control_problem_tpu.parallel import BatchedSolver as JBatchedSolver
from optimal_control_problem_tpu.utils import serialization as jser
from optimal_control_problem_tpu_torch.models import cartpole as tcp
from optimal_control_problem_tpu_torch.models import double_integrator as tdi
from optimal_control_problem_tpu_torch.models import quadrotor as tqr
from optimal_control_problem_tpu_torch.ops import admm_kernel as ak
from optimal_control_problem_tpu_torch.ops import banded_cr_kernel as bck
from optimal_control_problem_tpu_torch.ops import banded_kernel as bk
from optimal_control_problem_tpu_torch.ops import banded_rolled_kernel as brk
from optimal_control_problem_tpu_torch.ops import shared_kernel as sk
from optimal_control_problem_tpu_torch.parallel import BatchedSolver
from optimal_control_problem_tpu_torch.solvers import admm_batched as tab
from optimal_control_problem_tpu_torch.utils.serialization import (
    export_program,
    import_solver,
)

# Where each op's CPU implementation reaches its plain version.
PLAIN = {
    "banded_admm_chunk": (bk, "admm_chunk_iterate_plain"),
    "banded_admm_chunk_rolled": (brk, "admm_chunk_iterate_plain"),
    "banded_admm_chunk_cr": (bck, "admm_chunk_iterate_plain"),
    "shared_admm_chunk": (sk, "shared_admm_chunk_plain"),
    "admm_device_loop": (ak, "admm_device_loop_plain"),
}

BANDED = {"method": "banded", "max_iter": 500, "adaptive_rho": False, "rho": 0.05,
          "check_every": 2, "scaling_refresh": "tick"}
DENSE = {"method": "condensed", "max_iter": 500, "adaptive_rho": False, "rho": 0.05}
DI = {"method": "condensed", "eps_abs": 1e-7, "eps_rel": 1e-7, "max_iter": 150,
      "adaptive_rho": True}


def cartpole(module, dense=False):
    admm = {**DENSE, "backend": "pallas"} if dense else BANDED
    return module.build(module.make_config(horizon=4, dt=0.04, alpha=0.3, step_num=1,
                                           formulation="reduced", ADMM_settings=admm),
                        stagewise=not dense, **({"device": "cpu"} if module is tcp else {}))


def quadrotor(module, solver):
    cfg = module.make_config(horizon=4, dt=0.02, alpha=0.3, step_num=1, formulation="reduced",
                             ADMM_settings={**BANDED, "max_iter": 250, "banded_solver": solver})
    return module.build(cfg, stagewise=True, **({"device": "cpu"} if module is tqr else {}))


def double_integrator(module, backend, precision="highest"):
    """The double integrator's OCP; the configuration carries no
    ``iter_precision``, so it is set on the solver settings and the solver
    generated again."""
    cfg = module.make_config(horizon=4, dt=0.005, alpha=0.1, step_num=1, formulation="reduced",
                             ADMM_settings={**DI, "backend": backend})
    ocp = module.build(cfg, **({"device": "cpu"} if module is tdi else {}))
    if precision != "highest":
        ocp.solver_settings.admm = ocp.solver_settings.admm.replace(iter_precision=precision)
        ocp.gen_solver()
    assert ocp.solver.options.admm.iter_precision == precision
    return ocp


def inputs(model, B, seed=0):
    """Frames and references of a tick (numpy, float32)."""
    rng = np.random.default_rng(seed)
    if model == "quadrotor":
        frames = np.tile(tqr.initial_state()[None, :], (B, 1))
        frames[:, 0:2] += rng.uniform(-0.5, 0.5, (B, 2))
        refs = np.tile(tqr.reference_hover(4)[None, :], (B, 1))
    elif model == "double_integrator":
        frames = np.zeros((B, tdi.FRAME))
        frames[:, 0:2] = rng.uniform(-1, 1, size=(B, 2))
        refs = np.tile(tdi.reference_circle(4, 0.005)[None, :], (B, 1))
    else:
        frames = np.zeros((B, tcp.FRAME))
        frames[:, 2] = rng.uniform(-0.5, 0.5, B)
        refs = np.full((B, 1), np.pi)
    return frames.astype(np.float32), refs.astype(np.float32)


def solve_args(tb, frames, refs, state):
    """The batch function's arguments for a tick, as ``BatchedSolver``
    builds them (first frame pinned), contiguous."""
    B, fs = frames.shape[0], tb.frame_size
    lbx = tb._lbx_tail.expand(B, -1).clone()
    ubx = tb._ubx_tail.expand(B, -1).clone()
    lbx[:, :fs] = torch.as_tensor(frames)
    ubx[:, :fs] = torch.as_tensor(frames)
    return (state.x, torch.as_tensor(refs), lbx, ubx, tb._lbg.expand(B, -1).contiguous(),
            tb._ubg.expand(B, -1).contiguous(), state.qp_x, state.qp_y)


@contextlib.contextmanager
def plain_calls(monkeypatch, name, forbid=False):
    """Count the runs of ``name``'s plain version (through its op's CPU
    implementation); with ``forbid`` a run raises."""
    mod, attr = PLAIN[name]
    real = getattr(mod, attr)
    calls = []

    def spy(*args, **kwargs):
        if forbid:
            raise AssertionError(f"the plain version of {name} ran")
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(mod, attr, spy)
    try:
        yield calls
    finally:
        monkeypatch.setattr(mod, attr, real)


def op_nodes(program):
    """``ocp_torch`` op nodes of the program, by graph (top and loop bodies)."""
    found = {}
    for gname, gm in program.graph_module.named_modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            if str(node.target).startswith("ocp_torch."):
                key = (gname or "top", str(node.target).split(".")[1])
                found[key] = found.get(key, 0) + 1
    return found


def round_trip(monkeypatch, tmp_path, tb, jb, model, B, kernel, nodes, runs_direct):
    frames, refs = inputs(model, B)
    args = solve_args(tb, frames, refs, tb.init_state(B))
    fn = tb._solve_batch
    if kernel is None:
        program = export_program(fn, args)
    else:
        with plain_calls(monkeypatch, kernel, forbid=True):
            program = export_program(fn, args)
    assert op_nodes(program) == nodes
    path = tmp_path / f"{model}.pt2"
    torch.export.save(program, str(path))
    loaded = import_solver(str(path))

    direct = fn(*args)
    if kernel is None:
        out = loaded(*args)
    else:
        with plain_calls(monkeypatch, kernel) as calls:
            out = loaded(*args)
        assert len(calls) == runs_direct()
    assert torch.equal(out[5], direct.qp_iters)
    np.testing.assert_allclose(out[0].numpy(), direct.x.numpy(), atol=1e-5)
    np.testing.assert_allclose(out[2].numpy(), direct.qp_x.numpy(), atol=1e-5)

    jstate = jb.init_state(B)
    jargs = (frames, refs, jstate.x, jstate.qp_x, jstate.qp_y)
    jpath = tmp_path / f"{model}.bin"
    jser.export_solver(jb._batched_res, jargs, str(jpath))
    jres = jser.import_solver(str(jpath))(*jargs)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jres[0]), atol=2e-3)
    return direct


def double_integrator_round_trip(monkeypatch, tmp_path, backend, precision):
    """:func:`round_trip` of the double integrator's tick (h4, B=8, a forced
    budget of 150 iterations, adaptive rho) on ``backend``: on ``"pallas"``
    B3's op nodes (the first chunk and the device-side loop's) and one
    kernel run a chunk (two: the adaptation at 100), on ``"xla"`` none."""
    tb = BatchedSolver(double_integrator(tdi, backend, precision), device="cpu")
    jb = JBatchedSolver(double_integrator(jdi, backend, precision))
    B = 8
    frames, refs = inputs("double_integrator", B)
    before = tab._admm_iterate_fused.chunks
    tb._solve_batch(*solve_args(tb, frames, refs, tb.init_state(B)))
    chunks = tab._admm_iterate_fused.chunks - before
    if backend == "pallas":
        assert chunks == 2
        kernel = "shared_admm_chunk"
        nodes = {("top", kernel): 1, ("while_loop_body_graph_0", kernel): 1}
    else:
        assert chunks == 0
        kernel, nodes = None, {}
    direct = round_trip(monkeypatch, tmp_path, tb, jb, "double_integrator", B, kernel, nodes,
                        lambda: chunks)
    assert direct.qp_iters.tolist() == [150]
