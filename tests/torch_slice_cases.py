"""Cases and helpers of the ``test_torch_slice*.py`` test files (a module of
helpers, not of tests)."""

import ast
import pathlib

import numpy as np

from optimal_control_problem_tpu.models import double_integrator as jdi
from optimal_control_problem_tpu.parallel import BatchedSolver as JBatchedSolver
from optimal_control_problem_tpu_torch.interop import batch_state_from_numpy
from optimal_control_problem_tpu_torch.models import cartpole as tcp
from optimal_control_problem_tpu_torch.models import double_integrator as tdi
from optimal_control_problem_tpu_torch.parallel import BatchedSolver

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


# The JAX bench's cartpole_h20_pallas settings (bench_models.py:257-283);
# the backend is added per case.
DENSE_ADMM = {"method": "condensed", "max_iter": 500, "adaptive_rho": False, "rho": 0.05}


def dense_config(module, backend, H=6, step_num=3, **admm):
    return module.make_config(horizon=H, dt=0.02, alpha=0.3, step_num=step_num,
                              formulation="reduced",
                              ADMM_settings={**DENSE_ADMM, "backend": backend, **admm})


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


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


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
