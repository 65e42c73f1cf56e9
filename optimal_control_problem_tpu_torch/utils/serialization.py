"""Checkpoint / resume and solver-artifact serialization — port of
``optimal_control_problem_tpu/utils/serialization.py``.

* :func:`save_state` / :func:`load_state`, :func:`save_solver_state` /
  :func:`load_solver_state`: the solver's warm-start state (iterate + QP
  warm start, the reference's ``result_``) as an ``.npz`` checkpoint, so a
  long-running MPC process can stop and resume mid-mission;
* :func:`export_solver` / :func:`import_solver`: a solve function as a
  ``torch.export`` program (``torch.export.save`` / ``load``), the analog
  of the reference's generated ``.so`` solver libraries and of JAX's
  StableHLO export: it reloads and runs without the Python problem
  definition.  ``SQPOptimizationSolver.solve_fn`` reads its loop
  conditions on the host, which ``torch.export`` cannot trace; it carries
  an ``export_form`` twin with every condition on the device and the same
  results, and that is what is exported.  A function that reaches a
  hand-written CUDA kernel is refused: the kernel cannot be traced, and
  its plain version is never traced in its place.
* :func:`enable_compilation_cache`: where the port's kernels are built
  (it has no XLA cache; nothing here uses ``torch.compile``).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Sequence

import numpy as np
import torch

from ..ops import build

__all__ = [
    "save_state",
    "load_state",
    "save_solver_state",
    "load_solver_state",
    "export_solver",
    "import_solver",
    "enable_compilation_cache",
]


def _np(v: Any) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save_state(path: str, **arrays: Any) -> None:
    """Checkpoint named arrays (e.g. ``x=..., qp_x=..., qp_y=...``)."""
    np.savez(path, **{k: _np(v) for k, v in arrays.items()})


def load_state(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def save_solver_state(solver, path: str) -> None:
    """Checkpoint an ``SQPOptimizationSolver``'s persistent warm-start
    state (the ``result_`` analog, SQPOptimizationSolver.cpp:88-91)."""
    save_state(path, result_x=solver._result_x, result_f=solver._result_f,
               qp_x=solver._qp_x, qp_y=solver._qp_y)


def load_solver_state(solver, path: str) -> None:
    """Restore :func:`save_solver_state`'s checkpoint onto ``solver``'s
    device and dtype."""
    state = load_state(path)
    for name in ("result_x", "result_f", "qp_x", "qp_y"):
        setattr(solver, f"_{name}", torch.as_tensor(state[name], dtype=solver.dtype,
                                                    device=solver.device))


class _Exported(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        out = self.fn(*args)
        return tuple(out) if isinstance(out, (tuple, list)) else out


def export_solver(fn, example_args: Sequence[Any], path: str) -> None:
    """Serialize a solve function, traced at ``example_args`` (their
    shapes, dtypes and device), to ``path`` as a ``torch.export`` program.

    ``fn`` may be ``SQPOptimizationSolver.solve_fn`` (its ``export_form``
    is traced) or any torch function of tensors.  Raises ``ValueError`` for
    a function that reaches a hand-written CUDA kernel (``fn.kernel``, e.g.
    ``backend="pallas"``); any other kernel met during the trace raises
    there (``ops.banded_kernel.refuse_export``).
    """
    kernel = getattr(fn, "kernel", None)
    if kernel:
        raise ValueError(
            f"export_solver: this function reaches the hand-written CUDA kernel {kernel}, "
            "which torch.export cannot trace; the plain version is never traced in its place "
            "(solve with backend='xla' to export)"
        )
    form = getattr(fn, "export_form", None) or fn
    args = tuple(a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
                 for a in example_args)
    program = torch.export.export(_Exported(form), args, strict=False)
    torch.export.save(program, str(path))


def import_solver(path: str):
    """Load :func:`export_solver`'s program; returns a callable of the same
    arguments (the outputs as a tuple: ``SQPResult``'s fields in order)."""
    return torch.export.load(str(path)).module()


def enable_compilation_cache(directory: str = "build/ocp_torch_kernels") -> None:
    """Keep the port's built kernels in ``directory`` (created if needed),
    so later processes load them without compiling again — the analog of
    the reference's on-disk ``.so`` cache and of JAX's persistent XLA
    cache.  Kernels already loaded in this process stay loaded."""
    d = Path(directory).resolve()
    os.makedirs(d, exist_ok=True)
    build.BUILD_DIR = d
