"""Checkpoint / resume and solver-artifact serialization — port of
``optimal_control_problem_tpu/utils/serialization.py``.

* :func:`save_state` / :func:`load_state`, :func:`save_solver_state` /
  :func:`load_solver_state`: the solver's warm-start state (iterate + QP
  warm start, the reference's ``result_``) as an ``.npz`` checkpoint, so a
  long-running MPC process can stop and resume mid-mission;
* :func:`export_solver` / :func:`import_solver`: a solve function as a
  ``torch.export`` program (``torch.export.save`` / ``load``), the analog
  of the reference's generated ``.so`` solver libraries and of JAX's
  export of a jitted solve: it reloads and runs without the Python
  problem definition.  The solve functions of ``SQPOptimizationSolver``
  (``solve_fn``, ``solve_batch_fn``, ``solve_batch_banded_fn``,
  ``solve_batch_dense_fn``) read their loop conditions on the host, which
  ``torch.export`` cannot trace; each carries an ``export_form`` twin
  with every condition on the device (``torch.while_loop``) and the same
  results, and that is what is exported.  The hand-written CUDA kernels
  are custom ops (``torch.ops.ocp_torch.*``, registered when the port is
  imported): the program holds each as one node, never its plain
  version's operations, and the reloaded program launches the same
  kernels on the card (their plain versions on the CPU).  An artifact
  runs on the device it was exported for, as a JAX export runs on its
  platform.
* :func:`enable_compilation_cache`: where the port's kernels are built
  (it has no XLA cache; nothing here uses ``torch.compile``).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Sequence

import numpy as np
import torch
from torch.export._trace import _export

from ..ops import build

__all__ = [
    "save_state",
    "load_state",
    "save_solver_state",
    "load_solver_state",
    "export_program",
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


def export_program(fn, example_args: Sequence[Any]) -> torch.export.ExportedProgram:
    """:func:`export_solver`'s trace, unsaved: the ``ExportedProgram`` of
    ``fn``'s ``export_form`` (or of ``fn``) at ``example_args``.

    The trace is ``torch.export``'s non-strict one at the ATen level
    (``pre_dispatch=False``): the derivatives of the solves come from
    ``torch.func`` transforms, which only that level traces (they run as
    the trace is taken, and the program holds the operations they
    produce: the direct call's, so its values)."""
    form = getattr(fn, "export_form", fn)
    if form is None:
        raise ValueError(f"export_solver: {getattr(fn, 'no_export', 'this function')} has no "
                         "export form")
    args = tuple(a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
                 for a in example_args)
    return _export(_Exported(form), args, strict=False, pre_dispatch=False)


def export_solver(fn, example_args: Sequence[Any], path: str) -> None:
    """Serialize a solve function, traced at ``example_args`` (their
    shapes, dtypes and device), to ``path`` as a ``torch.export`` program.

    ``fn`` may be one of ``SQPOptimizationSolver``'s solve functions (its
    ``export_form`` is traced) or any torch function of tensors.  The
    kernels it reaches are traced as their custom ops.  Raises
    ``ValueError`` for a solve function without an export form (custom
    local-system parts without one; the banded batch solve with
    ``polish=True``, whose polish runs per scenario on the host).
    """
    torch.export.save(export_program(fn, example_args), str(path))


def import_solver(path: str):
    """Load :func:`export_solver`'s program; returns a callable of the same
    arguments (the outputs as a tuple: ``SQPResult``'s fields in order).
    The kernels' custom ops are registered first (``..ops``)."""
    from .. import ops  # noqa: F401  (registers the ocp_torch ops a program holds)

    return torch.export.load(str(path)).module()


def enable_compilation_cache(directory: str = "build/ocp_torch_kernels") -> None:
    """Keep the port's built kernels in ``directory`` (created if needed),
    so later processes load them without compiling again — the analog of
    the reference's on-disk ``.so`` cache and of JAX's persistent XLA
    cache.  Kernels already loaded in this process stay loaded."""
    d = Path(directory).resolve()
    os.makedirs(d, exist_ok=True)
    build.BUILD_DIR = d
