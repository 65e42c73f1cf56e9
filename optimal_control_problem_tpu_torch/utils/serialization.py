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
  problem definition.  What exports: the solve functions of
  ``SQPOptimizationSolver`` (``solve_fn``, ``solve_batch_fn``,
  ``solve_batch_banded_fn`` with or without ``polish``,
  ``solve_batch_dense_fn``) and the sequence-parallel solves
  (``parallel.admm_solve_seq_parallel``, ``parallel.sqp_solve_seq_parallel``,
  also as a ``functools.partial`` of them, as one writes it for JAX's
  ``export_solver``; ``HorizonShardedSolver``'s tick is such a call) over
  an in-process mesh.  Their direct forms read loop conditions on the
  host, which ``torch.export`` cannot trace; each carries an
  ``export_form`` twin with every condition on the device
  (``torch.while_loop`` or its operator) and the same results, and that
  is what is exported.  Over a ``torch.distributed`` mesh (the
  sequence-parallel solves, ``horizon_sharded_solve``,
  ``DistributedSolver.solve_jit``) each rank exports its own program, the
  SPMD program's part of that rank as JAX exports it for the whole mesh:
  its collectives op nodes on named process groups, its coordinates
  constants.  The hand-written CUDA kernels are
  custom ops (``torch.ops.ocp_torch.*``, registered when the port is
  imported): the program holds each as one node, never its plain
  version's operations, and the reloaded program launches the same
  kernels on the card (their plain versions on the CPU).  An artifact
  runs on the device it was exported for, as a JAX export runs on its
  platform.
* :func:`enable_compilation_cache`: where the port's kernels are built
  (it has no XLA cache; nothing here uses ``torch.compile``).
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
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
    "save_program",
    "import_solver",
    "rank_path",
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


def _export_form(fn):
    """``fn``'s ``export_form`` (``fn`` itself without one), found also
    through a ``functools.partial`` of ``fn``, whose arguments it keeps."""
    if isinstance(fn, functools.partial):
        return functools.partial(_export_form(fn.func), *fn.args, **fn.keywords)
    return getattr(fn, "export_form", fn)


@contextlib.contextmanager
def _no_stack_traces():
    """The trace without each node's Python stack trace (metadata only):
    recording them is about a fifth of tracing the device-side loops,
    whose bodies are traced several times over."""
    try:
        from torch.fx import config as fx_config
    except ImportError:
        fx_config = None
    if not hasattr(fx_config, "do_not_emit_stack_traces"):
        yield
        return
    saved = fx_config.do_not_emit_stack_traces
    fx_config.do_not_emit_stack_traces = True
    try:
        yield
    finally:
        fx_config.do_not_emit_stack_traces = saved


def _as_input(a):
    """An example argument as the trace takes it: a tensor, or a tuple
    (a ``NamedTuple`` such as ``ShardedBandedQP`` too) of them; other
    arrays become tensors."""
    if isinstance(a, torch.Tensor):
        return a
    if isinstance(a, tuple):
        parts = [_as_input(v) for v in a]
        return type(a)(*parts) if hasattr(a, "_fields") else tuple(parts)
    return torch.as_tensor(np.asarray(a))


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
    form = _export_form(fn)
    with _no_stack_traces():
        return _export(_Exported(form), tuple(_as_input(a) for a in example_args),
                       strict=False, pre_dispatch=False)


# The extra file of a rank program: its rank, world size and groups.
_RANK_META = "ocp_rank_program.json"


def _program_groups(program: torch.export.ExportedProgram) -> list:
    """The process groups (their names) that the program's collectives
    (``torch.ops._c10d_functional``), loop bodies included, run on."""
    names = set()
    for gm in program.graph_module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            schema = getattr(node.target, "_schema", None)
            if node.op != "call_function" or schema is None \
                    or not schema.name.startswith("_c10d_functional::"):
                continue
            for arg, value in zip(schema.arguments, node.args):
                if arg.name == "group_name":
                    names.add(str(value))
    return sorted(names, key=lambda n: (len(n), n))


def rank_path(path: str, rank: int, world_size: int) -> str:
    """Where :func:`export_solver` writes rank ``rank``'s program of a
    ``world_size``-rank export to ``path``: ``solver.pt2`` ->
    ``solver.rank0-of-4.pt2``."""
    p = Path(path)
    return str(p.with_name(f"{p.stem}.rank{rank}-of-{world_size}{p.suffix}"))


def _groups_by_name() -> dict:
    """This process's process groups by name (empty without
    ``torch.distributed``)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return {}
    from torch.distributed.distributed_c10d import _world

    return {name: pg for pg, name in _world.pg_names.items()}


def export_solver(fn, example_args: Sequence[Any], path: str) -> str:
    """Serialize a solve function, traced at ``example_args`` (their
    shapes, dtypes and device), to ``path`` as a ``torch.export`` program;
    returns the file written.

    ``fn`` may be one of ``SQPOptimizationSolver``'s solve functions, a
    sequence-parallel solve or a ``functools.partial`` of one (their
    ``export_form`` is traced), ``DistributedSolver.solve_jit``, or any
    torch function of tensors; an example argument may be a tuple of
    tensors (``ShardedBandedQP``).  The kernels it reaches are traced as
    their custom ops.  A program whose collectives run on a
    ``torch.distributed`` process group is this rank's: every rank calls
    ``export_solver`` with the same ``path``, and each writes
    :func:`rank_path` ``(path, rank, world_size)``, carrying its rank, the
    world size and the ranks of every group it names.  A function without
    an export form (custom local-system parts called directly, say) is
    traced as it is, and fails where it reads a tensor on the host.
    """
    program = export_program(fn, example_args)
    groups = _program_groups(program)
    if not groups:
        save_program(program, str(path))
        return str(path)
    import torch.distributed as dist

    by_name = _groups_by_name()
    meta = {"rank": dist.get_rank(), "world_size": dist.get_world_size(),
            "groups": {n: dist.get_process_group_ranks(by_name[n]) for n in groups}}
    out = rank_path(path, meta["rank"], meta["world_size"])
    save_program(program, out, extra_files={_RANK_META: json.dumps(meta)})
    return out


class _NoEmptyListNote(logging.Filter):
    """Drops the serializer's note on each empty argument list: a scan
    operator's (``ops/block_tridiag._stages``) empty extra inputs, saved
    as the empty tensor list they are, once a stage loop a program."""

    def filter(self, record):
        return "empty list" not in record.getMessage()


def save_program(program, path: str, extra_files=None) -> None:
    """``torch.export.save`` of ``program`` to ``path`` (with
    ``extra_files``), without the serializer's note on empty lists."""
    log = logging.getLogger("torch._export.serde.serialize")
    quiet = _NoEmptyListNote()
    log.addFilter(quiet)
    try:
        torch.export.save(program, str(path), extra_files=extra_files)
    finally:
        log.removeFilter(quiet)


def _rank_file(path: str):
    """The calling rank's program of a per-rank export to ``path``, or
    ``None`` where ``path`` holds a single program; a ``ValueError``
    naming the world sizes where the rank programs are of another world
    than this process's."""
    import torch.distributed as dist

    p = Path(path)
    found = sorted(p.parent.glob(f"{p.stem}.rank*-of-*{p.suffix}"))
    joined = dist.is_available() and dist.is_initialized()
    if joined:
        mine = rank_path(path, dist.get_rank(), dist.get_world_size())
        if os.path.exists(mine):
            return mine
    if p.exists() or not found:
        return None
    worlds = sorted({f.stem.rsplit("-of-", 1)[1] for f in found}, key=int)
    here = (f"this process is rank {dist.get_rank()} of a world of {dist.get_world_size()}"
            if joined else "this process has joined no process group")
    raise ValueError(f"{path} was exported one program a rank for a world of "
                     f"{' or '.join(worlds)} ranks ({', '.join(f.name for f in found)}), "
                     f"but {here}: start the same number of processes and call "
                     f"initialize_distributed before import_solver")


def import_solver(path: str):
    """Load :func:`export_solver`'s program; returns a callable of the same
    arguments (the outputs as a tuple: ``SQPResult``'s fields in order).
    The kernels' custom ops are registered first (``..ops``).

    For a per-rank export, each rank loads its own program
    (:func:`rank_path`): join the process group first
    (``initialize_distributed``), then build the same meshes, in the same
    order, as the exporting processes did (a mesh makes its axis groups
    when it is built, and the program names them).  Raises ``ValueError``
    naming what is missing, before any collective could wait on it: a
    world of another size, or a group the program names that this process
    does not have with the same ranks."""
    from .. import ops  # noqa: F401  (registers the ocp_torch ops a program holds)

    own = _rank_file(path)
    if own is None:
        return torch.export.load(str(path)).module()
    extra = {_RANK_META: ""}
    program = torch.export.load(own, extra_files=extra)
    meta = json.loads(extra[_RANK_META])
    import torch.distributed as dist

    if (meta["rank"], meta["world_size"]) != (dist.get_rank(), dist.get_world_size()):
        raise ValueError(f"{own} is rank {meta['rank']}'s program of a world of "
                         f"{meta['world_size']}; this process is rank {dist.get_rank()} of "
                         f"{dist.get_world_size()}")
    have = _groups_by_name()
    missing = {n: r for n, r in meta["groups"].items()
               if n not in have or dist.get_process_group_ranks(have[n]) != r}
    if missing:
        raise ValueError(
            f"{own} runs collectives on process groups "
            f"{', '.join(f'{n!r} (ranks {r})' for n, r in missing.items())}, which this "
            f"process does not have (it has "
            f"{', '.join(f'{n!r}' for n in sorted(have, key=lambda n: (len(n), n)))}): "
            f"build the same meshes, in the same order, as the exporting processes before "
            f"import_solver")
    return program.module()


def enable_compilation_cache(directory: str = "build/ocp_torch_kernels") -> None:
    """Keep the port's built kernels in ``directory`` (created if needed),
    so later processes load them without compiling again — the analog of
    the reference's on-disk ``.so`` cache and of JAX's persistent XLA
    cache.  Kernels already loaded in this process stay loaded."""
    d = Path(directory).resolve()
    os.makedirs(d, exist_ok=True)
    build.BUILD_DIR = d
