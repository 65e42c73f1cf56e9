"""Carry the JAX package's state into the port.

The counterpart of loading weights: each function takes the JAX package's
objects after ``np.asarray`` on their arrays (or ``dataclasses.asdict`` on
its settings) and builds the port's equivalents, so a test feeds both
packages identical inputs.  Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Union

import numpy as np
import torch

from .device import resolve_device
from .ops.block_tridiag import CRFactor
from .parallel.batch import BatchState
from .parallel.mesh import Mesh, make_mesh
from .parallel.seq_admm import ShardedBandedQP
from .solvers.admm import ADMMSettings, DensePrep
from .solvers.admm_banded import BandedQP
from .solvers.admm_batched import SharedQPFactor
from .solvers.sqp import SQPOptimizationSolver, SQPOptions

__all__ = [
    "banded_qp_from_numpy",
    "batch_state_from_numpy",
    "cr_factor_from_numpy",
    "dense_prep_from_numpy",
    "mesh_from_jax_layout",
    "settings_from_jax_dict",
    "shared_factor_from_numpy",
    "sharded_banded_qp_from_numpy",
    "sqp_iterate_from_numpy",
]


def _fields(obj, names):
    if isinstance(obj, Mapping):
        return [obj[n] for n in names]
    return [getattr(obj, n) for n in names]


def _tensor(a, device, dtype=None):
    arr = np.array(a)  # a writable copy (JAX hands out read-only buffers)
    if dtype is None:
        dtype = torch.float64 if arr.dtype == np.float64 else torch.float32
    return torch.as_tensor(arr, dtype=dtype, device=device)


def banded_qp_from_numpy(qp_np: Any, device=None, dtype=None) -> BandedQP:
    """A JAX ``BandedQP`` (fields as numpy arrays, or a mapping of them) ->
    the port's :class:`BandedQP` on ``device`` (default: the GPU).
    ``dtype`` defaults to the arrays' own float width."""
    dev = resolve_device(device)
    return BandedQP(*(_tensor(a, dev, dtype) for a in _fields(qp_np, BandedQP._fields)))


def sharded_banded_qp_from_numpy(qp_np: Any, device=None, dtype=None) -> ShardedBandedQP:
    """A JAX ``ShardedBandedQP`` (its per-stage fields as numpy arrays, or
    a mapping of them) -> the port's :class:`ShardedBandedQP` on
    ``device``."""
    dev = resolve_device(device)
    return ShardedBandedQP(
        *(_tensor(a, dev, dtype) for a in _fields(qp_np, ShardedBandedQP._fields))
    )


def mesh_from_jax_layout(shape: Mapping[str, int], device=None) -> Mesh:
    """A JAX mesh's shard layout (its ``mesh.shape``: axis names to sizes,
    in axis order) -> an in-process mesh of the port with the same axes
    and shard counts on ``device``, so both packages split the same
    arrays the same way."""
    return make_mesh(tuple(shape), tuple(int(n) for n in shape.values()), resolve_device(device))


def shared_factor_from_numpy(fac_np: Any, device=None, dtype=None) -> SharedQPFactor:
    """A JAX ``SharedQPFactor`` (fields as numpy arrays, or a mapping of
    them) -> the port's :class:`SharedQPFactor` on ``device``, so both
    packages iterate on the same equilibration, rho and operator inverse."""
    dev = resolve_device(device)
    return SharedQPFactor(
        *(_tensor(a, dev, dtype) for a in _fields(fac_np, SharedQPFactor._fields))
    )


def cr_factor_from_numpy(fac_np: Any, device=None, dtype=None) -> CRFactor:
    """A JAX ``CRFactor`` (its ``levels`` of six blocks each, ``root_dinv``
    and ``n_orig``, as attributes or a mapping; arrays as numpy) -> the
    port's :class:`~.ops.block_tridiag.CRFactor` on ``device``, so both
    packages' ``cr_solve`` run on one factor."""
    dev = resolve_device(device)
    levels, root_dinv, n_orig = _fields(fac_np, ("levels", "root_dinv", "n_orig"))
    return CRFactor(
        levels=tuple(tuple(_tensor(a, dev, dtype) for a in lv) for lv in levels),
        root_dinv=_tensor(root_dinv, dev, dtype),
        n_orig=int(n_orig),
    )


def dense_prep_from_numpy(prep_np: Any, device=None, dtype=None) -> DensePrep:
    """JAX's per-scenario prepared quantities of a batch of dense QPs (a
    mapping with the :class:`DensePrep` field names — Ruiz ``D``, ``E``,
    ``c``; scaled ``Pb``, ``qb``, ``Ab``, ``lb``, ``ub``; ``rho_v``; ``OP`` —
    as batch-leading numpy arrays, e.g. from ``jax.vmap`` of the JAX
    package's ``ruiz_equilibrate``, ``_rho_vec`` and ``_factor``) -> the
    port's :class:`DensePrep` on ``device``, so both packages iterate on
    one equilibration and one operator inverse."""
    dev = resolve_device(device)
    return DensePrep(*(_tensor(a, dev, dtype) for a in _fields(prep_np, DensePrep._fields)))


def batch_state_from_numpy(state_np: Any, device=None, dtype=None) -> BatchState:
    """A JAX ``BatchState`` (``x``, ``qp_x``, ``qp_y`` as numpy arrays, or a
    mapping of them; the QP warm start at whatever size the path uses,
    banded or dense) -> the port's :class:`BatchState` on ``device``."""
    dev = resolve_device(device)
    return BatchState(*(_tensor(a, dev, dtype) for a in _fields(state_np, BatchState._fields)))


def sqp_iterate_from_numpy(solver: SQPOptimizationSolver, x, qp_x, qp_y) -> None:
    """Set a port solver's persistent iterate and QP warm start from the
    JAX solver's arrays (its ``_result_x``, ``_qp_x``, ``_qp_y`` after
    ``np.asarray``), so the next ``get_optimal_solution`` of both packages
    starts from one state.  Sizes are checked against the port solver's."""
    sizes = {"x": solver.n_x, "qp_x": solver._qp_n, "qp_y": solver._qp_m}
    vals = {}
    for name, a in (("x", x), ("qp_x", qp_x), ("qp_y", qp_y)):
        t = _tensor(np.asarray(a).reshape(-1), solver.device, solver.dtype)
        if t.shape[0] != sizes[name]:
            raise ValueError(f"{name} must have size {sizes[name]}, got {t.shape[0]}")
        vals[name] = t
    solver._result_x, solver._qp_x, solver._qp_y = vals["x"], vals["qp_x"], vals["qp_y"]


def _torch_dtype(d) -> torch.dtype:
    return torch.float64 if np.dtype(d) == np.float64 else torch.float32


def settings_from_jax_dict(d: Mapping[str, Any]) -> Union[ADMMSettings, SQPOptions]:
    """``dataclasses.asdict`` of a JAX ``ADMMSettings`` -> the port's
    :class:`ADMMSettings`; of a JAX ``SQPOptions`` (recognised by its
    ``admm`` entry; the parity preset's and the line search's fields
    included) -> the port's :class:`SQPOptions` with its nested settings
    and dtype converted, and ``hessian_reg`` kept a string or made a
    Python float.  Fields the port does not know are dropped."""

    def known(cls, src):
        names = {f.name for f in dataclasses.fields(cls)}
        return {k: v for k, v in src.items() if k in names}

    if "admm" in d:
        kw = known(SQPOptions, d)
        admm = kw["admm"]
        kw["admm"] = admm if isinstance(admm, ADMMSettings) else ADMMSettings(**known(ADMMSettings, admm))
        if "dtype" in kw:
            kw["dtype"] = _torch_dtype(kw["dtype"])
        if "hessian_reg" in kw and not isinstance(kw["hessian_reg"], str):
            kw["hessian_reg"] = float(kw["hessian_reg"])
        return SQPOptions(**kw)
    return ADMMSettings(**known(ADMMSettings, d))
