"""Batched scenario MPC — port of
``optimal_control_problem_tpu/parallel/batch.py``.

The reference is strictly one problem at a time; here a whole batch of
independent scenarios runs as one SQP solve whose QPs iterate together:
shared-system (LTI) problems through one shared factorization
(``solvers/admm_batched.py``; with ``backend="pallas"`` its iterations run
in the fused chunk of ``ops/shared_kernel.py``), stage-structured problems
in the fused banded chunk (``ops/banded_kernel.py``), and every other
problem through its per-scenario dense QPs (``solvers/admm.py``'s
``admm_solve_batch``; with ``backend="pallas"`` in the device-loop kernel
of ``ops/admm_kernel.py``): on the card one CUDA launch per rho-constant
chunk or round covers every scenario.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device, same_device
from ..problem import OptimalControlProblem

__all__ = ["BatchState", "BatchedSolver"]


class BatchState(NamedTuple):
    """Per-scenario persistent solver state (iterates + QP warm start)."""

    x: torch.Tensor  # (B, n_x) current iterates
    qp_x: torch.Tensor  # (B, qp_n) last QP primal
    qp_y: torch.Tensor  # (B, qp_m) last QP dual


class BatchedSolver:
    """Batched front-end over a generated problem.

    Usage::

        ocp = cartpole.build(cfg, stagewise=True, device="cuda")
        batched = BatchedSolver(ocp)
        state = batched.init_state(1024)
        trajs, objs, state = batched.solve(frames, references, state)

    Runs on the problem's device, which must match ``device`` (default: the
    GPU); pass ``device="cpu"`` for a problem built on the CPU.
    """

    def __init__(self, ocp: OptimalControlProblem, device=None):
        if ocp.solver is None:
            raise ValueError(
                "OCP must be generated with a TPU_SQP-capable backend "
                "(call gen_solver() with solve_method TPU_SQP/CUDA_SQP)"
            )
        dev = resolve_device(device)
        if not same_device(dev, ocp.device):
            raise ValueError(f"problem lives on {ocp.device}, solver asked for {dev}")
        self.ocp = ocp
        self.solver = ocp.solver
        self.device = ocp.device
        cfg = ocp.ocp_config
        self.n_x = cfg.num_variables
        self.n_p = ocp.reference_size
        self.frame_size = cfg.get_frame_size()
        self.dtype = self.solver.dtype

        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)  # noqa: E731
        self._lbx_tail = as_t(cfg.lower_bounds_flat())
        self._ubx_tail = as_t(cfg.upper_bounds_flat())
        self._lbg = as_t(ocp.get_constraint_lower_bounds())
        self._ubg = as_t(ocp.get_constraint_upper_bounds())
        # The shared-factorization batch function first, then the banded
        # one, then the per-scenario dense one, as the JAX package chooses.
        self._solve_batch = (
            self.solver.solve_batch_fn
            or self.solver.solve_batch_banded_fn
            or self.solver.solve_batch_dense_fn
        )
        # Full SQPResult of the last .solve() call.
        self.last_result = None

    def init_state(self, batch: int, x0: Optional[np.ndarray] = None) -> BatchState:
        z = lambda *s: torch.zeros(s, dtype=self.dtype, device=self.device)  # noqa: E731
        x = z(batch, self.n_x) if x0 is None else torch.broadcast_to(
            torch.as_tensor(np.asarray(x0), dtype=self.dtype, device=self.device),
            (batch, self.n_x),
        ).clone()
        return BatchState(x=x, qp_x=z(batch, self.solver._qp_n), qp_y=z(batch, self.solver._qp_m))

    def _batch_args(self, frames, references, x, qp_x, qp_y):
        """The batch function's arguments, with first-frame pinning."""
        B, fs = frames.shape[0], self.frame_size
        # First-frame pinning per scenario (cpp:93-96); no in-place write,
        # which an export trace refuses on these constant tensors.
        frames = frames.to(self.dtype)
        lbx = torch.cat([frames, self._lbx_tail[fs:].expand(B, -1)], dim=1)
        ubx = torch.cat([frames, self._ubx_tail[fs:].expand(B, -1)], dim=1)
        lbg = self._lbg.expand(B, -1)
        ubg = self._ubg.expand(B, -1)
        return x, references, lbx, ubx, lbg, ubg, qp_x, qp_y

    def _batched_res(self, frames, references, x, qp_x, qp_y):
        """The batch solve with first-frame pinning; the full SQPResult."""
        res = self._solve_batch(*self._batch_args(frames, references, x, qp_x, qp_y))
        self.last_result = res
        return res

    def solve(self, frames, references, state: BatchState):
        """One batched MPC tick.

        ``frames``: (B, frame_size) measured states; ``references``: (B, n_p).
        Returns ``(trajectories (B, n_x), objectives (B,), new_state)``.
        """
        frames = torch.as_tensor(frames, dtype=self.dtype, device=self.device)
        references = torch.as_tensor(references, dtype=self.dtype, device=self.device)
        res = self._batched_res(frames, references, state.x, state.qp_x, state.qp_y)
        return res.x, res.f, BatchState(x=res.x, qp_x=res.qp_x, qp_y=res.qp_y)

    @property
    def solve_jit(self):
        """The batched function ``(frames, refs, x, qp_x, qp_y) -> (x, f,
        qp_x, qp_y)`` on tensors of the solver's device and dtype, for
        composition with sharding (``parallel/dist.py``); the JAX
        package's jitted function of that name.  Its ``export_form`` runs
        the batch function's (``export_solver`` traces it)."""

        def slim(frames, references, x, qp_x, qp_y):
            res = self._batched_res(frames, references, x, qp_x, qp_y)
            return res.x, res.f, res.qp_x, res.qp_y

        def export_form(frames, references, x, qp_x, qp_y):
            res = self._solve_batch.export_form(
                *self._batch_args(frames, references, x, qp_x, qp_y))
            return tuple(res[:4])

        slim.export_form = export_form
        return slim
