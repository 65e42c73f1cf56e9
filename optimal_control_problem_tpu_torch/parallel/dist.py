"""Multi-device scenario MPC: sharded batched solves and consensus
collectives — port of ``optimal_control_problem_tpu/parallel/dist.py``.

* **Sharded batch solve**: the scenario batch is split over the mesh's
  ``batch`` axis and each shard's scenarios solve independently (no
  communication on the hot path).  In-process every shard lives on one
  device, so the whole batch goes through :attr:`BatchedSolver.solve_jit`
  at once (on the card, one chunk launch per rho-constant chunk for all of
  it); with ``torch.distributed`` each rank solves its own slice and the
  results are gathered.  :attr:`DistributedSolver.solve_jit` is that tick
  on tensors; ``export_solver`` of it writes one program a rank (this
  rank's slice, the batch function's ``export_form``, the gather).
* **Consensus step**: the mean of a per-scenario quantity over every
  scenario, a ``psum`` over the mesh axis (the analog of a data-parallel
  gradient all-reduce).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import as_tensors
from ..solvers.admm import f32_matmuls
from .batch import BatchedSolver, BatchState
from .mesh import Mesh, batch_sharding, make_mesh

__all__ = ["DistributedSolver", "consensus_mean"]


def _local_mean(ax, v, axis):
    """Per-device: ``v (S, B/D, d)`` -> the global mean ``(S, d)``."""
    total = ax.psum(torch.sum(v, dim=1), axis)
    count = ax.psum(torch.full((ax.S,), v.shape[1], dtype=v.dtype, device=v.device), axis)
    return total / count[:, None]


def consensus_mean(values: torch.Tensor, mesh: Mesh, axis: str = "batch") -> torch.Tensor:
    """Mean over ALL scenarios of a per-scenario quantity, across shards.

    ``values``: (B, d), split over ``axis``.  Returns the global mean of
    shape (d,), the same on every shard: shard-local sums ``psum``-reduced.
    Values that are not a tensor go to the mesh's device
    (:func:`..device.as_tensors`)."""
    ax = mesh.shards()
    v = ax.shard(as_tensors(values, device=mesh.device)[0], (axis,))
    return _local_mean(ax, v, axis)[0]


class DistributedSolver:
    """Shards a :class:`BatchedSolver` over a mesh axis.

    The global batch must be divisible by the axis size.  The mesh
    defaults to an in-process one on the batched solver's device.  On a
    ``torch.distributed`` mesh every rank holds the global state and
    solves its own slice of scenarios; the outputs are gathered, so each
    rank returns the global result.
    """

    def __init__(self, batched: BatchedSolver, mesh: Optional[Mesh] = None, axis: str = "batch"):
        self.batched = batched
        self.mesh = mesh if mesh is not None else make_mesh((axis,), devices=batched.device)
        self.axis = axis
        self.sharding = batch_sharding(self.mesh, axis)
        self.n_devices = self.mesh.size

    def init_state(self, batch: int, x0=None) -> BatchState:
        if batch % self.n_devices:
            raise ValueError(f"batch {batch} not divisible by mesh size {self.n_devices}")
        return self.batched.init_state(batch, x0)

    def _tick(self, batch_fn, frames, references, x, qp_x, qp_y):
        if not self.mesh.distributed:
            # Every shard on one device: the whole batch in one call.
            return batch_fn(frames, references, x, qp_x, qp_y)
        ax = self.mesh.shards()
        # This rank's scenarios; S = 1 on a rank.
        local = [ax.shard(a, (self.axis,))[0] for a in (frames, references, x, qp_x, qp_y)]
        return tuple(ax.unshard(t[None], (self.axis,)) for t in batch_fn(*local))

    @property
    def solve_jit(self):
        """The sharded tick ``(frames, refs, x, qp_x, qp_y) -> (x, f,
        qp_x, qp_y)`` on global tensors of the solver's device and dtype
        (JAX's ``solve_jit`` under the mesh's sharding).  Its
        ``export_form`` is what ``export_solver`` traces: on a
        ``torch.distributed`` mesh this rank's slice, the batch function's
        ``export_form`` and the gather, one program a rank."""
        jit = self.batched.solve_jit

        def tick(*args):
            return self._tick(jit, *args)

        tick.export_form = lambda *args: self._tick(jit.export_form, *args)
        return tick

    @f32_matmuls
    def solve(self, frames, references, state: BatchState):
        """One sharded batched MPC tick; returns ``(x, f, new_state)``."""
        b = self.batched
        frames = torch.as_tensor(frames, dtype=b.dtype, device=b.device)
        references = torch.as_tensor(references, dtype=b.dtype, device=b.device)
        x, f, qp_x, qp_y = self.solve_jit(frames, references, state.x, state.qp_x, state.qp_y)
        return x, f, BatchState(x=x, qp_x=qp_x, qp_y=qp_y)

    def consensus_first_control(self, trajectories: torch.Tensor, field_slice: slice) -> torch.Tensor:
        """Scenario-consensus control: the mean of the given first-frame
        field over every scenario (a ``psum``), e.g. the control entries of
        frame 0.  Returns the consensus vector."""
        fs = self.batched.frame_size
        controls = trajectories[:, :fs][:, field_slice]
        return consensus_mean(controls, self.mesh, self.axis)
