"""Batched solvers.  Ported so far: ``BatchedSolver``; the multi-device
paths (``dist``, ``horizon``, ``seq_*``, ``sharded_solver``) follow
(ROADMAP Queue A10)."""

from .batch import BatchedSolver, BatchState

__all__ = ["BatchedSolver", "BatchState"]
