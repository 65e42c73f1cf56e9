"""Batched and multi-device solvers — port of
``optimal_control_problem_tpu/parallel``: the batched front end, the
scenario-sharded solve and its consensus, the horizon-sharded SPIKE solve,
ADMM and SQP, and the horizon-sharded MPC front end, over the meshes of
:mod:`.mesh` (in-process on one device, or ``torch.distributed``)."""

from .batch import BatchedSolver, BatchState
from .dist import DistributedSolver, consensus_mean
from .horizon import horizon_sharded_solve
from .mesh import (
    batch_sharding,
    initialize_distributed,
    make_mesh,
    replicated_sharding,
)
from .seq_admm import ShardedBandedQP, admm_solve_seq_parallel
from .seq_sqp import sqp_solve_seq_parallel
from .sharded_solver import HorizonShardedSolver

__all__ = [
    "BatchedSolver",
    "BatchState",
    "DistributedSolver",
    "consensus_mean",
    "horizon_sharded_solve",
    "ShardedBandedQP",
    "admm_solve_seq_parallel",
    "sqp_solve_seq_parallel",
    "HorizonShardedSolver",
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "initialize_distributed",
]
