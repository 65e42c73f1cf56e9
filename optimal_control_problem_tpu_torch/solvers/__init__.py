from .admm import ADMMSettings, QPSolution
from .sqp import SQPOptimizationSolver, SQPOptions, SQPResult

__all__ = [
    "ADMMSettings",
    "QPSolution",
    "SQPOptimizationSolver",
    "SQPOptions",
    "SQPResult",
]
