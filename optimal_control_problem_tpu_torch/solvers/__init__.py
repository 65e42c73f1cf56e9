from .admm import ADMMSettings, QPSolution, admm_solve, ruiz_equilibrate
from .sqp import SQPOptimizationSolver, SQPOptions, SQPResult

__all__ = [
    "ADMMSettings",
    "QPSolution",
    "admm_solve",
    "ruiz_equilibrate",
    "SQPOptimizationSolver",
    "SQPOptions",
    "SQPResult",
]
