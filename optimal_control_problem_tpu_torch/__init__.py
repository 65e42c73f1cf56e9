"""optimal_control_problem_tpu_torch — the PyTorch/CUDA port of
``optimal_control_problem_tpu``.

Same layout and module names as the JAX package (``ops/``, ``solvers/``,
``parallel/``, ``models/``, ``utils/``) so every module has an obvious
counterpart; the JAX package stays the reference the tests compare against.
This package imports ``torch`` and never ``jax`` or the JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`resolve_device`); with no GPU and no explicit CPU request they raise.
The hot kernels of the batched MPC ticks are hand-written CUDA
(``csrc/*.cu``, built with ``nvcc`` at first use; see ``ops/``).

Float32 matmuls stay true float32: TF32 is switched off here, once, for
the whole process, and again around every solve entry point
(``solvers/admm.f32_matmuls``, the JAX package's guard of that name), so a
caller that turns it back on does not reach the solver: ADMM residuals
floor far above the 1e-3 termination tolerance at TF32's ~3 decimal
digits.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .device import resolve_device  # noqa: E402
from .config import Frame, OCPConfig, load_config  # noqa: E402
from .controller import MPCController  # noqa: E402
from .problem import OptimalControlProblem, SolverSettings, SolverType  # noqa: E402
from .solvers.admm import ADMMSettings, QPSolution, admm_solve  # noqa: E402
from .solvers.qp_interface import CuCaQP, TpuQP  # noqa: E402
from .solvers.sqp import SQPOptimizationSolver, SQPOptions, SQPResult  # noqa: E402
from .stagewise import StageStructure  # noqa: E402
from . import sym  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "resolve_device",
    "Frame",
    "OCPConfig",
    "load_config",
    "MPCController",
    "OptimalControlProblem",
    "SolverSettings",
    "SolverType",
    "ADMMSettings",
    "QPSolution",
    "admm_solve",
    "CuCaQP",
    "TpuQP",
    "SQPOptimizationSolver",
    "SQPOptions",
    "SQPResult",
    "StageStructure",
    "sym",
]
