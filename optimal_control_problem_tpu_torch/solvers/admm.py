"""OSQP-style ADMM settings and result types — the part of
``optimal_control_problem_tpu/solvers/admm.py`` that the banded path reads.

``ADMMSettings`` is copied field for field (a frozen, hashable dataclass);
``QPSolution``, the OSQP rho limits and the Ruiz scaling limits come along
with it.  The dense per-scenario solver (``admm_solve``, ``ruiz_equilibrate``,
the condensed/KKT factorizations) is not ported yet (ROADMAP Queue A).

The JAX module's ``f32_matmuls`` has no counterpart here: the package
switches TF32 off once at import (``__init__.py``), and the banded path has
no matmuls to lower anyway.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

__all__ = [
    "ADMMSettings",
    "QPSolution",
]

# OSQP constants (osqp v1.0.0-beta1 defaults; the reference overrides only the
# tolerances/max_iter listed in SQPOptimizationSolver.cpp:80-85).
_RHO_MIN = 1e-6
_RHO_MAX = 1e6
_RHO_EQ_OVER_RHO_INEQ = 1e3
_RHO_TOL = 1e-4
_MIN_SCALING = 1e-4
_MAX_SCALING = 1e4


@dataclasses.dataclass(frozen=True)
class ADMMSettings:
    """Static solver settings (hashable; safe to close over under jit)."""

    rho: float = 0.1
    sigma: float = 1e-6
    alpha: float = 1.6  # over-relaxation
    eps_abs: float = 1e-3  # SQPOptimizationSolver.cpp:83
    eps_rel: float = 1e-3  # SQPOptimizationSolver.cpp:84
    max_iter: int = 10000  # SQPOptimizationSolver.cpp:85
    check_every: int = 25  # OSQP check_termination default
    scaling_iters: int = 10  # OSQP scaling default
    # When to recompute Ruiz equilibration on the banded batch SQP path:
    # "step" (default) runs it fresh for every SQP iteration's QP — the
    # reference behavior (CuCaQP full re-setup per iteration,
    # CuCaQP.cpp:271-288 -> OSQP setup scaling).  "tick" computes the
    # scalings ONCE per solve call from the first linearization and
    # reuses them across all SQP iterations: the scalings are a pure
    # preconditioner (termination tests run on UNSCALED residuals either
    # way, and per-row rho types are shift-invariant), so semantics are
    # OSQP-exact while the per-step prepare cost drops by ~scaling_iters
    # passes over the operator blocks.  Warm-started MPC re-linearizes
    # near the previous iterate, so the stale preconditioner costs at
    # most a few ADMM iterations (measured: none at steady state).
    scaling_refresh: str = "step"
    adaptive_rho: bool = True
    adaptive_rho_interval: int = 100
    adaptive_rho_tolerance: float = 5.0
    method: str = "kkt"  # "kkt" (robust, quasi-definite) | "condensed" (fast)
    # Linear solver inside method="banded": "thomas" (block LDL^T scan,
    # O(N) depth — right when a large scenario batch fills each scan step)
    # or "cr" (odd-even cyclic reduction, ~2 log2 N depth at ~2x flops —
    # right for small batches / long horizons where the scan's sequential
    # latency dominates).
    banded_solver: str = "thomas"
    # Iteration-loop backend: "xla" (lax.while_loop) or "pallas" (fused
    # in-VMEM device loops).  On the per-scenario dense path this is
    # ops/admm_kernel.py (condensed only, no adaptive rho; the win for
    # vmapped nonlinear models).  On the shared-factorization batched path
    # it is ops/shared_kernel.py (condensed only, full adaptive rho +
    # certificates via chunked re-entry) — measured at parity with the XLA
    # loop at flagship sizes (the XLA loop already hides the panel HBM
    # traffic), kept as a validated alternative; see docs/PERFORMANCE.md.
    # The Pallas kernels compute at fixed f32-HIGHEST; when combined with
    # precision != "highest" the shared-factorization path falls back to
    # the XLA loop so the two backends cannot silently diverge.
    backend: str = "xla"
    # Matmul precision for solver-internal linear algebra.  "highest"
    # (6-pass) is the safe default on TPU (see f32_matmuls); "high"
    # (3-pass bf16) trades ~2x matmul cost for a slightly earlier float32
    # noise floor - validate convergence before enabling.
    precision: str = "highest"
    # Precision of the ITERATION GEMMs only (shared-factorization condensed
    # path, XLA and Pallas backends).  Unlike ``precision`` (which lowers
    # everything, including the termination residuals — measured in round 3
    # to balloon iteration counts ~17x because the residual check itself
    # floats on the 3-pass noise floor), this knob keeps the RESIDUAL
    # matvecs and the factorization at "highest" and lowers only the
    # per-iteration x/z-update products:
    #   "highest" — 6-pass everywhere (default; bit-compatible with r04);
    #   "high"    — all three iteration GEMMs at 3-pass.  Termination still
    #               requires the full-precision residuals to pass, so a
    #               solution that terminates is exactly as accurate as the
    #               default path; the risk is extra iterations if 3-pass
    #               noise stalls the fixed point above eps (measure!);
    #   "mixed"   — x-update chain (rhs assembly + solve) at 3-pass, but
    #               the z-projection argument ``zt = xt @ A^T`` at 6-pass:
    #               zt feeds the RUNNING dual accumulator y directly, so
    #               this variant keeps noise out of the one quantity that
    #               integrates across iterations.
    iter_precision: str = "highest"
    # Single-GEMM condensed iteration (shared-factorization batched path
    # only): algebraically fold the three per-iteration products
    # (rhs assembly, x-update, z-projection argument) into ONE
    # (B, n+m) @ (n+m, n+m) GEMM against the precomputed block operator
    # [[OP, OP A^T], [A OP, A OP A^T]].  ~1.6x the flops of the 3-GEMM
    # form but one MXU launch instead of three at a better aspect ratio —
    # wins when the per-iteration GEMMs are pipeline-bound, which is what
    # the headline roofline measured (26% MFU, docs/PERFORMANCE.md).
    # Same fixed point and tolerances; f32 accumulation differs from the
    # 3-GEMM form, so iterates are not bitwise comparable.
    fused_gemm: bool = False
    # OSQP-style solution polishing: after convergence, re-solve the
    # equality-constrained KKT system on the detected active set (masked
    # formulation, delta-regularized, one iterative-refinement step) and
    # accept the polished point if it improves both residuals.  Lifts
    # accuracy from the 1e-3 ADMM tolerance to near float32 precision.
    polish: bool = False
    polish_delta: float = 1e-6
    # OSQP infeasibility detection (Banjac et al., "Infeasibility detection
    # in the ADMM algorithm"): the successive-iterate differences delta_x /
    # delta_y converge to dual / primal infeasibility certificates when the
    # QP is unbounded / infeasible.  Checked every ``check_every`` iterations
    # on unscaled quantities; tolerances are the OSQP defaults.
    check_infeasibility: bool = True
    eps_prim_inf: float = 1e-4
    eps_dual_inf: float = 1e-4

    def __post_init__(self):
        if self.scaling_refresh not in ("step", "tick"):
            raise ValueError(
                f"scaling_refresh must be 'step' or 'tick', got "
                f"{self.scaling_refresh!r}"
            )
        if self.banded_solver not in ("thomas", "cr"):
            raise ValueError(
                f"banded_solver must be 'thomas' or 'cr', got "
                f"{self.banded_solver!r}"
            )
        if self.iter_precision not in ("highest", "high", "mixed"):
            raise ValueError(
                f"iter_precision must be 'highest', 'high' or 'mixed', "
                f"got {self.iter_precision!r}"
            )

    def replace(self, **kw) -> "ADMMSettings":
        return dataclasses.replace(self, **kw)


class QPSolution(NamedTuple):
    x: torch.Tensor  # primal solution (n,)
    y: torch.Tensor  # dual solution (m,)
    z: torch.Tensor  # constraint-space iterate, z in [l, u] (m,)
    iters: torch.Tensor  # iterations used (scalar int32)
    converged: torch.Tensor  # bool scalar
    r_prim: torch.Tensor  # final unscaled primal residual (inf-norm)
    r_dual: torch.Tensor  # final unscaled dual residual (inf-norm)
    # OSQP-style infeasibility certificates.  When ``prim_inf`` is True the
    # problem is primal infeasible and delta-y (not returned; its direction
    # is ``y``'s divergence ray) certifies it; ``dual_inf`` marks an
    # unbounded (dual-infeasible) problem.  Both False for the Pallas
    # backend and for solvers that predate the check.
    prim_inf: torch.Tensor = False  # noqa: RUF009 - NamedTuple default
    dual_inf: torch.Tensor = False


def _limit_scaling(v: torch.Tensor) -> torch.Tensor:
    """OSQP ``limit_scaling``: tiny norms -> 1 (no scaling), clamp large."""
    v = torch.where(v < _MIN_SCALING, torch.ones_like(v), v)
    return torch.clamp(v, max=_MAX_SCALING)
