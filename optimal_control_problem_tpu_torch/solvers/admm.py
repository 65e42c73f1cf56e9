"""OSQP-style ADMM quadratic-program solver — port of
``optimal_control_problem_tpu/solvers/admm.py``.

Solved problem (OSQP standard form)::

    minimize    1/2 x^T P x + q^T x
    subject to  l <= A x <= u

``ADMMSettings`` is copied field for field (a frozen, hashable dataclass);
``QPSolution``, the OSQP rho limits and the Ruiz scaling limits come along
with it.  Ported with the LTI slice: ``ruiz_equilibrate``, ``_rho_vec``,
``_factor`` (condensed and quasi-definite KKT, explicit inverses through
``torch.linalg.inv`` as JAX uses ``jnp.linalg.inv``), ``admm_solve`` (both
methods, adaptive rho with refactorization, infeasibility certificates,
warm start) and ``_polish``.  ``admm_solve`` is eager PyTorch with a Python
loop for one problem at a time: it reads the termination flags on the host
at every check block, where the JAX version runs a ``lax.while_loop``.

Not ported yet, each raising ``NotImplementedError``: ``backend="pallas"``
on this per-problem path (the dense device-loop kernel, ``ROADMAP.md``
Queue B5) and the ``precision`` / ``iter_precision`` variants (Queue A8c).

The JAX module's ``f32_matmuls`` has no counterpart here: the package
switches TF32 off once at import (``__init__.py``), so every product is
true float32.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

__all__ = [
    "ADMMSettings",
    "QPSolution",
    "admm_solve",
    "ruiz_equilibrate",
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
    # Iteration-loop backend.  The strings are the JAX package's, so that
    # YAML configs carry over; here they mean:
    #   "xla"    — the loop written in PyTorch ops (its products are
    #              ``torch.matmul``, true f32);
    #   "pallas" — the hand-written CUDA kernel of the path.  On the
    #              shared-factorization batched path that is
    #              ops/shared_kernel.py (condensed only, full adaptive rho +
    #              certificates via chunked re-entry).  On the per-scenario
    #              dense path it is not ported yet (ROADMAP Queue B5).
    backend: str = "xla"
    # Matmul precision for solver-internal linear algebra.  Only "highest"
    # (true f32 everywhere) is ported; the JAX package's lower settings map
    # to a tensor-core decision on this card that is still open (ROADMAP
    # Queue A8c), so any other value raises NotImplementedError.
    precision: str = "highest"
    # Precision of the ITERATION GEMMs only (shared-factorization condensed
    # path): "highest" | "high" | "mixed" in the JAX package.  Only
    # "highest" is ported (ROADMAP Queue A8c).
    iter_precision: str = "highest"
    # Single-GEMM condensed iteration (shared-factorization batched path
    # only): algebraically fold the three per-iteration products
    # (rhs assembly, x-update, z-projection argument) into ONE
    # (B, n+m) @ (n+m, n+m) GEMM against the precomputed block operator
    # [[OP, OP A^T], [A OP, A OP A^T]].  ~1.6x the flops of the 3-GEMM
    # form but one product instead of three ("xla" backend only).
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


def require_highest_precision(st: ADMMSettings) -> None:
    """Only true-f32 products are ported; see ``ADMMSettings.precision``."""
    if st.precision != "highest" or st.iter_precision != "highest":
        raise NotImplementedError(
            f"precision={st.precision!r} / iter_precision={st.iter_precision!r} are "
            "not ported yet: the port computes in true float32 only "
            "(ROADMAP Queue A8c: precision variants)"
        )


def ruiz_equilibrate(P, q, A, iters: int):
    """Modified Ruiz equilibration of [[P, A^T], [A, 0]] with cost scaling.

    Returns (Pb, qb, Ab, D, E, c) such that Pb = c*D@P@D, qb = c*D*q,
    Ab = E*A*D (diagonal scalings as vectors).  Mirrors OSQP ``scale.c``.
    """
    n = P.shape[0]
    m = A.shape[0]
    D = torch.ones((n,), dtype=P.dtype, device=P.device)
    E = torch.ones((m,), dtype=P.dtype, device=P.device)
    c = torch.ones((), dtype=P.dtype, device=P.device)
    for _ in range(iters):
        Pb = c * (D[:, None] * P * D[None, :])
        Ab = E[:, None] * A * D[None, :]
        # column inf-norms of [Pb; Ab] -> x-block scaling
        norm_x = Pb.abs().amax(dim=0)
        if m:
            norm_x = torch.maximum(norm_x, Ab.abs().amax(dim=0))
        D = D * (1.0 / torch.sqrt(_limit_scaling(norm_x)))
        if m:
            # row inf-norms of Ab -> constraint-block scaling
            E = E * (1.0 / torch.sqrt(_limit_scaling(Ab.abs().amax(dim=1))))
        # cost scaling: gamma = 1/max(mean col-norm of Pb, ||qb||_inf)
        Pb = c * (D[:, None] * P * D[None, :])
        qb = c * D * q
        mean_pcol = Pb.abs().amax(dim=0).mean()
        c = c * (1.0 / _limit_scaling(torch.maximum(mean_pcol, qb.abs().max())))
    Pb = c * (D[:, None] * P * D[None, :])
    qb = c * D * q
    Ab = E[:, None] * A * D[None, :]
    return Pb, qb, Ab, D, E, c


def _rho_vec(l, u, rho):
    """Per-row rho: loose bounds -> RHO_MIN, equalities -> rho * 1e3 (OSQP).
    ``rho`` is a 0-dim tensor of the working dtype."""
    inf = float("inf")
    loose = (l <= -inf) & (u >= inf)
    eq = (u - l) < _RHO_TOL
    rho_v = rho.expand(l.shape)
    rho_v = torch.where(eq, torch.clamp(rho * _RHO_EQ_OVER_RHO_INEQ, _RHO_MIN, _RHO_MAX), rho_v)
    return torch.where(loose, torch.full_like(rho_v, _RHO_MIN), rho_v)


def _factor(Pb, Ab, rho_v, sigma, method: str):
    """Precompute the per-iteration solve operator as an explicit inverse."""
    n = Pb.shape[0]
    m = Ab.shape[0]
    eye = torch.eye(n, dtype=Pb.dtype, device=Pb.device)
    if method == "condensed":
        M = Pb + sigma * eye + (Ab.T * rho_v[None, :]) @ Ab
        return torch.linalg.inv(M)
    # Quasi-definite KKT matrix [[P + sigma I, A^T], [A, -diag(1/rho)]]:
    # always invertible, tolerates indefinite P.
    K = torch.zeros((n + m, n + m), dtype=Pb.dtype, device=Pb.device)
    K[:n, :n] = Pb + sigma * eye
    K[:n, n:] = Ab.T
    K[n:, :n] = Ab
    K[n:, n:] = torch.diag(-1.0 / rho_v)
    return torch.linalg.inv(K)


def admm_solve(
    P: torch.Tensor,
    q: torch.Tensor,
    A: torch.Tensor,
    l: torch.Tensor,
    u: torch.Tensor,
    settings: ADMMSettings = ADMMSettings(),
    x0: Optional[torch.Tensor] = None,
    y0: Optional[torch.Tensor] = None,
) -> QPSolution:
    """Solve one QP on the device of ``P``.  All arrays dense; use IEEE
    +-inf for absent bounds.  ``x0``/``y0`` warm-start the iteration (OSQP
    ``warm_start``)."""
    st = settings
    require_highest_precision(st)
    if st.backend == "pallas":
        raise NotImplementedError(
            "backend='pallas' on the per-problem dense path is the device-loop "
            "kernel, which is not ported yet (ROADMAP Queue B5)"
        )
    dtype, dev = P.dtype, P.device
    n = P.shape[0]
    m = A.shape[0]
    q, A, u = q.to(dtype), A.to(dtype), u.to(dtype)
    # Guard against inverted bounds from float noise.
    l = torch.minimum(l.to(dtype), u)

    def scalar(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    sigma = scalar(st.sigma)
    alpha = scalar(st.alpha)
    inf = scalar(float("inf"))

    Pb, qb, Ab, D, E, c = ruiz_equilibrate(P, q, A, st.scaling_iters)
    lb = E * l
    ub = E * u
    rho_v = _rho_vec(lb, ub, scalar(st.rho))
    OP = _factor(Pb, Ab, rho_v, sigma, st.method)

    x = torch.zeros((n,), dtype=dtype, device=dev) if x0 is None else x0.to(dtype) / D
    y = torch.zeros((m,), dtype=dtype, device=dev) if y0 is None else c * y0.to(dtype) / E
    z = torch.minimum(torch.maximum(Ab @ x, lb), ub)
    Einv = 1.0 / E
    Dinv = 1.0 / D
    cinv = 1.0 / c

    def one_iter(x, z, y, rho_v, OP):
        if st.method == "condensed":
            rhs = sigma * x - qb + Ab.T @ (rho_v * z - y)
            xt = OP @ rhs
            zt = Ab @ xt
        else:
            rhs = torch.cat([sigma * x - qb, z - y / rho_v])
            sol = OP @ rhs
            xt = sol[:n]
            zt = z + (sol[n:] - y) / rho_v
        x_new = alpha * xt + (1 - alpha) * x
        z_relaxed = alpha * zt + (1 - alpha) * z
        z_new = torch.minimum(torch.maximum(z_relaxed + y / rho_v, lb), ub)
        y_new = y + rho_v * (z_relaxed - z_new)
        return x_new, z_new, y_new

    def amax(v):
        return v.abs().max()

    def residuals(x, z, y):
        Ax = Ab @ x
        Px = Pb @ x
        Aty = Ab.T @ y
        zero = scalar(0.0)
        r_prim = amax((Ax - z) * Einv) if m else zero
        r_dual = cinv * amax((Px + qb + Aty) * Dinv)
        max_prim = torch.maximum(amax(Ax * Einv), amax(z * Einv)) if m else zero
        max_dual = cinv * torch.maximum(
            torch.maximum(amax(Aty * Dinv) if m else zero, amax(Px * Dinv)), amax(qb * Dinv)
        )
        eps_pri = st.eps_abs + st.eps_rel * max_prim
        eps_dua = st.eps_abs + st.eps_rel * max_dual
        return r_prim, r_dual, eps_pri, eps_dua, max_prim, max_dual

    def infeasibility_certificates(dx_u, dy_u):
        """OSQP is_primal_infeasible / is_dual_infeasible on the unscaled
        changes of (x, y) over one check block, against the ORIGINAL
        P, q, A, l, u (auxil.c)."""
        tiny = 1e-12
        if m:
            ndy = amax(dy_u)
            dy_p = torch.clamp(dy_u, min=0.0)
            dy_m = torch.clamp(dy_u, max=0.0)
            # Masked products so inf * 0 cannot produce NaN; an infinite
            # bound with matching delta sign yields +inf, which correctly
            # blocks certification.
            t_u = torch.where(dy_p > 0, u * dy_p, torch.zeros_like(u))
            t_l = torch.where(dy_m < 0, l * dy_m, torch.zeros_like(l))
            support = torch.sum(t_u + t_l)
            n_Atdy = amax(A.T @ dy_u)
            prim_inf = bool(
                (ndy > tiny)
                & (support < -st.eps_prim_inf * ndy)
                & (n_Atdy < st.eps_prim_inf * ndy)
            )
        else:
            prim_inf = False
        ndx = amax(dx_u)
        thr = st.eps_dual_inf * ndx
        cond = (ndx > tiny) & ((q @ dx_u) < -thr) & (amax(P @ dx_u) < thr)
        if m:
            Adx = A @ dx_u
            cond = cond & torch.all((u >= inf) | (Adx < thr)) & torch.all((l <= -inf) | (Adx > -thr))
        return prim_inf, bool(cond)

    # Round-based iteration: rho (and the factorization) are constant for
    # one adaptation interval, adaptation happens BETWEEN rounds.
    adaptive = st.adaptive_rho and m > 0
    if adaptive:
        interval = max(st.adaptive_rho_interval, st.check_every)
        interval = -(-interval // st.check_every) * st.check_every
    else:
        interval = st.max_iter

    it = 0
    done = pinf = dinf = False
    r_prim = r_dual = inf
    while it < st.max_iter and not (done or pinf or dinf):
        k = 0
        max_prim = max_dual = inf
        while k < interval and it + k < st.max_iter and not (done or pinf or dinf):
            x_old, y_old = x, y
            for _ in range(st.check_every):
                x, z, y = one_iter(x, z, y, rho_v, OP)
            r_prim, r_dual, eps_pri, eps_dua, max_prim, max_dual = residuals(x, z, y)
            done = bool((r_prim <= eps_pri) & (r_dual <= eps_dua))
            if st.check_infeasibility:
                pinf, dinf = infeasibility_certificates(D * (x - x_old), E * (y - y_old) / c)
                pinf = pinf and not done
                dinf = dinf and not done
            k += st.check_every
        it += k
        if adaptive:
            # OSQP adaptive rho: rescale by sqrt(relative residual ratio)
            # and refactor when the change crosses the tolerance.
            num = r_prim / torch.clamp(max_prim, min=1e-10)
            den = r_dual / torch.clamp(max_dual, min=1e-10)
            scale = torch.clamp(torch.sqrt(num / torch.clamp(den, min=1e-10)), 1e-3, 1e3)
            trigger = bool(
                (scale > st.adaptive_rho_tolerance) | (scale < 1.0 / st.adaptive_rho_tolerance)
            )
            if trigger and not done:
                rho_v = torch.clamp(rho_v * scale, _RHO_MIN, _RHO_MAX)
                OP = _factor(Pb, Ab, rho_v, sigma, st.method)

    if st.polish and m:
        x, y, z, r_prim, r_dual = _polish(
            Pb, qb, Ab, lb, ub, x, y, z, r_prim, r_dual, residuals, st
        )

    flag = lambda b: torch.as_tensor(b, dtype=torch.bool, device=dev)  # noqa: E731
    # Unscale: x = D xbar, y = E ybar / c, z = zbar / E.
    return QPSolution(
        x=D * x,
        y=E * y / c,
        z=z / E,
        iters=torch.as_tensor(it, dtype=torch.int32, device=dev),
        converged=flag(done),
        r_prim=r_prim,
        r_dual=r_dual,
        prim_inf=flag(pinf),
        dual_inf=flag(dinf),
    )


def _polish(Pb, qb, Ab, lb, ub, x, y, z, r_prim, r_dual, residuals, st):
    """OSQP solution polishing (masked active-set KKT re-solve).

    Active rows are those where the ADMM iterate sits on a bound with the
    matching dual sign (OSQP ``polish.c`` semantics).  The KKT system is
    formed with a row mask S::

        [[P + dI,  (S A)^T], [S A,  S - I - dI]] [x; nu] = [-q; S b]

    giving ``A_i x = b_i`` on active rows and ``nu_i = 0`` on inactive ones.
    One iterative-refinement step against the unregularized system follows;
    the polished point is accepted only if it improves both residuals.
    """
    n = Pb.shape[0]
    m = Ab.shape[0]
    dtype, dev = Pb.dtype, Pb.device
    delta = st.polish_delta
    lower_active = y < 0.0
    upper_active = y > 0.0
    active = lower_active | upper_active
    b_act = torch.where(upper_active, ub, torch.where(lower_active, lb, torch.zeros_like(lb)))
    S = active.to(dtype)

    SA = S[:, None] * Ab
    K = torch.zeros((n + m, n + m), dtype=dtype, device=dev)
    K[:n, :n] = Pb + delta * torch.eye(n, dtype=dtype, device=dev)
    K[:n, n:] = SA.T
    K[n:, :n] = SA
    K[n:, n:] = torch.diag(S - 1.0 - delta)
    rhs = torch.cat([-qb, S * b_act])
    Kinv = torch.linalg.inv(K)
    sol = Kinv @ rhs
    # One iterative-refinement step vs the unregularized KKT operator.
    K0 = K - delta * torch.eye(n + m, dtype=dtype, device=dev)
    sol = sol + Kinv @ (rhs - K0 @ sol)

    x_p = sol[:n]
    y_p = torch.where(active, sol[n:], torch.zeros_like(y))
    z_p = torch.minimum(torch.maximum(Ab @ x_p, lb), ub)
    rp_p, rd_p, _, _, _, _ = residuals(x_p, z_p, y_p)
    if bool((rp_p <= r_prim) & (rd_p <= r_dual)):
        return x_p, y_p, z_p, rp_p, rd_p
    return x, y, z, r_prim, r_dual
