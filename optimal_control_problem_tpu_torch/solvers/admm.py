"""OSQP-style ADMM quadratic-program solver — port of
``optimal_control_problem_tpu/solvers/admm.py``.

Solved problem (OSQP standard form)::

    minimize    1/2 x^T P x + q^T x
    subject to  l <= A x <= u

``ADMMSettings`` is copied field for field (a frozen, hashable dataclass);
``QPSolution``, the OSQP rho limits and the Ruiz scaling limits come along
with it.  Ported: ``ruiz_equilibrate``, ``_rho_vec``, ``_factor`` (condensed
and quasi-definite KKT, explicit inverses through ``torch.linalg.inv`` as
JAX uses ``jnp.linalg.inv``) and ``_polish``, each over any leading batch
dims; ``admm_solve`` (both methods, both backends, adaptive rho with
refactorization, infeasibility certificates, warm start, polish) and its
batched counterpart :func:`admm_solve_batch`, the port of
``jax.vmap(admm_solve)``, which ``admm_solve`` runs with a batch of one.
Both are eager PyTorch: the loop conditions are read on the host once per
check block (``backend="xla"``) or kernel entry (``backend="pallas"``, the
device-loop kernel of ``ops/admm_kernel.py``), where the JAX version runs a
``lax.while_loop``; ``on_device=True`` runs them as a ``torch.while_loop``
instead, the form ``torch.export`` traces.

``settings.precision`` is JAX's ``jax.default_matmul_precision`` around
the whole solve: every product here (the factorization's ``A^T R A``, the
iterations, residuals, certificates and polish) runs at it through
:func:`..ops.shared_kernel.precision_matmul` (``"highest"`` true f32,
``"high"`` bf16_3x, ``"default"`` one bf16 pass); the explicit inverses
stay ``torch.linalg.inv`` and the device-loop kernel stays f32, as JAX's
Pallas kernel does.

:func:`f32_matmuls` is the JAX module's guard of the same name: the
package switches TF32 off once at import (``__init__.py``), and every
solve entry point runs inside this scope as well, so a caller that turns
TF32 on again (``torch.set_float32_matmul_precision("high")``) cannot
reach the solver's products.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from ..device import as_tensors
from ..ops.admm_kernel import admm_device_loop
from ..ops.shared_kernel import PRECISION_NAMES, precision_matmul

__all__ = [
    "ADMMSettings",
    "DensePrep",
    "QPSolution",
    "admm_solve",
    "admm_solve_batch",
    "check_pallas_size",
    "f32_matmuls",
    "prepare_dense",
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
    #              dense path (condensed only) it is ops/admm_kernel.py, one
    #              kernel entry per adaptive-rho round.
    backend: str = "xla"
    # Matmul precision for solver-internal linear algebra (JAX's
    # jax.default_matmul_precision around the dense and shared solves):
    # "highest" true f32 (TF32 stays off), "high" the TPU's bf16_3x (each
    # f32 operand split into bf16 hi + lo, hi hi + hi lo + lo hi summed in
    # f32), "default" one bf16 pass.  The hand kernels compute at
    # "highest"; with another value the shared path takes the "xla" loop,
    # as JAX's does.
    precision: str = "highest"
    # Precision of the ITERATION GEMMs only (shared-factorization condensed
    # path, both backends): "highest"; "high" (all three iteration
    # products at bf16_3x); "mixed" (the rhs and x products at bf16_3x,
    # ``zt = xt @ A^T`` at "highest").  The termination residuals and
    # certificates stay at ``precision``, so a scenario that stops is
    # certified at it.  On the card "pallas" runs them on the tensor cores
    # (ops/shared_kernel.py).
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
        if self.precision not in PRECISION_NAMES:
            raise ValueError(
                f"precision must be one of {sorted(PRECISION_NAMES)}, got "
                f"{self.precision!r}"
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
    # unbounded (dual-infeasible) problem.  Both False when
    # ``check_infeasibility`` is off.
    prim_inf: torch.Tensor = False  # noqa: RUF009 - NamedTuple default
    dual_inf: torch.Tensor = False


def _tf32_flags():
    """The TF32 switches as ``(read, write, off)``: the global matmul
    precision, the legacy booleans of cuBLAS and cuDNN, then the newer
    ``fp32_precision`` strings where this torch has them (``"ieee"`` is
    true float32)."""
    b = torch.backends
    flags = [
        (torch.get_float32_matmul_precision, torch.set_float32_matmul_precision, "highest"),
        (lambda: b.cuda.matmul.allow_tf32,
         lambda v: setattr(b.cuda.matmul, "allow_tf32", v), False),
        (lambda: b.cudnn.allow_tf32, lambda v: setattr(b.cudnn, "allow_tf32", v), False),
    ]
    for mod in (b.cuda.matmul, getattr(b.cudnn, "conv", None), getattr(b.cudnn, "rnn", None)):
        try:
            mod.fp32_precision  # noqa: B018 - probes the attribute
        except (AttributeError, RuntimeError):
            continue
        flags.append((lambda m=mod: m.fp32_precision,
                      lambda v, m=mod: setattr(m, "fp32_precision", v), "ieee"))
    return flags


@contextlib.contextmanager
def _f32_scope():
    flags = _tf32_flags()
    saved = []
    for read, _, _ in flags:
        try:
            saved.append(read())
        except RuntimeError:  # torch refuses to read a mix of both APIs
            saved.append(None)
    for _, write, off in flags:
        write(off)
    try:
        yield
    finally:
        # The global precision, the legacy booleans, then the precision
        # strings: the later are the finer state and win where they
        # disagree.
        for (_, write, _), value in zip(flags, saved):
            if value is not None:
                write(value)


def f32_matmuls(fn=None):
    """True float32 products inside: TF32 off for cuBLAS and cuDNN (and
    ``fp32_precision = "ieee"`` where torch has it), restored on exit —
    the port of the JAX module's guard, which scopes HIGHEST matmul
    precision around every solver function.  A decorator (``@f32_matmuls``)
    or, called bare, a context manager (``with f32_matmuls():``)."""
    if fn is None:
        return _f32_scope()

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _f32_scope():
            return fn(*args, **kwargs)

    return wrapped


def _limit_scaling(v: torch.Tensor) -> torch.Tensor:
    """OSQP ``limit_scaling``: tiny norms -> 1 (no scaling), clamp large."""
    v = torch.where(v < _MIN_SCALING, torch.ones_like(v), v)
    return torch.clamp(v, max=_MAX_SCALING)


def _mv(M: torch.Tensor, v: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """``M @ v`` over any leading batch dims: ``M (..., r, c)``, ``v (..., c)``,
    at ``precision`` (:func:`..ops.shared_kernel.precision_matmul`)."""
    return precision_matmul(M, v.unsqueeze(-1), precision).squeeze(-1)


def ruiz_equilibrate(P, q, A, iters: int, *, device=None):
    """Modified Ruiz equilibration of [[P, A^T], [A, 0]] with cost scaling.

    Returns (Pb, qb, Ab, D, E, c) such that Pb = c*D@P@D, qb = c*D*q,
    Ab = E*A*D (diagonal scalings as vectors).  Mirrors OSQP ``scale.c``.
    Any leading batch dims scale each problem on its own (``c`` then has
    the batch shape), with the single problem's operation order.  Arrays
    that are not tensors go to ``device`` (:func:`..device.as_tensors`).
    """
    P, q, A = as_tensors(P, q, A, device=device)
    n = P.shape[-1]
    m = A.shape[-2]
    batch = P.shape[:-2]
    D = torch.ones(batch + (n,), dtype=P.dtype, device=P.device)
    E = torch.ones(batch + (m,), dtype=P.dtype, device=P.device)
    c = torch.ones(batch, dtype=P.dtype, device=P.device)

    def scaled_P(D, c):
        return c[..., None, None] * (D[..., :, None] * P * D[..., None, :])

    for _ in range(iters):
        Pb = scaled_P(D, c)
        Ab = E[..., :, None] * A * D[..., None, :]
        # column inf-norms of [Pb; Ab] -> x-block scaling
        norm_x = Pb.abs().amax(dim=-2)
        if m:
            norm_x = torch.maximum(norm_x, Ab.abs().amax(dim=-2))
        D = D * (1.0 / torch.sqrt(_limit_scaling(norm_x)))
        if m:
            # row inf-norms of Ab -> constraint-block scaling
            E = E * (1.0 / torch.sqrt(_limit_scaling(Ab.abs().amax(dim=-1))))
        # cost scaling: gamma = 1/max(mean col-norm of Pb, ||qb||_inf)
        Pb = scaled_P(D, c)
        qb = c[..., None] * D * q
        mean_pcol = Pb.abs().amax(dim=-2).mean(dim=-1)
        c = c * (1.0 / _limit_scaling(torch.maximum(mean_pcol, qb.abs().amax(dim=-1))))
    Pb = scaled_P(D, c)
    qb = c[..., None] * D * q
    Ab = E[..., :, None] * A * D[..., None, :]
    return Pb, qb, Ab, D, E, c


def _fresh(ts):
    """Copies of a tuple of tensors (nested tuples too), each with its
    strides (a column-major inverse stays one: the products' rounding
    follows the layout): a ``torch.while_loop`` takes no carried or
    returned tensor that aliases another."""
    return tuple(_fresh(t) if isinstance(t, tuple) else t.clone() for t in ts)


def _rho_vec(l, u, rho):
    """Per-row rho: loose bounds -> RHO_MIN, equalities -> rho * 1e3 (OSQP).
    ``rho`` is a 0-dim tensor of the working dtype; ``l``/``u`` may carry
    leading batch dims."""
    inf = float("inf")
    loose = (l <= -inf) & (u >= inf)
    eq = (u - l) < _RHO_TOL
    rho_v = rho.expand(l.shape)
    rho_v = torch.where(eq, torch.clamp(rho * _RHO_EQ_OVER_RHO_INEQ, _RHO_MIN, _RHO_MAX), rho_v)
    return torch.where(loose, torch.full_like(rho_v, _RHO_MIN), rho_v)


def _inv(M: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.inv`` that, like ``jnp.linalg.inv``, never raises: a
    singular operator (a diverged nonconvex QP of the parity preset) gives
    non-finite entries, and the solve goes on to NaN as JAX's does.  The
    values are ``torch.linalg.inv``'s wherever that succeeds."""
    return torch.linalg.inv_ex(M)[0]


def _factor(Pb, Ab, rho_v, sigma, method: str, precision: str = "highest"):
    """Precompute the per-iteration solve operator as an explicit inverse
    (of each problem, over any leading batch dims); ``A^T R A`` at
    ``precision``."""
    n = Pb.shape[-1]
    m = Ab.shape[-2]
    eye = torch.eye(n, dtype=Pb.dtype, device=Pb.device)
    AbT = Ab.transpose(-1, -2)
    if method == "condensed":
        M = Pb + sigma * eye + precision_matmul(AbT * rho_v[..., None, :], Ab, precision)
        return _inv(M)
    # Quasi-definite KKT matrix [[P + sigma I, A^T], [A, -diag(1/rho)]]:
    # always invertible, tolerates indefinite P.
    K = torch.zeros(Pb.shape[:-2] + (n + m, n + m), dtype=Pb.dtype, device=Pb.device)
    K[..., :n, :n] = Pb + sigma * eye
    K[..., :n, n:] = AbT
    K[..., n:, :n] = Ab
    K[..., n:, n:] = torch.diag_embed(-1.0 / rho_v)
    return _inv(K)


class DensePrep(NamedTuple):
    """A batch of dense QPs after the prepare stage (batch-leading): the
    scaled problem, its Ruiz scalings, per-row rho and the operator."""

    Pb: torch.Tensor  # (B, n, n) c D P D
    qb: torch.Tensor  # (B, n) c D q
    Ab: torch.Tensor  # (B, m, n) E A D
    lb: torch.Tensor  # (B, m) E l
    ub: torch.Tensor  # (B, m) E u
    D: torch.Tensor  # (B, n)
    E: torch.Tensor  # (B, m)
    c: torch.Tensor  # (B,)
    rho_v: torch.Tensor  # (B, m)
    OP: torch.Tensor  # (B, n, n) condensed or (B, n+m, n+m) KKT inverse


def prepare_dense(P, q, A, l, u, settings: ADMMSettings) -> DensePrep:
    """Equilibrate, choose per-row rho and factor each problem of a batch
    (``l <= u`` already)."""
    st = settings
    dtype, dev = P.dtype, P.device
    Pb, qb, Ab, D, E, c = ruiz_equilibrate(P, q, A, st.scaling_iters)
    lb = E * l
    ub = E * u
    rho_v = _rho_vec(lb, ub, torch.as_tensor(st.rho, dtype=dtype, device=dev))
    OP = _factor(Pb, Ab, rho_v, torch.as_tensor(st.sigma, dtype=dtype, device=dev), st.method,
                 st.precision)
    return DensePrep(Pb, qb, Ab, lb, ub, D, E, c, rho_v, OP)


def check_pallas_size(n: int, m: int) -> None:
    """The JAX package's size guard of the dense ``"pallas"`` path
    (``solvers/admm.py``, its VMEM budget for one QP's operators), copied
    so that the port raises exactly where JAX's does; the device loop
    itself takes any size (``ops/admm_kernel.kernel_tier``)."""
    vmem_bytes = 4 * (2 * n * n + 2 * m * n + 4 * (n + m))
    if vmem_bytes > 40 * 1024 * 1024:
        raise ValueError(
            f"backend='pallas' would need ~{vmem_bytes / 1e6:.1f} MB of VMEM for this "
            f"problem size (n={n}, m={m}) in the JAX package, whose limit the port "
            "keeps; use backend='xla' or method='banded'"
        )


@f32_matmuls
def admm_solve(
    P: torch.Tensor,
    q: torch.Tensor,
    A: torch.Tensor,
    l: torch.Tensor,
    u: torch.Tensor,
    settings: ADMMSettings = ADMMSettings(),
    x0: Optional[torch.Tensor] = None,
    y0: Optional[torch.Tensor] = None,
    on_device: bool = False,
    *,
    device=None,
) -> QPSolution:
    """Solve one QP on the device of ``P``.  All arrays dense; use IEEE
    +-inf for absent bounds.  ``x0``/``y0`` warm-start the iteration (OSQP
    ``warm_start``).  A batch of one through :func:`admm_solve_batch`
    (with ``backend="pallas"``, one scenario in the device-loop kernel;
    ``on_device`` as there).  Arrays that are not tensors go to ``device``
    (:func:`..device.as_tensors`: by default the first tensor's device,
    else ``cuda``)."""
    P, q, A, l, u, x0, y0 = as_tensors(P, q, A, l, u, x0, y0, device=device)
    one = lambda a: None if a is None else a[None]  # noqa: E731
    sol = admm_solve_batch(P[None], q[None], A[None], l[None], u[None], settings,
                           one(x0), one(y0), on_device)
    return QPSolution(*(f[0] for f in sol))


@f32_matmuls
def admm_solve_batch(
    P: torch.Tensor,
    q: torch.Tensor,
    A: torch.Tensor,
    l: torch.Tensor,
    u: torch.Tensor,
    settings: ADMMSettings = ADMMSettings(),
    x0: Optional[torch.Tensor] = None,
    y0: Optional[torch.Tensor] = None,
    on_device: bool = False,
    *,
    device=None,
) -> QPSolution:
    """Solve B independent QPs, ``P (B, n, n)``, ``q (B, n)``, ``A (B, m, n)``,
    ``l``/``u (B, m)``, warm starts ``x0 (B, n)``/``y0 (B, m)``: the port's
    ``jax.vmap(admm_solve)``.  Returns a :class:`QPSolution` with leading
    batch dims (``iters (B,)`` int32).

    Each scenario follows its own unbatched solve: its own iteration count,
    flags, residuals, adaptive rho (only the scenarios whose rule triggers
    are refactored) and polish; a scenario that has stopped keeps its
    iterates while the loop runs until every scenario has stopped.  The
    loop conditions are read on the host once per check block
    (``backend="xla"``) or kernel entry (``"pallas"``); ``on_device`` keeps
    them on the device instead (``torch.while_loop``; the same results),
    the form ``torch.export`` traces, the device loop one op node.  Arrays
    that are not tensors go to ``device`` as in :func:`admm_solve`.
    """
    P, q, A, l, u, x0, y0 = as_tensors(P, q, A, l, u, x0, y0, device=device)
    st = settings
    if st.backend == "pallas":
        if st.method != "condensed":
            raise ValueError("backend='pallas' requires method='condensed'")
        check_pallas_size(P.shape[-1], A.shape[-2])
    dtype = P.dtype
    q, A, u = q.to(dtype), A.to(dtype), u.to(dtype)
    # Guard against inverted bounds from float noise.
    l = torch.minimum(l.to(dtype), u)
    prep = prepare_dense(P, q, A, l, u, st)
    return _iterate_dense(prep, P, q, A, l, u, st, x0, y0, on_device)


def _iterate_dense(prep: DensePrep, P, q, A, l, u, st: ADMMSettings, x0, y0,
                   on_device: bool = False) -> QPSolution:
    """The iteration loops of :func:`admm_solve_batch` on prepared problems;
    ``P, q, A, l, u`` are the unscaled problems, for the certificates.

    ``on_device``: the loop conditions stay on the device instead of being
    read on the host (one ``torch.while_loop``: on ``"xla"`` an ADMM
    iteration a trip, on ``"pallas"`` a kernel entry a trip; the
    adaptive-rho refactorization applied by mask); the same results, and a
    form ``torch.export`` can trace."""
    Pb, qb, Ab, lb, ub, D, E, c, rho_v, OP = prep
    dtype, dev = Pb.dtype, Pb.device
    B, n = qb.shape
    m = Ab.shape[-2]
    inf = float("inf")
    prec = st.precision

    def mv(M, v):
        return _mv(M, v, prec)

    def scalar(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    sigma = scalar(st.sigma)
    alpha = scalar(st.alpha)
    AbT = Ab.transpose(-1, -2)
    if on_device:
        # A transposed copy with the view's strides (the same products):
        # torch.while_loop takes no two captured tensors that alias.
        AbT = AbT.clone()
    Einv = 1.0 / E
    Dinv = 1.0 / D
    cinv = 1.0 / c

    x = torch.zeros((B, n), dtype=dtype, device=dev) if x0 is None else x0.to(dtype) / D
    y = (torch.zeros((B, m), dtype=dtype, device=dev) if y0 is None
         else c[:, None] * y0.to(dtype) / E)
    z = torch.minimum(torch.maximum(mv(Ab, x), lb), ub)

    def amax(v):
        return v.abs().amax(dim=-1)

    def residuals(x, z, y):
        Ax = mv(Ab, x)
        Px = mv(Pb, x)
        Aty = mv(AbT, y)
        zero = torch.zeros((B,), dtype=dtype, device=dev)
        r_prim = amax((Ax - z) * Einv) if m else zero
        r_dual = cinv * amax((Px + qb + Aty) * Dinv)
        max_prim = torch.maximum(amax(Ax * Einv), amax(z * Einv)) if m else zero
        max_dual = cinv * torch.maximum(
            torch.maximum(amax(Aty * Dinv), amax(Px * Dinv)), amax(qb * Dinv)
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
            support = torch.sum(t_u + t_l, dim=-1)
            n_Atdy = amax(mv(A.transpose(-1, -2), dy_u))
            prim_inf = (
                (ndy > tiny)
                & (support < -st.eps_prim_inf * ndy)
                & (n_Atdy < st.eps_prim_inf * ndy)
            )
        else:
            prim_inf = torch.zeros((B,), dtype=torch.bool, device=dev)
        ndx = amax(dx_u)
        thr = st.eps_dual_inf * ndx
        dual_inf = (
            (ndx > tiny)
            & (torch.sum(q * dx_u, dim=-1) < -thr)
            & (amax(mv(P, dx_u)) < thr)
        )
        if m:
            Adx = mv(A, dx_u)
            t = thr[:, None]
            dual_inf = (dual_inf & torch.all((u >= inf) | (Adx < t), dim=-1)
                        & torch.all((l <= -inf) | (Adx > -t), dim=-1))
        return prim_inf, dual_inf

    def certify(x, y, x_old, y_old, done):
        if not st.check_infeasibility:
            return None
        pinf, dinf = infeasibility_certificates(
            D * (x - x_old), E * (y - y_old) / c[:, None]
        )
        return pinf & ~done, dinf & ~done

    adaptive = st.adaptive_rho and m > 0

    def adapt_rho(rho_v, OP, r_prim, r_dual, max_prim, max_dual, may):
        """OSQP adaptive rho per scenario: rescale by sqrt(relative residual
        ratio) and refactor the scenarios whose change crosses the
        tolerance (``may``: still running and not converged)."""
        num = r_prim / torch.clamp(max_prim, min=1e-10)
        den = r_dual / torch.clamp(max_dual, min=1e-10)
        scale = torch.clamp(torch.sqrt(num / torch.clamp(den, min=1e-10)), 1e-3, 1e3)
        trigger = may & (
            (scale > st.adaptive_rho_tolerance) | (scale < 1.0 / st.adaptive_rho_tolerance)
        )
        if on_device:
            # Every scenario refactored, the triggered ones kept: the same
            # values without a host read (each inverse is its own).
            new_rho = torch.clamp(rho_v * scale[:, None], _RHO_MIN, _RHO_MAX)
            new_OP = _factor(Pb, Ab, new_rho, sigma, st.method, prec)
            return pick(trigger, new_rho, rho_v), pick(trigger, new_OP, OP)
        if bool(trigger.any()):
            idx = trigger.nonzero().squeeze(1)
            new_rho = torch.clamp(rho_v[idx] * scale[idx, None], _RHO_MIN, _RHO_MAX)
            rho_v = rho_v.index_put((idx,), new_rho)
            OP = OP.index_put((idx,), _factor(Pb[idx], Ab[idx], new_rho, sigma, st.method, prec))
        return rho_v, OP

    # Rho (and the factorization) are constant for one adaptation
    # interval; adaptation happens BETWEEN rounds.
    ce = st.check_every
    if adaptive:
        interval = max(st.adaptive_rho_interval, ce)
        interval = -(-interval // ce) * ce
    else:
        interval = st.max_iter

    def pick(mask, new, old):
        return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)

    it = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    pinf = torch.zeros_like(done)
    dinf = torch.zeros_like(done)
    r_prim = torch.full((B,), inf, dtype=dtype, device=dev)
    r_dual = r_prim.clone()

    if st.backend == "pallas":
        # One kernel entry per round (the whole budget without adaptive
        # rho); residuals, certificates and adaptive rho in torch between
        # entries.  The round condition is tested between entries only: a
        # scenario the kernel stopped on its own test that the residuals
        # here find not done gets a fresh interval.  On the device: a
        # torch.while_loop of entries, the kernel one op node.
        def active(it, done, pinf, dinf):
            return (it < st.max_iter) & ~(done | pinf | dinf)

        def entry(it, x, y, z, rho_v, OP, done, pinf, dinf, r_prim, r_dual):
            act = active(it, done, pinf, dinf)
            # The kernel takes row-major arrays (torch.linalg.inv returns
            # column-major ones); contiguous() is free for the others.
            ops = [t.contiguous() for t in (OP, Ab, Pb, qb, lb, ub, rho_v, Dinv, Einv, cinv)]
            xs, ys, zs, kit = admm_device_loop(
                *ops, st.sigma, st.alpha, st.eps_abs, st.eps_rel,
                x.contiguous(), y.contiguous(), max_iter=interval, check_every=ce,
            )
            rp, rd, eps_pri, eps_dua, mp, md = residuals(xs, zs, ys)
            done_n = (rp <= eps_pri) & (rd <= eps_dua)
            certs = certify(xs, ys, x, y, done_n)
            if certs is not None:
                pinf, dinf = pick(act, certs[0], pinf), pick(act, certs[1], dinf)
            if adaptive:
                rho_v, OP = adapt_rho(rho_v, OP, rp, rd, mp, md, act & ~done_n)
            x, y, z = pick(act, xs, x), pick(act, ys, y), pick(act, zs, z)
            done = pick(act, done_n, done)
            r_prim, r_dual = pick(act, rp, r_prim), pick(act, rd, r_dual)
            it = it + torch.where(act, kit, torch.zeros_like(kit))
            return it, x, y, z, rho_v, OP, done, pinf, dinf, r_prim, r_dual

        s = (it, x, y, z, rho_v, OP, done, pinf, dinf, r_prim, r_dual)
        if on_device:
            s = torch.while_loop(lambda it, *c: active(it, *c[5:8]).any(),
                                 lambda *c: _fresh(entry(*c)), _fresh(s))
        else:
            while bool(active(s[0], *s[6:9]).any()):
                s = entry(*s)
                _iterate_dense.entries += 1
        it, x, y, z, rho_v, OP, done, pinf, dinf, r_prim, r_dual = s
    else:
        def one_iter(x, z, y, rho_v, OP):
            if st.method == "condensed":
                rhs = sigma * x - qb + mv(AbT, rho_v * z - y)
                xt = mv(OP, rhs)
                zt = mv(Ab, xt)
            else:
                rhs = torch.cat([sigma * x - qb, z - y / rho_v], dim=-1)
                sol = mv(OP, rhs)
                xt = sol[:, :n]
                zt = z + (sol[:, n:] - y) / rho_v
            x_new = alpha * xt + (1 - alpha) * x
            z_relaxed = alpha * zt + (1 - alpha) * z
            z_new = torch.minimum(torch.maximum(z_relaxed + y / rho_v, lb), ub)
            y_new = y + rho_v * (z_relaxed - z_new)
            return x_new, z_new, y_new

        def outer_mask(it, done, pinf, dinf):
            return (it < st.max_iter) & ~(done | pinf | dinf)

        def inner_mask(outer, it, k, done, pinf, dinf):
            # One round per scenario: whole check blocks while k < interval,
            # it + k < max_iter and the scenario has not stopped.
            return outer & (k < interval) & (it + k < st.max_iter) & ~(done | pinf | dinf)

        def check_block(inner, rho_v, OP, k, x, z, y, done, pinf, dinf, rp, rd, mp, md,
                        block=None):
            """A check block from ``x, z, y`` (its iterations given as
            ``block``, or run here), its check, kept where ``inner``."""
            if block is None:
                xs, zs, ys = x, z, y
                for _ in range(ce):
                    xs, zs, ys = one_iter(xs, zs, ys, rho_v, OP)
            else:
                xs, zs, ys = block
            rp_n, rd_n, eps_pri, eps_dua, mp_n, md_n = residuals(xs, zs, ys)
            done_n = (rp_n <= eps_pri) & (rd_n <= eps_dua)
            certs = certify(xs, ys, x, y, done_n)
            if certs is not None:
                pinf, dinf = pick(inner, certs[0], pinf), pick(inner, certs[1], dinf)
            x, z, y = pick(inner, xs, x), pick(inner, zs, z), pick(inner, ys, y)
            done = pick(inner, done_n, done)
            rp, rd = pick(inner, rp_n, rp), pick(inner, rd_n, rd)
            mp, md = pick(inner, mp_n, mp), pick(inner, md_n, md)
            return k + ce * inner.to(k.dtype), x, z, y, done, pinf, dinf, rp, rd, mp, md

        def end_round(it, k, outer, x, z, y, rho_v, OP, done, pinf, dinf, r_prim, r_dual,
                      rp, rd, mp, md):
            r_prim, r_dual = pick(outer, rp, r_prim), pick(outer, rd, r_dual)
            if adaptive:
                rho_v, OP = adapt_rho(rho_v, OP, rp, rd, mp, md, outer & ~done)
            return it + k, x, z, y, rho_v, OP, done, pinf, dinf, r_prim, r_dual

        def inf_b():
            return torch.full((B,), inf, dtype=dtype, device=dev)

        if not on_device:
            s = (it, x, z, y, rho_v, OP, done, pinf, dinf, r_prim, r_dual)
            while True:
                it, x, z, y, rho_v, OP, done, pinf, dinf, r_prim, r_dual = s
                outer = outer_mask(it, done, pinf, dinf)
                if not bool(outer.any()):
                    break
                b = (torch.zeros_like(it), x, z, y, done, pinf, dinf,
                     inf_b(), inf_b(), inf_b(), inf_b())
                while True:
                    inner = inner_mask(outer, it, b[0], *b[4:7])
                    if not bool(inner.any()):
                        break
                    b = check_block(inner, rho_v, OP, *b)
                k, x, z, y, done, pinf, dinf, rp, rd, mp, md = b
                s = end_round(it, k, outer, x, z, y, rho_v, OP, done, pinf, dinf, r_prim,
                              r_dual, rp, rd, mp, md)
        else:
            # One torch.while_loop (nested ones do not export beside the
            # derivative code's grad-mode regions), one ADMM iteration per
            # trip, the host loops' order exactly: a trip that starts a
            # round takes its outer mask, a trip that starts a check block
            # its inner mask (an empty one ends the round: that trip
            # changes nothing else), and the trip that ends a block checks
            # it.  `xs` carries the block's iterates, `x` the last check's.
            def trip(in_round, j, inner, outer, it, k, xs, zs, ys, x, z, y, rho_v, OP, done,
                     pinf, dinf, r_prim, r_dual, rp, rd, mp, md):
                start = ~in_round
                outer = torch.where(start, outer_mask(it, done, pinf, dinf), outer)
                k = torch.where(start, torch.zeros_like(k), k)
                rp, rd, mp, md = (torch.where(start, inf_b(), v) for v in (rp, rd, mp, md))
                first = j == 0
                inner = torch.where(first, inner_mask(outer, it, k, done, pinf, dinf), inner)
                end = first & ~inner.any()
                xs, zs, ys = (torch.where(first, a, b) for a, b in ((x, xs), (z, zs), (y, ys)))
                xs, zs, ys = one_iter(xs, zs, ys, rho_v, OP)
                last = j == ce - 1
                checked = check_block(inner, rho_v, OP, k, x, z, y, done, pinf, dinf,
                                      rp, rd, mp, md, (xs, zs, ys))
                k, x, z, y, done, pinf, dinf, rp, rd, mp, md = (
                    torch.where(last, a, b) for a, b in zip(
                        checked, (k, x, z, y, done, pinf, dinf, rp, rd, mp, md)))
                ended = end_round(it, k, outer, x, z, y, rho_v, OP, done, pinf, dinf, r_prim,
                                  r_dual, rp, rd, mp, md)
                kept = (it, x, z, y, rho_v, OP, done, pinf, dinf, r_prim, r_dual)
                it, x, z, y, rho_v, OP, done, pinf, dinf, r_prim, r_dual = (
                    torch.where(end, e, c) for e, c in zip(ended, kept))
                j = torch.where(end | last, torch.zeros_like(j), j + 1)
                return _fresh((~end, j, inner, outer, it, k, xs, zs, ys, x, z, y, rho_v, OP, done,
                               pinf, dinf, r_prim, r_dual, rp, rd, mp, md))

            false_b = torch.zeros((B,), dtype=torch.bool, device=dev)
            s = (torch.zeros((), dtype=torch.bool, device=dev),
                 torch.zeros((), dtype=torch.int64, device=dev), false_b, false_b, it,
                 torch.zeros_like(it), x, z, y, x, z, y, rho_v, OP, done, pinf, dinf, r_prim,
                 r_dual, inf_b(), inf_b(), inf_b(), inf_b())
            s = torch.while_loop(
                lambda *s: s[0] | outer_mask(s[4], *s[14:17]).any(), trip, _fresh(s))
            it = s[4]
            x, z, y, rho_v, OP, done, pinf, dinf, r_prim, r_dual = s[9:19]

    if st.polish and m:
        x, y, z, r_prim, r_dual = _polish(
            Pb, qb, Ab, lb, ub, x, y, z, r_prim, r_dual, residuals, st
        )

    # Unscale: x = D xbar, y = E ybar / c, z = zbar / E.
    return QPSolution(
        x=D * x,
        y=E * y / c[:, None],
        z=z / E,
        iters=it,
        converged=done,
        r_prim=r_prim,
        r_dual=r_dual,
        prim_inf=pinf,
        dual_inf=dinf,
    )


# Kernel entries the "pallas" loop has made (each one device-loop launch
# on the card).
_iterate_dense.entries = 0


def _polish(Pb, qb, Ab, lb, ub, x, y, z, r_prim, r_dual, residuals, st):
    """OSQP solution polishing (masked active-set KKT re-solve), for each
    problem of a batch.

    Active rows are those where the ADMM iterate sits on a bound with the
    matching dual sign (OSQP ``polish.c`` semantics).  The KKT system is
    formed with a row mask S::

        [[P + dI,  (S A)^T], [S A,  S - I - dI]] [x; nu] = [-q; S b]

    giving ``A_i x = b_i`` on active rows and ``nu_i = 0`` on inactive ones.
    One iterative-refinement step against the unregularized system follows;
    the polished point is accepted only if it improves both residuals.
    """
    n = Pb.shape[-1]
    m = Ab.shape[-2]
    dtype, dev = Pb.dtype, Pb.device
    delta = st.polish_delta
    lower_active = y < 0.0
    upper_active = y > 0.0
    active = lower_active | upper_active
    b_act = torch.where(upper_active, ub, torch.where(lower_active, lb, torch.zeros_like(lb)))
    S = active.to(dtype)

    SA = S[..., :, None] * Ab
    K = torch.zeros(Pb.shape[:-2] + (n + m, n + m), dtype=dtype, device=dev)
    K[..., :n, :n] = Pb + delta * torch.eye(n, dtype=dtype, device=dev)
    K[..., :n, n:] = SA.transpose(-1, -2)
    K[..., n:, :n] = SA
    K[..., n:, n:] = torch.diag_embed(S - 1.0 - delta)
    rhs = torch.cat([-qb, S * b_act], dim=-1)
    Kinv = _inv(K)

    def mv(M, v):
        return _mv(M, v, st.precision)

    sol = mv(Kinv, rhs)
    # One iterative-refinement step vs the unregularized KKT operator.
    K0 = K - delta * torch.eye(n + m, dtype=dtype, device=dev)
    sol = sol + mv(Kinv, rhs - mv(K0, sol))

    x_p = sol[..., :n]
    y_p = torch.where(active, sol[..., n:], torch.zeros_like(y))
    z_p = torch.minimum(torch.maximum(mv(Ab, x_p), lb), ub)
    rp_p, rd_p, _, _, _, _ = residuals(x_p, z_p, y_p)
    better = (rp_p <= r_prim) & (rd_p <= r_dual)
    b1 = better[..., None]
    return (
        torch.where(b1, x_p, x), torch.where(b1, y_p, y), torch.where(b1, z_p, z),
        torch.where(better, rp_p, r_prim), torch.where(better, rd_p, r_dual),
    )
