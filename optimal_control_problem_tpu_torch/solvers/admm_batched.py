"""Shared-system batched ADMM — port of
``optimal_control_problem_tpu/solvers/admm_batched.py``.

For LQ/LTI optimal-control problems (quadratic cost, linear dynamics — the
double integrator) the QP matrices ``P`` and ``A`` are independent of the
iterate and of the scenario: only the linear term ``q`` and the bounds
``l, u`` differ across scenarios and SQP iterations.  ONE factorization
(dense inverse of the condensed or quasi-definite KKT operator) is shared
by the whole scenario batch and by all SQP iterations, and every ADMM
iteration is three products over the batch::

    rhs (B,n)  = sigma*x - q + (rho*z - y) @ A
    xt  (B,n)  = rhs @ OP
    zt  (B,m)  = xt @ A^T

plus elementwise projection/dual updates.

The API is split prepare/iterate:

* :func:`prepare_shared` — Ruiz equilibration, per-row rho from the
  structural bound types, and the operator factorization.  Done ONCE per
  solve call (bound *types* are fixed by the problem structure, so rho is
  valid for every SQP iteration).
* :func:`admm_iterate_prepared` — the iteration loop.
  ``settings.backend`` picks it: ``"xla"`` is :func:`_admm_iterate_impl`,
  the loop in PyTorch ops whose products are ``torch.matmul``;
  ``"pallas"`` (condensed method, ``precision="highest"``) is
  :func:`_admm_iterate_fused`, the chunk driver around the hand-written
  CUDA kernel of :mod:`..ops.shared_kernel`.  Both are eager: the loop
  conditions (all scenarios done, the adaptive-rho trigger) are read on
  the host once per check block or chunk.

Precision, as in JAX: ``settings.precision`` is the ambient precision of
every product (prepare, residuals, certificates, refactorizations; see
:func:`..ops.shared_kernel.precision_matmul`), and the condensed
iteration products run at ``settings.iter_precision`` whatever it is
(``"highest"``, or ``HIGH``: bf16_3x for the rhs and x products, and for
``zt`` at ``"high"``).  The fused-GEMM form computes its one product at
the x products' precision, ``zt`` included, even at ``"mixed"`` (JAX's
quirk, kept).

Semantics match :mod:`.admm` (OSQP as configured by the reference): Ruiz
equilibration, per-row rho with equality scaling, relaxation alpha, sigma
regularization, relative+absolute termination, adaptive rho (batch-shared,
with a shared re-factorization when triggered), float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import as_tensors
from ..ops.shared_kernel import (
    matmul_split,
    pick_shared_tile,
    precision_matmul,
    shared_admm_chunk,
    split_bf16,
)
from .admm import (
    ADMMSettings,
    _RHO_EQ_OVER_RHO_INEQ,
    _RHO_MAX,
    _RHO_MIN,
    _RHO_TOL,
    _factor,
    _fresh,
    _limit_scaling,
    f32_matmuls,
    ruiz_equilibrate,
)

__all__ = [
    "BatchQPSolution",
    "SharedQPFactor",
    "prepare_shared",
    "admm_iterate_prepared",
    "admm_solve_shared",
]


class BatchQPSolution(NamedTuple):
    x: torch.Tensor  # (B, n)
    y: torch.Tensor  # (B, m)
    z: torch.Tensor  # (B, m)
    # scalar int32: iterations until every scenario converged or was
    # certified infeasible/unbounded (whichever stops the shared loop).
    iters: torch.Tensor
    converged: torch.Tensor  # (B,) bool
    r_prim: torch.Tensor  # (B,)
    r_dual: torch.Tensor  # (B,)
    # Per-scenario OSQP infeasibility certificates, always (B,) bool
    # (false-filled when ``settings.check_infeasibility`` is off).
    prim_inf: torch.Tensor
    dual_inf: torch.Tensor


class SharedQPFactor(NamedTuple):
    """Precomputed shared-QP operator (valid while P, A, bound types fixed)."""

    Pb: torch.Tensor  # (n, n) scaled Hessian
    Ab: torch.Tensor  # (m, n) scaled constraint matrix
    D: torch.Tensor  # (n,) variable scaling
    E: torch.Tensor  # (m,) constraint scaling
    c: torch.Tensor  # scalar cost scaling
    rho_v: torch.Tensor  # (m,) per-row rho
    OP: torch.Tensor  # (n,n) condensed inverse or (n+m,n+m) KKT inverse


def _shared_rho_vec(l, u, rho):
    """Per-row rho from structural bound types, shared across the batch.

    A row is treated as equality / loose only if EVERY scenario agrees —
    bound types come from the problem structure (pinned first frame,
    dynamics equalities, box rows), which is scenario-independent.
    ``rho`` is a 0-dim tensor of the working dtype.
    """
    inf = float("inf")
    loose = torch.all((l <= -inf) & (u >= inf), dim=0)
    eq = torch.all((u - l) < _RHO_TOL, dim=0)
    rho_v = rho.expand(l.shape[1:])
    rho_v = torch.where(eq, torch.clamp(rho * _RHO_EQ_OVER_RHO_INEQ, _RHO_MIN, _RHO_MAX), rho_v)
    return torch.where(loose, torch.full_like(rho_v, _RHO_MIN), rho_v)


def _fused_operator(OP, Ab, precision="highest"):
    """Block operator for the single-GEMM condensed iteration.

    ``[xt | zt] = [sigma*x - qb | rho*z - y] @ M2`` with
    ``M2 = [[OP, OP A^T], [A OP, A OP A^T]]`` reproduces the 3-GEMM
    iteration's fixed point exactly; see ``ADMMSettings.fused_gemm``.
    Its products at ``precision``.
    """
    mm = lambda a, w: precision_matmul(a, w, precision)  # noqa: E731
    top = torch.cat([OP, mm(OP, Ab.transpose(0, 1))], dim=1)
    AbOP = mm(Ab, OP)
    bottom = torch.cat([AbOP, mm(AbOP, Ab.transpose(0, 1))], dim=1)
    return torch.cat([top, bottom], dim=0)


# The shared operator is factored exactly as a single problem's.
_factor_shared = _factor


def prepare_shared(
    P: torch.Tensor,  # (n, n) shared Hessian
    A: torch.Tensor,  # (m, n) shared constraint matrix
    l: torch.Tensor,  # (B, m) bounds (used for structural row types only)
    u: torch.Tensor,  # (B, m)
    q_typical: Optional[torch.Tensor],  # (B, n) representative linear terms
    settings: ADMMSettings,
    *,
    device=None,
) -> SharedQPFactor:
    """Equilibrate, choose per-row rho, and factorize — once per solve
    (``A^T R A`` at ``settings.precision``).  Arrays that are not tensors
    go to ``device`` (:func:`..device.as_tensors`)."""
    P, A, l, u, q_typical = as_tensors(P, A, l, u, q_typical, device=device)
    st = settings
    dtype, dev = P.dtype, P.device
    n = P.shape[0]
    Pb0, _, Ab, D, E, c0 = ruiz_equilibrate(
        P, torch.zeros((n,), dtype=dtype, device=dev), A, st.scaling_iters
    )
    # Cost scaling from the batch-mean gradient magnitude (OSQP computes c
    # per problem from q; sharing keeps the factorization batch-wide).
    mean_pcol = (Pb0 / torch.clamp(c0, min=1e-30)).abs().amax(dim=0).mean()
    if q_typical is not None:
        qnorm = (q_typical * D[None, :]).abs().amax(dim=1).mean()
    else:
        qnorm = torch.zeros((), dtype=dtype, device=dev)
    c = 1.0 / _limit_scaling(torch.maximum(mean_pcol, qnorm))
    Pb = c * (D[:, None] * P * D[None, :])
    rho0 = torch.as_tensor(st.rho, dtype=dtype, device=dev)
    rho_v = _shared_rho_vec(l * E[None, :], u * E[None, :], rho0)
    sigma = torch.as_tensor(st.sigma, dtype=dtype, device=dev)
    OP = _factor_shared(Pb, Ab, rho_v, sigma, st.method, st.precision)
    return SharedQPFactor(Pb=Pb, Ab=Ab, D=D, E=E, c=c, rho_v=rho_v, OP=OP)


@f32_matmuls
def admm_iterate_prepared(
    fac: SharedQPFactor,
    q: torch.Tensor,  # (B, n)
    l: torch.Tensor,  # (B, m)
    u: torch.Tensor,  # (B, m)
    settings: ADMMSettings,
    x0: Optional[torch.Tensor] = None,  # (B, n) warm start
    y0: Optional[torch.Tensor] = None,  # (B, m)
    on_device: bool = False,
) -> BatchQPSolution:
    """Run the ADMM loop against a prepared factorization until every
    scenario meets the OSQP termination criteria or ``max_iter``.

    ``on_device`` keeps the loop conditions on the device, on either
    backend (a ``torch.while_loop`` of chunks or of check blocks, the
    adaptive refactorization kept by mask): the same results, and the form
    ``torch.export`` traces, with the chunk kernel one op node.

    With ``settings.backend == "pallas"`` and the condensed method the
    loop runs as rho-constant chunks of the fused kernel
    (:mod:`..ops.shared_kernel`, its tensor-core form at
    ``iter_precision`` ``"high"``/``"mixed"``); semantics match the
    ``"xla"`` loop, except that infeasibility certificates are evaluated
    once per chunk instead of once per check block (as on the banded batch
    path) and that a batch above the JAX package's tile limit votes on
    termination per tile (``pick_shared_tile``).  The KKT method,
    ``m == 0``, ``precision != "highest"`` (the kernel computes at f32;
    JAX takes its XLA loop so the backends cannot differ) and a problem
    whose working set fits at no tile take the ``"xla"`` loop, as in the
    JAX package.  Arrays that are not tensors go to the factor's device.
    """
    *fac, q, l, u, x0, y0 = as_tensors(*fac, q, l, u, x0, y0)
    fac = SharedQPFactor(*fac)
    if (
        settings.backend == "pallas"
        and settings.method == "condensed"
        and settings.precision == "highest"
        and fac.Ab.shape[0] > 0
    ):
        return _admm_iterate_fused(fac, q, l, u, settings, x0, y0, on_device=on_device)
    return _admm_iterate_impl(fac, q, l, u, settings, x0, y0, on_device)


def _shared_certificates(dx_b, dy_b, Pb, Ab, D, E, cinv, q_orig, l, u, st):
    """Per-scenario OSQP infeasibility certificates on iterate deltas.

    ``dx_b``/``dy_b`` are SCALED deltas (B, n)/(B, m); all tests run on
    unscaled quantities like OSQP's ``auxil.c``.  Matvecs reuse the scaled
    operators: ``A = E^-1 Ab D^-1``, ``P = c^-1 D^-1 Pb D^-1``.
    """
    Dinv = 1.0 / D
    Einv = 1.0 / E
    inf = float("inf")
    tiny = 1e-12

    def mm(a, w):
        return precision_matmul(a, w, st.precision)

    dx_u = dx_b * D[None, :]
    dy_u = dy_b * E[None, :] * cinv
    # -- primal infeasibility: delta_y with A^T dy ~ 0 and support
    #    function u'(dy)_+ + l'(dy)_- < 0 (per scenario).
    ndy = dy_u.abs().amax(dim=1)
    dy_p = torch.clamp(dy_u, min=0.0)
    dy_m = torch.clamp(dy_u, max=0.0)
    # Masked products so inf * 0 cannot produce NaN; an infinite bound
    # with matching delta sign yields +inf, correctly blocking the
    # certificate.
    t_u = torch.where(dy_p > 0, u * dy_p, torch.zeros_like(u))
    t_l = torch.where(dy_m < 0, l * dy_m, torch.zeros_like(l))
    support = torch.sum(t_u + t_l, dim=1)
    # A^T dy_u = c^-1 D^-1 (Ab^T dy_scaled): feed the scaled delta.
    n_Atdy = ((mm(dy_b, Ab) * Dinv[None, :]).abs() * cinv).amax(dim=1)
    pinf = (
        (ndy > tiny)
        & (support < -st.eps_prim_inf * ndy)
        & (n_Atdy < st.eps_prim_inf * ndy)
    )
    # -- dual infeasibility: delta_x with P dx ~ 0, q'dx < 0 and A dx
    #    consistent with a feasible recession direction.
    ndx = dx_u.abs().amax(dim=1)
    thr = st.eps_dual_inf * ndx
    cond_q = torch.sum(q_orig * dx_u, dim=1) < -thr
    Pdx = cinv * mm(dx_b, Pb) * Dinv[None, :]
    cond_P = Pdx.abs().amax(dim=1) < thr
    Adx = mm(dx_b, Ab.transpose(0, 1)) * Einv[None, :]
    cond_A = torch.all((u >= inf) | (Adx < thr[:, None]), dim=1) & torch.all(
        (l <= -inf) | (Adx > -thr[:, None]), dim=1
    )
    dinf = (ndx > tiny) & cond_q & cond_P & cond_A
    return pinf, dinf


def _scaled_start(fac, q, l, u, x0, y0, precision):
    """The scaled problem data and starting iterates of one solve."""
    dtype = fac.Pb.dtype
    B, n = q.shape
    m = fac.Ab.shape[0]
    Ab, D, E, c = fac.Ab, fac.D, fac.E, fac.c
    u = u.to(dtype)
    l = torch.minimum(l.to(dtype), u)
    q_orig = q.to(dtype)  # unscaled, for infeasibility certificates
    qb = c * q_orig * D[None, :]
    lb = l * E[None, :]
    ub = u * E[None, :]
    dev = q.device
    x = torch.zeros((B, n), dtype=dtype, device=dev) if x0 is None else x0.to(dtype) / D[None, :]
    y = torch.zeros((B, m), dtype=dtype, device=dev) if y0 is None else c * y0.to(dtype) / E[None, :]
    z = torch.minimum(torch.maximum(precision_matmul(x, Ab.T, precision), lb), ub)
    return l, u, q_orig, qb, lb, ub, x, z, y


def _rho_scale(rp_rel_sum, rd_rel_sum, cnt):
    """OSQP's batch-shared rho factor sqrt(mean rel. primal / mean rel.
    dual residual), clipped to [1e-3, 1e3]."""
    scale = torch.sqrt((rp_rel_sum / cnt) / torch.clamp(rd_rel_sum / cnt, min=1e-12))
    return torch.clamp(scale, 1e-3, 1e3)


def _admm_iterate_fused(fac, q, l, u, settings, x0, y0, batch_tile=None, on_device=False):
    """Chunked driver around :func:`..ops.shared_kernel.shared_admm_chunk`.

    Division of labor per solve (mirrors the banded batch driver):

    * iterate (the chunk kernel, batch-leading): iterations up to the next
      adaptation boundary of the ``"xla"`` rule per kernel entry (clamped
      to the remaining ``max_iter`` budget), OSQP termination every
      ``check_every``, shared by the termination group (nobody freezes);
    * between chunks (PyTorch ops): infeasibility certificates on chunk
      deltas and OSQP adaptive rho with a shared re-factorization.

    ``batch_tile`` is the termination group; the default is the JAX
    driver's, :func:`..ops.shared_kernel.pick_shared_tile` (the whole
    batch up to its size limit, which makes ``iters`` equal the ``"xla"``
    loop's); where that returns ``None`` the solve takes the ``"xla"``
    loop, as the JAX driver does.  A group that does not divide the batch
    is padded with replicas of the first scenario.  On CUDA tensors the
    chunk launches its kernel or raises: there is no other fallback to the
    ``"xla"`` loop.

    ``on_device``: the first chunk, then (with adaptive rho) a
    ``torch.while_loop`` of chunks, each chunk's budget computed on the
    device from the iteration count (the op takes it as a tensor) and
    every refactorization computed and kept where the rule triggers.
    Without adaptive rho the first chunk's budget is the whole of
    ``max_iter``, and a group stops short of it only when all of its
    scenarios converge, so no second chunk ever runs.
    """
    dtype = fac.Pb.dtype
    st = settings
    B, n = q.shape
    Pb, Ab, D, E, c, rho, OP = fac
    dev = q.device
    sigma = torch.as_tensor(st.sigma, dtype=dtype, device=dev)
    if batch_tile is None:
        batch_tile = pick_shared_tile(B, n, Ab.shape[0])
    if batch_tile is None:
        # The JAX driver's working set fits at no tile: its XLA loop.
        return _admm_iterate_impl(fac, q, l, u, settings, x0, y0, on_device)

    l, u, q_orig, qb, lb, ub, x, z, y = _scaled_start(fac, q, l, u, x0, y0, st.precision)

    pad_b = (-B) % batch_tile
    Bp = B + pad_b
    valid = torch.arange(Bp, device=dev) < B
    if pad_b:
        rep = lambda a: torch.cat([a, a[:1].expand((pad_b,) + a.shape[1:])], dim=0)  # noqa: E731
        qb, lb, ub, x, y, z, q_orig, l, u = map(rep, (qb, lb, ub, x, y, z, q_orig, l, u))
    # The kernel takes row-major arrays (torch.linalg.inv returns a
    # column-major one).
    qb, lb, ub, x, y, z, OP, Ab, Pb = (a.contiguous() for a in (qb, lb, ub, x, y, z, OP, Ab, Pb))

    ce = st.check_every
    ari = st.adaptive_rho_interval

    def chunk_bound(it):
        if not st.adaptive_rho:
            return st.max_iter - it
        # Next adaptation boundary under the "xla" rule: that loop adapts
        # at the end of the first check block (a multiple of check_every)
        # t > it with t % ari < check_every.  Ending each kernel chunk
        # exactly there keeps the rho trajectory identical to the "xla"
        # path for ANY (ari, check_every) pair, including non-divisible
        # ones.
        k = it // ari + 1
        t_next = -(-(k * ari) // ce) * ce
        if isinstance(t_next, torch.Tensor):  # the device-side loop's count
            return torch.clamp(t_next, max=st.max_iter) - it
        return min(t_next, st.max_iter) - it

    Dinv = 1.0 / D
    Einv = 1.0 / E
    cinv = 1.0 / c
    conv = torch.zeros((Bp,), dtype=torch.bool, device=dev)
    pinf = torch.zeros_like(conv)
    dinf = torch.zeros_like(conv)
    rp = torch.full((Bp,), float("inf"), dtype=dtype, device=dev)
    rd = rp.clone()
    zero = torch.zeros((), dtype=dtype, device=dev)

    def chunk(it, conv, pinf, dinf, rp, rd, x, z, y, rho, OP):
        """One chunk entry and the work between chunks."""
        x2, z2, y2, conv_k, it_inc, rp_k, rd_k, rpr_k, rdr_k = shared_admm_chunk(
            conv | pinf | dinf, chunk_bound(it),
            OP, Ab, Pb, rho, lb, ub, qb, Dinv, Einv, cinv, x, z, y,
            check_every=ce,
            sigma=float(st.sigma),
            alpha=float(st.alpha),
            eps_abs=float(st.eps_abs),
            eps_rel=float(st.eps_rel),
            batch_tile=batch_tile,
            iter_precision=st.iter_precision,
        )
        ran = it_inc > 0
        conv = torch.where(ran, conv_k, conv)
        rp = torch.where(ran, rp_k, rp)
        rd = torch.where(ran, rd_k, rd)
        if st.check_infeasibility:
            pinf_k, dinf_k = _shared_certificates(
                x2 - x, y2 - y, Pb, Ab, D, E, cinv, q_orig, l, u, st
            )
            pinf = pinf | (pinf_k & ran & ~conv)
            dinf = dinf | (dinf_k & ran & ~conv)
        x, z, y = x2, z2, y2
        it = it + (it_inc.max() if on_device else int(it_inc.max()))
        if st.adaptive_rho:
            # Batch-shared OSQP rho adaptation from the kernel's relative
            # residuals, aggregated over still-active real scenarios only
            # (padded replicas and converged/certified scenarios excluded —
            # see _admm_iterate_impl for the rationale).
            act = ~(conv | pinf | dinf) & valid & ran
            cnt = torch.clamp(act.sum().to(dtype), min=1.0)
            # Mask BEFORE the product: a group that was all-done at entry
            # reports inf residuals, and inf * 0.0 = NaN would poison the
            # sum (silently disabling rho adaptation for every later chunk).
            rpr_sum = torch.sum(torch.where(act, rpr_k, zero))
            rdr_sum = torch.sum(torch.where(act, rdr_k, zero))
            scale = _rho_scale(rpr_sum, rdr_sum, cnt)
            trigger = (
                (scale > st.adaptive_rho_tolerance) | (scale < 1.0 / st.adaptive_rho_tolerance)
            ) & act.any()
            if on_device:
                new_rho = torch.clamp(rho * scale, _RHO_MIN, _RHO_MAX)
                new_OP = _factor_shared(Pb, Ab, new_rho, sigma, st.method,
                                        st.precision).contiguous()
                rho = torch.where(trigger, new_rho, rho)
                OP = torch.where(trigger, new_OP, OP)
            elif bool(trigger):
                rho = torch.clamp(rho * scale, _RHO_MIN, _RHO_MAX)
                OP = _factor_shared(Pb, Ab, rho, sigma, st.method, st.precision).contiguous()
        return it, conv, pinf, dinf, rp, rd, x, z, y, rho, OP

    def going(it, conv, pinf, dinf, *_):
        return (it < st.max_iter) & ~torch.all(conv | pinf | dinf)

    s = (0, conv, pinf, dinf, rp, rd, x, z, y, rho, OP)
    if on_device:
        s = (torch.zeros((), dtype=torch.int32, device=dev),) + s[1:]
        if st.max_iter > 0 and Bp > 0:
            s = chunk(*s)
            if st.adaptive_rho:
                s = torch.while_loop(lambda *c: going(*c), lambda *c: _fresh(chunk(*c)),
                                     _fresh(s))
    else:
        while bool(going(*s)):
            s = chunk(*s)
            _admm_iterate_fused.chunks += 1
    it, conv, pinf, dinf, rp, rd, x, z, y, rho, OP = s
    return BatchQPSolution(
        x=(x * D[None, :])[:B],
        y=(y * E[None, :] * cinv)[:B],
        z=(z * Einv[None, :])[:B],
        iters=torch.as_tensor(it, dtype=torch.int32, device=dev),
        converged=conv[:B],
        r_prim=rp[:B],
        r_dual=rd[:B],
        prim_inf=pinf[:B],
        dual_inf=dinf[:B],
    )


# Chunk entries the driver has made (each one kernel launch on the card).
_admm_iterate_fused.chunks = 0


def _admm_iterate_impl(fac, q, l, u, settings, x0, y0, on_device=False):
    """The ``"xla"`` backend: the whole loop in PyTorch ops.  Its products
    are outside any kernel of the JAX package, so they are ``torch.matmul``
    here (TF32 off), on bf16 hi/lo splits where a precision asks for
    ``HIGH`` (the operators split once per factorization).

    ``on_device``: the loop of check blocks as one ``torch.while_loop``, a
    check block a trip, the adaptive refactorization (and its split)
    computed at every adaptation point and kept where the rule triggers;
    the same results."""
    dtype = fac.Pb.dtype
    st = settings
    B, n = q.shape
    Pb, Ab, D, E, c, rho, OP = fac
    m = Ab.shape[0]
    dev = q.device
    sigma = torch.as_tensor(st.sigma, dtype=dtype, device=dev)
    alpha = st.alpha
    fused = st.fused_gemm and st.method == "condensed" and m > 0
    if fused:
        # The loop carries the (n+m, n+m) block operator instead of OP;
        # a rho adaptation refactors OP and rebuilds it (rare).  The JAX
        # package computes this branch's zt at the x-update's precision
        # even under iter_precision="mixed", and so does the port.
        OP = _fused_operator(OP, Ab, st.precision)

    l, u, q_orig, qb, lb, ub, x, z, y = _scaled_start(fac, q, l, u, x0, y0, st.precision)
    # A copy on the device-side loop: a torch.while_loop captures no two
    # tensors that alias (the same values and strides' products).
    AbT = Ab.T.clone(memory_format=torch.preserve_format) if on_device else Ab.T

    def mm(a, w):
        return precision_matmul(a, w, st.precision)

    # The iteration products' precision (ADMMSettings.iter_precision): at
    # HIGH each takes its operator's bf16 hi/lo split, made once per
    # factorization.
    high_x = st.iter_precision != "highest"
    high_z = st.iter_precision == "high"
    Ab_s = split_bf16(Ab) if high_x else None
    AbT_s = split_bf16(AbT) if high_z else None

    def op_split(OP):
        return split_bf16(OP) if high_x else None

    def prod(a, w, w_split):
        return a @ w if w_split is None else matmul_split(a, w_split)

    def one_iter(x, z, y, rho, OP, OP_s):
        if fused:
            # One (B, n+m) @ (n+m, n+m) GEMM per iteration.
            xtzt = prod(torch.cat([sigma * x - qb, rho[None, :] * z - y], dim=1), OP, OP_s)
            xt = xtzt[:, :n]
            zt = xtzt[:, n:]
        elif st.method == "condensed":
            rhs = sigma * x - qb + prod(rho[None, :] * z - y, Ab, Ab_s)
            xt = prod(rhs, OP, OP_s)
            zt = prod(xt, AbT, AbT_s)
        else:
            rhs = torch.cat([sigma * x - qb, z - y / rho[None, :]], dim=1)
            sol = mm(rhs, OP)  # OP symmetric (quasi-definite KKT inverse)
            xt = sol[:, :n]
            zt = z + (sol[:, n:] - y) / rho[None, :]
        x_new = alpha * xt + (1 - alpha) * x
        z_relaxed = alpha * zt + (1 - alpha) * z
        z_new = torch.minimum(torch.maximum(z_relaxed + y / rho[None, :], lb), ub)
        y_new = y + rho[None, :] * (z_relaxed - z_new)
        return x_new, z_new, y_new

    Einv = 1.0 / E
    Dinv = 1.0 / D
    cinv = 1.0 / c

    def rowmax(a):
        return a.abs().amax(dim=1)

    def residuals(x, z, y):
        Ax = mm(x, AbT)
        Px = mm(x, Pb)  # Pb symmetric
        Aty = mm(y, Ab)
        r_prim = rowmax((Ax - z) * Einv[None, :])
        r_dual = cinv * rowmax((Px + qb + Aty) * Dinv[None, :])
        max_prim = torch.maximum(rowmax(Ax * Einv[None, :]), rowmax(z * Einv[None, :]))
        max_dual = cinv * torch.maximum(
            torch.maximum(rowmax(Aty * Dinv[None, :]), rowmax(Px * Dinv[None, :])),
            rowmax(qb * Dinv[None, :]),
        )
        eps_pri = st.eps_abs + st.eps_rel * max_prim
        eps_dua = st.eps_abs + st.eps_rel * max_dual
        rp_rel = r_prim / torch.clamp(max_prim, min=1e-12)
        rd_rel = r_dual / torch.clamp(max_dual, min=1e-12)
        return r_prim, r_dual, eps_pri, eps_dua, rp_rel, rd_rel

    def block(it, x, z, y, conv, pinf, dinf, r_prim, r_dual, all_done, rho, OP, OP_s):
        """One check block, its check and, at an adaptation point, the rho
        rule."""
        x_old, y_old = x, y
        for _ in range(st.check_every):
            x, z, y = one_iter(x, z, y, rho, OP, OP_s or None)
        it = it + st.check_every
        r_prim, r_dual, eps_pri, eps_dua, rp_rel, rd_rel = residuals(x, z, y)
        conv = (r_prim <= eps_pri) & (r_dual <= eps_dua)
        if st.check_infeasibility:
            pinf_new, dinf_new = _shared_certificates(
                x - x_old, y - y_old, Pb, Ab, D, E, cinv, q_orig, l, u, st
            )
            # Sticky: once a scenario is certified it stays certified (the
            # batch keeps iterating, so later check blocks could otherwise
            # drop a certificate when the deltas change under rho adaptation).
            pinf = pinf | (pinf_new & ~conv)
            dinf = dinf | (dinf_new & ~conv)
        # Early exit when every scenario is converged OR certified
        # infeasible/unbounded (certified scenarios would otherwise diverge
        # and hold the whole batch at max_iter).
        all_done = torch.all(conv | pinf | dinf)

        at = (it % st.adaptive_rho_interval) < st.check_every
        if st.adaptive_rho and m and (on_device or at):
            # OSQP rho adaptation, batch-shared, aggregated only over
            # still-active scenarios: a certified scenario's residuals
            # diverge and would poison the shared rho; converged ones sit
            # at the tolerance floor and would drag the aggregate toward 1,
            # stalling adaptation for the scenarios still working.
            act = (~(conv | pinf | dinf)).to(dtype)
            cnt = torch.clamp(act.sum(), min=1.0)
            scale = _rho_scale(torch.sum(rp_rel * act), torch.sum(rd_rel * act), cnt)
            trigger = (scale > st.adaptive_rho_tolerance) | (
                scale < 1.0 / st.adaptive_rho_tolerance
            )
            if on_device or (not bool(all_done) and bool(trigger)):
                new_rho = torch.clamp(rho * scale, _RHO_MIN, _RHO_MAX)
                new_OP = _factor_shared(Pb, Ab, new_rho, sigma, st.method, st.precision)
                if fused:
                    new_OP = _fused_operator(new_OP, Ab, st.precision)
                new_s = op_split(new_OP) or ()
                if on_device:
                    keep = at & ~all_done & trigger
                    new_rho = torch.where(keep, new_rho, rho)
                    new_OP = torch.where(keep, new_OP, OP)
                    new_s = tuple(torch.where(keep, a, b) for a, b in zip(new_s, OP_s))
                rho, OP, OP_s = new_rho, new_OP, new_s
        return it, x, z, y, conv, pinf, dinf, r_prim, r_dual, all_done, rho, OP, OP_s

    conv = torch.zeros((B,), dtype=torch.bool, device=dev)
    r_prim = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    s = (0, x, z, y, conv, conv, conv, r_prim, r_prim,
         torch.zeros((), dtype=torch.bool, device=dev), rho, OP, op_split(OP) or ())
    if on_device:
        s = (torch.zeros((), dtype=torch.int32, device=dev),) + s[1:]
        s = torch.while_loop(lambda it, *c: (it < st.max_iter) & ~c[8],
                             lambda *c: _fresh(block(*c)), _fresh(s))
    else:
        while s[0] < st.max_iter and not bool(s[9]):
            s = block(*s)
    it, x, z, y, conv, pinf, dinf, r_prim, r_dual = s[:9]

    return BatchQPSolution(
        x=x * D[None, :],
        y=y * E[None, :] / c,
        z=z * Einv[None, :],
        iters=torch.as_tensor(it, dtype=torch.int32, device=dev),
        converged=conv,
        r_prim=r_prim,
        r_dual=r_dual,
        prim_inf=pinf,
        dual_inf=dinf,
    )


@f32_matmuls
def admm_solve_shared(
    P: torch.Tensor,  # (n, n) shared
    A: torch.Tensor,  # (m, n) shared
    q: torch.Tensor,  # (B, n) per scenario
    l: torch.Tensor,  # (B, m)
    u: torch.Tensor,  # (B, m)
    settings: ADMMSettings = ADMMSettings(),
    x0: Optional[torch.Tensor] = None,  # (B, n)
    y0: Optional[torch.Tensor] = None,  # (B, m)
    *,
    device=None,
) -> BatchQPSolution:
    """One-shot convenience wrapper: prepare + iterate, on the tensors'
    device (arrays that are not tensors go to ``device``, as in
    :func:`prepare_shared`)."""
    P, A, q, l, u, x0, y0 = as_tensors(P, A, q, l, u, x0, y0, device=device)
    fac = prepare_shared(P, A, l, u, q, settings)
    return admm_iterate_prepared(fac, q, l, u, settings, x0=x0, y0=y0)
