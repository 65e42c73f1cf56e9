"""Banded (block-tridiagonal) ADMM for stage-structured OCP QPs — port of
``optimal_control_problem_tpu/solvers/admm_banded.py``.

The condensed ADMM operator of a stage-structured problem is
block-tridiagonal: the Hessian is block-diagonal per frame, the constraint
stack ``A = [I; J_dyn; J_sc]`` has identity rows, dynamics rows coupling
frames (k, k+1), and per-stage rows — so ``M = P + sigma I + A^T R A`` has
diagonal blocks ``H_k + sigma I + diag(rho_x_k) + J0_k^T R_k J0_k +
J1_{k-1}^T R_{k-1} J1_{k-1} + Jc_k^T Rc_k Jc_k`` and subdiagonal blocks
``J1_k^T R_k J0_k``.  Neither the dense operator nor the dense constraint
matrix is ever formed.

Every structural helper here is written batch-LAST (a trailing scenario
axis on every field: ``Hb (N, w, w, B)``, rows ``(m, B)``) — the layout of
the batched driver and the CUDA chunk kernel.  The per-scenario functions
(``ruiz_equilibrate_banded``, ``_apply_A`` ..., ``admm_solve_banded``) run
the same code with a batch of one, so the two paths cannot drift apart.
Contractions are explicit add chains / sums in the JAX module's op order.

Semantics: OSQP iteration with modified Ruiz equilibration computed
structurally on the stage blocks, per-row rho, over-relaxation, adaptive
rho, infeasibility certificates and the optional active-set polish.
``banded_solver`` picks the factorization of the per-scenario solver:
``"thomas"`` (block-Thomas, ``btd_factor``/``btd_solve``) or ``"cr"``
(cyclic reduction, ``cr_factor``/``cr_solve``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import as_tensors
from ..ops.block_tridiag import btd_factor, btd_solve, cr_factor, cr_solve
from .admm import (
    ADMMSettings,
    QPSolution,
    _RHO_EQ_OVER_RHO_INEQ,
    _RHO_MAX,
    _RHO_MIN,
    _RHO_TOL,
    _limit_scaling,
    f32_matmuls,
)

__all__ = [
    "BandedQP",
    "admm_solve_banded",
    "apply_scalings",
    "ruiz_equilibrate_banded",
    "ruiz_equilibrate_banded_T",
    "banded_residuals",
    "banded_certificates",
    "banded_certificates_T",
    "banded_polish",
]

_INF = float("inf")


class BandedQP(NamedTuple):
    """Stage-block description of one QP, or of a batch with a trailing
    scenario axis on every field.

    ``Hb``: (N, w, w) regularized Hessian blocks;
    ``J0``/``J1``: (N-1, r, w) dynamics Jacobians wrt frame k / k+1
    (``r = 0`` -> shape (N-1, 0, w));
    ``Jc``: (N, r2, w) stage-constraint Jacobians (``r2 = 0`` allowed);
    ``q``: (N*w,) linear term;
    ``l``/``u``: bounds over rows ordered [x (N*w); dyn ((N-1)*r); sc (N*r2)].
    """

    Hb: torch.Tensor
    J0: torch.Tensor
    J1: torch.Tensor
    Jc: torch.Tensor
    q: torch.Tensor
    l: torch.Tensor
    u: torch.Tensor


def _batch1(qp: BandedQP) -> BandedQP:
    """Per-scenario QP -> batch-last QP with a batch of one."""
    return BandedQP(*(a.unsqueeze(-1) for a in qp))


def _rho_vec(l, u, rho, dtype):
    """Per-row rho: equality rows x1e3, loose rows at the floor (OSQP)."""
    rho = torch.as_tensor(rho, dtype=dtype, device=l.device)
    loose = torch.logical_and(l <= -_INF, u >= _INF)
    eq = (u - l) < _RHO_TOL
    rho_v = torch.full(l.shape, float(rho), dtype=dtype, device=l.device)
    rho_v = torch.where(
        eq, torch.clamp(rho * _RHO_EQ_OVER_RHO_INEQ, _RHO_MIN, _RHO_MAX), rho_v
    )
    rho_v = torch.where(loose, torch.full_like(rho_v, _RHO_MIN), rho_v)
    return rho_v


def _amax0(a):
    """max over every axis but the trailing batch axis -> (B,)."""
    return torch.amax(a.reshape(-1, a.shape[-1]), dim=0)


# ---------------------------------------------------------------------------
# Ruiz equilibration


def _banded_tensors(qp, *arrays, device=None):
    """``BandedQP(*qp)`` and ``arrays`` as tensors (:func:`..device.as_tensors`:
    what is not a tensor goes to ``device``, by default the first
    tensor's)."""
    out = as_tensors(*qp, *arrays, device=device)
    return (BandedQP(*out[:len(BandedQP._fields)]),) + out[len(BandedQP._fields):]


def ruiz_equilibrate_banded_T(qpT: BandedQP, iters: int):
    """Batch-last modified Ruiz equilibration on stage blocks.

    Mirrors the per-scenario JAX ``ruiz_equilibrate_banded`` (OSQP
    ``scale.c``) with a trailing scenario axis: every column/row inf-norm
    of ``[[P, A^T], [A, 0]]`` is assembled from the block contributions.
    Returns ``(scaled_qpT, D (n, B), E (m, B), c (B,))`` with
    ``Hb_s = c D Hb D``, ``A_s = E A D``, ``q_s = c D q``, ``l_s = E l``.
    """
    Hb, J0, J1, Jc = qpT.Hb, qpT.J0, qpT.J1, qpT.Jc
    N, w, B = Hb.shape[0], Hb.shape[1], Hb.shape[-1]
    r = J0.shape[1]
    r2 = Jc.shape[1]
    n = N * w
    dtype, dev = Hb.dtype, Hb.device

    def scaled_blocks(D, Ex, Ed, Ec, c):
        # D/Ex: (N, w, B); Ed: (N-1, r, B); Ec: (N, r2, B); c: (B,).
        Pb = c * D[:, :, None, :] * Hb * D[:, None, :, :]
        Ax = Ex * D  # identity rows of A are diagonal: value per (k, j)
        Ad0 = Ed[:, :, None, :] * J0 * D[:-1, None, :, :] if r else J0
        Ad1 = Ed[:, :, None, :] * J1 * D[1:, None, :, :] if r else J1
        Ac = Ec[:, :, None, :] * Jc * D[:, None, :, :] if r2 else Jc
        return Pb, Ax, Ad0, Ad1, Ac

    D = torch.ones((N, w, B), dtype=dtype, device=dev)
    Ex = torch.ones((N, w, B), dtype=dtype, device=dev)
    Ed = torch.ones((max(N - 1, 0), r, B), dtype=dtype, device=dev)
    Ec = torch.ones((N, r2, B), dtype=dtype, device=dev)
    c = torch.ones((B,), dtype=dtype, device=dev)
    for _ in range(iters):
        Pb, Ax, Ad0, Ad1, Ac = scaled_blocks(D, Ex, Ed, Ec, c)
        # Column inf-norms of [Pb; Ab] per variable (k, j): P block k, its
        # identity row, dynamics rows k (J0) and k-1 (J1), stage rows k.
        norm_x = torch.amax(torch.abs(Pb), dim=1)
        norm_x = torch.maximum(norm_x, torch.abs(Ax))
        if r:
            norm_x = norm_x.clone()
            norm_x[:-1] = torch.maximum(
                norm_x[:-1], torch.amax(torch.abs(Ad0), dim=1)
            )
            norm_x[1:] = torch.maximum(
                norm_x[1:], torch.amax(torch.abs(Ad1), dim=1)
            )
        if r2:
            norm_x = torch.maximum(norm_x, torch.amax(torch.abs(Ac), dim=1))
        D = D / torch.sqrt(_limit_scaling(norm_x))
        # Row inf-norms of Ab (same pre-update blocks, as in the dense path).
        Ex = Ex / torch.sqrt(_limit_scaling(torch.abs(Ax)))
        if r:
            nrow = torch.maximum(
                torch.amax(torch.abs(Ad0), dim=2), torch.amax(torch.abs(Ad1), dim=2)
            )
            Ed = Ed / torch.sqrt(_limit_scaling(nrow))
        if r2:
            Ec = Ec / torch.sqrt(_limit_scaling(torch.amax(torch.abs(Ac), dim=2)))
        # Cost scaling: gamma = 1/max(mean P col-norm, ||qb||_inf).
        Pb = c * D[:, :, None, :] * Hb * D[:, None, :, :]
        qb = c * (D.reshape(n, B) * qpT.q)
        mean_pcol = torch.mean(torch.amax(torch.abs(Pb), dim=1), dim=(0, 1))
        gamma = 1.0 / _limit_scaling(
            torch.maximum(mean_pcol, _amax0(torch.abs(qb)))
        )
        c = c * gamma
    # Pin the identity-row scaling to its equilibration fixed point EXACTLY:
    # every solver hardcodes the scaled x-section of A as the identity,
    # which is only correct when Ex * D == 1 (Ruiz lands ~5e-4 away).
    Ex = 1.0 / D

    E_parts = [Ex.reshape(n, B)]
    if r:
        E_parts.append(Ed.reshape(-1, B))
    if r2:
        E_parts.append(Ec.reshape(-1, B))
    E = torch.cat(E_parts, dim=0)
    scaled = BandedQP(
        Hb=c * D[:, :, None, :] * Hb * D[:, None, :, :],
        J0=Ed[:, :, None, :] * J0 * D[:-1, None, :, :] if r else J0,
        J1=Ed[:, :, None, :] * J1 * D[1:, None, :, :] if r else J1,
        Jc=Ec[:, :, None, :] * Jc * D[:, None, :, :] if r2 else Jc,
        q=c * D.reshape(n, B) * qpT.q,
        l=E * qpT.l,
        u=E * qpT.u,
    )
    return scaled, D.reshape(n, B), E, c


def ruiz_equilibrate_banded(qp: BandedQP, iters: int, *, device=None):
    """Per-scenario modified Ruiz equilibration; returns
    ``(scaled_qp, D (n,), E (m,), c ())``.  Fields that are not tensors go
    to ``device`` (:func:`_banded_tensors`)."""
    qp, = _banded_tensors(qp, device=device)
    scaled, D, E, c = ruiz_equilibrate_banded_T(_batch1(qp), iters)
    return (
        BandedQP(*(a[..., 0] for a in scaled)),
        D[:, 0],
        E[:, 0],
        c[0],
    )


def apply_scalings(qp: BandedQP, D, E, c):
    """Scale a per-scenario BandedQP with PRECOMPUTED Ruiz factors (one
    elementwise pass — the reuse path behind ``scaling_refresh="tick"``).
    ``D (n,)``, ``E (m,)`` ordered [x; dyn; sc], ``c`` scalar."""
    N, w = qp.Hb.shape[0], qp.Hb.shape[1]
    r = qp.J0.shape[1]
    r2 = qp.Jc.shape[1]
    n = N * w
    Dn = D.reshape(N, w)
    Ed = E[n : n + (N - 1) * r].reshape(N - 1, r) if r else None
    Ec = E[n + (N - 1) * r :].reshape(N, r2) if r2 else None
    return BandedQP(
        Hb=c * Dn[:, :, None] * qp.Hb * Dn[:, None, :],
        J0=Ed[:, :, None] * qp.J0 * Dn[:-1, None, :] if r else qp.J0,
        J1=Ed[:, :, None] * qp.J1 * Dn[1:, None, :] if r else qp.J1,
        Jc=Ec[:, :, None] * qp.Jc * Dn[:, None, :] if r2 else qp.Jc,
        q=c * D * qp.q,
        l=E * qp.l,
        u=E * qp.u,
    )


# ---------------------------------------------------------------------------
# Structural products, batch-last


def _apply_A_T(qpT: BandedQP, x3):
    """A @ x from stage blocks: ``x3 (N, w, B)`` -> rows ``(m, B)``
    ordered [x; dyn; sc] (the x-section of A is the identity)."""
    B = x3.shape[-1]
    parts = [x3.reshape(-1, B)]
    if qpT.J0.shape[1]:
        ax_d = torch.sum(qpT.J0 * x3[:-1, None, :, :], dim=2) + torch.sum(
            qpT.J1 * x3[1:, None, :, :], dim=2
        )
        parts.append(ax_d.reshape(-1, B))
    if qpT.Jc.shape[1]:
        parts.append(torch.sum(qpT.Jc * x3[:, None, :, :], dim=2).reshape(-1, B))
    return torch.cat(parts, dim=0)


def _apply_AT_T(qpT: BandedQP, tT):
    """A^T @ t from stage blocks: ``tT (m, B)`` -> ``(N, w, B)``."""
    N, w, B = qpT.Hb.shape[0], qpT.Hb.shape[1], tT.shape[-1]
    r = qpT.J0.shape[1]
    r2 = qpT.Jc.shape[1]
    n = N * w
    out = tT[:n].reshape(N, w, B)
    if r:
        td = tT[n : n + (N - 1) * r].reshape(N - 1, r, B)
        out = out.clone()
        out[:-1] += torch.sum(qpT.J0 * td[:, :, None, :], dim=1)
        out[1:] += torch.sum(qpT.J1 * td[:, :, None, :], dim=1)
    if r2:
        tc = tT[n + (N - 1) * r :].reshape(N, r2, B)
        out = out + torch.sum(qpT.Jc * tc[:, :, None, :], dim=1)
    return out


def _apply_P_T(qpT: BandedQP, x3):
    """P @ x (block-diagonal Hessian): ``(N, w, B)`` -> ``(N, w, B)``."""
    return torch.sum(qpT.Hb * x3[:, None, :, :], dim=2)


def _outer_r(rho_s, ja, jb):
    """sum_r rho[k,r] * ja[k,r,a] * jb[k,r,b] -> (k, w, w, B): a sequential
    r-chain, ascending — the chunk kernel's M-assembly order."""
    acc = None
    for i in range(ja.shape[1]):
        t = (rho_s[:, i, None, None, :] * ja[:, i, :, None, :]) * jb[
            :, i, None, :, :
        ]
        acc = t if acc is None else acc + t
    return acc


def _build_M_blocks_T(qpT: BandedQP, rho_vT, sigma):
    """Diagonal/subdiagonal blocks of M = P + sigma I + A^T R A, batch-last:
    ``diag (N, w, w, B)``, ``lower (N-1, w, w, B)``."""
    N, w, B = qpT.Hb.shape[0], qpT.Hb.shape[1], qpT.Hb.shape[-1]
    r = qpT.J0.shape[1]
    r2 = qpT.Jc.shape[1]
    n = N * w
    dtype, dev = qpT.Hb.dtype, qpT.Hb.device
    rho_x = rho_vT[:n].reshape(N, w, B)
    eye_w = torch.eye(w, dtype=dtype, device=dev)[None, :, :, None]
    diag = qpT.Hb + sigma * eye_w + eye_w * rho_x[:, :, None, :]
    if r:
        rho_d = rho_vT[n : n + (N - 1) * r].reshape(N - 1, r, B)
        diag = diag.clone()
        diag[:-1] += _outer_r(rho_d, qpT.J0, qpT.J0)
        diag[1:] += _outer_r(rho_d, qpT.J1, qpT.J1)
        lower = _outer_r(rho_d, qpT.J1, qpT.J0)
    else:
        lower = torch.zeros((N - 1, w, w, B), dtype=dtype, device=dev)
    if r2:
        rho_c = rho_vT[n + (N - 1) * r :].reshape(N, r2, B)
        diag = diag + _outer_r(rho_c, qpT.Jc, qpT.Jc)
    return diag, lower


# Per-scenario forms (a batch of one).


def _apply_A(qp: BandedQP, x):
    """A @ x.  x: (N, w) -> rows [x; dyn; sc] flattened."""
    return _apply_A_T(_batch1(qp), x[..., None])[:, 0]


def _apply_AT(qp: BandedQP, t):
    """A^T @ t.  t: (m,) -> (N, w)."""
    return _apply_AT_T(_batch1(qp), t[:, None])[..., 0]


def _apply_P(qp: BandedQP, x):
    """P @ x.  x: (N, w) -> (N, w)."""
    return _apply_P_T(_batch1(qp), x[..., None])[..., 0]


def _build_M_blocks(qp: BandedQP, rho_v, sigma):
    """Per-scenario ``(diag (N, w, w), lower (N-1, w, w))``."""
    diag, lower = _build_M_blocks_T(_batch1(qp), rho_v[:, None], sigma)
    return diag[..., 0], lower[..., 0]


# ---------------------------------------------------------------------------
# Residuals and certificates


def banded_residuals_T(qpT: BandedQP, x, z, y, Einv, Dinv, cinv, st: ADMMSettings):
    """OSQP unscaled residuals/tolerances, batch-last.

    ``x (n, B)`` scaled iterate; ``z``/``y`` ``(m, B)`` scaled;
    ``Einv``/``Dinv`` row/variable inverse scalings; ``cinv (B,)``.
    Returns ``(r_prim, r_dual, eps_pri, eps_dua, rp_rel, rd_rel)``, each (B,).
    """
    N, w, B = qpT.Hb.shape[0], qpT.Hb.shape[1], x.shape[-1]
    x3 = x.reshape(N, w, B)
    Ax = _apply_A_T(qpT, x3)
    Px = _apply_P_T(qpT, x3).reshape(-1, B)
    Aty = _apply_AT_T(qpT, y).reshape(-1, B)
    q = qpT.q
    r_prim = _amax0(torch.abs((Ax - z) * Einv))
    r_dual = cinv * _amax0(torch.abs((Px + q + Aty) * Dinv))
    max_prim = torch.maximum(
        _amax0(torch.abs(Ax * Einv)), _amax0(torch.abs(z * Einv))
    )
    max_dual = cinv * torch.maximum(
        torch.maximum(_amax0(torch.abs(Aty * Dinv)), _amax0(torch.abs(Px * Dinv))),
        _amax0(torch.abs(q * Dinv)),
    )
    eps_pri = st.eps_abs + st.eps_rel * max_prim
    eps_dua = st.eps_abs + st.eps_rel * max_dual
    rp_rel = r_prim / torch.clamp(max_prim, min=1e-12)
    rd_rel = r_dual / torch.clamp(max_dual, min=1e-12)
    return r_prim, r_dual, eps_pri, eps_dua, rp_rel, rd_rel


def banded_residuals(qp: BandedQP, x, z, y, Einv, Dinv, cinv, st: ADMMSettings, *,
                     device=None):
    """Per-scenario :func:`banded_residuals_T`; returns 0-d tensors.
    Arrays that are not tensors go to ``device`` (:func:`_banded_tensors`)."""
    qp, x, z, y, Einv, Dinv, cinv = _banded_tensors(qp, x, z, y, Einv, Dinv, cinv,
                                                    device=device)
    outs = banded_residuals_T(
        _batch1(qp), x[:, None], z[:, None], y[:, None],
        Einv[:, None], Dinv[:, None], cinv.reshape(1), st,
    )
    return tuple(o[0] for o in outs)


def banded_certificates_T(qpT: BandedQP, dx_s, dy_s, D, E, cinv, st: ADMMSettings):
    """OSQP delta-iterate infeasibility certificates on UNSCALED quantities,
    batch-last: ``dx_s (n, B)``, ``dy_s (m, B)`` scaled iterate deltas,
    ``D (n, B)``, ``E (m, B)``, ``cinv (B,)`` -> ``(prim_inf, dual_inf)``
    bool (B,).  With A_s = E A D, P_s = c D P D, q_s = c D q:

        dy_u = E dy_s / c;  A^T dy_u = (1/c) D^-1 A_s^T dy_s;
        dx_u = D dx_s;      P dx_u = (1/c) D^-1 P_s dx_s;
        q . dx_u = (1/c) q_s . dx_s;  A dx_u = E^-1 A_s dx_s.
    """
    N, w, B = qpT.Hb.shape[0], qpT.Hb.shape[1], dx_s.shape[-1]
    l, u, q = qpT.l, qpT.u, qpT.q
    Dinv, Einv = 1.0 / D, 1.0 / E
    tiny = 1e-12
    zero = torch.zeros((), dtype=l.dtype, device=l.device)
    # -- primal infeasibility via dy.
    dy_u = E * dy_s * cinv
    ndy = _amax0(torch.abs(dy_u))
    lu, uu = l * Einv, u * Einv  # original bounds
    dy_p = torch.clamp(dy_u, min=0.0)
    dy_m = torch.clamp(dy_u, max=0.0)
    support = torch.sum(
        torch.where(dy_p > 0, uu * dy_p, zero)
        + torch.where(dy_m < 0, lu * dy_m, zero),
        dim=0,
    )
    n_Atdy = cinv * _amax0(
        torch.abs(Dinv * _apply_AT_T(qpT, dy_s).reshape(-1, B))
    )
    prim_inf = (
        (ndy > tiny)
        & (support < -st.eps_prim_inf * ndy)
        & (n_Atdy < st.eps_prim_inf * ndy)
    )
    # -- dual infeasibility via dx.
    dx3 = dx_s.reshape(N, w, B)
    dx_u = D * dx_s
    ndx = _amax0(torch.abs(dx_u))
    thr = st.eps_dual_inf * ndx
    cond_q = cinv * torch.sum(q * dx_s, dim=0) < -thr
    cond_P = cinv * _amax0(torch.abs(Dinv * _apply_P_T(qpT, dx3).reshape(-1, B))) < thr
    Adx = Einv * _apply_A_T(qpT, dx3)
    true = torch.ones_like(Adx, dtype=torch.bool)
    cond_A = torch.all(torch.where(uu < _INF, Adx < thr, true), dim=0) & torch.all(
        torch.where(lu > -_INF, Adx > -thr, true), dim=0
    )
    dual_inf = (ndx > tiny) & cond_q & cond_P & cond_A
    return prim_inf, dual_inf


def banded_certificates(qp: BandedQP, dx_s, dy_s, D, E, cinv, st: ADMMSettings, *,
                        device=None):
    """Per-scenario :func:`banded_certificates_T`; returns 0-d bools.
    Arrays that are not tensors go to ``device`` (:func:`_banded_tensors`)."""
    qp, dx_s, dy_s, D, E, cinv = _banded_tensors(qp, dx_s, dy_s, D, E, cinv, device=device)
    pinf, dinf = banded_certificates_T(
        _batch1(qp), dx_s[:, None], dy_s[:, None], D[:, None], E[:, None],
        cinv.reshape(1), st,
    )
    return pinf[0], dinf[0]


# ---------------------------------------------------------------------------
# Polish


def banded_polish(
    qp: BandedQP,
    st: ADMMSettings,
    factor,
    solve,
    x,
    y,
    z,
    r_prim,
    r_dual,
    Einv,
    Dinv,
    cinv,
    *,
    device=None,
):
    """Active-set polish with block structure (OSQP ``polish.c`` analog):
    rows whose dual sits on a bound with matching sign are pinned via a
    1/delta penalty in the same block-tridiagonal operator family, and two
    augmented-Lagrangian sweeps remove the O(delta) bias.  Accepted only if
    both unscaled residuals improve.  Per scenario, all quantities in
    SCALED space; returns updated ``(x, y, z, r_prim, r_dual)``.  Arrays
    that are not tensors go to ``device`` (:func:`_banded_tensors`).
    """
    qp, x, y, z, r_prim, r_dual, Einv, Dinv, cinv = _banded_tensors(
        qp, x, y, z, r_prim, r_dual, Einv, Dinv, cinv, device=device)
    N, w = qp.Hb.shape[0], qp.Hb.shape[1]
    m = qp.l.shape[0]
    dtype, dev = qp.Hb.dtype, qp.Hb.device
    l, u, q = qp.l, qp.u, qp.q
    zero = torch.zeros((), dtype=dtype, device=dev)
    delta = torch.tensor(st.polish_delta, dtype=dtype, device=dev)
    lower_act = y < 0.0
    upper_act = y > 0.0
    active = torch.logical_or(lower_act, upper_act)
    b_act = torch.where(upper_act, u, torch.where(lower_act, l, zero))
    rho_pol = torch.where(active, 1.0 / delta, zero)
    diag_p, lower_p = _build_M_blocks(qp, rho_pol, delta)
    fac_p = factor(diag_p, lower_p)

    nu = torch.zeros((m,), dtype=dtype, device=dev)
    x_p = x
    for _ in range(2):  # augmented-Lagrangian sweeps
        rhs = -q + _apply_AT(qp, (rho_pol * b_act - nu)).reshape(-1)
        x_p = solve(fac_p, rhs.reshape(N, w)).reshape(-1)
        Axp = _apply_A(qp, x_p.reshape(N, w))
        nu = nu + torch.where(active, rho_pol * (Axp - b_act), zero)
    y_p = torch.where(active, nu, zero)
    z_p = torch.clip(_apply_A(qp, x_p.reshape(N, w)), l, u)
    rp_p, rd_p, _, _, _, _ = banded_residuals(
        qp, x_p, z_p, y_p, Einv, Dinv, cinv, st
    )
    better = torch.logical_and(rp_p <= r_prim, rd_p <= r_dual)
    pick = lambda a, b: torch.where(better, a, b)  # noqa: E731
    return pick(x_p, x), pick(y_p, y), pick(z_p, z), pick(rp_p, r_prim), pick(rd_p, r_dual)


# ---------------------------------------------------------------------------
# Per-scenario solver


@f32_matmuls
def admm_solve_banded(
    qp: BandedQP,
    settings: ADMMSettings = ADMMSettings(),
    x0: Optional[torch.Tensor] = None,  # (n,) warm start
    y0: Optional[torch.Tensor] = None,  # (m,)
    on_device: bool = False,
    *,
    device=None,
) -> QPSolution:
    """Solve one stage-structured QP without dense operators.

    The per-scenario reference path (and the per-scenario
    ``compute_optimal_trajectory`` path): plain torch on the QP's device,
    with the JAX version's round structure — rho and the factorization stay
    constant for one adaptation interval, adaptation happens between
    rounds, termination and certificates every ``check_every`` iterations.
    Loop conditions are read on the host; ``on_device`` keeps them on the
    device instead (one ``torch.while_loop``, an ADMM iteration a trip, the
    adaptive refactorization applied by mask): the same results, and the
    form ``torch.export`` traces.  Arrays that are not tensors go to
    ``device`` (:func:`_banded_tensors`).
    """
    qp, x0, y0 = _banded_tensors(qp, x0, y0, device=device)
    st = settings
    dtype, dev = qp.Hb.dtype, qp.Hb.device
    N, w = qp.Hb.shape[0], qp.Hb.shape[1]
    n = N * w
    m = qp.l.shape[0]
    sigma = torch.tensor(st.sigma, dtype=dtype, device=dev)
    alpha = torch.tensor(st.alpha, dtype=dtype, device=dev)
    qp = qp._replace(
        l=torch.minimum(qp.l.to(dtype), qp.u.to(dtype)),
        u=qp.u.to(dtype),
        q=qp.q.to(dtype),
    )
    qp, D, E, c = ruiz_equilibrate_banded(qp, st.scaling_iters)
    l, u, q = qp.l, qp.u, qp.q
    Dinv, Einv, cinv = 1.0 / D, 1.0 / E, 1.0 / c

    if st.banded_solver == "cr":
        factor, solve = cr_factor, cr_solve
    elif st.banded_solver == "thomas":
        factor, solve = btd_factor, btd_solve
    else:
        raise ValueError(f"unknown banded_solver: {st.banded_solver!r}")

    rho_v = _rho_vec(l, u, st.rho, dtype)
    fac = factor(*_build_M_blocks(qp, rho_v, sigma))

    x = torch.zeros((n,), dtype=dtype, device=dev) if x0 is None else x0.to(dtype) * Dinv
    y = torch.zeros((m,), dtype=dtype, device=dev) if y0 is None else c * y0.to(dtype) * Einv
    z = torch.clip(_apply_A(qp, x.reshape(N, w)), l, u)

    def one_iter(x, z, y, fac, rho_v):
        rhs = sigma * x - q + _apply_AT(qp, rho_v * z - y).reshape(-1)
        xt = solve(fac, rhs.reshape(N, w)).reshape(-1)
        zt = _apply_A(qp, xt.reshape(N, w))
        x_new = alpha * xt + (1 - alpha) * x
        z_rel = alpha * zt + (1 - alpha) * z
        z_new = torch.clip(z_rel + y / rho_v, l, u)
        y_new = y + rho_v * (z_rel - z_new)
        return x_new, z_new, y_new

    if st.adaptive_rho:
        interval = max(st.adaptive_rho_interval, st.check_every)
        interval = ((interval + st.check_every - 1) // st.check_every) * st.check_every
    else:
        interval = st.max_iter

    inf = torch.tensor(_INF, dtype=dtype, device=dev)
    false = torch.tensor(False, device=dev)
    done, pinf, dinf = false, false, false
    r_prim, r_dual = inf, inf
    if on_device:
        return _banded_on_device(
            qp, st, factor, solve, fac, one_iter, interval, x, z, y, rho_v, sigma,
            D, E, Dinv, Einv, cinv,
        )
    it = 0
    stop = lambda: bool(done | pinf | dinf)  # noqa: E731
    while it < st.max_iter and not stop():
        # One rho-constant round of check blocks.
        k = 0
        rp_rel = rd_rel = None
        while k < interval and it + k < st.max_iter and not stop():
            x_old, y_old = x, y
            for _ in range(st.check_every):
                x, z, y = one_iter(x, z, y, fac, rho_v)
            r_prim, r_dual, eps_pri, eps_dua, rp_rel, rd_rel = banded_residuals(
                qp, x, z, y, Einv, Dinv, cinv, st
            )
            done = torch.logical_and(r_prim <= eps_pri, r_dual <= eps_dua)
            if st.check_infeasibility:
                pinf, dinf = banded_certificates(
                    qp, x - x_old, y - y_old, D, E, cinv, st
                )
                pinf = pinf & ~done
                dinf = dinf & ~done
            k += st.check_every
        it += k
        if st.adaptive_rho:
            scale = torch.sqrt(rp_rel / torch.clamp(rd_rel, min=1e-12))
            scale = torch.clamp(scale, 1e-3, 1e3)
            trigger = bool(
                (scale > st.adaptive_rho_tolerance)
                | (scale < 1.0 / st.adaptive_rho_tolerance)
            )
            if trigger and not bool(done):
                rho_v = torch.clamp(rho_v * scale, _RHO_MIN, _RHO_MAX)
                fac = factor(*_build_M_blocks(qp, rho_v, sigma))

    if st.polish:
        x, y, z, r_prim, r_dual = banded_polish(
            qp, st, factor, solve, x, y, z, r_prim, r_dual,
            Einv, Dinv, cinv,
        )

    return QPSolution(
        x=D * x,
        y=E * y * cinv,
        z=z * Einv,
        iters=torch.tensor(it, dtype=torch.int32, device=dev),
        converged=done,
        r_prim=r_prim,
        r_dual=r_dual,
        prim_inf=pinf,
        dual_inf=dinf,
    )


def _banded_on_device(qp, st, factor, solve, fac, one_iter, interval, x, z, y, rho_v, sigma,
                      D, E, Dinv, Einv, cinv) -> QPSolution:
    """:func:`admm_solve_banded`'s loops as one ``torch.while_loop``, an
    ADMM iteration a trip, in the host loops' order: the trip that ends a
    check block checks it, and when the round's condition then fails, ends
    the round (iteration count, adaptive rho with a refactorization kept by
    mask).  Nested loops do not export beside the derivative code's
    grad-mode regions, and a loop body may capture no two tensors that
    alias, hence the flat loop and the clones."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    dev = x.device
    ce = st.check_every
    leaves, spec = tree_flatten(fac)
    is_t = [isinstance(v, torch.Tensor) for v in leaves]

    def unflat(ts):
        it_ts = iter(ts)
        return tree_unflatten([next(it_ts) if t else v for v, t in zip(leaves, is_t)], spec)

    def refactor(rho):
        fl, _ = tree_flatten(factor(*_build_M_blocks(qp, rho, sigma)))
        return [v for v in fl if isinstance(v, torch.Tensor)]

    def stop_of(done, pinf, dinf):
        return done | pinf | dinf

    def trip(j, it, k, x, z, y, x_old, y_old, rho_v, done, pinf, dinf, r_prim, r_dual,
             rp_rel, rd_rel, *fac_ts):
        first = j == 0
        x_old = torch.where(first, x, x_old)
        y_old = torch.where(first, y, y_old)
        x, z, y = one_iter(x, z, y, unflat(fac_ts), rho_v)
        last = j == ce - 1
        rp, rd, eps_pri, eps_dua, rpr, rdr = banded_residuals(qp, x, z, y, Einv, Dinv, cinv, st)
        done_n = torch.logical_and(rp <= eps_pri, rd <= eps_dua)
        pinf_n, dinf_n = pinf, dinf
        if st.check_infeasibility:
            pinf_n, dinf_n = banded_certificates(qp, x - x_old, y - y_old, D, E, cinv, st)
            pinf_n, dinf_n = pinf_n & ~done_n, dinf_n & ~done_n
        done, pinf, dinf, r_prim, r_dual, rp_rel, rd_rel = (
            torch.where(last, a, b) for a, b in zip(
                (done_n, pinf_n, dinf_n, rp, rd, rpr, rdr),
                (done, pinf, dinf, r_prim, r_dual, rp_rel, rd_rel)))
        k = torch.where(last, k + ce, k)
        go_on = (k < interval) & (it + k < st.max_iter) & ~stop_of(done, pinf, dinf)
        end = last & ~go_on
        it = torch.where(end, it + k, it)
        k = torch.where(end, torch.zeros_like(k), k)
        fac_ts = list(fac_ts)
        if st.adaptive_rho:
            scale = torch.clamp(torch.sqrt(rp_rel / torch.clamp(rd_rel, min=1e-12)), 1e-3, 1e3)
            trigger = (scale > st.adaptive_rho_tolerance) | (scale < 1.0 / st.adaptive_rho_tolerance)
            refit = end & trigger & ~done
            new_rho = torch.clamp(rho_v * scale, _RHO_MIN, _RHO_MAX)
            fac_ts = [torch.where(refit, a, b) for a, b in zip(refactor(new_rho), fac_ts)]
            rho_v = torch.where(refit, new_rho, rho_v)
        j = torch.where(last, torch.zeros_like(j), j + 1)
        return tuple(t.clone(memory_format=torch.contiguous_format) for t in (
            j, it, k, x, z, y, x_old, y_old, rho_v, done, pinf, dinf, r_prim, r_dual,
            rp_rel, rd_rel, *fac_ts))

    def cond(j, it, k, x, z, y, x_old, y_old, rho_v, done, pinf, dinf, *_):
        return (j != 0) | ((it < st.max_iter) & ~stop_of(done, pinf, dinf))

    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    inf = torch.full((), _INF, dtype=x.dtype, device=dev)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    s = (torch.zeros((), dtype=torch.int64, device=dev), zero_i, zero_i, x, z, y, x, y, rho_v,
         false, false, false, inf, inf, inf, inf,
         *(v for v in leaves if isinstance(v, torch.Tensor)))
    s = torch.while_loop(cond, trip,
                         tuple(t.clone(memory_format=torch.contiguous_format) for t in s))
    it, x, z, y = s[1], s[3], s[4], s[5]
    done, pinf, dinf, r_prim, r_dual = s[9:14]
    if st.polish:
        x, y, z, r_prim, r_dual = banded_polish(
            qp, st, factor, solve, x, y, z, r_prim, r_dual, Einv, Dinv, cinv,
        )
    return QPSolution(
        x=D * x,
        y=E * y * cinv,
        z=z * Einv,
        iters=it,
        converged=done,
        r_prim=r_prim,
        r_dual=r_dual,
        prim_inf=pinf,
        dual_inf=dinf,
    )
