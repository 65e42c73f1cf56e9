"""Sequence-parallel ADMM: the banded OCP QP solved with the horizon
sharded across a mesh — port of
``optimal_control_problem_tpu/parallel/seq_admm.py``.

The block-structured OSQP iteration of ``solvers/admm_banded.py`` with the
SPIKE partition solve of :mod:`.horizon`: every stage-local quantity
(Hessian and Jacobian blocks, bounds, iterates) is split over the mesh
axis, and each ADMM iteration does

* neighbour ``ppermute`` exchanges for the off-by-one dynamics couplings
  (A and A^T across chunk boundaries),
* a local block-LDL^T solve against the chunk factorization,
* one small ``all_gather`` for the reduced interface system,

with the termination reductions on ``pmax``.  Modified Ruiz
equilibration runs distributed at setup, and adaptive rho runs
round-based: each adaptation interval refactors the SPIKE partition with
the rescaled rho, the trigger a globally reduced scalar so every shard
runs the same collectives.

JAX's two ``while_loop``s (the rho rounds, and the check blocks of a
round) are Python loops here.  Each reads one host bool a check, after
the ``pmax`` that makes it the same on every shard and rank, so every
rank takes the same branch.  Where JAX ``vmap``s this function over a
local scenario batch (a 2-D mesh, :mod:`.seq_sqp`), its loops run while
any scenario's condition holds and freeze the others; the port masks the
same way.  ``on_device`` runs both loops, the check block's iterations
and the Ruiz sweeps as device-side loops (:func:`_while`) instead, and
the SPIKE chunk's stage recursions as scan operators (``ops/block_tridiag``,
``loop=True``), the conditions on the device and the freezing by the same
masks: the same
results bitwise, no host read, and the form ``torch.export`` traces
(``admm_solve_seq_parallel.export_form``, which ``export_solver`` finds
through a ``functools.partial``).  Over a ``torch.distributed`` mesh the
collectives are torch's functional ones, which the trace keeps as op
nodes, and the rank's coordinate is a constant: each rank exports its own
program.  Local tensors carry the shard dimension S first
(``parallel/mesh.py``).
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import NamedTuple

import torch
from torch.utils._pytree import _register_namedtuple

from ..device import as_tensors
from ..ops.block_tridiag import BTDFactor, btd_factor, btd_solve, btd_solve_mat
from ..solvers.admm import (
    ADMMSettings,
    _RHO_EQ_OVER_RHO_INEQ,
    _RHO_MAX,
    _RHO_MIN,
    _RHO_TOL,
    _limit_scaling,
    f32_matmuls,
)
from .horizon import _neighbours, _reduced_operator, _spike_apply, _spike_blocks, _stage_first
from .mesh import Mesh

__all__ = ["ShardedBandedQP", "admm_solve_seq_parallel"]

_INF = float("inf")


class ShardedBandedQP(NamedTuple):
    """Per-stage layout of a stage-structured QP (leading dim = stages N).

    ``J0``/``J1`` are padded to N rows (row k = dynamics residual k for
    k < N-1; row N-1 zero).  Bounds are per-stage: ``lx``/``ux`` (N, w) box
    rows, ``ld``/``ud`` (N, r) dynamics rows (row N-1 ignored), ``lc``/``uc``
    (N, r2) stage-constraint rows.
    """

    Hb: torch.Tensor  # (N, w, w)
    J0: torch.Tensor  # (N, r, w)
    J1: torch.Tensor  # (N, r, w)
    Jc: torch.Tensor  # (N, r2, w)
    q: torch.Tensor  # (N, w)
    lx: torch.Tensor
    ux: torch.Tensor
    ld: torch.Tensor
    ud: torch.Tensor
    lc: torch.Tensor
    uc: torch.Tensor


# An exported admm_solve_seq_parallel takes this type: its program names
# it, and keeps example inputs of it that torch.load reads back.
_register_namedtuple(ShardedBandedQP, serialized_type_name=f"{__name__}.ShardedBandedQP")
torch.serialization.add_safe_globals([ShardedBandedQP])


def _rho_of(l, u, rho, dtype):
    loose = torch.logical_and(l <= -_INF, u >= _INF)
    eq = (u - l) < _RHO_TOL
    rho = torch.tensor(rho, dtype=dtype, device=l.device)
    r = torch.full(l.shape, float(rho), dtype=dtype, device=l.device)
    r = torch.where(eq, torch.clamp(rho * _RHO_EQ_OVER_RHO_INEQ, _RHO_MIN, _RHO_MAX), r)
    return torch.where(loose, torch.full_like(r, _RHO_MIN), r)


def _clip(x, lo, hi):
    """``jnp.clip``: ``min(max(x, lo), hi)``."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _mask_row(t, row: int, keep):
    """Row ``row`` of the stage dim times ``keep (S,)`` (0 on the boundary
    shard): a product, so a NaN there stays NaN, as in JAX."""
    t = t.clone()
    t[:, row] = t[:, row] * keep.reshape((-1,) + (1,) * (t.dim() - 2))
    return t


def _amax(*ts):
    """Per-shard max of ``|t|`` over every non-empty ``(S, ...)`` part
    (the max of JAX's concatenation; NaN kept)."""
    out = None
    for t in ts:
        if t.numel():
            m = torch.amax(torch.abs(t).reshape(t.shape[0], -1), dim=1)
            out = m if out is None else torch.maximum(out, m)
    return out


def _bvec(s, t):
    """A per-shard ``(S,)`` value broadcast against ``t (S, ...)``."""
    return s.reshape((-1,) + (1,) * (t.dim() - 1))


def _rho_outer(rho, ja, jb):
    """``sum_r rho[s,k,r] ja[s,k,r,a] jb[s,k,r,b] -> (S, C, w, w)``: an
    ascending r-chain."""
    acc = None
    for i in range(ja.shape[2]):
        t = (rho[:, :, i, None, None] * ja[:, :, i, :, None]) * jb[:, :, i, None, :]
        acc = t if acc is None else acc + t
    return acc


def _rows(J, x):
    """``J (S, C, r, w) @ x (S, C, w) -> (S, C, r)``."""
    return torch.sum(J * x[:, :, None, :], dim=-1)


def _cols(J, t):
    """``J^T (S, C, w, r) @ t (S, C, r) -> (S, C, w)``."""
    return torch.sum(J * t[..., None], dim=-2)


def _select(mask, new, old):
    """Per-shard ``where`` over a tuple of ``(S, ...)`` tensors."""
    return tuple(torch.where(_bvec(mask, n), n, o) for n, o in zip(new, old))


def _count(mask) -> int:
    """The one host read of a loop check: how many shards go on."""
    return int(mask.sum())


def _fresh_rows(ts):
    """Row-major copies of ``ts``: a device loop carries no aliasing
    tensors, and its body must return each one with the strides it took
    (the SPIKE solve returns the iterate stage-major)."""
    return tuple(t.clone(memory_format=torch.contiguous_format) for t in ts)


def _while(cond, body, carry, inputs):
    """``while cond(carry, inputs): carry = body(carry, inputs)`` on the
    device: torch's ``while_loop`` operator, with the tensors the loop
    reads besides its carry passed as explicit ``inputs`` (the bodies see
    them only as arguments).  So the loop runs eagerly as a plain loop,
    and ``torch.export`` traces each body as it traces the rest of the
    program (``torch.while_loop`` would first compile it with dynamo,
    minutes for these bodies).  Carry and results are row-major copies."""
    from torch._higher_order_ops.while_loop import while_loop_op

    n = len(carry)
    return while_loop_op(lambda *a: cond(a[:n], a[n:]),
                         lambda *a: _fresh_rows(body(a[:n], a[n:])),
                         _fresh_rows(carry), tuple(inputs))


def _repeat(n: int, fn, carry, inputs, on_device: bool):
    """``carry = fn(carry, inputs)`` ``n`` times: a Python loop, or on the
    device one counted :func:`_while` (JAX's ``fori_loop``)."""
    if not on_device:
        for _ in range(n):
            carry = fn(carry, inputs)
        return carry
    j0 = torch.zeros((), dtype=torch.int64, device=carry[0].device)
    return _while(lambda s, c: s[0] < n, lambda s, c: (s[0] + 1, *fn(s[1:], c)),
                  (j0, *carry), inputs)[1:]


def _ruiz_seq_local(ax, Hb, J0, J1, Jc, q, *, iters, axis, keep_first, left_shift, right_shift,
                    on_device=False):
    """Distributed modified Ruiz equilibration over the sharded stages
    (``solvers/admm_banded.ruiz_equilibrate_banded`` with the horizon
    split).  Per sweep: one right shift delivers each residual row's J1
    column-norm contribution to the next stage, one left shift fetches the
    next stage's variable scaling for the J1 row norms, and the cost
    scaling reduces with one psum and one pmax over ``axis``.  Returns
    per-stage factors ``(Dv, Ex, Ed, Ec)`` and the per-shard cost scaling
    ``c (S,)``; padded dynamics rows keep ``Ed = 1``.  ``on_device``: the
    sweeps as one counted device loop (:func:`_repeat`).

    The initial factors are ``1 + 0 * data`` as in JAX (where they type
    the loop carry): a non-finite entry of ``Hb``, ``J0`` or ``Jc`` makes
    its factor NaN, and one anywhere in ``Hb[:, 0, 0]`` on the axis makes
    ``c`` NaN — the outcome the port keeps."""
    S, C, w = Hb.shape[0], Hb.shape[1], Hb.shape[2]
    r, r2 = J0.shape[2], Jc.shape[2]
    N = C * ax.size(axis)
    Dv = 1.0 + 0.0 * Hb[..., 0]
    Ex = 1.0 + 0.0 * Hb[..., 0]
    Ed = 1.0 + 0.0 * J0[..., 0]
    Ec = 1.0 + 0.0 * Jc[..., 0]
    c = 1.0 + 0.0 * ax.psum(torch.sum(Hb[:, :, 0, 0], dim=1), axis)

    def sweep(carry, data):
        Dv, Ex, Ed, Ec, c = carry
        Hb, J0, J1, Jc, q, keep_first = data

        def pcol(c, Dv):
            return torch.amax(torch.abs(_bvec(c, Hb) * Dv[..., :, None] * Hb * Dv[..., None, :]),
                              dim=2)

        # Column inf-norms of the scaled [P; A] per variable (pre-update
        # scalings, as in the dense and banded paths).
        norm_x = torch.maximum(pcol(c, Dv), torch.abs(Ex * Dv))
        if r:
            norm_x = torch.maximum(norm_x, torch.amax(torch.abs(Ed[..., None] * J0), dim=2) * Dv)
            # Residual row k couples stage k+1 through J1: deliver row
            # C-1's contribution to the right neighbour's first stage.
            t = torch.amax(torch.abs(Ed[..., None] * J1), dim=2)  # (S, C, w)
            t_sh = torch.cat([right_shift(t[:, -1])[:, None], t[:, :-1]], dim=1)
            t_sh = _mask_row(t_sh, 0, keep_first)
            norm_x = torch.maximum(norm_x, t_sh * Dv)
        if r2:
            norm_x = torch.maximum(norm_x, torch.amax(torch.abs(Ec[..., None] * Jc), dim=2) * Dv)
        # Row inf-norms of the scaled A (same pre-update scalings).
        rowx = torch.abs(Ex * Dv)
        if r:
            Dv_next = torch.cat([Dv[:, 1:], left_shift(Dv[:, 0])[:, None]], dim=1)
            row_d = Ed * torch.maximum(
                torch.amax(torch.abs(J0 * Dv[:, :, None, :]), dim=3),
                torch.amax(torch.abs(J1 * Dv_next[:, :, None, :]), dim=3),
            )
        if r2:
            row_c = Ec * torch.amax(torch.abs(Jc * Dv[:, :, None, :]), dim=3)
        Dv = Dv / torch.sqrt(_limit_scaling(norm_x))
        Ex = Ex / torch.sqrt(_limit_scaling(rowx))
        if r:
            Ed = Ed / torch.sqrt(_limit_scaling(row_d))
        if r2:
            Ec = Ec / torch.sqrt(_limit_scaling(row_c))
        # Cost scaling (post-update Dv): gamma = 1/max(mean P col-norm,
        # ||qb||_inf), both global over the horizon axis.
        Pc = pcol(c, Dv)
        mean_pcol = ax.psum(torch.sum(Pc.reshape(S, -1), dim=1), axis) / (N * w)
        qmax = ax.pmax(torch.amax(torch.abs(_bvec(c, q) * Dv * q).reshape(S, -1), dim=1), axis)
        gamma = 1.0 / _limit_scaling(torch.maximum(mean_pcol, qmax))
        c = c * gamma
        return Dv, Ex, Ed, Ec, c

    return _repeat(iters, sweep, (Dv, Ex, Ed, Ec, c), (Hb, J0, J1, Jc, q, keep_first), on_device)


class _LoopData(NamedTuple):
    """What :func:`seq_admm_local`'s iteration reads besides its iterates:
    the scaled data, the scalings and their inverses, the boundary masks,
    the neighbour rows and the constants (local tensors ``(S, ...)``)."""

    Hb: torch.Tensor
    J0: torch.Tensor
    J1: torch.Tensor
    Jc: torch.Tensor
    q: torch.Tensor
    lx: torch.Tensor
    ux: torch.Tensor
    ld: torch.Tensor
    ud: torch.Tensor
    lc: torch.Tensor
    uc: torch.Tensor
    Dv: torch.Tensor
    Exs: torch.Tensor
    Eds: torch.Tensor
    Ecs: torch.Tensor
    cinv: torch.Tensor
    exi: torch.Tensor
    edi: torch.Tensor
    eci: torch.Tensor
    dvi: torch.Tensor
    dyn_valid: torch.Tensor
    keep_first: torch.Tensor
    keep_last: torch.Tensor
    is_first: torch.Tensor
    is_last: torch.Tensor
    d: torch.Tensor
    sigma: torch.Tensor
    alpha: torch.Tensor
    J0_prev: torch.Tensor
    J1_sh: torch.Tensor
    eye: torch.Tensor
    empty: torch.Tensor


_N_DATA = len(_LoopData._fields)


def _flat_ops(ops):
    """The SPIKE operators ``(fac, WL, WR, Kinv)`` as a flat tuple."""
    return (*ops[0], *ops[1:])


def _ops_of(ts):
    """:func:`_flat_ops` undone."""
    return (BTDFactor(*ts[:3]), *ts[3:])


def seq_admm_local(
    ax, Hb, J0, J1, Jc, q, lx, ux, ld, ud, lc, uc, *, settings: ADMMSettings, axis: str,
    sync_axes=None, warm=None, on_device: bool = False,
):
    """The per-device ADMM over local tensors ``(S, C, ...)`` (C stages a
    shard), against the collectives ``ax`` (``parallel/mesh.Shards``).

    ``sync_axes``: the mesh axes termination synchronizes over (default
    ``axis``); on a multi-axis mesh pass all of them, so every shard runs
    the same number of collective rounds.  ``warm``: ``(x, yx, yd, yc)`` in
    unscaled units.  Returns ``(x (S, C, w), iters (S,), converged (S,),
    prim_inf (S,), dual_inf (S,), warm_out)``; the flags are reduced over
    the horizon axis, so they are one problem's on each shard.
    ``on_device``: the loops on the device (module docstring).
    """
    st = settings
    if sync_axes is None:
        sync_axes = (axis,)
    dtype, dev = Hb.dtype, Hb.device
    S, C, w, _ = Hb.shape
    r, r2 = J0.shape[2], Jc.shape[2]
    D = ax.size(axis)

    def right_shift(t):
        """Row from the LEFT neighbour's last stage (shard d-1 -> d)."""
        return ax.ppermute(t, axis, 1)

    def left_shift(t):
        """Row from the RIGHT neighbour's first stage (shard d+1 -> d)."""
        return ax.ppermute(t, axis, -1)

    d = ax.axis_index(axis)
    is_first = d == 0
    is_last = d == D - 1
    keep_first = (~is_first).to(dtype)
    keep_last = (~is_last).to(dtype)
    sigma = torch.tensor(st.sigma, dtype=dtype, device=dev)
    alpha = torch.tensor(st.alpha, dtype=dtype, device=dev)

    # ---- distributed Ruiz equilibration (setup, fixed trip count) ----
    Dv, Exs, Eds, Ecs, c = _ruiz_seq_local(
        ax, Hb, J0, J1, Jc, q, iters=st.scaling_iters, axis=axis, keep_first=keep_first,
        left_shift=left_shift, right_shift=right_shift, on_device=on_device,
    )
    Dv_next = torch.cat([Dv[:, 1:], left_shift(Dv[:, 0])[:, None]], dim=1)
    Hb = _bvec(c, Hb) * Dv[..., :, None] * Hb * Dv[..., None, :]
    if r:
        J0 = Eds[..., None] * J0 * Dv[:, :, None, :]
        J1 = Eds[..., None] * J1 * Dv_next[:, :, None, :]
    if r2:
        Jc = Ecs[..., None] * Jc * Dv[:, :, None, :]
    q = _bvec(c, q) * Dv * q
    lx, ux = Exs * lx, Exs * ux
    ld, ud = Eds * ld, Eds * ud
    lc, uc = Ecs * lc, Ecs * uc
    cinv = 1.0 / c

    rho_x = _rho_of(lx, ux, st.rho, dtype)  # (S, C, w)
    rho_d = _rho_of(ld, ud, st.rho, dtype)  # (S, C, r)
    rho_c = _rho_of(lc, uc, st.rho, dtype)  # (S, C, r2)
    # Row C-1 of the dynamics block on the last shard is padding.
    pad = is_last[:, None, None] & (torch.arange(C, device=dev)[None, :, None] == C - 1)
    dyn_valid = torch.where(pad, 0.0, 1.0).to(dtype)  # (S, C, 1)
    rho_d = rho_d * dyn_valid + (1 - dyn_valid) * _RHO_MIN

    # Neighbour rows for the M assembly and A^T.
    J0_prev = right_shift(J0[:, -1])  # left neighbour's last dynamics row
    J1_prev = right_shift(J1[:, -1])
    J1_sh = torch.cat([J1_prev[:, None], J1[:, :-1]], dim=1)
    eye = torch.eye(w, dtype=dtype, device=dev)
    empty = torch.zeros((S, C, 0), dtype=dtype, device=dev)
    g = lambda t: ax.all_gather(t, axis)  # noqa: E731
    nred = 2 * D * w

    exi, edi, eci, dvi = 1.0 / Exs, 1.0 / Eds, 1.0 / Ecs, 1.0 / Dv
    # ---- rho rounds: the SPIKE setup once an adaptation interval ----
    # Each round refactors with the current rho (the trigger a globally
    # reduced scalar, so every shard scales alike), then up to `interval`
    # iterations run with early termination synced over `sync_axes`.
    # adaptive_rho=False is a single round.
    if st.adaptive_rho:
        interval = max(st.adaptive_rho_interval, st.check_every)
        interval = ((interval + st.check_every - 1) // st.check_every) * st.check_every
    else:
        interval = st.max_iter

    # The functions of the iteration, over the tensors it reads.  The host
    # loops build them once; on the device each loop body rebuilds them
    # over its explicit inputs (:func:`_while`), and the SPIKE chunk's
    # stage recursions are scan operators (``loop``).
    factor, solve, solve_mat = (functools.partial(f, loop=on_device)
                                for f in (btd_factor, btd_solve, btd_solve_mat))

    def kit(data: _LoopData):
        """The iteration's functions over ``data``."""
        (Hb, J0, J1, Jc, q, lx, ux, ld, ud, lc, uc, Dv, Exs, Eds, Ecs, cinv, exi, edi,
         eci, dvi, dyn_valid, keep_first, keep_last, is_first, is_last, d, sigma, alpha,
         J0_prev, J1_sh, eye, empty) = data

        def spike_setup(rho_x, rho_d, rho_c):
            """M = P + sigma I + A^T R A and its SPIKE partition factorization
            (local block LDL^T, WL/WR spikes, reduced interface inverse).  Once
            a rho round; rho adaptation re-enters here."""
            diag = Hb + sigma * eye + torch.diag_embed(rho_x)
            if r:
                diag = diag + _rho_outer(rho_d, J0, J0)
                # Residual row k-1's contribution through J1 on stage k.
                rho_sh = torch.cat([right_shift(rho_d[:, -1])[:, None], rho_d[:, :-1]], dim=1)
                J1m = _mask_row(J1_sh, 0, keep_first)
                diag = diag + _rho_outer(rho_sh, J1m, J1m)
                # Subdiagonal L_k = J1_{k-1}^T R J0_{k-1}; local row k holds L_k.
                J0_sh = torch.cat([J0_prev[:, None], J0[:, :-1]], dim=1)
                lower = _mask_row(_rho_outer(rho_sh, J1m, J0_sh), 0, keep_first)
            else:
                lower = torch.zeros((S, C, w, w), dtype=dtype, device=dev)
            if r2:
                diag = diag + _rho_outer(rho_c, Jc, Jc)

            fac = factor(_stage_first(diag), _stage_first(lower[:, 1:]))
            zeros = torch.zeros_like(lower[:, 0])
            L0 = torch.where(is_first[:, None, None], zeros, lower[:, 0])
            Ln = torch.where(is_last[:, None, None], zeros, left_shift(lower[:, 0]))
            BL, BR = _spike_blocks(L0, Ln, C)
            WL = solve_mat(fac, _stage_first(BL)).movedim(0, 1)
            WR = solve_mat(fac, _stage_first(BR)).movedim(0, 1)
            K = _reduced_operator(g(WL[:, 0]), g(WL[:, -1]), g(WR[:, 0]), g(WR[:, -1]), D, w)
            # inv_ex: a singular K gives non-finite entries, as jnp.linalg.inv.
            Kinv = torch.linalg.inv_ex(K).inverse
            return fac, WL, WR, Kinv

        def spike_solve(ops, rhs):
            fac, WL, WR, Kinv = ops
            v = solve(fac, _stage_first(rhs)).movedim(0, 1)
            rred = torch.stack([g(v[:, 0]), g(v[:, -1])], dim=2).reshape(S, nred)
            u = torch.sum(Kinv * rred[:, None, :], dim=-1)
            l_prev, f_next = _neighbours(u, d, is_first, is_last, D, w)
            return _spike_apply(v, WL, WR, l_prev, f_next)

        # ---- A / A^T with boundary exchanges ----
        def apply_A(x):
            if r:
                x_next = torch.cat([x[:, 1:], left_shift(x[:, 0])[:, None]], dim=1)
                x_next = _mask_row(x_next, C - 1, keep_last)
                ax_d = (_rows(J0, x) + _rows(J1, x_next)) * dyn_valid
            else:
                ax_d = empty
            ax_c = _rows(Jc, x) if r2 else empty
            return x, ax_d, ax_c

        def apply_AT(tx, td, tc):
            out = tx
            if r:
                out = out + _cols(J0, td)
                td_sh = torch.cat([right_shift(td[:, -1])[:, None], td[:, :-1]], dim=1)
                out = out + _cols(J1_sh, _mask_row(td_sh, 0, keep_first))
            if r2:
                out = out + _cols(Jc, tc)
            return out

        def P(x):
            return torch.sum(Hb * x[:, :, None, :], dim=-1)

        def one_iter(rhos, ops, carry):
            rho_x, rho_d, rho_c = rhos
            x, zx, zd, zc, yx, yd, yc = carry
            rhs = sigma * x - q + apply_AT(rho_x * zx - yx, rho_d * zd - yd, rho_c * zc - yc)
            xt = spike_solve(ops, rhs)
            ztx, ztd, ztc = apply_A(xt)
            x_new = alpha * xt + (1 - alpha) * x

            def upd(zt, z, y, rho, lo, hi):
                z_rel = alpha * zt + (1 - alpha) * z
                z_new = _clip(z_rel + y / rho, lo, hi)
                return z_new, y + rho * (z_rel - z_new)

            zx_n, yx_n = upd(ztx, zx, yx, rho_x, lx, ux)
            zd_n, yd_n = upd(ztd, zd, yd, rho_d, ld, ud)
            zc_n, yc_n = upd(ztc, zc, yc, rho_c, lc, uc)
            return (x_new, zx_n, zd_n * dyn_valid, zc_n, yx_n, yd_n * dyn_valid, yc_n)

        def residuals(x, zx, zd, zc, yx, yd, yc):
            """Unscaled residuals (OSQP): rows divided by their E factor,
            variables by Dv, dual quantities by the cost scaling c."""
            a_x, a_d, a_c = apply_A(x)
            px = P(x)
            aty = apply_AT(yx, yd, yc)
            rp_loc = _amax((a_x - zx) * exi, (a_d - zd) * dyn_valid * edi, (a_c - zc) * eci)
            rd_loc = cinv * _amax((px + q + aty) * dvi)
            mp_loc = torch.maximum(_amax(a_x * exi, a_d * edi, a_c * eci),
                                   _amax(zx * exi, zd * edi, zc * eci))
            md_loc = cinv * torch.maximum(torch.maximum(_amax(aty * dvi), _amax(px * dvi)),
                                          _amax(q * dvi))
            r_prim, r_dual = ax.pmax(rp_loc, sync_axes), ax.pmax(rd_loc, sync_axes)
            max_prim, max_dual = ax.pmax(mp_loc, sync_axes), ax.pmax(md_loc, sync_axes)
            eps_pri = st.eps_abs + st.eps_rel * max_prim
            eps_dua = st.eps_abs + st.eps_rel * max_dual
            done = (r_prim <= eps_pri) & (r_dual <= eps_dua)
            return done, r_prim, r_dual, max_prim, max_dual

        def certificates(dx, dyx, dyd, dyc):
            """OSQP infeasibility certificates (Banjac et al.) on one check
            block's scaled iterate deltas, tested on unscaled quantities.
            Reductions span the horizon axis only: a certificate is one
            problem's, so on a 2-D mesh each scenario keeps its own flags."""
            tiny = 1e-12
            pm = lambda t: ax.pmax(t, axis)  # noqa: E731
            ps = lambda t: ax.psum(t, axis)  # noqa: E731
            cb = lambda t: _bvec(cinv, t)  # noqa: E731
            # -- primal infeasibility: dy with A^T dy ~ 0 and support function
            #    u'(dy)_+ + l'(dy)_- < 0 (padded dynamics rows carry zero
            #    deltas: one_iter masks yd with dyn_valid).
            if r:
                dyd = dyd * dyn_valid
            dyx_u = dyx * exi * cb(dyx)
            dyd_u = dyd * edi * cb(dyd) if r else dyd
            dyc_u = dyc * eci * cb(dyc) if r2 else dyc
            ndy = pm(_amax(dyx_u, dyd_u, dyc_u))

            def support_of(dy_u, lo_s, hi_s, e_inv):
                # Masked products so inf * 0 cannot produce NaN; an infinite
                # bound with matching delta sign gives +inf, blocking the
                # certificate.
                dy_p = torch.clamp(dy_u, min=0.0)
                dy_m = torch.clamp(dy_u, max=0.0)
                zero = torch.zeros_like(dy_u)
                t_u = torch.where(dy_p > 0, (hi_s * e_inv) * dy_p, zero)
                t_l = torch.where(dy_m < 0, (lo_s * e_inv) * dy_m, zero)
                return torch.sum((t_u + t_l).reshape(S, -1), dim=1)

            support = support_of(dyx_u, lx, ux, exi)
            if r:
                support = support + support_of(dyd_u, ld, ud, edi)
            if r2:
                support = support + support_of(dyc_u, lc, uc, eci)
            support = ps(support)
            atdy = apply_AT(dyx, dyd, dyc)
            n_Atdy = pm(_amax(cb(atdy) * atdy * dvi))
            pinf = ((ndy > tiny) & (support < -st.eps_prim_inf * ndy)
                    & (n_Atdy < st.eps_prim_inf * ndy))
            # -- dual infeasibility: dx with P dx ~ 0, q'dx < 0 and A dx
            #    consistent with a feasible recession direction.
            dx_u = Dv * dx
            ndx = pm(_amax(dx_u))
            thr = st.eps_dual_inf * ndx
            cond_q = ps(torch.sum((q * dx).reshape(S, -1), dim=1)) * cinv < -thr
            pdx = P(dx)
            cond_P = pm(_amax(cb(pdx) * pdx * dvi)) < thr
            a_x, a_d, a_c = apply_A(dx)
            ok = torch.ones((S,), dtype=torch.bool, device=dev)
            for adx, lo, hi, e in ((a_x, lx, ux, exi), (a_d * dyn_valid, ld, ud, edi),
                                   (a_c, lc, uc, eci)):
                if not adx.numel():
                    continue
                adx_u, t = (adx * e).reshape(S, -1), _bvec(thr, adx.reshape(S, -1))
                hi_u, lo_u = (hi * e).reshape(S, -1), (lo * e).reshape(S, -1)
                ok = ok & torch.all(torch.where(hi_u < _INF, adx_u < t, True), dim=1)
                ok = ok & torch.all(torch.where(lo_u > -_INF, adx_u > -t, True), dim=1)
            # all() must hold on EVERY shard: pmax-reduce the violation flag.
            cond_A = pm((~ok).to(dtype)) < 0.5
            dinf = (ndx > tiny) & cond_q & cond_P & cond_A
            return pinf, dinf

        def stop_of(done, pinf, dinf):
            """The loop-exit flag, the same on every shard of `sync_axes`:
            converged OR certified everywhere there."""
            go = (~(done | pinf | dinf)).to(dtype)
            return ax.pmax(go, sync_axes) < 0.5

        def block(rhos, ops, k, carry, pinf, dinf):
            """One check block: ``check_every`` iterations, then termination
            and the certificates on the block's deltas.  Returns the round
            state ``(k, *carry, done, pinf, dinf, stop, rp, rd, mp, md)``."""
            x_o, yx_o, yd_o, yc_o = carry[0], carry[4], carry[5], carry[6]
            if on_device:
                new = _repeat(st.check_every,
                              lambda c, i: kit(_LoopData(*i[:_N_DATA])).one_iter(
                                  i[-3:], _ops_of(i[_N_DATA:-3]), c),
                              carry, (*data, *_flat_ops(ops), *rhos), True)
            else:
                new = _repeat(st.check_every, lambda c, _: one_iter(rhos, ops, c), carry, (),
                              False)
            done_n, rp, rd, mp, md = residuals(*new)
            pinf_n, dinf_n = pinf, dinf
            if st.check_infeasibility:
                pi, di_ = certificates(new[0] - x_o, new[4] - yx_o, new[5] - yd_o, new[6] - yc_o)
                pinf_n = pinf | (pi & ~done_n)
                dinf_n = dinf | (di_ & ~done_n)
            return (k + st.check_every, *new, done_n, pinf_n, dinf_n,
                    stop_of(done_n, pinf_n, dinf_n), rp, rd, mp, md)

        def run_round(rhos, it0, carry, done, pinf, dinf, stop):
            """Check blocks while the round's condition holds on some shard;
            a shard where it fails keeps its state (a ``vmap``-ed scenario
            that stopped).  Returns the round state of :func:`block`."""
            ops = spike_setup(*rhos)
            zero = torch.zeros((S,), dtype=dtype, device=dev)
            state = (torch.zeros((S,), dtype=torch.int32, device=dev), *carry, done, pinf, dinf,
                     stop, zero, zero, zero, zero)

            def go_of(it0, k, *rest):
                return (k < interval) & (it0 + k < st.max_iter) & ~rest[10]

            def step(state):
                return block(rhos, ops, state[0], state[1:8], *state[9:11])

            if on_device:
                def body(s, c):
                    new = kit(_LoopData(*c[:_N_DATA])).block(
                        c[-4:-1], _ops_of(c[_N_DATA:-4]), s[0], s[1:8], *s[9:11])
                    return _select(go_of(c[-1], *s), new, s)

                return _while(lambda s, c: go_of(c[-1], *s).any(), body, state,
                              (*data, *_flat_ops(ops), *rhos, it0))
            while True:
                go = go_of(it0, *state)
                n = _count(go)
                if n == 0:
                    return state
                new = step(state)
                state = new if n == S else _select(go, new, state)

        def adapt(rhos, stop, rp, rd, mp, md):
            """The OSQP rho rule on globally reduced residuals: every shard
            computes the same scale, so the next round's refactorization
            collectives stay uniform."""
            if not st.adaptive_rho:
                return rhos
            num = rp / torch.clamp(mp, min=1e-10)
            den = rd / torch.clamp(md, min=1e-10)
            scale = torch.clamp(torch.sqrt(num / torch.clamp(den, min=1e-10)), 1e-3, 1e3)
            trigger = ((scale > st.adaptive_rho_tolerance)
                       | (scale < 1.0 / st.adaptive_rho_tolerance))
            s_eff = torch.where(trigger & ~stop, scale, torch.ones_like(scale))
            rho_x_n, rho_d_n, rho_c_n = (
                torch.clamp(rh * _bvec(s_eff, rh), _RHO_MIN, _RHO_MAX) for rh in rhos)
            return rho_x_n, rho_d_n * dyn_valid + (1 - dyn_valid) * _RHO_MIN, rho_c_n

        def outer(state):
            """One rho round and its adaptation: ``(it, *carry, *rhos, done,
            pinf, dinf, stop)`` in and out."""
            it, carry, rhos, flags = state[0], state[1:8], state[8:11], state[11:15]
            rnd = run_round(rhos, it, carry, *flags)
            return (it + rnd[0], *rnd[1:8], *adapt(rhos, rnd[11], *rnd[12:]), *rnd[8:12])

        return SimpleNamespace(apply_A=apply_A, residuals=residuals, stop_of=stop_of,
                               one_iter=one_iter, block=block, outer=outer)


    data = _LoopData(Hb, J0, J1, Jc, q, lx, ux, ld, ud, lc, uc, Dv, Exs, Eds, Ecs, cinv,
                     exi, edi, eci, dvi, dyn_valid, keep_first, keep_last, is_first,
                     is_last, d, sigma, alpha, J0_prev, J1_sh, eye, empty)
    it_ = kit(data)

    # ---- the ADMM iteration ----
    # Warm starts arrive in UNSCALED units (admm_solve's x0/y0 semantics).
    # Cold, the iterates are JAX's `0 * data`: a non-finite q or a
    # non-finite lower bound makes them NaN there, the outcome kept.
    if warm is None:
        x, yx, yd, yc = q * 0.0, lx * 0.0, ld * 0.0, lc * 0.0
    else:
        x_u, yx_u, yd_u, yc_u = warm
        x = x_u / Dv
        yx = _bvec(c, yx_u) * yx_u / Exs
        yd = _bvec(c, yd_u) * yd_u / Eds if r else yd_u
        yc = _bvec(c, yc_u) * yc_u / Ecs if r2 else yc_u
    zx, zd, zc = it_.apply_A(x)
    zx = _clip(zx, lx, ux)
    zd = _clip(zd, ld, ud) * dyn_valid
    zc = _clip(zc, lc, uc)

    carry = (x, zx, zd, zc, yx, yd, yc)
    # Termination once up front: an already converged warm start exits.
    done, *_ = it_.residuals(*carry)
    pinf = torch.zeros((S,), dtype=torch.bool, device=dev)
    dinf = pinf
    stop = it_.stop_of(done, pinf, dinf)
    state = (torch.zeros((S,), dtype=torch.int32, device=dev), *carry, rho_x, rho_d, rho_c,
             done, pinf, dinf, stop)

    def outer_go(it, *rest):
        return (it < st.max_iter) & ~rest[13]

    if on_device and not st.adaptive_rho:
        # Without adaptation the host loop runs one round (its interval is
        # the budget): the same here, its SPIKE setup outside every loop.
        state = _select(outer_go(*state), it_.outer(state), state)
    elif on_device:
        state = _while(lambda s, c: outer_go(*s).any(),
                       lambda s, c: _select(outer_go(*s), kit(_LoopData(*c)).outer(s), s),
                       state, data)
    else:
        while True:
            go = outer_go(*state)
            n = _count(go)
            if n == 0:
                break
            new = it_.outer(state)
            state = new if n == S else _select(go, new, state)
    it, carry, (done, pinf, dinf) = state[0], state[1:8], state[11:14]

    x, zx, zd, zc, yx, yd, yc = carry
    x_u = Dv * x
    warm_u = (
        x_u,
        Exs * yx * _bvec(cinv, yx),
        Eds * yd * _bvec(cinv, yd) if r else yd,
        Ecs * yc * _bvec(cinv, yc) if r2 else yc,
    )
    return x_u, it, done, pinf, dinf, warm_u


@f32_matmuls
def admm_solve_seq_parallel(qp: ShardedBandedQP, settings: ADMMSettings, *, mesh: Mesh,
                            axis: str = "h", on_device: bool = False):
    """Solve the stage-structured QP with stages sharded over ``mesh[axis]``.

    Returns ``(x (N, w), iters, converged, prim_inf, dual_inf)``.  Only
    interface-sized data crosses shards.  ``prim_inf``/``dual_inf`` are
    the OSQP infeasibility certificates (False when
    ``settings.check_infeasibility`` is off); a certified QP exits early.
    Fields that are not tensors go to the mesh's device
    (:func:`..device.as_tensors`).  ``on_device`` keeps the loops on the
    device (the same results): the function's ``export_form``.
    """
    qp = ShardedBandedQP(*as_tensors(*qp, device=mesh.device))
    N = qp.Hb.shape[0]
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.shape}")
    D = mesh.shape[axis]
    C = N // D
    if C * D != N or C < 2:
        raise ValueError(f"horizon {N} must split into >=2 stages per device over {D}")
    ax = mesh.shards()
    spec = (axis,)
    x, its, done, pinf, dinf, _ = seq_admm_local(
        ax, *(ax.shard(a, spec) for a in qp), settings=settings, axis=axis, on_device=on_device,
    )
    return ax.unshard(x, spec), its[0], done[0], pinf[0], dinf[0]


admm_solve_seq_parallel.export_form = functools.partial(admm_solve_seq_parallel, on_device=True)
