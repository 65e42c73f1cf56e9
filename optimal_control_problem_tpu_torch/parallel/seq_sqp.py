"""End-to-end sequence-parallel SQP: the derivatives AND the QP solve with
the horizon sharded across a mesh — port of
``optimal_control_problem_tpu/parallel/seq_sqp.py``.

Each shard owns ``C = N / D`` stages of the trajectory.  Per SQP
iteration:

* the stage derivatives (Hessian blocks, dynamics and stage-constraint
  Jacobians) are evaluated locally with the port's ``torch.func`` stage
  builders over every stage of every shard at once; one ``ppermute``
  fetches the boundary frame from the right neighbour for the dynamics
  pairs;
* the local QP is solved by :func:`.seq_admm.seq_admm_local` (SPIKE
  factorization and sharded ADMM), its warm start carried across SQP
  iterations;
* the damped update ``x += alpha * dx`` is local, or the merit line
  search sums every candidate's merit with one ``psum``.

Scope: the reduced formulation.  2-D meshes: pass ``batch_axis`` and
batched ``(B, N, w)`` inputs to split scenarios over one axis and the
horizon over another; each shard's scenarios are its own problems (JAX
``vmap``s the per-scenario program over them).

``on_device`` runs each QP's loops on the device
(:func:`.seq_admm.seq_admm_local`): the same results, no host read, and
the function's ``export_form`` (over a ``torch.distributed`` mesh one
program a rank), which
``utils/serialization.export_solver`` finds through a
``functools.partial`` of it, so that exporting the function is written as
with JAX's ``export_solver``.

JAX caches its compiled program per call signature (``_SOLVE_CACHE``, keyed
on ``id()``); the port builds nothing worth caching — its stage maps are
made per call in microseconds — so it keeps no cache.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, vmap

from ..device import as_tensors
from ..solvers.admm import ADMMSettings, f32_matmuls
from ..stagewise import StageStructure
from .mesh import Mesh
from .seq_admm import seq_admm_local

__all__ = ["sqp_solve_seq_parallel"]

_SCENARIO = "_scenario"  # the local scenario axis of a 2-D mesh


def _stage_map(fn, dtype):
    """``fn`` mapped over leading dims flattened into one (every stage of
    every shard at once), its result cast to ``dtype`` (forward mode
    promotes ``tensor / python_float`` tangents to float64)."""
    mapped = vmap(fn)

    def call(*args):
        lead = args[0].shape[:-1]
        n = int(np.prod(lead))
        flat = [a.reshape((n,) + tuple(a.shape[len(lead):])) for a in args]
        out = mapped(*flat).to(dtype)
        return out.reshape(tuple(lead) + tuple(out.shape[1:]))

    return call


def seq_sqp_local(ax, x_l, ref_l, lx_l, ux_l, *, ss: StageStructure, sqp_iters, alpha,
                  admm: ADMMSettings, axis, sync_axes, hessian_reg, line_search, ls_num,
                  ls_alpha_max, ls_merit_mu, on_device=False):
    """The per-device SQP over local tensors ``(S, C, ...)``.  Returns the
    trajectory ``(S, C, w)``, the ADMM iterations ``(S, sqp_iters)`` and
    the per-iteration QP flags (converged, prim_inf, dual_inf)
    ``(S, sqp_iters, 3)``; ``on_device`` as :func:`.seq_admm.seq_admm_local`."""
    dtype, dev = x_l.dtype, x_l.device
    S, C, w = x_l.shape
    D = ax.size(axis)
    r = ss.dynamics_size if ss.dynamics is not None else 0
    r2 = (len(np.atleast_1d(np.asarray(ss.stage_constraints[1])))
          if ss.stage_constraints is not None else 0)
    d = ax.axis_index(axis)
    is_last = d == D - 1
    ks = d[:, None] * C + torch.arange(C, device=dev)[None, :]  # (S, C)

    def left_shift(t):
        return ax.ppermute(t, axis, -1)

    stage_hess = _stage_map(hessian(ss.stage_cost), dtype)
    stage_grad = _stage_map(grad(ss.stage_cost), dtype)
    stage_cost_v = _stage_map(ss.stage_cost, dtype)
    if r:
        dyn_val = _stage_map(ss.dynamics, dtype)
        dyn_j0 = _stage_map(jacfwd(ss.dynamics, argnums=0), dtype)
        dyn_j1 = _stage_map(jacfwd(ss.dynamics, argnums=1), dtype)
        # Global row N-1 is padding.
        pad = is_last[:, None] & (torch.arange(C, device=dev)[None, :] == C - 1)
        valid = torch.where(pad, 0.0, 1.0).to(dtype)[..., None]  # (S, C, 1)
    if r2:
        sc_fn, sc_lb, sc_ub = ss.stage_constraints
        sc_val = _stage_map(sc_fn, dtype)
        sc_jac = _stage_map(jacfwd(sc_fn, argnums=0), dtype)
        as_row = lambda b: torch.as_tensor(np.atleast_1d(np.asarray(b, np.float64)),  # noqa: E731
                                           dtype=dtype, device=dev)
        sc_lb, sc_ub = as_row(sc_lb), as_row(sc_ub)
    eye = torch.eye(w, dtype=dtype, device=dev)

    warm = (
        x_l * 0.0,
        x_l * 0.0,
        torch.zeros((S, C, r), dtype=dtype, device=dev) + x_l[..., :1] * 0.0,
        torch.zeros((S, C, r2), dtype=dtype, device=dev) + x_l[..., :1] * 0.0,
    )
    its, status = [], []
    for _ in range(sqp_iters):
        frames = x_l
        Hb = stage_hess(frames, ref_l, ks)
        # Gershgorin convexification per block.
        sym = 0.5 * (Hb + Hb.transpose(-1, -2))
        diag_b = torch.diagonal(sym, dim1=-2, dim2=-1)
        offsum = torch.sum(torch.abs(sym), dim=-1) - torch.abs(diag_b)
        bound = torch.amin(diag_b - offsum, dim=-1)
        shift = torch.clamp(hessian_reg - bound, min=0.0)
        Hb = Hb + shift[..., None, None] * eye
        g = stage_grad(frames, ref_l, ks)

        # Dynamics pairs (k, k+1): the boundary frame from the right
        # neighbour.
        frames_next = torch.cat([frames[:, 1:], left_shift(frames[:, 0])[:, None]], dim=1)
        if r:
            J0 = dyn_j0(frames, frames_next) * valid[..., None]
            J1 = dyn_j1(frames, frames_next) * valid[..., None]
            dynres = dyn_val(frames, frames_next) * valid
            ld, ud = -dynres, -dynres
        else:
            J0 = J1 = torch.zeros((S, C, 0, w), dtype=dtype, device=dev)
            ld = ud = torch.zeros((S, C, 0), dtype=dtype, device=dev)
        if r2:
            Jc = sc_jac(frames, ref_l, ks)
            scv = sc_val(frames, ref_l, ks)
            lc, uc = sc_lb - scv, sc_ub - scv
        else:
            Jc = torch.zeros((S, C, 0, w), dtype=dtype, device=dev)
            lc = uc = torch.zeros((S, C, 0), dtype=dtype, device=dev)

        dx, it, done, pinf, dinf, warm = seq_admm_local(
            ax, Hb, J0, J1, Jc, g, lx_l - frames, ux_l - frames, ld, ud, lc, uc,
            settings=admm, axis=axis, sync_axes=sync_axes, warm=warm, on_device=on_device,
        )
        if line_search == "none":
            x_new = x_l + alpha * dx
        else:
            # Distributed merit line search (the L1 exact-penalty rule of
            # solvers/sqp._make_step_rule): each shard sums its stages'
            # merit for every candidate, one psum over the horizon axis
            # reduces them, and argmin on the common result picks the same
            # step everywhere.
            al = torch.as_tensor(ls_alpha_max * (0.5 ** np.arange(ls_num)), dtype=dtype,
                                 device=dev)
            K = al.shape[0]
            cand = x_l[:, None] + al[None, :, None, None] * dx[:, None]  # (S, K, C, w)
            ref_k = ref_l[:, None].expand((S, K) + tuple(ref_l.shape[1:]))
            ks_k = ks[:, None].expand(S, K, C)
            fv = torch.sum(stage_cost_v(cand, ref_k, ks_k), dim=2)
            viol = torch.sum(torch.clamp(lx_l[:, None] - cand, min=0.0)
                             + torch.clamp(cand - ux_l[:, None], min=0.0), dim=(2, 3))
            if r:
                nxt = left_shift(cand[:, :, 0])
                cand_next = torch.cat([cand[:, :, 1:], nxt[:, :, None]], dim=2)
                resid = dyn_val(cand, cand_next) * valid[:, None]
                viol = viol + torch.sum(torch.abs(resid), dim=(2, 3))
            if r2:
                scv_k = sc_val(cand, ref_k, ks_k)
                viol = viol + torch.sum(torch.clamp(sc_lb - scv_k, min=0.0)
                                        + torch.clamp(scv_k - sc_ub, min=0.0), dim=(2, 3))
            merits = ax.psum(fv + ls_merit_mu * viol, axis)  # (S, K)
            step = al[torch.argmin(merits, dim=1)]
            x_new = x_l + step[:, None, None] * dx
        its.append(it)
        status.append(torch.stack([done, pinf, dinf], dim=-1))
        x_l = x_new
    return x_l, torch.stack(its, dim=1), torch.stack(status, dim=1)


@f32_matmuls
def sqp_solve_seq_parallel(
    ss: StageStructure,
    x0: torch.Tensor,  # (N, w) initial trajectory (frames)
    ref: torch.Tensor,  # (N, ref_dim) per-stage references
    lx: torch.Tensor,  # (N, w) box bounds (first frame pinned by the caller)
    ux: torch.Tensor,
    *,
    sqp_iters: int,
    alpha: float,
    admm: ADMMSettings,
    mesh: Mesh,
    axis: str = "h",
    batch_axis: str | None = None,
    hessian_reg: float = 1e-6,
    line_search: str = "none",
    ls_num: int = 8,
    ls_alpha_max: float = 1.0,
    ls_merit_mu: float = 10.0,
    on_device: bool = False,
):
    """Run ``sqp_iters`` damped SQP iterations with everything sharded over
    ``mesh[axis]``.  Returns ``(x, its, qp_status)``: the final trajectory
    (N, w), the ADMM iterations of each SQP iteration (sqp_iters,) and
    its QP flags (converged, prim_inf, dual_inf) (sqp_iters, 3); with
    ``batch_axis`` and inputs carrying a leading scenario dim, (B, N, w),
    (B, sqp_iters) and (B, sqp_iters, 3).  The arrays stay on the mesh's
    device; on a distributed mesh every rank returns the global result.
    Arrays that are not tensors go to the mesh's device
    (:func:`..device.as_tensors`).  ``on_device`` keeps every QP's loops on
    the device (the same results): the function's ``export_form``."""
    x0, ref, lx, ux = as_tensors(x0, ref, lx, ux, device=mesh.device)
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.shape}")
    if batch_axis is not None and batch_axis not in mesh.shape:
        raise ValueError(f"mesh has no batch axis {batch_axis!r}: {mesh.shape}")
    N, w = x0.shape[-2:]
    D = mesh.shape[axis]
    C = N // D
    if C * D != N or C < 2:
        raise ValueError(f"horizon {N} must split into >=2 stages per device over {D}")
    if ss.ref_frame_size <= 0:
        raise ValueError("sequence-parallel SQP requires per-stage references")
    ax = mesh.shards()
    if batch_axis is None:
        sync_axes = (axis,)
        lead = (N,)
        spec = (axis,)
        order = [0]
    else:
        B = x0.shape[0]
        Bd = mesh.shape[batch_axis]
        if B % Bd:
            raise ValueError(f"scenario batch {B} must divide over the {Bd}-way {batch_axis!r} axis")
        sync_axes = (axis, batch_axis)
        ax = ax.with_local(_SCENARIO, B // Bd, after=batch_axis)
        lead = (Bd, B // Bd, N)
        dims = {batch_axis: 0, _SCENARIO: 1, axis: 2}
        spec = tuple(a for a, _, _ in ax.axes if a in dims)
        order = [dims[a] for a in spec]

    def to_local(t):
        t = t.reshape(lead + tuple(t.shape[-1:]))
        t = t.permute(order + [len(lead)])
        return ax.shard(t, spec).reshape(ax.S, C, t.shape[-1])

    x_l, its, status = seq_sqp_local(
        ax, *(to_local(t) for t in (x0, ref, lx, ux)), ss=ss, sqp_iters=sqp_iters,
        alpha=alpha, admm=admm, axis=axis, sync_axes=sync_axes, hessian_reg=hessian_reg,
        line_search=line_search, ls_num=ls_num, ls_alpha_max=ls_alpha_max,
        ls_merit_mu=ls_merit_mu, on_device=on_device,
    )
    # Back to the global layout: the trajectory from every shard, the
    # flags (the same on every shard of the horizon axis) from the first.
    rem = [C if a == axis else 1 for a in spec]
    x = ax.unshard(x_l.reshape([ax.S] + rem + [w]), spec)
    x = x.permute([order.index(i) for i in range(len(order))] + [len(order)])
    flat_spec = tuple(a for a in spec if a != axis)
    its = ax.unshard(its.reshape([ax.S] + [1] * len(flat_spec) + [sqp_iters]), flat_spec)
    status = ax.unshard(status.reshape([ax.S] + [1] * len(flat_spec) + [sqp_iters, 3]), flat_spec)
    if batch_axis is None:
        return x.reshape(N, w), its, status
    return x.reshape(B, N, w), its.reshape(B, sqp_iters), status.reshape(B, sqp_iters, 3)


sqp_solve_seq_parallel.export_form = functools.partial(sqp_solve_seq_parallel, on_device=True)
