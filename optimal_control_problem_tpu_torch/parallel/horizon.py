"""Horizon-axis sharding: distributed block-tridiagonal KKT solve — port of
``optimal_control_problem_tpu/parallel/horizon.py``.

The stage axis of a block-tridiagonal SPD system is split over a mesh axis
and solved with the Schur-complement partition method (SPIKE):

1. each shard owns ``C = N / D`` contiguous stages and eliminates its
   interior with a local block LDL^T (``ops/block_tridiag``), giving its
   chunk's response to the two interface unknowns (its left neighbour's
   last stage and its right neighbour's first stage);
2. the per-chunk interface data (2 vectors and 4 coupling blocks a shard)
   is ``all_gather``-ed over the axis, the only collective besides one
   neighbour ``ppermute``;
3. the reduced interface system (2 D w unknowns) is solved the same way on
   every shard (``torch.linalg.solve``), and each shard reconstructs its
   interior.

Exact: the reduced system is the Schur complement of the interior
elimination.  Local tensors carry the shard dimension S first (see
``parallel/mesh.py``); the boundary shards' masks are ``(S,)`` tensors.
"""

from __future__ import annotations

import torch

from ..device import as_tensors
from ..ops.block_tridiag import btd_factor, btd_solve, btd_solve_mat
from ..solvers.admm import f32_matmuls
from .mesh import Mesh

__all__ = ["horizon_sharded_solve"]


def _stage_first(t):
    """``(S, C, ...) -> (C, S, ...)``: the stage loop of ``ops/block_tridiag``
    runs over the first dim, every shard at once."""
    return t.movedim(1, 0)


def _spike_blocks(L0, Ln, C):
    """``BL``/``BR (S, C, w, w)``: the left coupling block in stage 0 and
    the transposed right coupling block in stage C-1, zeros elsewhere."""
    S, w = L0.shape[0], L0.shape[-1]
    BL = torch.zeros((S, C, w, w), dtype=L0.dtype, device=L0.device)
    BR = torch.zeros_like(BL)
    BL[:, 0] = L0
    BR[:, -1] = Ln.transpose(-1, -2)
    return BL, BR


def _reduced_operator(WL0, WL1, WR0, WR1, D, w):
    """The reduced interface system over ``u = [f_0, l_0, f_1, l_1, ...]``
    (2 D blocks), one copy a shard: ``(S, 2 D w, 2 D w)`` from the gathered
    spikes ``(S, D, w, w)``::

        f_d + WL0_d l_{d-1} + WR0_d f_{d+1} = v0_d
        l_d + WL1_d l_{d-1} + WR1_d f_{d+1} = v1_d
    """
    S = WL0.shape[0]
    nred = 2 * D * w
    K = torch.eye(nred, dtype=WL0.dtype, device=WL0.device).repeat(S, 1, 1)
    for dd in range(D):
        rf = 2 * dd * w  # row/col offset of f_dd
        rl = rf + w  # of l_dd
        if dd > 0:
            cl = (2 * (dd - 1) + 1) * w  # column of l_{dd-1}
            K[:, rf:rf + w, cl:cl + w] += WL0[:, dd]
            K[:, rl:rl + w, cl:cl + w] += WL1[:, dd]
        if dd < D - 1:
            cf = 2 * (dd + 1) * w  # column of f_{dd+1}
            K[:, rf:rf + w, cf:cf + w] += WR0[:, dd]
            K[:, rl:rl + w, cf:cf + w] += WR1[:, dd]
    return K


def _neighbours(u, d, is_first, is_last, D, w):
    """This shard's neighbours' interface values from the reduced
    solution ``u (S, 2 D w)``: ``l_{d-1}`` and ``f_{d+1}``, zero at the
    ends of the horizon."""
    cols = torch.arange(w, device=u.device)
    l_idx = (2 * ((d - 1) % D) + 1) * w
    f_idx = (2 * ((d + 1) % D)) * w
    l_prev = torch.gather(u, 1, l_idx[:, None] + cols[None, :])
    f_next = torch.gather(u, 1, f_idx[:, None] + cols[None, :])
    l_prev = torch.where(is_first[:, None], torch.zeros_like(l_prev), l_prev)
    f_next = torch.where(is_last[:, None], torch.zeros_like(f_next), f_next)
    return l_prev, f_next


def _spike_apply(v, WL, WR, l_prev, f_next):
    """``x = v - WL l_prev - WR f_next`` over a shard's stages
    (``v (S, C, w)``, spikes ``(S, C, w, w)``)."""
    return (v - torch.sum(WL * l_prev[:, None, None, :], dim=-1)
            - torch.sum(WR * f_next[:, None, None, :], dim=-1))


def horizon_local(ax, diag_l, lower_l, b_l, axis: str):
    """The per-device SPIKE solve over local tensors ``diag_l``/``lower_l``
    ``(S, C, w, w)`` (row k couples local stage k to its predecessor; row 0
    to the left neighbour's last stage) and ``b_l (S, C, w)``."""
    S, C, w, _ = diag_l.shape
    D = ax.size(axis)
    d = ax.axis_index(axis)
    is_first = d == 0
    is_last = d == D - 1
    # Right neighbour's row-0 coupling block via a left-shift permute.
    next_L = ax.ppermute(lower_l[:, 0], axis, -1)
    zeros = torch.zeros_like(next_L)
    L0 = torch.where(is_first[:, None, None], zeros, lower_l[:, 0])
    Ln = torch.where(is_last[:, None, None], zeros, next_L)

    fac = btd_factor(_stage_first(diag_l), _stage_first(lower_l[:, 1:]))
    v = btd_solve(fac, _stage_first(b_l)).movedim(0, 1)
    BL, BR = _spike_blocks(L0, Ln, C)
    WL = btd_solve_mat(fac, _stage_first(BL)).movedim(0, 1)
    WR = btd_solve_mat(fac, _stage_first(BR)).movedim(0, 1)

    # Interface quantities of every chunk, gathered on every shard.
    g = lambda t: ax.all_gather(t, axis)  # noqa: E731 - (S, D, ...)
    v0, v1 = g(v[:, 0]), g(v[:, -1])
    K = _reduced_operator(g(WL[:, 0]), g(WL[:, -1]), g(WR[:, 0]), g(WR[:, -1]), D, w)
    rhs = torch.stack([v0, v1], dim=2).reshape(S, 2 * D * w)
    u = torch.linalg.solve(K, rhs)  # the same small solve on every shard
    l_prev, f_next = _neighbours(u, d, is_first, is_last, D, w)
    return _spike_apply(v, WL, WR, l_prev, f_next)


@f32_matmuls
def horizon_sharded_solve(
    diag: torch.Tensor,  # (N, w, w) diagonal blocks (global)
    lower: torch.Tensor,  # (N, w, w): row k couples stage k to k-1; row 0 zero
    b: torch.Tensor,  # (N, w)
    *,
    mesh: Mesh,
    axis: str = "h",
) -> torch.Tensor:
    """Solve the SPD block-tridiagonal system with stages sharded over
    ``mesh[axis]``.  ``N`` must split into at least two stages a shard.
    Returns the global ``(N, w)`` solution (on every rank of a distributed
    mesh).  Arrays that are not tensors go to the mesh's device
    (:func:`..device.as_tensors`)."""
    diag, lower, b = as_tensors(diag, lower, b, device=mesh.device)
    N, w, _ = diag.shape
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.shape}")
    D = mesh.shape[axis]
    C = N // D
    if C * D != N or C < 2:
        raise ValueError(f"horizon {N} must split into >=2 stages per device over {D}")
    ax = mesh.shards()
    spec = (axis,)
    x = horizon_local(ax, *(ax.shard(t, spec) for t in (diag, lower, b)), axis=axis)
    return ax.unshard(x, spec)
