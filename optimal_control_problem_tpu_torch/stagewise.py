"""Stage-structured problem definition and derivatives — port of
``optimal_control_problem_tpu/stagewise.py``.

Optimal-control problems are stage-separable: the cost is a sum of
per-stage terms and the constraints couple at most adjacent frames.  So the
objective Hessian is block-diagonal per frame (a ``(w, w)`` stage Hessian
mapped over the horizon) and the constraint Jacobian block-bidiagonal (two
``(r, w)`` stage Jacobians) — exactly the stage blocks the banded QP layer
(``solvers/admm_banded.py``) consumes.

Derivatives come from ``torch.func`` (``hessian``/``jacfwd``/``grad``)
under ``torch.func.vmap`` over stage x batch FLATTENED into one trailing
axis (:func:`_vmap_batch_last`), so every per-stage intermediate is one
``(S*B,)`` tensor and every output is batch-last — the layout of the
batched driver and the CUDA chunk kernel.  Per-scenario evaluators are the
same code with a batch of one.  ``build_stagewise_parts`` also embeds the
blocks in the dense ``(H_mat, A)`` of the dense and shared-system QP paths.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, vmap

__all__ = [
    "StageStructure",
    "build_stagewise_fns",
    "build_stagewise_parts",
    "build_stage_blocks",
    "build_stage_blocks_batch",
    "build_stage_vectors_batch",
]


@dataclasses.dataclass(frozen=True)
class StageStructure:
    """Stage-separable OCP description (reduced formulation).

    ``stage_cost(frame, ref_frame, k) -> scalar`` — summed over all stages;
    ``dynamics(frame, next_frame) -> (r,)`` — equality residuals between
    consecutive frames (bounds 0);
    ``stage_constraints`` — optional ``(fn, lb, ub)`` with
    ``fn(frame, ref_frame, k) -> (r2,)`` applied at every stage.

    ``ref_frame_size``: reference entries per stage; 0 means the whole
    reference vector is passed to every stage.  All callables take and
    return torch tensors.
    """

    horizon: int
    frame_size: int
    stage_cost: Callable
    dynamics: Optional[Callable] = None
    dynamics_size: int = 0
    stage_constraints: Optional[Tuple[Callable, Sequence[float], Sequence[float]]] = None
    ref_frame_size: int = 0

    def ref_frames(self, P: torch.Tensor) -> torch.Tensor:
        """Reshape the flat reference to per-stage slices (H, ref_dim)."""
        H = self.horizon
        if self.ref_frame_size > 0:
            return P.reshape(H, self.ref_frame_size)
        return torch.broadcast_to(P, (H,) + tuple(P.shape))

    @property
    def n_g(self) -> int:
        n = (self.horizon - 1) * self.dynamics_size
        if self.stage_constraints is not None:
            n += self.horizon * len(np.atleast_1d(self.stage_constraints[1]))
        return n


def _sizes(ss: StageStructure):
    r_dyn = ss.dynamics_size if ss.dynamics is not None else 0
    r_sc = (
        len(np.atleast_1d(ss.stage_constraints[1]))
        if ss.stage_constraints is not None
        else 0
    )
    return r_dyn, r_sc


def build_stagewise_fns(ss: StageStructure):
    """Generate ``(f_fn, g_fn, lbg, ubg)`` from the structure.

    ``f_fn(X, P)``/``g_fn(X, P)`` take one flat decision vector; batch them
    with ``torch.func.vmap``.  ``g`` row ordering: all dynamics residuals
    (stage-major), then all stage-constraint rows (stage-major).
    """
    H, w = ss.horizon, ss.frame_size

    def f_fn(X, P):
        frames = X.reshape(H, w)
        refs = ss.ref_frames(P)
        ks = torch.arange(H, device=X.device)
        return torch.sum(vmap(ss.stage_cost)(frames, refs, ks))

    def g_fn(X, P):
        frames = X.reshape(H, w)
        parts = []
        if ss.dynamics is not None:
            parts.append(vmap(ss.dynamics)(frames[:-1], frames[1:]).reshape(-1))
        if ss.stage_constraints is not None:
            fn = ss.stage_constraints[0]
            ks = torch.arange(H, device=X.device)
            parts.append(vmap(fn)(frames, ss.ref_frames(P), ks).reshape(-1))
        return torch.cat(parts) if parts else X.new_zeros((0,))

    lbg_parts: List[np.ndarray] = []
    ubg_parts: List[np.ndarray] = []
    if ss.dynamics is not None:
        lbg_parts.append(np.zeros((H - 1) * ss.dynamics_size))
        ubg_parts.append(np.zeros((H - 1) * ss.dynamics_size))
    if ss.stage_constraints is not None:
        _, lb, ub = ss.stage_constraints
        lbg_parts.append(np.tile(np.atleast_1d(np.asarray(lb, np.float64)), H))
        ubg_parts.append(np.tile(np.atleast_1d(np.asarray(ub, np.float64)), H))
    lbg = np.concatenate(lbg_parts) if lbg_parts else np.zeros(0)
    ubg = np.concatenate(ubg_parts) if ubg_parts else np.zeros(0)
    return f_fn, g_fn, lbg, ubg


def build_stagewise_parts(ss: StageStructure, dtype, hessian_reg="auto"):
    """Structured local-system pieces ``(matrices, matrices_raw, vectors,
    stack_bounds)`` compatible with ``solvers/sqp.build_local_system_parts``
    (reduced formulation), with every derivative taken stage-wise.

    ``matrices(x, p) -> (H_mat, A)`` embeds the per-stage Hessian blocks
    (regularized per ``hessian_reg``; ``matrices_raw`` without) on the block
    diagonal and the dynamics / stage-constraint Jacobian blocks in the
    block-bidiagonal rows of ``A = [I; J_dyn; J_sc]``: the dense operator
    the dense and shared-system QP paths consume.  ``vectors(x, p) ->
    (grad (n,), cval (m,))``; ``stack_bounds(p, lbx, ubx, lbg, ubg) ->
    (lower, upper)`` (batched inputs work too: the bound stack concatenates
    along the last axis).  Each piece maps under ``torch.func.vmap``.
    """
    H, w = ss.horizon, ss.frame_size
    n_x = H * w
    vectors_T = build_stage_vectors_batch(ss, dtype)
    blocks = build_stage_blocks(ss, dtype, hessian_reg)
    blocks_raw = build_stage_blocks(ss, dtype, 0.0)

    def vectors(x, p):
        gT, cT = vectors_T(x[:, None], p[:, None])
        return gT[:, 0], cT[:, 0]

    def _assemble(Hb, J0, J1, Jc):
        rows = [torch.eye(n_x, dtype=dtype, device=Hb.device)]
        if J0.shape[1] and H > 1:
            rows.append(_scatter_bidiagonal(J0, J1))
        if Jc.shape[1]:
            rows.append(_scatter_stage_rows(Jc))
        return _scatter_block_diag(Hb), torch.cat(rows, dim=0)

    def matrices(x, p):
        return _assemble(*blocks(x, p))

    def matrices_raw(x, p):
        return _assemble(*blocks_raw(x, p))

    def stack_bounds(p, lbx, ubx, lbg, ubg):
        return (
            torch.cat([lbx, lbg], dim=-1).to(dtype),
            torch.cat([ubx, ubg], dim=-1).to(dtype),
        )

    return matrices, matrices_raw, vectors, stack_bounds


# The dense embeddings are diagonal embeddings of the stacked blocks, so
# every entry is a block's value or an exact zero; built out of place, they
# map under torch.func.vmap.


def _scatter_block_diag(Hb):
    """(H, w, w) blocks -> the (H w, H w) block-diagonal matrix."""
    H, w = Hb.shape[0], Hb.shape[1]
    D = torch.diag_embed(Hb.permute(1, 2, 0))  # (w, w, H, H): [i, j, k, k] = Hb[k, i, j]
    return D.permute(2, 0, 3, 1).reshape(H * w, H * w)


def _scatter_bidiagonal(J0, J1):
    """Dynamics rows ((H-1) r, H w): block row k holds J0[k] at frame k and
    J1[k] at frame k + 1."""
    Hm1, r, w = J0.shape
    D0 = torch.nn.functional.pad(torch.diag_embed(J0.permute(1, 2, 0)), (0, 1))
    D1 = torch.diag_embed(J1.permute(1, 2, 0), offset=1)[:, :, :Hm1, :]
    return (D0 + D1).permute(2, 0, 3, 1).reshape(Hm1 * r, (Hm1 + 1) * w)


def _scatter_stage_rows(Jc):
    """Stage-constraint rows (H r2, H w): block row k touches frame k only."""
    H, r2, w = Jc.shape
    D = torch.diag_embed(Jc.permute(1, 2, 0))  # (r2, w, H, H)
    return D.permute(2, 0, 3, 1).reshape(H * r2, H * w)


# ----------------------------------------------------------------------
# Batch-LAST derivative evaluation.


def _vmap_batch_last(fn, n_array_args, scalar_axes=()):
    """vmap ``fn`` over stage x batch FLATTENED into one trailing axis.

    Inputs: ``n_array_args`` leading arguments shaped ``(S, d, B)`` (stage
    leading, batch trailing) plus ``scalar_axes`` extra args shaped
    ``(S,)`` (per-stage scalars, e.g. ``k``).  Every per-stage
    intermediate is one ``(S*B,)`` tensor; outputs come back as
    ``(S, ..., B)``.
    """

    def to_flat(a):
        # (S, d, B) -> (d, S*B), row-major: at B=1 the reshape is a view with
        # permuted strides, which forward-mode AD under torch.export's trace
        # rejects ("tangent ... same layout as primal").
        flat = a.movedim(0, -2).reshape(a.shape[1:-1] + (a.shape[0] * a.shape[-1],))
        return flat.contiguous()

    in_dims = tuple([-1] * n_array_args + [0] * len(scalar_axes))
    mapped = vmap(fn, in_dims=in_dims, out_dims=-1)

    def wrapper(*args):
        arrays = args[:n_array_args]
        scalars = args[n_array_args:]
        S = arrays[0].shape[0]
        B = arrays[0].shape[-1]
        flat_arrays = [to_flat(a) for a in arrays]
        flat_scalars = [torch.repeat_interleave(s, B) for s in scalars]
        # Forward-mode AD through ``tensor / python_float`` yields float64
        # tangents in torch.func; results keep the inputs' dtype.
        out = mapped(*flat_arrays, *flat_scalars).to(arrays[0].dtype)  # (..., S*B)
        return out.reshape(out.shape[:-1] + (S, B)).movedim(-2, 0).contiguous()

    return wrapper


def _regularize_blocks_T(HbT, w, hessian_reg):
    """Per-stage convexification on batch-last blocks (H, w, w, B).

    "auto": Gershgorin lower bound on each block's smallest eigenvalue
    (no eigendecomposition in the hot path); "eigh": the exact smallest
    eigenvalue; a float adds a fixed multiple of the identity."""
    sym = 0.5 * (HbT + HbT.transpose(1, 2))
    eye = torch.eye(w, dtype=HbT.dtype, device=HbT.device)
    if hessian_reg == "auto":
        diag = torch.sum(sym * eye[None, :, :, None], dim=2)  # (H, w, B)
        offsum = torch.sum(torch.abs(sym), dim=2) - torch.abs(diag)
        bound = torch.amin(diag - offsum, dim=1)  # (H, B)
        shift = torch.clamp(1e-6 - bound, min=0.0)
        return HbT + shift[:, None, None, :] * eye[None, :, :, None]
    if hessian_reg == "eigh":
        w_min = torch.linalg.eigvalsh(sym.movedim(-1, 1))[..., 0]  # (H, B)
        shift = torch.clamp(1e-6 - w_min, min=0.0)
        return HbT + shift[:, None, None, :] * eye[None, :, :, None]
    reg = float(hessian_reg)
    if reg > 0.0:
        return HbT + reg * eye[None, :, :, None]
    return HbT


def _ref_frames_T(ss, pT):
    """Batch-last per-stage reference slices: pT (n_p, B) -> (H, ., B)."""
    H = ss.horizon
    if ss.ref_frame_size > 0:
        return pT.reshape(H, ss.ref_frame_size, pT.shape[-1])
    return torch.broadcast_to(pT, (H,) + tuple(pT.shape))


def build_stage_blocks_batch(ss: StageStructure, dtype, hessian_reg="auto"):
    """Batch-last stage-block evaluator for the banded batch path.

    Returns ``blocks_T(xT, pT) -> (HbT, J0T, J1T, JcT)``: ``xT (n, B)``,
    ``pT (n_p, B)`` -> ``HbT (H, w, w, B)``, ``J0T/J1T (H-1, r, w, B)``,
    ``JcT (H, r2, w, B)``.
    """
    H, w = ss.horizon, ss.frame_size
    r_dyn, r_sc = _sizes(ss)
    hess_T = _vmap_batch_last(hessian(ss.stage_cost), 2, (2,))
    if ss.dynamics is not None:
        jac0_T = _vmap_batch_last(jacfwd(ss.dynamics, argnums=0), 2)
        jac1_T = _vmap_batch_last(jacfwd(ss.dynamics, argnums=1), 2)
    if ss.stage_constraints is not None:
        sc_jac_T = _vmap_batch_last(jacfwd(ss.stage_constraints[0], argnums=0), 2, (2,))

    def blocks_T(xT, pT):
        B = xT.shape[-1]
        dev = xT.device
        ks = torch.arange(H, device=dev)
        frames = xT.reshape(H, w, B).to(dtype)
        refs = _ref_frames_T(ss, pT.to(dtype))
        HbT = _regularize_blocks_T(hess_T(frames, refs, ks), w, hessian_reg)
        if r_dyn:
            J0T = jac0_T(frames[:-1], frames[1:])
            J1T = jac1_T(frames[:-1], frames[1:])
        else:
            J0T = torch.zeros((H - 1, 0, w, B), dtype=dtype, device=dev)
            J1T = torch.zeros((H - 1, 0, w, B), dtype=dtype, device=dev)
        if r_sc:
            JcT = sc_jac_T(frames, refs, ks)
        else:
            JcT = torch.zeros((H, 0, w, B), dtype=dtype, device=dev)
        return HbT, J0T, J1T, JcT

    return blocks_T


def build_stage_blocks(ss: StageStructure, dtype, hessian_reg="auto"):
    """Per-scenario stage blocks ``blocks(x, p) -> (Hb, J0, J1, Jc)``."""
    blocks_T = build_stage_blocks_batch(ss, dtype, hessian_reg)

    def blocks(x, p):
        return tuple(a[..., 0] for a in blocks_T(x[:, None], p[:, None]))

    return blocks


def build_stage_vectors_batch(ss: StageStructure, dtype):
    """Batch-last gradient/constraint-value evaluator (reduced formulation).

    Returns ``vectors_T(xT, pT) -> (gradT (n, B), cvalT (m, B))``;
    constraint rows ordered [x; dynamics; stage constraints].
    """
    H, w = ss.horizon, ss.frame_size
    r_dyn, r_sc = _sizes(ss)
    grad_T = _vmap_batch_last(grad(ss.stage_cost), 2, (2,))
    if ss.dynamics is not None:
        dyn_T = _vmap_batch_last(ss.dynamics, 2)
    if ss.stage_constraints is not None:
        sc_T = _vmap_batch_last(ss.stage_constraints[0], 2, (2,))

    def vectors_T(xT, pT):
        B = xT.shape[-1]
        ks = torch.arange(H, device=xT.device)
        frames = xT.reshape(H, w, B).to(dtype)
        refs = _ref_frames_T(ss, pT.to(dtype))
        gradT = grad_T(frames, refs, ks).reshape(H * w, B)
        parts = [xT.to(dtype)]
        if r_dyn:
            parts.append(dyn_T(frames[:-1], frames[1:]).reshape((H - 1) * r_dyn, B))
        if r_sc:
            parts.append(sc_T(frames, refs, ks).reshape(H * r_sc, B))
        return gradT, torch.cat(parts, dim=0)

    return vectors_T
