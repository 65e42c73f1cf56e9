"""Cyclic-reduction block-tridiagonal ADMM chunk, batch-last — port of
``optimal_control_problem_tpu/ops/banded_cr_kernel.py::banded_admm_chunk_cr``.

Same contract as :mod:`.banded_kernel` and :mod:`.banded_rolled_kernel`
(same positional and keyword arguments, same 13 outputs), for any block
width up to 16.  What differs is how ``M`` is factored and solved: block
odd-even cyclic reduction, level by level over the plan of
:func:`cr_level_plan` (quadrotor h100: 100 -> 50 -> 25 -> 13 -> 7 -> 4 ->
2 -> 1, seven levels), each level padded to even by one identity stage.

* **Factorization**, per level: the odd pivots' inverses ``dinv_odd``
  (every odd stage of the level at once), then for every survivor ``i``
  ``G_lo = L_lo dinv_lo`` (``dinv_lo``: the inverse of the odd stage below,
  zero for ``i = 0``), the reduced diagonal
  ``new_d = d_even - G_lo LT_lo - (LT_odd dinv_odd) L_odd`` and the next
  level's couplings ``L' = -G_lo L_odd_sh`` and
  ``LT' = -LT_odd_sh (dinv_lo LT_lo)`` (``_sh``: the previous survivor's
  odd block).  ``LT`` is a transposed-L workspace in the JAX kernel's
  orientation: it equals ``L^T`` bitwise at level 0 only, because an f32
  Gauss-Jordan inverse is not exactly symmetric.
* **Solve**, per level down: ``t_odd = dinv_odd b_odd``, fold
  ``b_even - L_lo t_lo - L_odd^T t_odd`` into the survivors; the root
  block; per level up: ``x_odd = dinv_odd (b_odd - L_odd x_even -
  L_next^T x_hi)``, interleaved with the survivors.

:func:`banded_admm_chunk_cr` is the wrapper: CUDA tensors launch the
hand-written kernel ``csrc/banded_cr_chunk.cu`` (counted in
``banded_admm_chunk_cr.launches``), CPU tensors run
:func:`banded_admm_chunk_cr_plain`.  No fallback from one to the other.
Every contraction of the plain version is an ascending chain (``mm``,
``mv``, ``mtv``, ``csum``), so the CUDA kernel (same chains, no FMA
contraction) can agree with it bitwise.  The TPU mechanics
(``pick_cr_tile``, 128-lane batch padding, survivor groups of 16 and their
loops, the Hb DMA through the working diagonals, runtime zeros,
reshape-based de-interleave) are not ported.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .banded_kernel import (
    admm_chunk_iterate_plain,
    block_inv,
    chunk_contract,
    chunk_outputs,
    chunk_scalars,
    chunk_tensors,
    launch_chunk,
    mm,
    mtv,
    mv,
    outer_r,
    register_chunk_op,
)

__all__ = [
    "banded_admm_chunk_cr",
    "banded_admm_chunk_cr_plain",
    "cr_level_plan",
    "cr_slab_floats",
    "MAX_CR_WIDTH",
]

# Widest block the CUDA kernel takes.
MAX_CR_WIDTH = 16


def cr_level_plan(N: int):
    """Static level metadata: list of ``(n, n_p, half, off_d, off_L)``
    plus the root slot index and total L slots (the JAX module's
    ``cr_level_plan``, copied).

    ``n``: live stage count entering the level; ``n_p``: padded to even;
    ``half``: survivors (= odds eliminated); ``off_d``: this level's
    offset into the packed odd-pivot-inverse array; ``off_L``: offset of
    this level's (padded) subdiagonal array in the packed L buffer.
    """
    levels = []
    off_d = 0
    off_L = 0
    n = N
    while n > 1:
        n_p = n + (n % 2)
        half = n_p // 2
        levels.append((n, n_p, half, off_d, off_L))
        off_d += half
        off_L += n_p
        n = half
    return levels, off_d, off_L


def cr_slab_floats(N: int, w: int, r: int, r2: int) -> int:
    """Floats of the CUDA kernel's global slab per scenario (the layout the
    kernel checks, ``make_layout`` in ``csrc/banded_cr_chunk.cu``): the
    operators copied from the batch-last inputs (Hb, J0, J1, Jc, the
    bound and scaling rows), the carried state, the level arrays (working
    diagonals and transposed couplings in two ping-pong buffers each, of
    ``N + 1`` and ``N // 2 + 2`` blocks), the packed odd-pivot inverses
    plus the root and their transposes, the packed couplings and their
    transposes, the level's three block products and the solve vectors,
    each rounded up to 16 bytes.  Regions held in shared memory keep their
    slot."""
    _, nd_slots, nl_slots = cr_level_plan(N)
    ww = w * w
    h0 = (N + 1) // 2
    regions = (
        N * ww, (N - 1) * r * w, (N - 1) * r * w, N * r2 * w,
        _ov_floats(N, w, r, r2), _st_floats(N, w, r, r2),
        (N + 1) * ww, (N + 1) * ww, (N // 2 + 2) * ww, (N // 2 + 2) * ww,
        (nd_slots + 1) * ww, (nd_slots + 1) * ww, nl_slots * ww, nl_slots * ww,
        3 * h0 * ww, _vec_floats(N, w, nd_slots),
    )
    return sum(_r4(n) for n in regions)


def _r4(n):  # a count of floats rounded up to 16 bytes
    return -(-n // 4) * 4


def _ov_floats(N, w, r, r2):  # q, rho_x, lx, ux, ds, ex; rho_d, ld, ud, ed; rho_c, lc, uc, ec
    return 6 * N * w + 4 * (N - 1) * r + 4 * N * r2


def _st_floats(N, w, r, r2):  # x, zx, yx, zd, yd, zc, yc
    return 3 * N * w + 2 * (N - 1) * r + 2 * N * r2


def _vec_floats(N, w, nd_slots):  # two ping-pong solve vectors, a temporary, the odd rhs
    return 3 * (N + 1) * w + nd_slots * w


def _cr_factor(diag, low) -> Tuple[List[tuple], torch.Tensor]:
    """Level-by-level CR factorization of the batch-last system with
    diagonal blocks ``diag`` (N, w, w, B) and subdiagonal blocks ``low``
    (N-1, w, w, B) (``low[k-1] = L[k]``).  Returns the per-level
    ``(dinv_odd, L_lo, L_odd)`` of the solve and the root inverse."""
    N, w, _, B = diag.shape
    zb = diag.new_zeros((1, w, w, B))
    eye = torch.eye(w, dtype=diag.dtype, device=diag.device)[None, :, :, None].expand(1, w, w, B)
    d = diag
    L = torch.cat([zb, low])  # L[k] couples stage k to k-1, L[0] = 0
    LT = L.transpose(1, 2)  # equal to the JAX kernel's row_r_t bitwise
    levels = []
    plan, _, _ = cr_level_plan(N)
    for n, n_p, half, _, _ in plan:
        if n_p != n:  # pad stage: identity diagonal, zero coupling
            d = torch.cat([d, eye])
            L = torch.cat([L, zb])
            LT = torch.cat([LT, zb])
        d_even, d_odd = d[0::2], d[1::2]
        L_lo, L_odd = L[0::2], L[1::2]
        LT_lo, LT_odd = LT[0::2], LT[1::2]
        dinv_odd = block_inv(d_odd)
        dinv_lo = torch.cat([zb, dinv_odd[:-1]])
        G_lo = mm(L_lo, dinv_lo)
        new_d = d_even - mm(G_lo, LT_lo) - mm(mm(LT_odd, dinv_odd), L_odd)
        levels.append((dinv_odd, L_lo, L_odd))
        if half > 1:
            G_loT = mm(dinv_lo, LT_lo)
            L = torch.cat([zb, -mm(G_lo[1:], L_odd[:-1])])
            LT = torch.cat([zb, -mm(LT_odd[:-1], G_loT[1:])])
        d = new_d
    return levels, block_inv(d[0])


def _cr_solve(N, levels, root_dinv, rhs):
    """Solve with :func:`_cr_factor`'s factors; ``rhs`` (N, w, B)."""
    plan, _, _ = cr_level_plan(N)
    s = rhs
    zv = rhs.new_zeros((1,) + rhs.shape[1:])
    stack = []
    for (n, n_p, _, _, _), (dinv_odd, L_lo, L_odd) in zip(plan, levels):
        if n_p != n:
            s = torch.cat([s, zv])
        b_even, b_odd = s[0::2], s[1::2]
        t_odd = mv(dinv_odd, b_odd)
        t_lo = torch.cat([zv, t_odd[:-1]])
        s = b_even - mv(L_lo, t_lo) - mtv(L_odd, t_odd)
        stack.append(b_odd)
    s = mv(root_dinv[None], s)
    zb = root_dinv.new_zeros((1,) + root_dinv.shape)
    for (n, n_p, _, _, _), (dinv_odd, L_lo, L_odd), b_odd in zip(
        reversed(plan), reversed(levels), reversed(stack)
    ):
        x_hi = torch.cat([s[1:], zv])
        L_next = torch.cat([L_lo[1:], zb])
        rhs_o = b_odd - mv(L_odd, s) - mtv(L_next, x_hi)
        x_odd = mv(dinv_odd, rhs_o)
        s = torch.stack([s, x_odd], dim=1).reshape((n_p,) + s.shape[1:])[:n]
    return s


def banded_admm_chunk_cr_plain(
    it0, done0, HbT, J0T, J1T, JcT, qT,
    boundsT: Dict[str, torch.Tensor],
    scaleT: Dict[str, torch.Tensor],
    xT, yxT, ydT, ycT, zxT, zdT, zcT,
    *,
    interval: int,
    check_every: int,
    max_iter: int,
    sigma: float,
    alpha: float,
    eps_abs: float,
    eps_rel: float,
):
    """Plain PyTorch version of the CR chunk, op for op the JAX ``_kernel``
    (arguments and returns as :func:`.banded_kernel.banded_admm_chunk_plain`)
    with whole levels in place of its survivor groups."""
    N, w, B = qT.shape
    rx, rd_, rc = boundsT["rx"], boundsT["rd"], boundsT["rc"]
    nd = N - 1

    # ---- M assembly, as the rolled chunk's ------------------------------
    idx = torch.arange(w, device=qT.device)
    diag = HbT.clone()
    diag[:, idx, idx] = diag[:, idx, idx] + (sigma + rx)
    diag[:nd] = diag[:nd] + outer_r(rd_, J0T, J0T)
    diag[1:] = diag[1:] + outer_r(rd_, J1T, J1T)
    diag = diag + outer_r(rc, JcT, JcT)
    low = outer_r(rd_, J1T, J0T)  # (Nd, w, w, B): low[k-1] = L[k]

    levels, root_dinv = _cr_factor(diag, low)
    return admm_chunk_iterate_plain(
        it0, done0, HbT, J0T, J1T, JcT, qT, boundsT, scaleT,
        (xT, zxT, zdT, zcT, yxT, ydT, ycT),
        lambda rhs: _cr_solve(N, levels, root_dinv, rhs),
        interval=interval, check_every=check_every, max_iter=max_iter,
        sigma=sigma, alpha=alpha, eps_abs=eps_abs, eps_rel=eps_rel,
    )


def banded_admm_chunk_cr(
    it0, done0, HbT, J0T, J1T, JcT, qT,
    boundsT: Dict[str, torch.Tensor],
    scaleT: Dict[str, torch.Tensor],
    xT, yxT, ydT, ycT, zxT, zdT, zcT,
    *,
    interval: int,
    check_every: int,
    max_iter: int,
    sigma: float,
    alpha: float,
    eps_abs: float,
    eps_rel: float,
    device=None,
):
    """Run one rho-constant banded-ADMM chunk through the cyclic-reduction
    kernel; all arrays batch-last.

    Same contract as :func:`banded_admm_chunk_cr_plain`, through the op
    ``ocp_torch::banded_admm_chunk_cr``.  CPU tensors take
    the plain version; CUDA tensors launch ``csrc/banded_cr_chunk.cu`` on
    the current stream (f32, contiguous, ``w <= MAX_CR_WIDTH``,
    ``r, r2 >= 1``) or raise.  Arrays that are not tensors go to
    ``device`` (:func:`chunk_tensors`).
    """
    (it0, done0, HbT, J0T, J1T, JcT, qT, boundsT, scaleT,
     xT, yxT, ydT, ycT, zxT, zdT, zcT) = chunk_tensors(
        it0, done0, HbT, J0T, J1T, JcT, qT, boundsT, scaleT,
        xT, yxT, ydT, ycT, zxT, zdT, zcT, device=device)
    inputs, dims = chunk_contract(
        "banded_admm_chunk_cr", it0, done0, HbT, J0T, J1T, JcT, qT, boundsT,
        scaleT, xT, yxT, ydT, ycT, zxT, zdT, zcT, check_every,
    )
    if qT.device.type != "cpu":
        _card_width(dims[1])
    return tuple(torch.ops.ocp_torch.banded_admm_chunk_cr(
        inputs, *chunk_scalars(interval, check_every, max_iter, sigma, alpha, eps_abs,
                               eps_rel)))


def _card_width(w: int) -> None:
    """Raise for a block width the CUDA kernel does not take (checked by the
    wrapper before the op, so a trace for the card refuses it too)."""
    if w > MAX_CR_WIDTH:
        raise ValueError(
            f"banded_admm_chunk_cr: block width w={w} exceeds the CUDA "
            f"kernel's {MAX_CR_WIDTH}"
        )


def _launch(inputs, dims, interval, check_every, max_iter, sigma, alpha, eps_abs, eps_rel):
    """The wrapper's kernel path: outputs, slab and the launch of
    ``csrc/banded_cr_chunk.cu`` on ``inputs`` (checked by
    ``chunk_contract``)."""
    N, w, r, r2, B = dims
    _card_width(w)
    dev = inputs[0].device
    outs = chunk_outputs(dims, dev)
    if B == 0:
        return outs
    # The operators, level arrays and whatever else does not fit in shared
    # memory, scenario-major: one thread block's scenario is one slab.
    per = cr_slab_floats(N, w, r, r2)
    slab = torch.empty((B, per), dtype=torch.float32, device=dev)
    launch_chunk(
        "banded_admm_chunk_cr", "banded_cr_chunk", "ocp_banded_admm_chunk_cr_f32",
        [*inputs, *outs, slab],
        (N, w, r, r2, B, interval, check_every, max_iter, per),
        (sigma, alpha, eps_abs, eps_rel), dev,
    )
    banded_admm_chunk_cr.launches += 1
    return outs


banded_admm_chunk_cr.launches = 0
register_chunk_op("banded_admm_chunk_cr", banded_admm_chunk_cr_plain, _launch)
