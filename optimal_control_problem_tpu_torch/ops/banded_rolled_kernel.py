"""Rolled two-way block-tridiagonal ADMM chunk, batch-last — port of
``optimal_control_problem_tpu/ops/banded_rolled_kernel.py::banded_admm_chunk_rolled``.

Same contract as :mod:`.banded_kernel` (same positional arguments, keyword
arguments and 13 outputs), for any block width up to 16: the chunk of the
long-horizon, wide-frame problems (quadrotor h100: N=100, w=16) that the
one-way kernel's register-array design does not take.  What differs is how
``M`` is factored and solved:

* **Two-way ("twisted") factorization** meeting at ``m = n_sys // 2``:
  block elimination runs from stage 0 down and from stage ``n_sys - 1``
  up.  Top multipliers ``g[k] = L[k+1] dinv[k]`` fill slots ``[0, m-1]``;
  the bottom chain's transposed multipliers ``W[k] = dinv[k+1] L[k+1]``
  fill slots ``[m, n_sys-2]``; the middle stage takes Schur terms from
  both sides.
* **Two-way solve**: forward elimination from both ends, one
  stage-parallel ``u = dinv s`` pass, then back-substitution outward from
  the middle.
* **Depth-1 cyclic-reduction level** when ``cr1``: every odd stage is
  eliminated stage-parallel first (reduced diagonal
  ``D' = d_even - Lb^T dinv_o Lb - La dinv_o La^T``, reduced couplings
  ``-Ya Lb`` with ``Ya = La dinv_o``), each solve folds the odd right-hand
  sides into the evens, runs the two-way solve on the ``N/2``-stage
  system and recovers the odds.  The driver decides ``cr1``.

:func:`banded_admm_chunk_rolled` is the wrapper: CUDA tensors launch the
hand-written kernel ``csrc/banded_rolled_chunk.cu`` (counted in
``banded_admm_chunk_rolled.launches``), CPU tensors run
:func:`banded_admm_chunk_rolled_plain`.  No fallback from one to the other.
The plain version keeps the JAX kernel's op order: every contraction is an
explicit ascending chain, so the CUDA kernel (same chains, no FMA
contraction) can agree with it bitwise.  The TPU mechanics (``pick_rolled_tile``,
unroll groups, the ``la`` dummy slot, VMEM limits) are not ported.
"""

from __future__ import annotations

from typing import Dict

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
    mmt,
    mtm,
    mtv,
    mv,
    outer_r,
    register_chunk_op,
)

__all__ = [
    "banded_admm_chunk_rolled",
    "banded_admm_chunk_rolled_plain",
    "rolled_slab_floats",
    "MAX_ROLLED_WIDTH",
]

# Widest block the CUDA kernel takes (two blocks' elements, one thread
# each, fill its 512-thread thread block).
MAX_ROLLED_WIDTH = 16


def rolled_slab_floats(N: int, w: int, r: int, r2: int, cr1: bool) -> int:
    """Floats of one scenario's global slab in ``csrc/banded_rolled_chunk.cu``
    (its ``make_layout``): M's diagonal and subdiagonal blocks ((2N-1)
    w^2); with the CR level the reduced system and the temporaries ``Vb``,
    ``Ya`` and the workspace of the level's batched inverses ((8H - 2)
    w^2, H = N // 2); the Gauss-Jordan / Schur workspace of the two chains
    (10 w^2); the rhs, sweep and u vectors (3 N w); the scenario's copy of
    its operators (Hb, J0, J1, Jc and the bound and scaling rows) and its
    carried state.  What fits in shared memory is used from there."""
    W2, H, nd = w * w, N // 2, N - 1
    blocks = (2 * N - 1) * W2 + ((8 * H - 2) * W2 if cr1 else 0) + 10 * W2 + 3 * N * w
    ops = N * W2 + 2 * nd * r * w + N * r2 * w
    rows = 6 * N * w + 4 * nd * r + 4 * N * r2
    state = 3 * N * w + 2 * nd * r + 2 * N * r2
    return blocks + ops + rows + state


def two_way_factor(d, low):
    """Two-way block factorization of the SPD block-tridiagonal system with
    diagonal blocks ``d`` (n, w, w, B) and subdiagonal blocks ``low``
    (n-1, w, w, B) (``low[k-1] = L[k]``, the block at row k, column k-1).

    Returns ``(dinv (n, ...), gw (n-1, ...))``: pivot inverses, and
    multipliers ``g[k] = L[k+1] dinv[k]`` in slots ``[0, m-1]`` and
    ``W[k] = dinv[k+1] L[k+1]`` in slots ``[m, n-2]``, ``m = n // 2``.
    The two chains are independent; the middle stage subtracts the top
    Schur term, then the bottom one."""
    n = d.shape[0]
    m = n // 2
    dinv = [None] * n
    gw = [None] * (n - 1)
    dinv[0] = block_inv(d[0])
    if m < n - 1:
        dinv[n - 1] = block_inv(d[n - 1])
    for k in range(1, m):  # top: k = 1 .. m-1
        g_k = mm(low[k - 1], dinv[k - 1])
        dinv[k] = block_inv(d[k] - mmt(g_k, low[k - 1]))
        gw[k - 1] = g_k
    for k in range(n - 2, m, -1):  # bottom: k = n-2 .. m+1
        w_k = mm(dinv[k + 1], low[k])
        dinv[k] = block_inv(d[k] - mtm(low[k], w_k))
        gw[k] = w_k
    g_m1 = mm(low[m - 1], dinv[m - 1])
    dm = d[m] - mmt(g_m1, low[m - 1])
    if m < n - 1:
        w_m = mm(dinv[m + 1], low[m])
        dm = dm - mtm(low[m], w_m)
        gw[m] = w_m
    dinv[m] = block_inv(dm)
    gw[m - 1] = g_m1
    return torch.stack(dinv), torch.stack(gw)


def two_way_solve(dinv, gw, rhs):
    """Solve with :func:`two_way_factor`'s factors; ``rhs`` (n, w, B).

    Forward elimination from both ends (top ``s[k] -= g[k-1] s[k-1]`` for
    k = 1..m, bottom ``s[k] -= W[k]^T s[k+1]`` for k = n-2..m, paired
    step by step as in the JAX kernel, which fixes the order in which the
    two chains fold into ``s[m]``), ``u = dinv s`` for every stage, then
    back-substitution outward from the middle."""
    n = rhs.shape[0]
    m = n // 2
    s = list(rhs.unbind(0))

    def fwd_top(i):
        k = i + 1
        s[k] = s[k] - mv(gw[k - 1], s[k - 1])

    def fwd_bot(i):
        k = n - 2 - i
        s[k] = s[k] - mtv(gw[k], s[k + 1])

    nt, nb = m, n - 1 - m
    common = min(nt, nb)
    for i in range(common):
        fwd_top(i)
        fwd_bot(i)
    for i in range(common, nt):
        fwd_top(i)
    for i in range(common, nb):
        fwd_bot(i)
    u = mv(dinv, torch.stack(s))
    x = list(u.unbind(0))
    for k in range(m - 1, -1, -1):
        x[k] = u[k] - mtv(gw[k], x[k + 1])
    for k in range(m + 1, n):
        x[k] = u[k] - mv(gw[k - 1], x[k - 1])
    return torch.stack(x)


def banded_admm_chunk_rolled_plain(
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
    cr1: bool,
):
    """Plain PyTorch version of the rolled chunk, op for op the JAX
    ``_kernel`` (arguments and returns as
    :func:`.banded_kernel.banded_admm_chunk_plain`; ``cr1`` adds the
    depth-1 cyclic-reduction level and needs an even ``N >= 4``)."""
    N, w, B = qT.shape
    j0, j1, jc = J0T, J1T, JcT
    rx, rd_, rc = boundsT["rx"], boundsT["rd"], boundsT["rc"]
    nd = N - 1
    if cr1 and (N % 2 or N < 4):
        raise ValueError(f"cr1 needs an even horizon N >= 4 (got N={N})")

    # ---- M assembly: Hb, + (sigma + rho_x) on the diagonal, then the J0,
    # J1 and stage-row terms as ascending r-chains ----------------------
    idx = torch.arange(w, device=qT.device)
    diag = HbT.clone()
    diag[:, idx, idx] = diag[:, idx, idx] + (sigma + rx)
    diag[:nd] = diag[:nd] + outer_r(rd_, j0, j0)
    diag[1:] = diag[1:] + outer_r(rd_, j1, j1)
    diag = diag + outer_r(rc, jc, jc)
    low = outer_r(rd_, j1, j0)  # (Nd, w, w, B): low[k-1] = L[k]

    if cr1:
        H = N // 2
        d_even, d_odd = diag[0::2], diag[1::2]
        Lb = low[0::2]  # (H,) L[2i+1]: odd 2i+1 below even 2i
        La = low[1::2]  # (H-1,) L[2i+2]: even 2i+2 below odd 2i+1
        dinv_o = block_inv(d_odd)
        Vb = mm(dinv_o, Lb)
        Ya = mm(La, dinv_o[: H - 1])
        d_red = d_even - mtm(Lb, Vb)
        d_red = torch.cat([d_red[:1], d_red[1:] - mmt(Ya, La)])
        l_red = -mm(Ya, Lb[: H - 1])
        dinv, gw = two_way_factor(d_red, l_red)

        def btd_solve(rhs):
            b_even, b_odd = rhs[0::2], rhs[1::2]
            t_o = mv(dinv_o, b_odd)
            fold = b_even - mtv(Lb, t_o)
            fold = torch.cat([fold[:1], fold[1:] - mv(La, t_o[: H - 1])])
            x_even = two_way_solve(dinv, gw, fold)
            rhs_o = b_odd - mv(Lb, x_even)
            rhs_o = torch.cat([rhs_o[: H - 1] - mtv(La, x_even[1:]), rhs_o[H - 1 :]])
            x_odd = mv(dinv_o, rhs_o)
            return torch.stack([x_even, x_odd], dim=1).reshape(N, w, B)

    else:
        dinv, gw = two_way_factor(diag, low)

        def btd_solve(rhs):
            return two_way_solve(dinv, gw, rhs)

    return admm_chunk_iterate_plain(
        it0, done0, HbT, J0T, J1T, JcT, qT, boundsT, scaleT,
        (xT, zxT, zdT, zcT, yxT, ydT, ycT), btd_solve,
        interval=interval, check_every=check_every, max_iter=max_iter,
        sigma=sigma, alpha=alpha, eps_abs=eps_abs, eps_rel=eps_rel,
    )


def banded_admm_chunk_rolled(
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
    cr1: bool,
    device=None,
):
    """Run one rho-constant banded-ADMM chunk through the rolled two-way
    kernel; all arrays batch-last.

    Same contract as :func:`banded_admm_chunk_rolled_plain`, through the op
    ``ocp_torch::banded_admm_chunk_rolled``.  CPU tensors
    take the plain version; CUDA tensors launch
    ``csrc/banded_rolled_chunk.cu`` on the current stream (f32,
    contiguous, ``w <= MAX_ROLLED_WIDTH``, ``r, r2 >= 1``) or raise.
    Arrays that are not tensors go to ``device`` (:func:`chunk_tensors`).
    """
    (it0, done0, HbT, J0T, J1T, JcT, qT, boundsT, scaleT,
     xT, yxT, ydT, ycT, zxT, zdT, zcT) = chunk_tensors(
        it0, done0, HbT, J0T, J1T, JcT, qT, boundsT, scaleT,
        xT, yxT, ydT, ycT, zxT, zdT, zcT, device=device)
    inputs, dims = chunk_contract(
        "banded_admm_chunk_rolled", it0, done0, HbT, J0T, J1T, JcT, qT, boundsT,
        scaleT, xT, yxT, ydT, ycT, zxT, zdT, zcT, check_every,
    )
    N = dims[0]
    if cr1 and (N % 2 or N < 4):
        raise ValueError(f"cr1 needs an even horizon N >= 4 (got N={N})")
    if qT.device.type != "cpu":
        _card_width(dims[1])
    return tuple(torch.ops.ocp_torch.banded_admm_chunk_rolled(
        inputs, *chunk_scalars(interval, check_every, max_iter, sigma, alpha, eps_abs,
                               eps_rel), bool(cr1)))


def _card_width(w: int) -> None:
    """Raise for a block width the CUDA kernel does not take (checked by the
    wrapper before the op, so a trace for the card refuses it too)."""
    if w > MAX_ROLLED_WIDTH:
        raise ValueError(
            f"banded_admm_chunk_rolled: block width w={w} exceeds the CUDA "
            f"kernel's {MAX_ROLLED_WIDTH}"
        )


def _launch(inputs, dims, interval, check_every, max_iter, sigma, alpha, eps_abs, eps_rel, cr1):
    """The wrapper's kernel path: outputs, slab and the launch of
    ``csrc/banded_rolled_chunk.cu`` on ``inputs`` (checked by
    ``chunk_contract``)."""
    N, w, r, r2, B = dims
    _card_width(w)
    dev = inputs[0].device
    outs = chunk_outputs(dims, dev)
    if B == 0:
        return outs
    per = rolled_slab_floats(N, w, r, r2, cr1)
    slab = torch.empty((B, per), dtype=torch.float32, device=dev)
    launch_chunk(
        "banded_admm_chunk_rolled", "banded_rolled_chunk",
        "ocp_banded_admm_chunk_rolled_f32",
        [*inputs, *outs, slab],
        (N, w, r, r2, B, interval, check_every, max_iter, int(bool(cr1)), per),
        (sigma, alpha, eps_abs, eps_rel), dev,
    )
    banded_admm_chunk_rolled.launches += 1
    return outs


banded_admm_chunk_rolled.launches = 0
register_chunk_op("banded_admm_chunk_rolled", banded_admm_chunk_rolled_plain, _launch,
                  flags=("cr1",))
