"""Block-tridiagonal SPD solver (block-Thomas / Riccati-style) — port of
``optimal_control_problem_tpu/ops/block_tridiag.py``.

The condensed ADMM operator ``M = P + sigma*I + A^T R A`` of a
horizon-structured OCP is block-tridiagonal; its block LDL^T costs
O(N w^3) instead of the dense O(N^3 w^3).  These are the per-scenario
plain-torch versions used by ``solvers/admm_banded.py`` (the per-scenario
reference path and the active-set polish).  The batched hot loop factors
inside the CUDA chunk kernels (``ops/banded_kernel.py``, one-way, and
``ops/banded_rolled_kernel.py``, two-way).

Every block product is an explicit add chain in the JAX module's order, so
the two packages agree to f32 roundoff.  The cyclic-reduction pair
(``cr_factor``/``cr_solve``, log-depth, behind ``banded_solver="cr"`` of the
per-scenario solver) pads the horizon to a power of two with identity
blocks; the batched CR chunk kernel (``ops/banded_cr_kernel.py``) pads each
level to even instead.  ``btd_solve_mat`` (block right-hand sides) serves
the horizon-sharded paths (``parallel/horizon.py``, ``parallel/seq_admm.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import as_tensors

__all__ = [
    "BTDFactor",
    "CRFactor",
    "btd_factor",
    "btd_solve",
    "btd_solve_mat",
    "btd_matvec",
    "cr_factor",
    "cr_solve",
    "dense_to_blocks",
    "small_spd_inv",
]


def small_spd_inv(a: torch.Tensor, *, device=None) -> torch.Tensor:
    """Batched inverse of small SPD blocks ``(..., w, w)`` without pivoting.

    An unrolled Gauss-Jordan with diagonal pivots (the pivot blocks are
    SPD Schur complements, so diagonal pivoting is sound): ``w`` rank-1
    broadcast updates vectorized over every leading dim, in the exact
    elementwise op order of the JAX version and of the chunk kernel's
    in-kernel inverse.  Not ``torch.linalg.inv``: LU with partial pivoting
    is a different op order and a library call per block batch.  A
    non-tensor ``a`` goes to ``device`` (:func:`..device.as_tensors`).
    """
    a, = as_tensors(a, device=device)
    w = a.shape[-1]
    if w == 0:
        return a
    if w == 1:
        return 1.0 / a
    if w > 32:  # not "small": generic LU wins asymptotically
        return torch.linalg.inv(a)
    eye = torch.eye(w, dtype=a.dtype, device=a.device)
    m = a
    inv = torch.broadcast_to(eye, a.shape)
    for k in range(w):
        piv = m[..., k : k + 1, k : k + 1]  # (..., 1, 1)
        mrow = m[..., k : k + 1, :] / piv  # (..., 1, w)
        irow = inv[..., k : k + 1, :] / piv
        col = m[..., :, k : k + 1] * (1.0 - eye[:, k : k + 1])  # row k zeroed
        m = m - col * mrow  # rank-1 broadcast update
        inv = inv - col * irow
        rowmask = eye[k][:, None]  # (w, 1): select row k
        m = m * (1.0 - rowmask) + rowmask * mrow
        inv = inv * (1.0 - rowmask) + rowmask * irow
    return inv


class BTDFactor(NamedTuple):
    """Block LDL^T factors: M = L D L^T with unit-block-lower L.

    ``dinv``: (N, w, w) inverses of the pivot blocks D_k;
    ``g``: (N-1, w, w) subdiagonal multipliers L_{k+1,k} = A_k D_k^{-1};
    ``lower``: (N-1, w, w) original subdiagonal blocks A_k.
    """

    dinv: torch.Tensor
    g: torch.Tensor
    lower: torch.Tensor


def _mm(a, b):
    """(..., w, w) block products as a sequential j-chain (kernel op order)."""
    w = a.shape[-1]
    if w > 8:
        return a @ b
    acc = None
    for j in range(w):
        t = a[..., :, j : j + 1] * b[..., j : j + 1, :]
        acc = t if acc is None else acc + t
    return acc


def _mm_t(a, b):
    """``a @ b^T`` over leading dims as a sequential j-chain."""
    w = a.shape[-1]
    if w > 8:
        return a @ b.transpose(-1, -2)
    acc = None
    for j in range(w):
        t = a[..., :, j : j + 1] * b[..., :, j : j + 1].transpose(-1, -2)
        acc = t if acc is None else acc + t
    return acc


# Stages a trip of a sweep's scan: a solve's stage is a few small ops, as
# many as the trip's own fixed cost, which its stages share; the factor's
# stage (a pivot inverse) is ~200, and each a trip would only lengthen the
# trace.
SWEEP_STAGES_A_TRIP = 8


def _stages(step, first, xs, loop: bool, reverse: bool = False, trip: int = 1):
    """A stage recursion ``v_k = step(v_{k-1}, *xs_k)[0]`` from ``v = first``
    over the leading (stage) dim of ``xs``, backwards with ``reverse``;
    ``step`` may return more per-stage tensors after ``v_k``.  Returns the
    stacked ``v`` (``first`` included, in stage order) and each stacked
    extra.  A Python loop; with ``loop`` the stages past the first
    ``n % trip`` run as one scan operator, ``trip`` stages a trip: the
    device loop ``torch.export`` traces once whatever the number of
    stages, each trip reading its stages' slices and writing only its own
    outputs, the same ops on the same values (bitwise)."""
    n = xs[0].shape[0]
    h = n % trip if loop else n  # the stages of the Python loop
    vs, extra = [first], []
    for k in range(n - 1, n - 1 - h, -1) if reverse else range(h):
        v, *e = step(vs[-1], *(x[k] for x in xs))
        vs.append(v)
        extra.append(e)
    if h == n:
        outs = [list(t) for t in zip(*extra)]
        if reverse:
            for t in (vs, *outs):
                t.reverse()
        return (torch.stack(vs), *(torch.stack(t) for t in outs))
    from torch._higher_order_ops.scan import scan_op

    def body(prev, *xk):
        got = []
        for j in range(trip):
            got.append(step(prev, *(x[j] for x in xk)))
            prev = got[-1][0]
        return (prev.contiguous(),  # row-major, as the carry went in
                *(torch.stack(t) for t in zip(*got)))  # aliasing nothing

    rest = [x[:n - h].flip(0) if reverse else x[h:] for x in xs]
    _, vb, *eb = scan_op(
        body, [vs[-1].clone(memory_format=torch.contiguous_format)],
        [r.reshape(-1, trip, *r.shape[1:]).contiguous() for r in rest], ())
    vs = torch.cat([torch.stack(vs), vb.flatten(0, 1)])
    outs = [t.flatten(0, 1) for t in eb]
    if extra:
        outs = [torch.cat([torch.stack(a), b]) for a, b in zip(zip(*extra), outs)]
    if reverse:
        return (vs.flip(0), *(t.flip(0) for t in outs))
    return (vs, *outs)


def _factor_step(dinv_prev, d_k, a_km1):
    """One block-LDL^T stage: ``(D_k^{-1}, G_k)`` from ``D_{k-1}^{-1}``."""
    g_k = _mm(a_km1, dinv_prev)
    return small_spd_inv(d_k - _mm_t(g_k, a_km1)), g_k


def btd_factor(diag: torch.Tensor, lower: torch.Tensor, *, device=None,
               loop: bool = False) -> BTDFactor:
    """Factor an SPD block-tridiagonal matrix.

    ``diag``: (N, w, w) diagonal blocks; ``lower``: (N-1, w, w) subdiagonal
    blocks (block (k+1, k)); what is not a tensor goes to ``device``
    (:func:`..device.as_tensors`).  ``loop``: the stage recursion as one
    device loop (:func:`_stages`).
    """
    diag, lower = as_tensors(diag, lower, device=device)
    if diag.shape[0] == 1:
        return BTDFactor(dinv=small_spd_inv(diag[:1]), g=lower[:0], lower=lower)
    dinv, g = _stages(_factor_step, small_spd_inv(diag[0]), (diag[1:], lower), loop)
    return BTDFactor(dinv=dinv, g=g, lower=lower)


def _sweeps(fac, b, fwd, bwd, last, loop):
    """Forward ``y_k = fwd(y_{k-1}, b_k, G_k)`` from ``y_0 = b_0``, then
    backward ``x_k = bwd(x_{k+1}, Dinv_k, y_k, G_k)`` from ``x_N =
    last(Dinv_N, y_N)``: the two block-Thomas sweeps of a solve."""
    dinv, g, _ = fac
    y, = _stages(lambda y, b_k, g_k: (fwd(y, b_k, g_k),), b[0], (b[1:], g), loop,
                 trip=SWEEP_STAGES_A_TRIP)
    x, = _stages(lambda x, d_k, y_k, g_k: (bwd(x, d_k, y_k, g_k),), last(dinv[-1], y[-1]),
                 (dinv[:-1], y[:-1], g), loop, reverse=True, trip=SWEEP_STAGES_A_TRIP)
    return x


def btd_solve(fac: BTDFactor, b: torch.Tensor, *, loop: bool = False) -> torch.Tensor:
    """Solve M x = b given the factorization.  ``b``: (N, w) -> (N, w);
    batch dims after the stage dim (``b (N, ..., w)`` against factors
    ``(N, ..., w, w)``) solve every system at once.

    Block "matvecs" are broadcast-multiply-reduce in the chunk kernel's
    sweep order.  What is not a tensor goes to the factor's device.
    ``loop``: each sweep one device loop (:func:`_stages`).
    """
    dinv, g, lower, b = as_tensors(*fac, b)
    return _sweeps(
        BTDFactor(dinv, g, lower), b,
        lambda y, b_k, g_k: b_k - torch.sum(g_k * y[..., None, :], dim=-1),
        lambda x, d_k, y_k, g_k: (torch.sum(d_k * y_k[..., None, :], dim=-1)
                                  - torch.sum(g_k * x[..., :, None], dim=-2)),
        lambda d, y: torch.sum(d * y[..., None, :], dim=-1), loop)


def btd_solve_mat(fac: BTDFactor, B: torch.Tensor, *, loop: bool = False) -> torch.Tensor:
    """Solve M X = B with block right-hand sides: ``B (N, w, k) -> (N, w,
    k)`` (batch dims after the stage dim as in :func:`btd_solve`).  The
    JAX module's two scans as one forward and one backward sweep; every
    block product an ascending j-chain (``_mm``).  ``loop`` as in
    :func:`btd_solve`."""
    return _sweeps(
        fac, B,
        lambda y, b_k, g_k: b_k - _mm(g_k, y),
        lambda x, d_k, y_k, g_k: _mm(d_k, y_k) - _mm(g_k.transpose(-1, -2), x),
        _mm, loop)


def btd_matvec(diag: torch.Tensor, lower: torch.Tensor, x: torch.Tensor, *,
               device=None) -> torch.Tensor:
    """M @ x for a block-tridiagonal M.  ``x``: (N, w); what is not a tensor
    goes to ``device`` (:func:`..device.as_tensors`)."""
    diag, lower, x = as_tensors(diag, lower, x, device=device)
    out = torch.einsum("kij,kj->ki", diag, x)
    out = out.clone()
    out[1:] += torch.einsum("kij,kj->ki", lower, x[:-1])
    out[:-1] += torch.einsum("kji,kj->ki", lower, x[1:])
    return out


def dense_to_blocks(M: torch.Tensor, N: int, w: int, *, device=None):
    """Extract (diag, lower) blocks from a dense block-tridiagonal matrix
    (a non-tensor ``M`` goes to ``device``, :func:`..device.as_tensors`)."""
    M, = as_tensors(M, device=device)
    Mb = M.reshape(N, w, N, w)
    diag = torch.stack([Mb[k, :, k, :] for k in range(N)])
    lower = torch.stack([Mb[k + 1, :, k, :] for k in range(N - 1)])
    return diag, lower


# ----------------------------------------------------------------------
# Cyclic reduction: log-depth block-tridiagonal solve.  Odd-even cyclic
# reduction eliminates all odd stages of a level at once, so the sequential
# depth is ~2 log2(N) whole levels instead of block-Thomas' ~2N steps.


class CRFactor(NamedTuple):
    """Per-level elimination operators of :func:`cr_factor`.

    ``levels``: tuple over levels of ``(G_lo, G_hi, dinv_odd, L_odd, L_lo,
    L_up)``: for each even survivor j, ``G_lo = L_j D_{j-1}^{-1}`` (its
    coupling to the lower odd neighbour), ``G_hi = L_{j+1}^T D_{j+1}^{-1}``
    (upper odd neighbour), the inverses of the eliminated odd pivots, and
    the level's subdiagonal blocks (odd rows, even rows, the rows coupling
    each odd stage to the even stage below it); ``root_dinv``: the inverse
    of the final one-block system; ``n_orig``: the stage count before
    padding.
    """

    levels: tuple
    root_dinv: torch.Tensor
    n_orig: int


def _pad_pow2(diag: torch.Tensor, lower: torch.Tensor):
    """Pad ``(N, w, w)`` diagonal and ``(N-1, w, w)`` subdiagonal blocks to
    a power-of-two horizon with identity diagonals and zero couplings."""
    N, w, _ = diag.shape
    N2 = 1 << max(1, (N - 1).bit_length())
    if N2 == N:
        return diag, lower
    eye = torch.eye(w, dtype=diag.dtype, device=diag.device).expand(N2 - N, w, w)
    diag = torch.cat([diag, eye], dim=0)
    zeros = lower.new_zeros((N2 - 1 - lower.shape[0], w, w))
    return diag, torch.cat([lower, zeros], dim=0)


def cr_factor(diag: torch.Tensor, lower: torch.Tensor) -> CRFactor:
    """Precompute the cyclic-reduction elimination operators of an SPD
    block-tridiagonal matrix.

    ``diag``: (N, w, w); ``lower``: (N-1, w, w).  N is padded to a power of
    two with identity blocks.  The block products are :func:`_mm` /
    :func:`_mm_t` chains, the pivot inverses :func:`small_spd_inv`.
    """
    n_orig = diag.shape[0]
    diag, lower = _pad_pow2(diag, lower)
    N, w, _ = diag.shape
    zero = diag.new_zeros((1, w, w))
    # Uniform representation: L[k] couples stage k to k-1, L[0] = 0.
    L = torch.cat([zero, lower], dim=0)

    levels = []
    while N > 1:
        dinv_odd = small_spd_inv(diag[1::2])  # pivots to eliminate
        even_d = diag[0::2]
        # Even survivor 2i: lower odd neighbour 2i-1, upper odd 2i+1.
        L_lo = L[0::2]  # couples 2i -> 2i-1
        L_up = L[1::2]  # couples 2i+1 -> 2i (used transposed upward)
        dinv_lo = torch.cat([zero, dinv_odd[:-1]], dim=0)
        G_lo = _mm(L_lo, dinv_lo)
        G_hi = _mm(L_up.transpose(-1, -2), dinv_odd)
        new_diag = even_d - _mm_t(G_lo, L_lo) - _mm(G_hi, L_up)
        # Survivor 2i couples to 2i-2 through odd 2i-1:
        # L'_i = -G_lo[i] L[2i-1] (L[odd] couples 2i-1 -> 2i-2).
        L_odd = L[1::2]
        new_L = torch.cat([zero, -_mm(G_lo[1:], L_odd[:-1])], dim=0)
        levels.append((G_lo, G_hi, dinv_odd, L_odd, L_lo, L_up))
        diag, L = new_diag, new_L
        N //= 2

    return CRFactor(levels=tuple(levels), root_dinv=small_spd_inv(diag[0]), n_orig=n_orig)


def _bmv(a, v):
    """(k, w, w) @ (k, w) -> (k, w)."""
    return torch.sum(a * v[:, None, :], dim=-1)


def _bmv_t(a, v):
    """(k, w, w)^T @ (k, w) -> (k, w)."""
    return torch.sum(a * v[:, :, None], dim=-2)


def cr_solve(fac: CRFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b with precomputed cyclic-reduction factors.  ``b``: (N, w)."""
    n_orig = fac.n_orig
    w = b.shape[1]
    N2 = 1 << max(1, (n_orig - 1).bit_length())
    if N2 != n_orig:
        b = torch.cat([b, b.new_zeros((N2 - n_orig, w))], dim=0)
    zero_v = b.new_zeros((1, w))

    # Down-sweep: fold the odd right-hand sides into the even survivors.
    rhs_stack = []
    for G_lo, G_hi, _dinv_odd, _L_odd, _L_lo, _L_up in fac.levels:
        b_even, b_odd = b[0::2], b[1::2]
        b_odd_lo = torch.cat([zero_v, b_odd[:-1]], dim=0)
        rhs_stack.append(b_odd)
        b = b_even - _bmv(G_lo, b_odd_lo) - _bmv(G_hi, b_odd)

    x = torch.sum(fac.root_dinv * b[0][None, :], dim=1)[None, :]

    # Up-sweep: recover the odd unknowns of each level.  Odd stage 2i+1
    # couples to its even neighbours 2i and 2i+2:
    # L[2i+1] x_{2i} + D x + L[2i+2]^T x_{2i+2} = b_odd.
    zero_b = b.new_zeros((1, w, w))
    for (_G_lo, _G_hi, dinv_odd, L_odd, L_lo, _L_up), b_odd in zip(
        reversed(fac.levels), reversed(rhs_stack)
    ):
        x_hi = torch.cat([x[1:], zero_v], dim=0)
        L_next = torch.cat([L_lo[1:], zero_b], dim=0)
        rhs = b_odd - _bmv(L_odd, x) - _bmv_t(L_next, x_hi)
        x_odd = _bmv(dinv_odd, rhs)
        x = torch.stack([x, x_odd], dim=1).reshape(-1, w)

    return x[:n_orig]
