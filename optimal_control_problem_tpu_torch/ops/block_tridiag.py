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
the two packages agree to f32 roundoff.  The cyclic-reduction variants
(``cr_factor``/``cr_solve``) are not ported yet (ROADMAP Queue A).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "BTDFactor",
    "btd_factor",
    "btd_solve",
    "btd_matvec",
    "dense_to_blocks",
    "small_spd_inv",
]


def small_spd_inv(a: torch.Tensor) -> torch.Tensor:
    """Batched inverse of small SPD blocks ``(..., w, w)`` without pivoting.

    An unrolled Gauss-Jordan with diagonal pivots (the pivot blocks are
    SPD Schur complements, so diagonal pivoting is sound): ``w`` rank-1
    broadcast updates vectorized over every leading dim, in the exact
    elementwise op order of the JAX version and of the chunk kernel's
    in-kernel inverse.  Not ``torch.linalg.inv``: LU with partial pivoting
    is a different op order and a library call per block batch.
    """
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
    """(w, w) block product as a sequential j-chain (kernel op order)."""
    w = a.shape[-1]
    if w > 8:
        return a @ b
    acc = None
    for j in range(w):
        t = a[:, j : j + 1] * b[j : j + 1, :]
        acc = t if acc is None else acc + t
    return acc


def _mm_t(a, b):
    """``a @ b.T`` as a sequential j-chain."""
    w = a.shape[-1]
    if w > 8:
        return a @ b.T
    acc = None
    for j in range(w):
        t = a[:, j : j + 1] * b[:, j : j + 1].reshape(1, w)
        acc = t if acc is None else acc + t
    return acc


def btd_factor(diag: torch.Tensor, lower: torch.Tensor) -> BTDFactor:
    """Factor an SPD block-tridiagonal matrix.

    ``diag``: (N, w, w) diagonal blocks; ``lower``: (N-1, w, w) subdiagonal
    blocks (block (k+1, k)).
    """
    N = diag.shape[0]
    dinv = [small_spd_inv(diag[0])]
    gs = []
    for k in range(1, N):
        a_km1 = lower[k - 1]
        g_k = _mm(a_km1, dinv[-1])
        schur = diag[k] - _mm_t(g_k, a_km1)
        dinv.append(small_spd_inv(schur))
        gs.append(g_k)
    g = torch.stack(gs) if gs else lower[:0]
    return BTDFactor(dinv=torch.stack(dinv), g=g, lower=lower)


def btd_solve(fac: BTDFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b given the factorization.  ``b``: (N, w) -> (N, w).

    Block "matvecs" are broadcast-multiply-reduce in the chunk kernel's
    sweep order.
    """
    dinv, g, _ = fac
    N = b.shape[0]
    # Forward: y_k = b_k - G_k y_{k-1}
    y = [b[0]]
    for k in range(1, N):
        y.append(b[k] - torch.sum(g[k - 1] * y[-1][None, :], dim=1))
    # Backward: x_N = Dinv_N y_N; x_k = Dinv_k y_k - G_{k+1}^T x_{k+1}
    x = [None] * N
    x[N - 1] = torch.sum(dinv[N - 1] * y[N - 1][None, :], dim=1)
    for k in range(N - 2, -1, -1):
        x[k] = torch.sum(dinv[k] * y[k][None, :], dim=1) - torch.sum(
            g[k] * x[k + 1][:, None], dim=0
        )
    return torch.stack(x)


def btd_matvec(diag: torch.Tensor, lower: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """M @ x for a block-tridiagonal M.  ``x``: (N, w)."""
    out = torch.einsum("kij,kj->ki", diag, x)
    out = out.clone()
    out[1:] += torch.einsum("kij,kj->ki", lower, x[:-1])
    out[:-1] += torch.einsum("kji,kj->ki", lower, x[1:])
    return out


def dense_to_blocks(M: torch.Tensor, N: int, w: int):
    """Extract (diag, lower) blocks from a dense block-tridiagonal matrix."""
    Mb = M.reshape(N, w, N, w)
    diag = torch.stack([Mb[k, :, k, :] for k in range(N)])
    lower = torch.stack([Mb[k + 1, :, k, :] for k in range(N - 1)])
    return diag, lower
