"""Port's block-tridiagonal ops (``optimal_control_problem_tpu_torch/ops/
block_tridiag.py``) against the JAX package on the same numpy inputs.

Both run in float32 on the CPU with the same elementwise op order, so they
agree to f32 roundoff (rtol 1e-5).  The port's scan form of the stage
recursions (``loop=True``) is held bitwise to its host loops."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.ops import block_tridiag as jbt
from optimal_control_problem_tpu_torch.ops import block_tridiag as tbt
from optimal_control_problem_tpu_torch.utils.serialization import export_solver, import_solver
from torch_threads import one_torch_thread  # noqa: F401


def spd_blocks(rng, lead, w):
    L = rng.normal(size=lead + (w, w))
    return (L @ np.swapaxes(L, -1, -2) + 2 * np.eye(w)).astype(np.float32)


def btd_system(seed, N, w):
    rng = np.random.default_rng(seed)
    diag = spd_blocks(rng, (N,), w) + 4 * np.eye(w, dtype=np.float32)
    lower = (0.3 * rng.normal(size=(N - 1, w, w))).astype(np.float32)
    b = rng.normal(size=(N, w)).astype(np.float32)
    return diag, lower, b


@pytest.mark.parametrize("w", [1, 3, 5, 8])
def test_small_spd_inv_matches_jax(w):
    a = spd_blocks(np.random.default_rng(w), (4, 3), w)
    ours = tbt.small_spd_inv(torch.as_tensor(a)).numpy()
    ref = np.asarray(jbt.small_spd_inv(jnp.asarray(a)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        ours @ a, np.broadcast_to(np.eye(w), a.shape), atol=1e-4
    )


@pytest.mark.parametrize("N,w", [(6, 4), (8, 5), (3, 3), (5, 12)])
def test_btd_factor_solve_matches_jax(N, w):
    diag, lower, b = btd_system(N * 10 + w, N, w)
    fac = tbt.btd_factor(torch.as_tensor(diag), torch.as_tensor(lower))
    jfac = jbt.btd_factor(jnp.asarray(diag), jnp.asarray(lower))
    np.testing.assert_allclose(fac.dinv.numpy(), np.asarray(jfac.dinv), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(fac.g.numpy(), np.asarray(jfac.g), rtol=1e-5, atol=1e-7)
    x = tbt.btd_solve(fac, torch.as_tensor(b)).numpy()
    xj = np.asarray(jbt.btd_solve(jfac, jnp.asarray(b)))
    np.testing.assert_allclose(x, xj, rtol=1e-5, atol=1e-6)
    # and it solves the system
    Mx = tbt.btd_matvec(torch.as_tensor(diag), torch.as_tensor(lower), torch.as_tensor(x))
    np.testing.assert_allclose(Mx.numpy(), b, atol=1e-4)


@pytest.mark.parametrize("N,w,lead", [(1, 3, ()), (2, 4, ()), (9, 5, (3,)), (6, 12, (2,))])
def test_btd_loop_form_is_bitwise_the_host_form(N, w, lead, tmp_path):
    """``loop=True`` (each stage recursion one scan operator, the form the
    device-side sequence-parallel solves and their exports run) gives the
    host loops' bits, eagerly and as a reloaded ``torch.export`` program;
    batch dims after the stage dim as the SPIKE chunk passes them."""
    rng = np.random.default_rng(N * 10 + w)
    diag = torch.as_tensor(spd_blocks(rng, (N,) + lead, w) + 4 * np.eye(w, dtype=np.float32))
    lower = torch.as_tensor((0.3 * rng.normal(size=(N - 1,) + lead + (w, w))).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(N,) + lead + (w,)).astype(np.float32))
    B = torch.as_tensor(rng.normal(size=(N,) + lead + (w, 2)).astype(np.float32))

    def solves(diag, lower, b, B, loop):
        fac = tbt.btd_factor(diag, lower, loop=loop)
        return (*fac[:2], tbt.btd_solve(fac, b, loop=loop), tbt.btd_solve_mat(fac, B, loop=loop))

    host = solves(diag, lower, b, B, False)
    for got in (solves(diag, lower, b, B, True),
                import_solver(export_solver(functools.partial(solves, loop=True),
                                            (diag, lower, b, B), str(tmp_path / "btd.pt2")))(
                    diag, lower, b, B)):
        assert all(torch.equal(h, g) for h, g in zip(host, got))


def test_btd_matvec_and_dense_to_blocks_match_jax():
    N, w = 5, 3
    diag, lower, b = btd_system(7, N, w)
    ours = tbt.btd_matvec(torch.as_tensor(diag), torch.as_tensor(lower), torch.as_tensor(b))
    ref = jbt.btd_matvec(jnp.asarray(diag), jnp.asarray(lower), jnp.asarray(b))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    M = np.zeros((N * w, N * w), np.float32)
    for k in range(N):
        M[k * w:(k + 1) * w, k * w:(k + 1) * w] = diag[k]
    for k in range(N - 1):
        M[(k + 1) * w:(k + 2) * w, k * w:(k + 1) * w] = lower[k]
        M[k * w:(k + 1) * w, (k + 1) * w:(k + 2) * w] = lower[k].T
    d, lo = tbt.dense_to_blocks(torch.as_tensor(M), N, w)
    dj, loj = jbt.dense_to_blocks(jnp.asarray(M), N, w)
    np.testing.assert_array_equal(d.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(loj))
