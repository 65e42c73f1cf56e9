"""The batch driver's rolled path against JAX's: the ``chunk_kernel`` rule,
the wrappers' width guard, the driver with ``rolled=True`` under forced
budgets, with warm starts and padding, and with the depth-1 CR level (the
driver cases of ``test_torch_banded_rolled.py``; helpers in
``torch_banded_rolled_cases.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.solvers.admm_banded_batch import (
    admm_solve_banded_batch as j_batch,
)
from optimal_control_problem_tpu_torch.ops import banded_kernel as bk
from optimal_control_problem_tpu_torch.ops import banded_rolled_kernel as brk
from optimal_control_problem_tpu_torch.solvers import admm_banded_batch as abb
from tests.test_torch_banded_kernel import SET, chunk_case, port, stacked
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize(
    "N,w,B,rolled,fn,kw",
    [
        (100, 16, 64, None, "rolled", {"cr1": True}),  # quadrotor h100, B=64
        (100, 16, 128, None, "rolled", {"cr1": False}),  # ... B=128: no CR level
        (17, 16, 8, None, "rolled", {"cr1": False}),  # odd horizon
        (20, 5, 1024, None, "one_way", {}),  # cart-pole h20
        (20, 5, 8, True, "rolled", {"cr1": True}),  # forced
        (100, 16, 64, False, "one_way", {}),  # forced
    ],
)
def test_chunk_kernel_rule(N, w, B, rolled, fn, kw):
    want = {"rolled": brk.banded_admm_chunk_rolled, "one_way": bk.banded_admm_chunk}[fn]
    got, got_kw = abb.chunk_kernel(N, w, B, rolled)
    assert got is want and got_kw == kw


def test_wrappers_raise_for_widths_their_kernel_does_not_take(monkeypatch):
    """On the card the one-way wrapper raises for w=16 and the rolled one
    for w > 16 (checked on meta tensors past the contract checks)."""
    st = port(SET).replace(eps_abs=0.0, eps_rel=0.0, max_iter=4, adaptive_rho=False)
    args, kw = chunk_case(st, N=4)
    meta = [
        {k: v.to("meta") for k, v in x.items()} if isinstance(x, dict) else x.to("meta")
        for x in args
    ]
    monkeypatch.setattr(bk, "chunk_contract", lambda *a: ([], (4, 16, 3, 1, 3)))
    with pytest.raises(ValueError, match="no CUDA instantiation"):
        bk.banded_admm_chunk(*meta, **kw)
    monkeypatch.setattr(brk, "chunk_contract", lambda *a: ([], (4, 20, 3, 1, 3)))
    with pytest.raises(ValueError, match="exceeds"):
        brk.banded_admm_chunk_rolled(*meta, **kw, cr1=False)


@pytest.mark.parametrize("adaptive", [True, False])
def test_rolled_driver_matches_jax_forced_budget(adaptive):
    st = SET.replace(adaptive_rho=adaptive, eps_abs=0.0, eps_rel=0.0, max_iter=100,
                     check_infeasibility=False)
    jqp, tqp = stacked(range(4))
    ref = j_batch(jqp, st, rolled=True)
    bat = abb.admm_solve_banded_batch(tqp, port(st), device="cpu", rolled=True)
    np.testing.assert_array_equal(bat.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(bat.x.numpy(), np.asarray(ref.x), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(bat.y.numpy(), np.asarray(ref.y), atol=1e-3, rtol=1e-2)


def test_rolled_driver_warm_start_and_padding_match_jax():
    # r2 = 0 exercises the inert-row padding; warm starts enter scaled.  A
    # forced budget, as in test_torch_banded_kernel: at eps 1e-4 one of these
    # scenarios sits at the f32 residual floor and converges a hundred
    # iterations apart in the two packages (ROADMAP Queue C, knife edge).
    jqp, tqp = stacked([s + 10 for s in range(3)], r2=0)
    n, m = tqp.q.shape[1], tqp.l.shape[1]
    rng = np.random.default_rng(0)
    x0 = (0.1 * rng.normal(size=(3, n))).astype(np.float32)
    y0 = (0.1 * rng.normal(size=(3, m))).astype(np.float32)
    st = SET.replace(eps_abs=0.0, eps_rel=0.0, max_iter=60, check_infeasibility=False)
    ref = j_batch(jqp, st, x0=jnp.asarray(x0), y0=jnp.asarray(y0), rolled=True)
    bat = abb.admm_solve_banded_batch(
        tqp, port(st), x0=torch.as_tensor(x0), y0=torch.as_tensor(y0), device="cpu",
        rolled=True,
    )
    assert bat.y.shape == tuple(ref.y.shape)
    np.testing.assert_array_equal(bat.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(bat.x.numpy(), np.asarray(ref.x), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(bat.y.numpy(), np.asarray(ref.y), atol=1e-3, rtol=1e-2)


def test_rolled_driver_depth1_cr_level_matches_jax():
    """N=16 takes the CR level in both packages; N=17 stays on the plain
    two-way path.  Forced budget to f32 roundoff, converged solves at the
    solver tolerance."""
    st = SET.replace(eps_abs=0.0, eps_rel=0.0, max_iter=60, check_infeasibility=False,
                     adaptive_rho=False)
    jqp, tqp = stacked(range(3), N=16, w=4)
    ref = j_batch(jqp, st, rolled=True)
    bat = abb.admm_solve_banded_batch(tqp, port(st), device="cpu", rolled=True)
    np.testing.assert_allclose(bat.x.numpy(), np.asarray(ref.x), atol=3e-4, rtol=1e-3)
    st2 = SET.replace(adaptive_rho=False)
    ref2 = j_batch(jqp, st2, rolled=True)
    bat2 = abb.admm_solve_banded_batch(tqp, port(st2), device="cpu", rolled=True)
    np.testing.assert_allclose(bat2.x.numpy(), np.asarray(ref2.x), atol=5e-3, rtol=1e-2)
    jqo, tqo = stacked([s + 3 for s in range(2)], N=17, w=4)
    ref3 = j_batch(jqo, st, rolled=True)
    bat3 = abb.admm_solve_banded_batch(tqo, port(st), device="cpu", rolled=True)
    np.testing.assert_allclose(bat3.x.numpy(), np.asarray(ref3.x), atol=3e-4, rtol=1e-3)
