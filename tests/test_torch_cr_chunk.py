"""The plain cyclic-reduction chunk against JAX's `banded_admm_chunk_cr` in
interpret mode, its wrapper on CPU tensors, the driver's kernel choice, and
the driver with `banded_solver="cr"` against JAX's (the chunk and driver
cases of `test_torch_cr.py`, whose helpers are in `torch_cr_cases.py`;
split so that two test workers carry them).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.solvers.admm_banded_batch import (
    admm_solve_banded_batch as j_batch,
)
from optimal_control_problem_tpu_torch.ops import banded_cr_kernel as bck
from optimal_control_problem_tpu_torch.ops import banded_kernel as bk
from optimal_control_problem_tpu_torch.ops import banded_rolled_kernel as brk
from optimal_control_problem_tpu_torch.solvers import admm_banded_batch as abb
from tests.test_torch_banded_kernel import SET, assert_chunk_close, chunk_case, port, stacked
from torch_banded_rolled_cases import WIDE_ATOL, WIDE_RTOL, to_f64
from torch_cr_cases import (
    CR,
    run_jax_cr,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize(
    "N,it0,done0,interval,max_iter,r2",
    [
        (6, None, None, 40, 40, 1),  # even horizon, one level padded (3 -> 4)
        (7, [0, 20, 0], [0, 0, 1], 30, 40, 1),  # odd: 7 -> 8 -> 4 -> 2 -> 1; frozen
        (6, None, None, 40, 40, 0),  # no stage rows: the driver's inert pad
    ],
)
def test_cr_plain_matches_pallas_interpret(N, it0, done0, interval, max_iter, r2):
    st = port(SET).replace(eps_abs=0.0, eps_rel=0.0, max_iter=max_iter,
                           adaptive_rho=False, check_every=5)
    args, kw = chunk_case(st, it0=it0, done0=done0, N=N, r2=r2)
    kw["interval"] = interval
    ours = bck.banded_admm_chunk_cr_plain(*args, **kw)
    assert_chunk_close(ours, run_jax_cr(args, kw))
    if done0 is not None:
        assert int(ours[8][2]) == 0 and np.isinf(ours[9][2].item())
        assert int(ours[8][1]) == 20  # froze at max_iter mid-chunk
    # An exact elimination: the rolled two-way chunk gives the same iterates.
    rolled = brk.banded_admm_chunk_rolled_plain(*args, **kw, cr1=False)
    for a, b in zip(ours[:9], rolled[:9]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


def test_cr_plain_quadrotor_width_matches_pallas_interpret():
    """w=16, r=12 (the quadrotor's block shapes), N=5: 5 -> 6 -> 3 -> 4 ->
    2 -> 1, both kinds of padded level."""
    st = port(SET).replace(eps_abs=0.0, eps_rel=0.0, max_iter=10,
                           adaptive_rho=False, check_every=5)
    args, kw = chunk_case(st, seeds=(0,), N=5, w=16, r=12)
    ours = bck.banded_admm_chunk_cr_plain(*args, **kw)
    assert_chunk_close(ours, run_jax_cr(args, kw), WIDE_ATOL, WIDE_RTOL)
    f64 = bck.banded_admm_chunk_cr_plain(*to_f64(args), **kw)
    for a, b in zip(ours[:7], f64[:7]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=WIDE_ATOL / 2, rtol=WIDE_RTOL)


def test_cr_plain_converging_matches_pallas_interpret():
    # At the reference's tolerance 1e-3 (see test_torch_banded_kernel).
    st = port(SET).replace(adaptive_rho=False, max_iter=200, check_every=5,
                           eps_abs=1e-3, eps_rel=1e-3)
    args, kw = chunk_case(st, seeds=(4, 5, 6), N=6)
    ours = bck.banded_admm_chunk_cr_plain(*args, **kw)
    ref = run_jax_cr(args, kw)
    np.testing.assert_array_equal(ours[7].numpy(), np.asarray(ref[7]))
    np.testing.assert_array_equal(ours[8].numpy(), np.asarray(ref[8]))
    assert bool((ours[7] == 1).all())
    for i, (a, b) in enumerate(zip(ours[:7], ref[:7])):
        atol, rtol = (1e-3, 1e-2) if i in (1, 2, 3) else (1e-4, 1e-3)  # y: dual tolerance
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=rtol)


def test_cr_wrapper_takes_plain_version_for_cpu_tensors(monkeypatch):
    st = port(SET).replace(eps_abs=0.0, eps_rel=0.0, max_iter=10, adaptive_rho=False)
    args, kw = chunk_case(st, N=7)
    before = bck.banded_admm_chunk_cr.launches
    a = bck.banded_admm_chunk_cr(*args, **kw)
    b = bck.banded_admm_chunk_cr_plain(*args, **kw)
    assert bck.banded_admm_chunk_cr.launches == before  # no launch on the CPU
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    meta = [
        {k: v.to("meta") for k, v in x.items()} if isinstance(x, dict) else x.to("meta")
        for x in args
    ]
    with pytest.raises(ValueError, match="unsupported device"):
        bck.banded_admm_chunk_cr(*meta, **kw)
    # On the card a block wider than the kernel's 16 raises (checked on
    # meta tensors past the contract checks).
    monkeypatch.setattr(bck, "chunk_contract", lambda *a: ([], (7, 20, 3, 1, 3)))
    with pytest.raises(ValueError, match="exceeds"):
        bck.banded_admm_chunk_cr(*meta, **kw)


@pytest.mark.parametrize(
    "rolled,B", [(None, 64), (True, 8), (False, 1024)],
)
def test_chunk_kernel_takes_cr_for_cr(rolled, B):
    assert abb.chunk_kernel(100, 16, B, rolled, banded_solver="cr") == (
        bck.banded_admm_chunk_cr, {})
    assert abb.chunk_kernel(20, 5, B, rolled, banded_solver="cr") == (
        bck.banded_admm_chunk_cr, {})
    fn, _ = abb.chunk_kernel(20, 5, B, rolled)
    assert fn is (bk.banded_admm_chunk if rolled is not True else brk.banded_admm_chunk_rolled)


@pytest.mark.parametrize("adaptive", [True, False])
def test_cr_driver_matches_jax_forced_budget(adaptive):
    st = CR.replace(adaptive_rho=adaptive, eps_abs=0.0, eps_rel=0.0, max_iter=100,
                    check_infeasibility=False)
    jqp, tqp = stacked(range(4))
    ref = j_batch(jqp, st)
    bat = abb.admm_solve_banded_batch(tqp, port(st), device="cpu")
    np.testing.assert_array_equal(bat.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(bat.x.numpy(), np.asarray(ref.x), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(bat.y.numpy(), np.asarray(ref.y), atol=1e-3, rtol=1e-2)


def test_cr_driver_odd_horizon_and_warm_start_match_jax():
    # N=7 pads every level (7 -> 8 -> 4 -> 2 -> 1); r2 = 0 takes the inert
    # stage-row pad; warm starts enter scaled.  Forced budget, as in
    # test_torch_banded_rolled (ROADMAP Queue C's knife edge at eps 1e-4).
    jqp, tqp = stacked([s + 10 for s in range(3)], N=7, r2=0)
    n, m = tqp.q.shape[1], tqp.l.shape[1]
    rng = np.random.default_rng(0)
    x0 = (0.1 * rng.normal(size=(3, n))).astype(np.float32)
    y0 = (0.1 * rng.normal(size=(3, m))).astype(np.float32)
    st = CR.replace(eps_abs=0.0, eps_rel=0.0, max_iter=60, check_infeasibility=False)
    ref = j_batch(jqp, st, x0=jnp.asarray(x0), y0=jnp.asarray(y0))
    bat = abb.admm_solve_banded_batch(
        tqp, port(st), x0=torch.as_tensor(x0), y0=torch.as_tensor(y0), device="cpu",
    )
    np.testing.assert_array_equal(bat.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(bat.x.numpy(), np.asarray(ref.x), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(bat.y.numpy(), np.asarray(ref.y), atol=1e-3, rtol=1e-2)


def test_cr_driver_converges_to_thomas_solutions():
    """Converged solutions agree across the CR and Thomas chunks at the
    solver tolerance (different eliminations, same fixed point)."""
    _, tqp = stacked([s + 3 for s in range(4)])
    a = abb.admm_solve_banded_batch(tqp, port(SET), device="cpu")
    b = abb.admm_solve_banded_batch(tqp, port(CR), device="cpu")
    assert bool(b.converged.all())
    np.testing.assert_allclose(a.x.numpy(), b.x.numpy(), atol=5e-3, rtol=1e-2)
