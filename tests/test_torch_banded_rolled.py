"""Port's rolled two-way chunk (plain PyTorch version), the driver's choice
between the two chunk kernels, and the driver on the rolled chunk, against
the JAX package: its rolled Pallas kernel in interpret mode and its batch
driver with ``rolled=True``.

Chunk inputs come from the port's own driver prepare on ``random_stage_qp``
batches and go to both kernels unchanged.  Under a forced budget (eps = 0)
both run the same iterations: ``done``/``it_inc`` equal, iterates to
ATOL / RTOL (the f32 floor recorded in ROADMAP Queue C: the equality rows'
rho x 1e3 makes M ill-conditioned, and the JAX kernel's ``jnp.sum``
reductions need not run in the ascending order the port keeps).  The
driver is held to ``tests/test_banded_batch.py``'s rolled-kernel
tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.ops.banded_rolled_kernel import (
    banded_admm_chunk_rolled as j_rolled,
)
from optimal_control_problem_tpu.solvers.admm_banded_batch import (
    admm_solve_banded_batch as j_batch,
)
from optimal_control_problem_tpu_torch.ops import banded_kernel as bk
from optimal_control_problem_tpu_torch.ops import banded_rolled_kernel as brk
from optimal_control_problem_tpu_torch.solvers import admm_banded_batch as abb
from tests.test_torch_banded_kernel import (
    ATOL,
    RTOL,
    SET,
    assert_chunk_close,
    chunk_case,
    port,
    run_jax_chunk,
    stacked,
)
from torch_threads import one_torch_thread  # noqa: F401

# At the quadrotor's width (w=16, r=12) random stage QPs are worse
# conditioned still: each f32 program (the port's plain chunk, one-way or
# two-way, and JAX's kernel) sits ~1e-3 from a float64 run of the same
# chunk after one iteration, so they are held to each other at WIDE and
# the port is also held to its own float64 run.
WIDE_ATOL, WIDE_RTOL = 4e-3, 1e-2


def run_jax_rolled(args, kw):
    return run_jax_chunk(args, kw, j_rolled)


def cr1_of(N):
    return N % 2 == 0 and N >= 16


def to_f64(args):
    return [
        {k: v.double() for k, v in a.items()} if isinstance(a, dict)
        else (a.double() if a.is_floating_point() else a)
        for a in args
    ]


@pytest.mark.parametrize(
    "N,w,r,it0,done0,interval,max_iter",
    [
        (6, 4, 3, None, None, 40, 40),  # two-way only
        (16, 4, 3, None, None, 40, 40),  # depth-1 CR level on
        (17, 4, 3, None, None, 40, 40),  # odd horizon: plain two-way
        (16, 4, 3, [0, 20, 0], [0, 0, 1], 30, 40),  # it0 near max_iter, one frozen
        (4, 16, 12, None, None, 10, 10),  # quadrotor width, two-way
    ],
)
def test_rolled_plain_matches_pallas_interpret(N, w, r, it0, done0, interval, max_iter):
    st = port(SET).replace(eps_abs=0.0, eps_rel=0.0, max_iter=max_iter,
                           adaptive_rho=False, check_every=5)
    args, kw = chunk_case(st, it0=it0, done0=done0, N=N, w=w, r=r)
    kw["interval"] = interval
    ours = brk.banded_admm_chunk_rolled_plain(*args, **kw, cr1=cr1_of(N))
    ref = run_jax_rolled(args, kw)
    if w == 16:
        assert_chunk_close(ours, ref, WIDE_ATOL, WIDE_RTOL)
        f64 = brk.banded_admm_chunk_rolled_plain(*to_f64(args), **kw, cr1=cr1_of(N))
        for a, b in zip(ours[:7], f64[:7]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=WIDE_ATOL / 2, rtol=WIDE_RTOL)
    else:
        assert_chunk_close(ours, ref)
    if done0 is not None:
        assert int(ours[8][2]) == 0 and np.isinf(ours[9][2].item())
        assert int(ours[8][1]) == 20  # froze at max_iter mid-chunk


def test_rolled_plain_quadrotor_width_cr1():
    """w=16, r=12 with the CR level (N=16): the quadrotor's block shapes."""
    st = port(SET).replace(eps_abs=0.0, eps_rel=0.0, max_iter=10,
                           adaptive_rho=False, check_every=5)
    args, kw = chunk_case(st, seeds=(0,), N=16, w=16, r=12)
    ours = brk.banded_admm_chunk_rolled_plain(*args, **kw, cr1=True)
    assert_chunk_close(ours, run_jax_rolled(args, kw), WIDE_ATOL, WIDE_RTOL)
    f64 = brk.banded_admm_chunk_rolled_plain(*to_f64(args), **kw, cr1=True)
    for a, b in zip(ours[:7], f64[:7]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=WIDE_ATOL / 2, rtol=WIDE_RTOL)


@pytest.mark.parametrize("N", [6, 16])
def test_rolled_plain_converging_matches_pallas_interpret(N):
    # At the reference's tolerance 1e-3 (see test_torch_banded_kernel).
    st = port(SET).replace(adaptive_rho=False, max_iter=200, check_every=5,
                           eps_abs=1e-3, eps_rel=1e-3)
    args, kw = chunk_case(st, seeds=(4, 5, 6), N=N)
    ours = brk.banded_admm_chunk_rolled_plain(*args, **kw, cr1=cr1_of(N))
    ref = run_jax_rolled(args, kw)
    np.testing.assert_array_equal(ours[7].numpy(), np.asarray(ref[7]))
    np.testing.assert_array_equal(ours[8].numpy(), np.asarray(ref[8]))
    assert bool((ours[7] == 1).all())
    for i, (a, b) in enumerate(zip(ours[:7], ref[:7])):
        atol, rtol = (1e-3, 1e-2) if i in (1, 2, 3) else (ATOL, RTOL)  # y: dual tolerance
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=rtol)


def test_cr1_level_is_exact():
    """The depth-1 CR level is an exact elimination: with and without it
    the plain chunk agrees to f32 roundoff under a forced budget."""
    st = port(SET).replace(eps_abs=0.0, eps_rel=0.0, max_iter=30,
                           adaptive_rho=False, check_every=5)
    args, kw = chunk_case(st, N=16)
    a = brk.banded_admm_chunk_rolled_plain(*args, **kw, cr1=True)
    b = brk.banded_admm_chunk_rolled_plain(*args, **kw, cr1=False)
    c = bk.banded_admm_chunk_plain(*args, **kw)
    for u, v, t in zip(a[:7], b[:7], c[:7]):
        torch.testing.assert_close(u, v, atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(u, t, atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="even horizon"):
        args17, kw17 = chunk_case(st, N=17)
        brk.banded_admm_chunk_rolled(*args17, **kw17, cr1=True)


def test_rolled_wrapper_takes_plain_version_for_cpu_tensors():
    st = port(SET).replace(eps_abs=0.0, eps_rel=0.0, max_iter=10, adaptive_rho=False)
    args, kw = chunk_case(st, N=8)
    before = brk.banded_admm_chunk_rolled.launches
    a = brk.banded_admm_chunk_rolled(*args, **kw, cr1=False)
    b = brk.banded_admm_chunk_rolled_plain(*args, **kw, cr1=False)
    assert brk.banded_admm_chunk_rolled.launches == before  # no launch on the CPU
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    meta = [
        {k: v.to("meta") for k, v in x.items()} if isinstance(x, dict) else x.to("meta")
        for x in args
    ]
    with pytest.raises(ValueError, match="unsupported device"):
        brk.banded_admm_chunk_rolled(*meta, **kw, cr1=False)


# ---- the driver's choice of kernel -------------------------------------


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


# ---- the port's driver on the rolled chunk against JAX's (rolled=True) --


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
