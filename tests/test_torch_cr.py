"""The port's cyclic-reduction path (``banded_solver="cr"``) against the JAX
package on the same numpy inputs:

* ``ops/block_tridiag.cr_factor``/``cr_solve`` against a dense float64
  solve (the tolerances of ``tests/test_block_tridiag.py``) and against
  JAX's ``cr_solve`` on JAX's own factor, carried over with
  ``interop.cr_factor_from_numpy`` (f32 roundoff: rtol 1e-5);
* the per-scenario ``admm_solve_banded`` with ``"cr"`` against JAX's and
  against the port's ``"thomas"`` (``tests/test_admm_banded.py``'s equal
  iterations and 1e-4);
* the plain CR chunk against JAX's ``banded_admm_chunk_cr`` in interpret
  mode on the port's prepared inputs, under forced budgets: equal
  ``done``/``it_inc``, iterates at ``test_torch_banded_kernel``'s
  ATOL / RTOL (at w=16 at ``test_torch_banded_rolled``'s wide-block
  tolerances, and to the port's own float64 run: the f32 floor of ROADMAP
  Queue C);
* the batch driver with ``"cr"`` against JAX's driver
  (``tests/test_banded_batch.py``'s CR tolerances), the driver's kernel
  rule and the wrapper's device rules.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.ops import banded_cr_kernel as jcrk
from optimal_control_problem_tpu.ops import block_tridiag as jbt
from optimal_control_problem_tpu.solvers.admm_banded import admm_solve_banded as j_solve
from optimal_control_problem_tpu.solvers.admm_banded_batch import (
    admm_solve_banded_batch as j_batch,
)
from optimal_control_problem_tpu_torch.interop import (
    banded_qp_from_numpy,
    cr_factor_from_numpy,
)
from optimal_control_problem_tpu_torch.ops import banded_cr_kernel as bck
from optimal_control_problem_tpu_torch.ops import banded_kernel as bk
from optimal_control_problem_tpu_torch.ops import banded_rolled_kernel as brk
from optimal_control_problem_tpu_torch.ops import block_tridiag as tbt
from optimal_control_problem_tpu_torch.solvers import admm_banded_batch as abb
from optimal_control_problem_tpu_torch.solvers.admm_banded import admm_solve_banded
from tests.test_admm_banded import random_stage_qp
from tests.test_block_tridiag import random_btd
from tests.test_torch_banded_kernel import (
    SET,
    assert_chunk_close,
    chunk_case,
    port,
    run_jax_chunk,
    stacked,
)
from tests.test_torch_banded_rolled import WIDE_ATOL, WIDE_RTOL, to_f64
from torch_threads import one_torch_thread  # noqa: F401

CR = SET.replace(banded_solver="cr")

# ---- ops/block_tridiag: cr_factor / cr_solve ----------------------------


@pytest.mark.parametrize("N,w", [(8, 4), (10, 3), (33, 5), (50, 8)])
def test_cr_solve_matches_dense_and_jax(N, w):
    diag, lower, M = random_btd(7, N, w)
    b = np.random.default_rng(11).normal(size=(N, w)).astype(np.float32)
    fac = tbt.cr_factor(torch.as_tensor(diag), torch.as_tensor(lower))
    assert fac.n_orig == N and len(fac.levels) == (N - 1).bit_length()
    x = tbt.cr_solve(fac, torch.as_tensor(b)).numpy()
    x_dense = np.linalg.solve(M.astype(np.float64), b.reshape(-1).astype(np.float64))
    np.testing.assert_allclose(x.reshape(-1), x_dense, rtol=3e-3, atol=3e-4)
    # JAX's solve on JAX's factor, and the port's solve on the same factor.
    jfac = jbt.cr_factor(jnp.asarray(diag), jnp.asarray(lower))
    jx = np.asarray(jbt.cr_solve(jfac, jnp.asarray(b)))
    x_on_jax = tbt.cr_solve(cr_factor_from_numpy(jfac, device="cpu"), torch.as_tensor(b))
    np.testing.assert_allclose(x_on_jax.numpy(), jx, rtol=1e-5, atol=1e-6)
    # The two packages' factors agree to f32 roundoff.
    for lv, jlv in zip(fac.levels, jfac.levels):
        for a, ja in zip(lv, jlv):
            np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-5)


def test_pad_pow2_pads_with_identity():
    diag, lower, _ = random_btd(3, 5, 2)
    d, lo = tbt._pad_pow2(torch.as_tensor(diag), torch.as_tensor(lower))
    assert d.shape == (8, 2, 2) and lo.shape == (7, 2, 2)
    assert torch.equal(d[5:], torch.eye(2).expand(3, 2, 2)) and not lo[4:].any()
    same = tbt._pad_pow2(torch.as_tensor(diag[:4]), torch.as_tensor(lower[:3]))
    assert same[0].shape == (4, 2, 2)


# ---- solvers/admm_banded: the per-scenario "cr" branch -------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_per_scenario_cr_matches_jax_and_thomas(seed):
    jqp = random_stage_qp(seed)
    tqp = banded_qp_from_numpy(jqp._asdict(), device="cpu")
    ref = j_solve(jqp, CR)
    cr = admm_solve_banded(tqp, port(CR))
    thomas = admm_solve_banded(tqp, port(SET))
    assert bool(cr.converged) and bool(ref.converged)
    assert int(cr.iters) == int(thomas.iters) == int(ref.iters)
    np.testing.assert_allclose(cr.x.numpy(), thomas.x.numpy(), atol=1e-4)
    np.testing.assert_allclose(cr.x.numpy(), np.asarray(ref.x), atol=1e-4)


def test_per_scenario_cr_polish_and_unknown_solver():
    jqp = random_stage_qp(2, N=7)
    tqp = banded_qp_from_numpy(jqp._asdict(), device="cpu")
    st = CR.replace(polish=True)
    ref = j_solve(jqp, st)
    ours = admm_solve_banded(tqp, port(st))
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x), atol=1e-4)
    bad = port(SET)
    object.__setattr__(bad, "banded_solver", "lu")
    with pytest.raises(ValueError, match="unknown banded_solver"):
        admm_solve_banded(tqp, bad)


# ---- ops/banded_cr_kernel: the plain chunk against JAX's Pallas kernel ---


@pytest.mark.parametrize("N", [2, 5, 7, 13, 25, 100])
def test_cr_level_plan_is_jax_plan(N):
    assert bck.cr_level_plan(N) == jcrk.cr_level_plan(N)


def run_jax_cr(args, kw):
    return run_jax_chunk(args, kw, jcrk.banded_admm_chunk_cr)


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


def test_cr_scratch_layout():
    # N=100, w=16, r=12, r2=1: operators 100 + 2 x 99 x 12 / 16 + 100 / 16
    # blocks, rows and state, 2 x 101 + 2 x 52 working blocks, 2 x (102 + 1)
    # inverses and transposes, 2 x 204 couplings and transposes, 3 x 50
    # products, 3 x 101 + 102 vectors.
    ov = 6 * 100 * 16 + 4 * 99 * 12 + 4 * 100
    st = 3 * 100 * 16 + 2 * 99 * 12 + 2 * 100
    assert bck.cr_slab_floats(100, 16, 12, 1) == (
        (100 + 2 * 101 + 2 * 52 + 2 * 103 + 2 * 204 + 150) * 256 + 2 * 99 * 12 * 16 + 100 * 16
        + ov + st + (3 * 101 + 102) * 16)
    # Every region is rounded up to 16 bytes: at N=50, w=3, r=2, r2=1, J0
    # and J1 hold 294 floats each, padded to 296.
    assert bck.cr_slab_floats(50, 3, 2, 1) % 4 == 0


# ---- the driver ------------------------------------------------------------


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


def test_settings_carry_banded_solver_to_the_driver(monkeypatch):
    """``banded_solver`` reaches the chunk rule through ``ADMMSettings``."""
    seen = []
    real = abb.chunk_kernel

    def spy(*args, **kwargs):
        seen.append(kwargs.get("banded_solver"))
        return real(*args, **kwargs)

    monkeypatch.setattr(abb, "chunk_kernel", spy)
    _, tqp = stacked(range(2), N=4)
    abb.admm_solve_banded_batch(tqp, port(CR.replace(max_iter=4)), device="cpu")
    assert seen == ["cr"]
