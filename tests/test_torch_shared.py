"""The shared-factorization ADMM (``solvers/admm_batched.py``) and its chunk
(``ops/shared_kernel.py``) against the JAX package — mirrors
``tests/test_shared_fused.py``.

Kernel-level cases feed BOTH packages the same ``SharedQPFactor`` (JAX's,
through ``interop.shared_factor_from_numpy``): the two LAPACK front-ends
invert the condensed operator differently at f32 roundoff, which is a
difference of the factorization, not of the loop under test.

Tolerances.  The plain chunk sums every product as an ascending chain;
the Pallas kernel in interpret mode and the ``"xla"`` loops use the
backend's GEMM order.  Measured on these problems the iterates then agree
to ~4e-6 after 75 iterations; they are held to 2e-5 (iterates) and 1e-5
(residuals) with equal ``conv`` / ``it_inc``, and solver outputs to 1e-4.
Cases that compare convergence run at eps 1e-4, well inside f32 reach for
these well-conditioned problems, so iteration counts are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.ops.shared_kernel import shared_admm_chunk as j_chunk
from optimal_control_problem_tpu.solvers import admm_batched as jab
from optimal_control_problem_tpu.solvers.admm import ADMMSettings as JSettings
from optimal_control_problem_tpu_torch.interop import shared_factor_from_numpy
from optimal_control_problem_tpu_torch.ops import shared_kernel as sk
from optimal_control_problem_tpu_torch.solvers import admm_batched as tab
from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings
from torch_threads import one_torch_thread  # noqa: F401

BASE = dict(eps_abs=1e-4, eps_rel=1e-4, method="condensed")
KW = dict(check_every=25, sigma=1e-6, alpha=1.6, eps_abs=1e-4, eps_rel=1e-4)


def t(a):
    return torch.as_tensor(np.array(a))


def problem(B=16, n=6, m=9, seed=0):
    """The random shared QP batch of tests/test_shared_fused.py::_problem."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, n))
    P = (L @ L.T + 0.5 * np.eye(n)).astype(np.float32)
    A = rng.normal(size=(m, n)).astype(np.float32)
    qs = rng.normal(size=(B, n)).astype(np.float32)
    centers = rng.normal(size=(B, n)) @ A.T
    ls = (centers - rng.uniform(0.2, 1.5, size=(B, m))).astype(np.float32)
    us = (centers + rng.uniform(0.2, 1.5, size=(B, m))).astype(np.float32)
    return P, A, qs, ls, us


def factors(prob, **kw):
    """JAX's factor of ``prob`` and the same numbers as the port's type."""
    P, A, qs, ls, us = map(jnp.asarray, prob)
    jfac = jab.prepare_shared(P, A, ls, us, qs, JSettings(**{**BASE, **kw}))
    return jfac, shared_factor_from_numpy(jfac._asdict(), device="cpu")


def solve_both(prob, x0=None, y0=None, **kw):
    jfac, tfac = factors(prob, **kw)
    _, _, qs, ls, us = prob
    js = jab.admm_iterate_prepared(
        jfac, *map(jnp.asarray, (qs, ls, us)), JSettings(**{**BASE, **kw}),
        x0=None if x0 is None else jnp.asarray(x0), y0=None if y0 is None else jnp.asarray(y0))
    ts = tab.admm_iterate_prepared(
        tfac, t(qs), t(ls), t(us), ADMMSettings(**{**BASE, **kw}),
        x0=None if x0 is None else t(x0), y0=None if y0 is None else t(y0))
    return js, ts


def assert_solutions_close(ts, js, atol=1e-4):
    assert int(ts.iters) == int(js.iters)
    np.testing.assert_array_equal(ts.converged.numpy(), np.asarray(js.converged))
    np.testing.assert_array_equal(ts.prim_inf.numpy(), np.asarray(js.prim_inf))
    np.testing.assert_array_equal(ts.dual_inf.numpy(), np.asarray(js.dual_inf))
    for name in ("x", "y", "z"):
        np.testing.assert_allclose(
            getattr(ts, name).numpy(), np.asarray(getattr(js, name)), atol=atol, rtol=1e-4)


@pytest.mark.parametrize("method", ["condensed", "kkt"])
def test_prepare_shared_matches_jax(method):
    P, A, qs, ls, us = problem()
    # A loose and an equality row, so every rho class appears.
    ls, us = ls.copy(), us.copy()
    ls[:, 0], us[:, 0] = -np.inf, np.inf
    us[:, 1] = ls[:, 1]
    jfac = jab.prepare_shared(*map(jnp.asarray, (P, A, ls, us, qs)), JSettings(**BASE).replace(method=method))
    tfac = tab.prepare_shared(*map(t, (P, A, ls, us, qs)), ADMMSettings(**BASE).replace(method=method))
    for name in ("Pb", "Ab", "D", "E", "c", "rho_v"):
        np.testing.assert_allclose(
            getattr(tfac, name).numpy(), np.asarray(getattr(jfac, name)), rtol=1e-5, atol=1e-7)
    rho = tfac.rho_v.numpy()
    assert rho[0] == np.float32(1e-6) and rho[1] == np.float32(100.0) and rho[2] == np.float32(0.1)
    jop = np.asarray(jfac.OP)
    np.testing.assert_allclose(tfac.OP.numpy(), jop, atol=2e-3 * np.abs(jop).max())
    # q_typical=None: the cost scaling comes from P alone.
    jf0 = jab.prepare_shared(*map(jnp.asarray, (P, A, ls, us)), None, JSettings(**BASE))
    tf0 = tab.prepare_shared(*map(t, (P, A, ls, us)), None, ADMMSettings(**BASE))
    np.testing.assert_allclose(float(tf0.c), float(jf0.c), rtol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(adaptive_rho=False), dict(adaptive_rho=True), dict(method="kkt"),
    dict(fused_gemm=True), dict(adaptive_rho_interval=40),
], ids=["fixed_rho", "adaptive", "kkt", "fused_gemm", "interval40"])
def test_xla_loop_matches_jax(kw):
    js, ts = solve_both(problem(), **kw)
    assert bool(ts.converged.all())
    assert_solutions_close(ts, js)
    np.testing.assert_allclose(ts.r_prim.numpy(), np.asarray(js.r_prim), atol=1e-5)


def chunk_inputs(jfac, prob, x0=None):
    """Scaled chunk inputs as the fused drivers form them, as jnp arrays."""
    _, _, qs, ls, us = map(jnp.asarray, prob)
    Pb, Ab, D, E, c, rho, OP = jfac
    qb, lb, ub = c * qs * D[None, :], ls * E[None, :], us * E[None, :]
    B, n = qs.shape
    x = jnp.zeros((B, n)) if x0 is None else jnp.asarray(x0)
    y = jnp.zeros((B, Ab.shape[0]))
    with jax.default_matmul_precision("highest"):
        z = jnp.clip(x @ Ab.T, lb, ub)
    return [OP, Ab, Pb, rho, lb, ub, qb, 1.0 / D, 1.0 / E, 1.0 / c, x, z, y]


CHUNK_NAMES = ("x", "z", "y", "conv", "it_inc", "rp", "rd", "rp_rel", "rd_rel")


def run_chunks(done0, bound, args, tile, **kw):
    """The Pallas kernel in interpret mode and the port's plain chunk on the
    same inputs; returns both output tuples as numpy."""
    kw = {**KW, **kw}
    with jax.default_matmul_precision("highest"):
        jo = j_chunk(jnp.asarray(done0), bound, *args, batch_tile=tile, interpret=True, **kw)
    targs = [t(a) for a in args]
    to = sk.shared_admm_chunk(t(done0), bound, *targs, batch_tile=tile, **kw)
    return [np.asarray(a) for a in jo], [a.numpy() for a in to]


def assert_chunks_close(jo, to):
    for name, a, b in zip(CHUNK_NAMES, jo, to):
        if name in ("conv", "it_inc"):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            tol = 2e-5 if name in ("x", "z", "y") else 1e-5
            np.testing.assert_allclose(b, a, atol=tol, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("bound,tile,expect_it", [(60, 16, 75), (100, 8, 100), (1, 16, 25)])
def test_plain_chunk_matches_pallas_interpret_forced_budget(bound, tile, expect_it):
    """eps = 0: nobody converges, so the chunk runs whole check blocks up to
    the first multiple of check_every at or past ``bound``."""
    prob = problem()
    jfac, _ = factors(prob)
    before = sk.shared_admm_chunk.launches
    jo, to = run_chunks(np.zeros(16, bool), bound, chunk_inputs(jfac, prob), tile,
                        eps_abs=0.0, eps_rel=0.0)
    assert sk.shared_admm_chunk.launches == before  # CPU tensors: the plain version
    assert_chunks_close(jo, to)
    assert (to[4] == expect_it).all() and not to[3].any()
    assert to[4].dtype == np.int32 and to[3].dtype == bool


def test_plain_chunk_matches_pallas_interpret_converging_with_inf_bounds():
    prob = list(problem())
    prob[3], prob[4] = prob[3].copy(), prob[4].copy()
    prob[3][:, 0], prob[4][:, 0] = -np.inf, np.inf  # a loose row: rho 1e-6
    prob[3][:, 2] = -np.inf  # a one-sided row
    jfac, _ = factors(prob)
    jo, to = run_chunks(np.zeros(16, bool), 1000, chunk_inputs(jfac, prob), 16)
    assert_chunks_close(jo, to)
    assert to[3].all() and 0 < to[4][0] < 1000
    assert np.isfinite(to[0]).all() and np.isfinite(to[2]).all()


def test_plain_chunk_group_done_at_entry_returns_its_inputs():
    """Two termination groups of 8; the second enters all done: outputs =
    inputs, it_inc 0, residuals inf.  The first has one scenario done at
    entry and still iterates it (nobody freezes)."""
    prob = problem()
    jfac, _ = factors(prob)
    rng = np.random.default_rng(1)
    args = chunk_inputs(jfac, prob, x0=rng.normal(size=(16, 6)).astype(np.float32))
    done0 = np.zeros(16, bool)
    done0[8:] = True
    done0[3] = True
    jo, to = run_chunks(done0, 50, args, 8, eps_abs=0.0, eps_rel=0.0)
    assert_chunks_close(jo, to)
    assert (to[4][:8] == 50).all() and (to[4][8:] == 0).all()
    for k, i in ((0, 10), (1, 11), (2, 12)):
        np.testing.assert_array_equal(to[k][8:], np.asarray(args[i])[8:])
    assert to[3][8:].all() and not to[3][:8].any()
    assert np.isinf(to[5][8:]).all() and np.isinf(to[8][8:]).all()
    assert np.isfinite(to[5][:8]).all()
    # The whole batch as one group is not all done: everyone iterates.
    jo, to = run_chunks(done0, 50, args, 16, eps_abs=0.0, eps_rel=0.0)
    assert_chunks_close(jo, to)
    assert (to[4] == 50).all()


def test_chunk_contract_errors():
    prob = problem()
    jfac, _ = factors(prob)
    args = [t(a) for a in chunk_inputs(jfac, prob)]
    done0 = torch.zeros(16, dtype=torch.bool)
    with pytest.raises(ValueError, match="not divisible"):
        sk.shared_admm_chunk(done0, 25, *args, batch_tile=5, **KW)
    bad = list(args)
    bad[0] = bad[0].T  # OP transposed view: not row-major
    with pytest.raises(ValueError, match="contiguous"):
        sk.shared_admm_chunk(done0, 25, *bad, batch_tile=16, **KW)
    bad = list(args)
    bad[4] = bad[4][:, :-1]
    with pytest.raises(ValueError, match="lb has shape"):
        sk.shared_admm_chunk(done0, 25, *bad, batch_tile=16, **KW)
    with pytest.raises(ValueError, match="check_every"):
        sk.shared_admm_chunk(done0, 25, *args, batch_tile=16, **{**KW, "check_every": 0})


def test_wrapper_raises_for_rows_the_kernel_does_not_take(monkeypatch):
    """On the card the wrapper refuses a forced scenarios-per-block count
    the kernel has no instantiation for (checked on meta tensors past the
    contract checks, which the CPU tests hold elsewhere)."""
    prob = problem()
    jfac, _ = factors(prob)
    args = [t(a).to("meta") for a in chunk_inputs(jfac, prob)]
    done0 = torch.zeros(16, dtype=torch.int32, device="meta")
    cinv = torch.zeros(1, device="meta")
    monkeypatch.setattr(sk, "_contract", lambda *a: (16, 6, 9, 25, done0, cinv))
    with pytest.raises(ValueError, match="rows_per_block must be one of"):
        sk.shared_admm_chunk(done0, 25, *args, batch_tile=16, rows_per_block=12, **KW)


def test_chain_matmul_is_the_ascending_chain():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(5, 7)).astype(np.float32)
    w = rng.normal(size=(7, 4)).astype(np.float32)
    ref = np.zeros((5, 4), np.float32)
    for k in range(7):
        ref = ref + a[:, k : k + 1] * w[k]
    np.testing.assert_array_equal(sk.chain_matmul(t(a), t(w)).numpy(), ref)


@pytest.mark.parametrize("adaptive", [False, True])
def test_fused_matches_xla_and_jax(adaptive):
    """The port's two backends agree (equal iterations; iterates to f32
    roundoff, the chain order against torch.matmul), and each agrees with
    its JAX counterpart."""
    prob = problem()
    jx, tx = solve_both(prob, adaptive_rho=adaptive)
    jp, tp = solve_both(prob, adaptive_rho=adaptive, backend="pallas")
    assert bool(tp.converged.all()) and bool(tx.converged.all())
    assert_solutions_close(tp, jp)
    assert_solutions_close(tx, jx)
    assert int(tp.iters) == int(tx.iters)
    for name in ("x", "y", "z"):
        np.testing.assert_allclose(
            getattr(tp, name).numpy(), getattr(tx, name).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ari,ce", [(40, 25), (100, 30), (60, 7)])
def test_chunks_land_on_the_xla_adaptation_boundaries(ari, ce):
    """For non-divisible (adaptive_rho_interval, check_every) pairs the
    fused driver's chunk bounds must end where the "xla" loop adapts, or
    the rho trajectory and the iteration count drift apart.  (Seed 2 takes
    161 to 250 iterations, past several boundaries; seed 3 sits on the
    knife edge of the termination test: there even the two packages' "xla"
    loops stop 7 iterations apart at (60, 7).)"""
    kw = dict(adaptive_rho=True, adaptive_rho_interval=ari, check_every=ce)
    _, tx = solve_both(problem(seed=2), **kw)
    jp, tp = solve_both(problem(seed=2), backend="pallas", **kw)
    assert int(tp.iters) == int(tx.iters) == int(jp.iters)
    np.testing.assert_allclose(tp.x.numpy(), tx.x.numpy(), rtol=1e-5, atol=1e-5)


def test_fused_warm_start_and_multi_tile():
    prob = problem(B=24)
    kw = dict(adaptive_rho=True, backend="pallas")
    jcold, cold = solve_both(prob, **kw)
    jwarm, warm = solve_both(prob, x0=np.asarray(jcold.x), y0=np.asarray(jcold.y), **kw)
    assert_solutions_close(cold, jcold)
    assert_solutions_close(warm, jwarm)
    assert bool(warm.converged.all()) and int(warm.iters) <= int(cold.iters)
    # Three termination groups of 8, each ending on its own: the same
    # solutions, at the solver tolerance.
    _, tfac = factors(prob, **kw)
    _, _, qs, ls, us = prob
    tiled = tab._admm_iterate_fused(
        tfac, t(qs), t(ls), t(us), ADMMSettings(**{**BASE, **kw}), None, None, batch_tile=8)
    assert bool(tiled.converged.all())
    np.testing.assert_allclose(tiled.x.numpy(), cold.x.numpy(), atol=5e-3)


def test_fused_padding_non_divisible_batch():
    """B=10 with groups of 8: the driver pads 6 replicas of scenario 0 and
    returns the 10 real scenarios, as JAX's driver does."""
    prob = problem(B=10)
    kw = dict(adaptive_rho=True)
    jfac, tfac = factors(prob, **kw)
    _, _, qs, ls, us = prob
    _, tx = solve_both(prob, **kw)
    with jax.default_matmul_precision("highest"):
        jp = jab._admm_iterate_fused(
            jfac, *map(jnp.asarray, (qs, ls, us)), JSettings(**{**BASE, **kw}), None, None,
            batch_tile=8)
    tp = tab._admm_iterate_fused(
        tfac, t(qs), t(ls), t(us), ADMMSettings(**{**BASE, **kw}), None, None, batch_tile=8)
    assert tp.x.shape == (10, 6) and tp.converged.shape == (10,)
    assert bool(tp.converged.all())
    assert_solutions_close(tp, jp)
    np.testing.assert_allclose(tp.x.numpy(), tx.x.numpy(), atol=5e-3)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_infeasibility_certificates(backend):
    P, A, qs, ls, us = problem()
    B = qs.shape[0]
    # Contradictory duplicated row: a x >= 1 and a x <= -1.
    A2 = np.concatenate([A[:1], A[:1], A], axis=0)
    l2 = np.concatenate([np.full((B, 1), 1.0), np.full((B, 1), -np.inf), ls], axis=1)
    u2 = np.concatenate([np.full((B, 1), np.inf), np.full((B, 1), -1.0), us], axis=1)
    prob = (P, A2, qs, l2.astype(np.float32), u2.astype(np.float32))
    js, ts = solve_both(prob, adaptive_rho=True, backend=backend)
    assert bool(ts.prim_inf.all()) and not bool(ts.converged.any())
    assert int(ts.iters) < 10000, "certificates must end the loop"
    assert int(ts.iters) == int(js.iters)
    np.testing.assert_array_equal(ts.prim_inf.numpy(), np.asarray(js.prim_inf))
    np.testing.assert_array_equal(ts.dual_inf.numpy(), np.asarray(js.dual_inf))


def test_fused_dispatch_guards(monkeypatch):
    """The KKT method has no kernel: backend="pallas" takes the "xla" loop
    there, as in the JAX package; the condensed method takes the chunk."""
    calls = []
    real = tab.shared_admm_chunk
    monkeypatch.setattr(tab, "shared_admm_chunk", lambda *a, **k: calls.append(1) or real(*a, **k))
    js, ts = solve_both(problem(), method="kkt", backend="pallas", adaptive_rho=False)
    assert bool(ts.converged.all()) and not calls
    assert_solutions_close(ts, js)
    before = tab._admm_iterate_fused.chunks
    _, ts = solve_both(problem(), backend="pallas", adaptive_rho=False)
    assert calls and len(calls) == tab._admm_iterate_fused.chunks - before


def test_one_shot_solve_and_unported_precisions():
    P, A, qs, ls, us = problem()
    js = jab.admm_solve_shared(*map(jnp.asarray, (P, A, qs, ls, us)), JSettings(**BASE))
    ts = tab.admm_solve_shared(*map(t, (P, A, qs, ls, us)), ADMMSettings(**BASE))
    # Each package factors on its own here: solver tolerance, not roundoff.
    assert bool(ts.converged.all())
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), atol=2e-3)
    # The precision variants are ported (they raised before): each solves
    # and lands on JAX's solution at the converged tolerance of
    # tests/test_shared_fused.py (JAX's CPU computes them in f32).
    for kw in (dict(precision="high"), dict(iter_precision="high")):
        js = jab.admm_solve_shared(*map(jnp.asarray, (P, A, qs, ls, us)), JSettings(**BASE, **kw))
        ts = tab.admm_solve_shared(*map(t, (P, A, qs, ls, us)), ADMMSettings(**BASE, **kw))
        assert bool(ts.converged.all()) and bool(js.converged.all())
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=1e-3, atol=2e-3)


# ---- the termination group: JAX's pick_shared_tile -------------------------


@pytest.mark.parametrize("n,m", [(120, 196), (6, 9), (1000, 2000), (2600, 5200), (4000, 8000)])
@pytest.mark.parametrize("B", [1, 8, 64, 4096, 6538, 6539, 8192, 100_000])
def test_pick_shared_tile_matches_jax(B, n, m):
    """The port's copy of the group rule equals JAX's, ``None`` included
    (operators too large for any tile at the widest shapes)."""
    from optimal_control_problem_tpu.ops.shared_kernel import pick_shared_tile as j_pick

    assert sk.pick_shared_tile(B, n, m) == j_pick(B, n, m)


def test_pick_shared_tile_double_integrator_groups():
    """At the double integrator's n=120, m=196 the whole batch votes up to
    6,538 scenarios and tiles of 6,536 above; the widest shapes get none."""
    assert sk.pick_shared_tile(4096, 120, 196) == 4096
    assert sk.pick_shared_tile(6538, 120, 196) == 6538
    assert sk.pick_shared_tile(6539, 120, 196) == 6536
    assert sk.pick_shared_tile(8192, 120, 196) == 6536
    assert sk.pick_shared_tile(8, 4000, 8000) is None


@pytest.mark.parametrize("tile", [8, None])
def test_default_group_and_xla_fallback_match_jax(monkeypatch, tile):
    """With the group rule patched to the same tile in both packages, the
    fused drivers' default group matches JAX's (B=20 in groups of 8: padded
    to 24, three votes); where the rule returns None both take the "xla"
    loop and no chunk runs.  Converging at eps 1e-4 (far from the knife
    edge on this problem): equal iteration counts, flags and iterates."""
    from optimal_control_problem_tpu.ops import shared_kernel as jsk

    monkeypatch.setattr(jsk, "pick_shared_tile", lambda B, n, m: tile)
    monkeypatch.setattr(tab, "pick_shared_tile", lambda B, n, m: tile)
    calls = []
    real = tab.shared_admm_chunk
    monkeypatch.setattr(tab, "shared_admm_chunk",
                        lambda *a, **k: calls.append(k["batch_tile"]) or real(*a, **k))
    prob = problem(B=20)
    kw = dict(adaptive_rho=True, backend="pallas")
    with jax.default_matmul_precision("highest"):
        jp, tp = solve_both(prob, **kw)
    assert_solutions_close(tp, jp)
    assert bool(tp.converged.all())
    if tile is None:
        assert not calls
        _, tx = solve_both(prob, adaptive_rho=True)
        assert int(tp.iters) == int(tx.iters)
        assert torch.equal(tp.x, tx.x)
    else:
        assert calls and set(calls) == {tile}


# ---- the CUDA kernel's block shape (a host-side rule) ----------------------


# (B, tile, n, m, SMs, rows): of the shapes whose panels fit, the fewest
# scenario rows on the busiest SM, ceil(blocks / SMs) * rows, then the most
# rows.  The panels of 8, 16 and 32 scenarios fit at every n, m below but
# n=600, m=1200, where only 8 do.
_ROWS_AT = {(8, 132): 8,  # one block of 8
            (64, 132): 8,  # 8 blocks of 8, where 32 would leave 130 SMs idle
            (4096, 132): 32,  # 128 blocks of 32: one a SM
            (6144, 132): 16,  # 384 blocks of 16: 3 a SM (48 rows) against 2 of 32 (64)
            (200, 7): 32}  # 7 blocks of 32, 13 of 16, 25 of 8: 32 rows on each SM, a tie
BLOCK_ROWS_CASES = [
    (4096, 4096, 120, 196, 132, 32),
    (64, 64, 120, 196, 132, 8),
    (6144, 6144, 120, 196, 132, 16),
    (13072, 6536, 120, 196, 132, 8),
    (1, 1, 120, 196, 132, 8),
] + [(B, B, n, m, sms, rows) for n, m in [(120, 196), (6, 9), (40, 36), (232, 12)]
     for (B, sms), rows in _ROWS_AT.items()] + [
    (B, B, 600, 1200, sms, 8) for B, sms in _ROWS_AT]


@pytest.mark.parametrize("B,tile,n,m,sms,rows", BLOCK_ROWS_CASES)
def test_block_rows_rule(B, tile, n, m, sms, rows):
    assert sk.shared_block_rows(B, tile, n, m, sms) == rows


def test_block_rows_refuses_panels_beyond_shared_memory():
    with pytest.raises(ValueError, match="exceed"):
        sk.shared_block_rows(64, 64, 3000, 3000, 132)
