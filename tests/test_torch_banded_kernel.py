"""Port's banded chunk (plain PyTorch version) and batch driver against the
JAX package: the Pallas kernel in interpret mode and the JAX batch driver
(which selects interpret mode off-TPU).

The chunk inputs come from the port's own driver prepare on a
``random_stage_qp`` batch and go to both kernels unchanged.  Under a forced
budget (eps = 0) both run the same iterations: ``done``/``it_inc`` equal,
iterates to ATOL / RTOL.  That is f32 roundoff as the operator's
conditioning amplifies it: the equality rows carry rho x 1e3, and after a
single iteration each f32 version already sits ~5e-5 from a float64 run of
the same chunk, so two independent f32 programs cannot meet 1e-5 / 1e-4.
The driver is held to the forced-budget tolerances of
``tests/test_banded_batch.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.ops.banded_kernel import banded_admm_chunk as j_chunk
from optimal_control_problem_tpu.solvers.admm import ADMMSettings as JSettings
from optimal_control_problem_tpu.solvers.admm_banded_batch import (
    admm_solve_banded_batch as j_batch,
)
from optimal_control_problem_tpu_torch.interop import (
    banded_qp_from_numpy,
    settings_from_jax_dict,
)
from optimal_control_problem_tpu_torch.ops import banded_kernel as bk
from optimal_control_problem_tpu_torch.solvers import admm_banded_batch as abb
from optimal_control_problem_tpu_torch.solvers.admm_banded import BandedQP
from tests.test_admm_banded import random_stage_qp
from torch_threads import one_torch_thread  # noqa: F401

ATOL, RTOL = 1e-4, 1e-3
SET = JSettings(eps_abs=1e-4, eps_rel=1e-4, method="banded", scaling_iters=10,
                adaptive_rho=True)


def stacked(seeds, **kw):
    """(JAX batch-leading BandedQP, port batch-leading BandedQP)."""
    qps = [random_stage_qp(s, **kw) for s in seeds]
    jqp = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *qps)
    return jqp, banded_qp_from_numpy(jqp._asdict(), device="cpu")


def port(st):
    return settings_from_jax_dict(dataclasses.asdict(st))


def chunk_case(st, seeds=(0, 1, 2), it0=None, done0=None, **qp_kw):
    """Chunk inputs from the port's driver prepare, with a warm start;
    ``qp_kw`` sizes the ``random_stage_qp`` batch."""
    _, tqp = stacked(seeds, **qp_kw)
    qpT = BandedQP(*(abb._t(a) for a in tqp))
    rng = np.random.default_rng(1)
    n, B = qpT.q.shape
    m = qpT.l.shape[0]
    x0 = torch.as_tensor(0.1 * rng.normal(size=(n, B)), dtype=torch.float32)
    y0 = torch.as_tensor(0.1 * rng.normal(size=(m, B)), dtype=torch.float32)
    prob = abb.prepare_banded_batch_T(qpT, st, x0, y0)
    it0 = torch.zeros(B, dtype=torch.int32) if it0 is None else torch.tensor(it0, dtype=torch.int32)
    done0 = torch.zeros(B, dtype=torch.int32) if done0 is None else torch.tensor(done0, dtype=torch.int32)
    return abb.chunk_inputs(prob, st, it0, done0, prob.x, prob.y, prob.z, prob.rho)


def run_jax_chunk(args, kw, chunk=j_chunk):
    """A JAX chunk kernel in interpret mode with the whole batch as one tile
    (for the rolled kernel: its depth-1 CR level is on exactly when N is
    even and >= 16)."""
    to_j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    jargs = [
        {k: to_j(v) for k, v in a.items()} if isinstance(a, dict) else to_j(a)
        for a in args
    ]
    B = args[6].shape[-1]
    return chunk(*jargs, **kw, batch_tile=B, interpret=True)


def assert_chunk_close(ours, ref, atol=ATOL, rtol=RTOL):
    """A forced-budget chunk against the JAX kernel's: equal ``done`` and
    ``it_inc``, iterates to atol/rtol, max_prim/max_dual to rtol; the
    residuals rp/rd are differences of nearly equal terms, so they agree
    to rtol of the scale they measure."""
    np.testing.assert_array_equal(ours[7].numpy(), np.asarray(ref[7]))  # done
    np.testing.assert_array_equal(ours[8].numpy(), np.asarray(ref[8]))  # it_inc
    for a, b in zip(ours[:7], ref[:7]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=rtol)
    for a, b in zip(ours[11:], ref[11:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol)
    for a, b, scale in zip(ours[9:11], ref[9:11], ours[11:]):
        fin = np.isfinite(scale.numpy())
        np.testing.assert_array_equal(np.isinf(a.numpy()), np.isinf(np.asarray(b)))
        np.testing.assert_allclose(
            a.numpy()[fin], np.asarray(b)[fin], atol=rtol * float(scale[fin].max()), rtol=0
        )


@pytest.mark.parametrize(
    "it0,done0,interval,max_iter",
    [
        (None, None, 60, 60),  # one chunk of 60 iterations
        ([0, 40, 0], [0, 0, 1], 30, 60),  # it0 near max_iter, a frozen scenario
    ],
)
def test_chunk_plain_matches_pallas_interpret(it0, done0, interval, max_iter):
    st = port(SET).replace(eps_abs=0.0, eps_rel=0.0, max_iter=max_iter,
                           adaptive_rho=False, check_every=5)
    args, kw = chunk_case(st, it0=it0, done0=done0)
    kw["interval"] = interval
    ours = bk.banded_admm_chunk_plain(*args, **kw)
    assert_chunk_close(ours, run_jax_chunk(args, kw))
    if done0 is not None:
        assert int(ours[8][2]) == 0 and np.isinf(ours[9][2].item())


@pytest.mark.parametrize("seeds", [(4, 5, 6), (0, 1, 2)])
def test_chunk_converging_matches_pallas_interpret(seeds):
    # At the reference's tolerance (1e-3): at 1e-4 a scenario can sit at
    # the f32 residual floor within an ulp of eps, where the two f32
    # programs legitimately disagree on which check block converges.
    st = port(SET).replace(adaptive_rho=False, max_iter=200, check_every=5,
                           eps_abs=1e-3, eps_rel=1e-3)
    args, kw = chunk_case(st, seeds=seeds)
    ours = bk.banded_admm_chunk_plain(*args, **kw)
    ref = run_jax_chunk(args, kw)
    np.testing.assert_array_equal(ours[7].numpy(), np.asarray(ref[7]))
    np.testing.assert_array_equal(ours[8].numpy(), np.asarray(ref[8]))
    assert bool((ours[7] == 1).all())
    for i, (a, b) in enumerate(zip(ours[:7], ref[:7])):
        atol, rtol = (1e-3, 1e-2) if i in (1, 2, 3) else (ATOL, RTOL)  # y: dual tolerance
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=rtol)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    st = port(SET).replace(eps_abs=0.0, eps_rel=0.0, max_iter=20, adaptive_rho=False)
    args, kw = chunk_case(st)
    before = bk.banded_admm_chunk.launches
    a = bk.banded_admm_chunk(*args, **kw)
    b = bk.banded_admm_chunk_plain(*args, **kw)
    assert bk.banded_admm_chunk.launches == before  # no kernel launch on the CPU
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    meta = [
        {k: v.to("meta") for k, v in x.items()} if isinstance(x, dict) else x.to("meta")
        for x in args
    ]
    with pytest.raises(ValueError, match="unsupported device"):
        bk.banded_admm_chunk(*meta, **kw)


@pytest.mark.parametrize("adaptive", [True, False])
def test_driver_matches_jax_forced_budget(adaptive):
    st = SET.replace(adaptive_rho=adaptive, eps_abs=0.0, eps_rel=0.0, max_iter=100,
                     check_infeasibility=False)
    jqp, tqp = stacked(range(4))
    ref = j_batch(jqp, st)
    bat = abb.admm_solve_banded_batch(tqp, port(st), device="cpu")
    np.testing.assert_array_equal(bat.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(bat.x.numpy(), np.asarray(ref.x), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(bat.y.numpy(), np.asarray(ref.y), atol=1e-3, rtol=1e-2)


def test_driver_padding_and_warm_start_match_jax():
    # r2 = 0 exercises the inert-row padding; warm starts enter scaled.
    jqp, tqp = stacked([s + 10 for s in range(3)], r2=0)
    n, m = tqp.q.shape[1], tqp.l.shape[1]
    rng = np.random.default_rng(0)
    x0 = (0.1 * rng.normal(size=(3, n))).astype(np.float32)
    y0 = (0.1 * rng.normal(size=(3, m))).astype(np.float32)
    st = SET.replace(eps_abs=0.0, eps_rel=0.0, max_iter=60, check_infeasibility=False)
    ref = j_batch(jqp, st, x0=jnp.asarray(x0), y0=jnp.asarray(y0))
    bat = abb.admm_solve_banded_batch(
        tqp, port(st), x0=torch.as_tensor(x0), y0=torch.as_tensor(y0), device="cpu"
    )
    assert bat.y.shape == tuple(ref.y.shape)
    np.testing.assert_array_equal(bat.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(bat.x.numpy(), np.asarray(ref.x), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(bat.y.numpy(), np.asarray(ref.y), atol=1e-3, rtol=1e-2)


def test_driver_max_iter_freeze_and_certificates():
    st = SET.replace(eps_abs=1e-12, eps_rel=1e-12, max_iter=100, check_infeasibility=False)
    jqp, tqp = stacked(range(2))
    bat = abb.admm_solve_banded_batch(tqp, port(st), device="cpu")
    assert np.all(bat.iters.numpy() == 100)
    assert not bat.converged.any()
    # converged solutions with certificates on agree at the solver tolerance
    bat2 = abb.admm_solve_banded_batch(tqp, port(SET), device="cpu")
    ref2 = j_batch(jqp, SET)
    assert bool(bat2.converged.all()) and not bool(bat2.prim_inf.any())
    np.testing.assert_allclose(bat2.x.numpy(), np.asarray(ref2.x), atol=5e-3, rtol=1e-2)


def test_precomputed_scalings_and_polish():
    jqp, tqp = stacked(range(3), r2=0)
    st = port(SET)
    ref = abb.admm_solve_banded_batch(tqp, st, device="cpu")
    sc = abb.ruiz_scalings_batch(tqp, st.scaling_iters)
    pre = abb.admm_solve_banded_batch(tqp, st, scalings=sc, device="cpu")
    np.testing.assert_array_equal(ref.iters.numpy(), pre.iters.numpy())
    np.testing.assert_allclose(ref.x.numpy(), pre.x.numpy(), atol=1e-6, rtol=1e-5)
    pol = abb.admm_solve_banded_batch(tqp, st.replace(polish=True), device="cpu")
    assert np.all(pol.r_prim.numpy() <= ref.r_prim.numpy() + 1e-7)
    assert np.all(pol.r_dual.numpy() <= ref.r_dual.numpy() + 1e-7)
