"""The dense device loop (``ops/admm_kernel.py``) and the batched dense
solver (``solvers/admm.py::admm_solve_batch``) against the JAX package —
mirrors ``tests/test_pallas_admm.py``.

Kernel-level cases feed both packages the same prepared quantities (JAX's
``jax.vmap`` of ``ruiz_equilibrate``, ``_rho_vec`` and ``_factor``, carried
over by ``interop.dense_prep_from_numpy``): the two LAPACK front-ends invert
the condensed operator differently at f32 roundoff, which is a difference
of the factorization, not of the loop under test.

Tolerances.  The plain device loop sums every product as an ascending
chain; JAX's kernel in interpret mode uses the backend's dot order.
Iterates are held to 2e-5 absolute / 1e-4 relative after up to 1000
iterations (measured: up to 4e-6), with equal iteration counts.  Solver-level
cases let each package factor its own operator: iterates to 2e-3 as in
``tests/test_torch_admm.py``, flags equal, counts equal where the run is
far from the knife edge of the termination test.

Split over this file and ``test_torch_admm_kernel_pallas.py`` (``backend="pallas"``
against ``"xla"`` and the size guard), so that two test workers carry
them; their helpers are in ``torch_admm_kernel_cases.py``.
"""

import numpy as np
import pytest
import torch

from optimal_control_problem_tpu_torch.interop import dense_prep_from_numpy
from optimal_control_problem_tpu_torch.ops import admm_kernel as ak
from optimal_control_problem_tpu_torch.solvers import admm as tadmm
from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings
from torch_admm_kernel_cases import (
    BASE,
    assert_flags_equal,
    assert_loops_close,
    inf_eq_qp,
    infeasible,
    jax_prep,
    random_qp,
    run_loops,
    solve_both,
    stack,
    t,
    warm,
)
from torch_threads import one_torch_thread  # noqa: F401


def test_plain_loop_matches_pallas_interpret_forced_budget():
    """eps = 0: nobody converges; whole check blocks up to the first
    multiple of check_every at or past max_iter (60 -> 75)."""
    prep = jax_prep(*stack([random_qp(s) for s in range(3)]))
    jo, to = run_loops(prep, *warm(prep, 0), max_iter=60, eps=(0.0, 0.0))
    assert_loops_close(jo, to)
    assert to[3].tolist() == [75, 75, 75] and to[3].dtype == np.int32
    # max_iter 0: no iteration, z recomputed from the warm start.
    jo, to = run_loops(prep, *warm(prep, 1), max_iter=0, eps=(0.0, 0.0))
    assert_loops_close(jo, to)
    assert to[3].tolist() == [0, 0, 0]


def test_plain_loop_matches_pallas_interpret_converging_with_different_counts():
    """Four scenarios in one vmapped call stop at their own counts; the
    stopped ones keep their iterates while the others run on."""
    prep = jax_prep(*stack([random_qp(s) for s in (0, 1, 2, 5)]))
    B, n = prep["qb"].shape
    jo, to = run_loops(prep, np.zeros((B, n), np.float32),
                       np.zeros((B, prep["lb"].shape[1]), np.float32), max_iter=1000)
    assert_loops_close(jo, to)
    assert len(set(to[3].tolist())) > 1 and (to[3] < 1000).all()
    assert np.isfinite(to[0]).all()


def test_plain_loop_matches_pallas_interpret_inf_bounds_and_equalities():
    """A loose row (rho 1e-6, +-inf bounds) and equality rows (rho 100).
    This QP is ill-conditioned enough that each f32 program sits ~1e-3
    from a float64 run of the same loop in y after 25 iterations (ROADMAP
    Queue C): under a forced budget the counts are equal and x agrees to
    1e-4, y to 2e-3.  At eps 1e-4 the stop is f32 noise (JAX's kernel 25,
    the plain loop 175, JAX's own "xla" backend never), so there both are
    held to converge and to agree on x."""
    prep = jax_prep(*stack([inf_eq_qp()]))
    assert prep["rho_v"][0].tolist() == pytest.approx([100.0, 1e-6, 0.1, 100.0])
    x0, y0 = np.zeros((1, 3), np.float32), np.zeros((1, 4), np.float32)
    jo, to = run_loops(prep, x0, y0, max_iter=50, eps=(0.0, 0.0))
    assert to[3].tolist() == jo[3].tolist() == [50]
    np.testing.assert_allclose(to[0], jo[0], atol=1e-4)
    np.testing.assert_allclose(to[1], jo[1], atol=2e-3)
    jo, to = run_loops(prep, x0, y0, max_iter=1000)
    assert 0 < to[3][0] < 1000 and 0 < jo[3][0] < 1000
    np.testing.assert_allclose(to[0], jo[0], atol=1e-4)
    assert np.isfinite(to[2]).all()


def test_chain_bmm_is_the_ascending_chain():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(3, 7)).astype(np.float32)
    w = rng.normal(size=(3, 7, 4)).astype(np.float32)
    ref = np.zeros((3, 4), np.float32)
    for k in range(7):
        ref = ref + a[:, k : k + 1] * w[:, k]
    np.testing.assert_array_equal(ak.chain_bmm(t(a), t(w)).numpy(), ref)


def test_device_loop_contract_and_shared_memory_guard(monkeypatch):
    prep = dense_prep_from_numpy(jax_prep(*stack([random_qp(0)] * 2)), device="cpu")
    args = [prep.OP, prep.Ab, prep.Pb, prep.qb, prep.lb, prep.ub, prep.rho_v,
            1.0 / prep.D, 1.0 / prep.E, 1.0 / prep.c]
    tail = (1e-6, 1.6, 1e-3, 1e-3, torch.zeros(2, 8), torch.zeros(2, 12))
    bad = list(args)
    bad[0] = bad[0].transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ak.admm_device_loop(*bad, *tail)
    bad = list(args)
    bad[9] = bad[9][:1]
    with pytest.raises(ValueError, match="cinv has shape"):
        ak.admm_device_loop(*bad, *tail)
    with pytest.raises(ValueError, match="check_every"):
        ak.admm_device_loop(*args, *tail, check_every=0)
    # CPU tensors take the plain version and never ask the CUDA library
    # (its layout queries, the tier rule) for anything.
    def no_library(name):
        raise AssertionError(f"the CPU path loaded {name}")

    monkeypatch.setattr(ak, "load_library", no_library)
    out = ak.admm_device_loop(*args, *tail, max_iter=50)
    ref = ak.admm_device_loop_plain(*args, *tail, max_iter=50)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    # The kernel's tiers (held against its C entry point in
    # tests/test_torch_kernel_emulation.py) take the cart-pole h20 QP
    # (n=100, m=196), n=120, m=236 and n=200, m=392 alike, so the only size
    # refused is the JAX package's own guard's.
    for n, m in ((100, 196), (120, 236), (200, 392)):
        tadmm.check_pallas_size(n, m)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("adaptive", [False, True])
def test_admm_solve_batch_matches_vmapped_jax(backend, adaptive):
    """Adaptive rho from a badly scaled start (rho 1e-4, interval 50, as
    tests/test_pallas_admm.py:87) and off; one primal-infeasible scenario
    in the batch is certified alone; each scenario equals the port's own
    single-problem solve."""
    kw = dict(backend=backend, adaptive_rho=adaptive, adaptive_rho_interval=50,
              rho=1e-4 if adaptive else 0.1, max_iter=2000)
    qps = [random_qp(0), random_qp(1), infeasible(2), random_qp(3)]
    js, ts = solve_both(qps, **kw)
    assert_flags_equal(ts, js)
    np.testing.assert_array_equal(ts.iters.numpy(), np.asarray(js.iters))
    assert ts.converged.tolist() == [True, True, False, True]
    assert ts.iters.dtype == torch.int32
    if backend == "pallas" and not adaptive:
        # One kernel entry runs the whole budget; the certificate test on
        # that entry's delta does not fire (the reference does the same).
        assert not bool(ts.prim_inf.any()) and int(ts.iters[2]) == 2000
    else:
        assert ts.prim_inf.tolist() == [False, False, True, False]
        assert int(ts.iters[2]) < 2000
    ok = [0, 1, 3]
    for name in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(ts, name).numpy()[ok],
                                   np.asarray(getattr(js, name))[ok], atol=2e-3, err_msg=name)
    for b in ok:
        one = tadmm.admm_solve(*map(t, qps[b]), ADMMSettings(**{**BASE, **kw}))
        assert int(one.iters) == int(ts.iters[b]) and bool(one.converged)
        np.testing.assert_allclose(one.x.numpy(), ts.x[b].numpy(), atol=1e-5)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_admm_solve_batch_warm_start_and_forced_budget(backend):
    qps = [random_qp(s) for s in range(3)]
    jcold, cold = solve_both(qps, backend=backend)
    jwarm, warm_ = solve_both(qps, x0=np.asarray(jcold.x), y0=np.asarray(jcold.y),
                              backend=backend)
    assert bool(warm_.converged.all())
    assert (warm_.iters <= cold.iters).all()
    np.testing.assert_array_equal(warm_.iters.numpy(), np.asarray(jwarm.iters))
    np.testing.assert_allclose(warm_.x.numpy(), np.asarray(jwarm.x), atol=1e-3)
    # eps = 0 and max_iter = 150: the "xla" loop stops at 150; the
    # "pallas" rounds (adaptive rho, interval 100) test max_iter only
    # between kernel entries, so the second entry runs a whole interval
    # (200), as in the reference.
    js, ts = solve_both(qps, backend=backend, eps_abs=0.0, eps_rel=0.0, max_iter=150,
                        check_infeasibility=False)
    expect = 150 if backend == "xla" else 200
    assert ts.iters.tolist() == np.asarray(js.iters).tolist() == [expect] * 3
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), atol=1e-4)
