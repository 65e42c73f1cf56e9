"""The port's dense OSQP-style ADMM solver (``solvers/admm.py``) against the
JAX package's, on the same numpy-seeded QPs — mirrors ``tests/test_admm.py``.

Tolerances.  Both solvers run the same float32 algorithm, but their
explicit inverses come from two LAPACK front-ends (``torch.linalg.inv`` and
``jnp.linalg.inv``) and their matvecs sum in different orders, so iterates
drift apart at f32 roundoff times the operator's conditioning (equality
rows carry rho x 1e3).  Equilibration is elementwise and agrees to 1e-6
relative; an inverse is held to 2e-3 of its largest entry; converged
solutions are held to 2e-3 at eps 1e-4 (each is within ~1e-3 of the true
optimum) and polished ones to 5e-4.  Iteration counts are compared only
under a forced budget or where the run is far from the knife edge of the
termination test.

Split over this file, ``test_torch_admm_random.py`` (random convex QPs and
polish) and ``test_torch_admm_certificates.py``, so that test workers
share them; their helpers are in ``torch_admm_cases.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.solvers import admm as jadmm
from optimal_control_problem_tpu_torch.solvers import admm as tadmm
from torch_admm_cases import SMALL_QPS, TSET, both, j32, random_qp, t32
from torch_threads import one_torch_thread  # noqa: F401


def test_ruiz_equilibrate_matches_jax():
    P, q, A, _, _ = random_qp(5)
    P = P * np.logspace(-2, 2, 8)[:, None] * np.logspace(-2, 2, 8)[None, :]
    jo = jadmm.ruiz_equilibrate(j32(P), j32(q), j32(A), 10)
    to = tadmm.ruiz_equilibrate(t32(P), t32(q), t32(A), 10)
    for a, b in zip(jo, to):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-7)
    # m = 0: no constraint rows to scale.
    A0 = np.zeros((0, 8))
    jo = jadmm.ruiz_equilibrate(j32(P), j32(q), j32(A0), 10)
    to = tadmm.ruiz_equilibrate(t32(P), t32(q), t32(A0), 10)
    np.testing.assert_allclose(to[3].numpy(), np.asarray(jo[3]), rtol=1e-5)
    assert to[2].shape == (0, 8) and to[4].shape == (0,)


def test_ruiz_equilibration_improves_conditioning():
    P = np.diag([1e6, 1.0])
    Pb, *_ = tadmm.ruiz_equilibrate(t32(P), t32(np.zeros(2)), t32(np.eye(2)), 10)
    diag = np.abs(np.diag(Pb.numpy()))
    assert diag.max() / max(diag.min(), 1e-12) < 1e6 / 100


def test_rho_vec_matches_jax():
    l = np.array([-np.inf, 0.0, 1.0, -1.0, -np.inf])
    u = np.array([np.inf, 0.0, 1.00005, 1.0, 3.0])
    jr = jadmm._rho_vec(j32(l), j32(u), jnp.asarray(0.1, jnp.float32), jnp.float32)
    tr = tadmm._rho_vec(t32(l), t32(u), torch.tensor(0.1))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tr.numpy(), [1e-6, 100.0, 100.0, 0.1, 0.1], rtol=1e-6)


@pytest.mark.parametrize("method", ["condensed", "kkt"])
def test_factor_matches_jax(method):
    P, q, A, l, u = random_qp(6)
    Pb, _, Ab, _, E, _ = jadmm.ruiz_equilibrate(j32(P), j32(q), j32(A), 10)
    rho = jadmm._rho_vec(E * j32(l), E * j32(u), jnp.asarray(0.1, jnp.float32), jnp.float32)
    jo = np.asarray(jadmm._factor(Pb, Ab, rho, jnp.asarray(1e-6, jnp.float32), method))
    to = tadmm._factor(t32(Pb), t32(Ab), t32(rho), torch.tensor(1e-6), method).numpy()
    size = 8 if method == "condensed" else 20
    assert to.shape == (size, size)
    np.testing.assert_allclose(to, jo, atol=2e-3 * np.abs(jo).max())


@pytest.mark.parametrize("name", sorted(SMALL_QPS))
def test_small_qps_match_jax_and_the_known_optimum(name):
    P, q, A, l, u, x_ref = SMALL_QPS[name]
    js, ts = both(P, q, np.asarray(A, float).reshape(-1, 2), l, u)
    assert bool(ts.converged) and bool(js.converged)
    assert int(ts.iters) == int(js.iters)
    np.testing.assert_allclose(ts.x.numpy(), x_ref, atol=1e-3)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), atol=1e-4)
    np.testing.assert_allclose(ts.y.numpy(), np.asarray(js.y), atol=1e-3)
    assert ts.iters.dtype == torch.int32 and ts.converged.dtype == torch.bool


@pytest.mark.parametrize("method", ["kkt", "condensed"])
def test_forced_budget_gives_equal_iterations_and_close_iterates(method):
    """eps = 0 never converges: both run exactly max_iter iterations (two
    adaptation rounds), and the iterates agree to f32 roundoff."""
    qp = random_qp(3, shift=0.5)
    js, ts = both(*qp, method=method, eps_abs=0.0, eps_rel=0.0, max_iter=150,
                  check_infeasibility=False)
    assert int(ts.iters) == int(js.iters) == 150
    assert not bool(ts.converged)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), atol=1e-4)
    np.testing.assert_allclose(ts.y.numpy(), np.asarray(js.y), atol=1e-3)
    np.testing.assert_allclose(float(ts.r_prim), float(js.r_prim), atol=1e-4)


def test_badly_scaled_qp():
    P = np.diag([1e4, 1e-2])
    q = np.array([-1e4, 1e-2])
    A = np.array([[1e3, 0.0], [0.0, 1e-2]])
    js, ts = both(P, q, A, [-1e3, -1.0], [1e3, 1.0])
    assert bool(ts.converged)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=5e-2, atol=1e-3)
    np.testing.assert_allclose(ts.x.numpy(), [1.0, -1.0], rtol=5e-2, atol=1e-3)


def test_warm_start_reduces_iterations():
    rng = np.random.default_rng(3)
    n, m = 10, 14
    L = rng.normal(size=(n, n))
    qp = (L @ L.T + 0.5 * np.eye(n), rng.normal(size=n), rng.normal(size=(m, n)),
          -np.ones(m), np.ones(m))
    jcold, cold = both(*qp)
    jwarm, warm = both(*qp, x0=np.asarray(jcold.x), y0=np.asarray(jcold.y))
    assert int(warm.iters) <= int(cold.iters)
    assert int(warm.iters) == int(jwarm.iters)
    np.testing.assert_allclose(warm.x.numpy(), np.asarray(jwarm.x), atol=1e-3)


def test_indefinite_P_kkt_method():
    P = np.diag([2.0, -2.0])
    l, u = np.array([-1.0, -1.0]), np.array([1.0, 1.0])
    _, ts = both(P, np.zeros(2), np.eye(2), l, u, max_iter=2000)
    x = ts.x.numpy()
    assert np.all(x >= l - 1e-2) and np.all(x <= u + 1e-2)


def test_unported_variants_raise():
    """Nothing raises any more: backend="pallas" solves (the device loop
    with a batch of one; iterates as the "xla" loop's to 2e-3, as in
    tests/test_pallas_admm.py), and so do the precision variants, JAX's
    default_matmul_precision around the solve (bf16_3x at "high", one bf16
    pass at "default"; the dense path does not read iter_precision).  They
    converge to JAX's solution at the converged tolerance of
    tests/test_shared_fused.py (rtol 1e-3, atol 2e-3): JAX on the CPU
    computes every precision in f32, the port rounds as the TPU does.  At
    "default" the residuals themselves are bf16 products, so they float
    at bf16's floor (~4e-2 here) and never meet eps 1e-4, as the JAX
    package measured on the TPU: the solve runs its whole budget and its x
    stays within bf16 accuracy (5e-2) of JAX's.  An unknown precision is
    refused when the settings are built."""
    qp = [t32(a) for a in random_qp(0)]
    ker = tadmm.admm_solve(*qp, TSET.replace(backend="pallas", method="condensed"))
    ref = tadmm.admm_solve(*qp, TSET.replace(method="condensed"))
    assert bool(ker.converged) and ker.x.shape == (8,) and ker.iters.shape == ()
    np.testing.assert_allclose(ker.x.numpy(), ref.x.numpy(), atol=2e-3)
    for kw in (dict(precision="high"), dict(iter_precision="mixed"),
               dict(precision="high", method="condensed", backend="pallas")):
        js, ts = both(*random_qp(0), **kw)
        assert bool(ts.converged) and bool(js.converged), kw
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=1e-3, atol=2e-3)
    js, ts = both(*random_qp(0), precision="default")
    assert bool(js.converged) and not bool(ts.converged) and int(ts.iters) == 10000
    assert 1e-3 < float(ts.r_prim) < 0.1
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), atol=5e-2)
    with pytest.raises(ValueError, match="precision"):
        TSET.replace(precision="f16")
