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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.ops.admm_kernel import admm_device_loop as j_loop
from optimal_control_problem_tpu.solvers import admm as jadmm
from optimal_control_problem_tpu_torch.interop import dense_prep_from_numpy
from optimal_control_problem_tpu_torch.ops import admm_kernel as ak
from optimal_control_problem_tpu_torch.solvers import admm as tadmm
from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings
from torch_threads import one_torch_thread  # noqa: F401

SCAL = dict(sigma=1e-6, alpha=1.6)


def t(a):
    return torch.as_tensor(np.array(a))


def random_qp(seed, n=8, m=12):
    """The random QP of tests/test_pallas_admm.py."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, n))
    P = (L @ L.T + 0.5 * np.eye(n)).astype(np.float32)
    q = rng.normal(size=n).astype(np.float32)
    A = rng.normal(size=(m, n)).astype(np.float32)
    c = A @ rng.normal(size=n)
    l = (c - rng.uniform(0.2, 1.5, size=m)).astype(np.float32)
    u = (c + rng.uniform(0.2, 1.5, size=m)).astype(np.float32)
    return P, q, A, l, u


def stack(qps):
    return [np.stack(f) for f in zip(*qps)]


def inf_eq_qp():
    """The +-inf / equality QP of tests/test_pallas_admm.py:48."""
    P = (2 * np.eye(3)).astype(np.float32)
    q = np.array([-2.0, 0.0, 1.0], np.float32)
    A = np.vstack([np.eye(3), [[1.0, 1.0, 1.0]]]).astype(np.float32)
    l = np.array([0.5, -np.inf, -1.0, 1.0], np.float32)
    u = np.array([0.5, np.inf, 1.0, 1.0], np.float32)
    return P, q, A, l, u


def jax_prep(P, q, A, l, u, rho=0.1):
    """JAX's prepared batch (numpy), named as the port's ``DensePrep``."""
    P, q, A, l, u = map(jnp.asarray, (P, q, A, l, u))
    with jax.default_matmul_precision("highest"):
        Pb, qb, Ab, D, E, c = jax.vmap(lambda *a: jadmm.ruiz_equilibrate(*a, 10))(P, q, A)
        lb, ub = E * l, E * u
        rho_v = jax.vmap(lambda a, b: jadmm._rho_vec(a, b, jnp.float32(rho), jnp.float32))(lb, ub)
        OP = jax.vmap(lambda a, b, r: jadmm._factor(a, b, r, jnp.float32(1e-6), "condensed"))(
            Pb, Ab, rho_v)
    out = dict(Pb=Pb, qb=qb, Ab=Ab, lb=lb, ub=ub, D=D, E=E, c=c, rho_v=rho_v, OP=OP)
    return {k: np.asarray(v) for k, v in out.items()}


def run_loops(prep, x0, y0, max_iter, eps=(1e-4, 1e-4), check_every=25):
    """JAX's kernel (interpret mode, vmapped) and the port's plain loop on
    the same prepared batch; both results as numpy ``(x, y, z, it)``."""
    p = prep
    args = [p["OP"], p["Ab"], p["Pb"], p["qb"], p["lb"], p["ub"], p["rho_v"],
            1.0 / p["D"], 1.0 / p["E"], 1.0 / p["c"]]
    kw = dict(max_iter=max_iter, check_every=check_every)
    fn = jax.vmap(
        lambda *a: j_loop(*a[:10], SCAL["sigma"], SCAL["alpha"], *eps, a[10], a[11],
                          interpret=True, **kw))
    with jax.default_matmul_precision("highest"):
        jo = fn(*map(jnp.asarray, args), jnp.asarray(x0), jnp.asarray(y0))
    tp = dense_prep_from_numpy(prep, device="cpu")
    before = ak.admm_device_loop.launches
    to = ak.admm_device_loop(
        tp.OP, tp.Ab, tp.Pb, tp.qb, tp.lb, tp.ub, tp.rho_v, 1.0 / tp.D, 1.0 / tp.E,
        1.0 / tp.c, SCAL["sigma"], SCAL["alpha"], *eps, t(x0), t(y0), **kw)
    assert ak.admm_device_loop.launches == before  # CPU tensors: the plain version
    return [np.asarray(a) for a in jo], [a.numpy() for a in to]


def assert_loops_close(jo, to):
    np.testing.assert_array_equal(to[3], jo[3], err_msg="it")
    for name, a, b in zip("xyz", jo, to):
        np.testing.assert_allclose(b, a, atol=2e-5, rtol=1e-4, err_msg=name)


def warm(prep, seed):
    rng = np.random.default_rng(seed)
    B, n = prep["qb"].shape
    m = prep["lb"].shape[1]
    return (0.1 * rng.normal(size=(B, n))).astype(np.float32), (
        0.1 * rng.normal(size=(B, m))).astype(np.float32)


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


# -- admm_solve_batch against jax.vmap(admm_solve) --------------------------

BASE = dict(eps_abs=1e-4, eps_rel=1e-4, method="condensed")


def solve_both(qps, x0=None, y0=None, **kw):
    P, q, A, l, u = stack(qps)
    jst = jadmm.ADMMSettings(**{**BASE, **kw})
    w = [None if a is None else jnp.asarray(a) for a in (x0, y0)]
    js = jax.vmap(lambda *a: jadmm.admm_solve(*a[:5], jst, x0=a[5], y0=a[6]),
                  in_axes=(0,) * 5 + tuple(None if a is None else 0 for a in w))(
        *map(jnp.asarray, (P, q, A, l, u)), *w)
    ts = tadmm.admm_solve_batch(
        *map(t, (P, q, A, l, u)), ADMMSettings(**{**BASE, **kw}),
        x0=None if x0 is None else t(x0), y0=None if y0 is None else t(y0))
    return js, ts


def assert_flags_equal(ts, js):
    for name in ("converged", "prim_inf", "dual_inf"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)


def infeasible(seed):
    """random_qp with a contradictory duplicated row: a x >= 1, a x <= -1."""
    P, q, A, l, u = random_qp(seed)
    A = np.concatenate([A[:1], A[:1], A[2:]])
    l = np.concatenate([[1.0, -np.inf], l[2:]]).astype(np.float32)
    u = np.concatenate([[np.inf, -1.0], u[2:]]).astype(np.float32)
    return P, q, A, l, u


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


# -- the single-problem "pallas" backend (tests/test_pallas_admm.py) --------

XLA = ADMMSettings(eps_abs=1e-4, eps_rel=1e-4, method="condensed", adaptive_rho=False)
PALLAS = XLA.replace(backend="pallas")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pallas_matches_xla(seed):
    qp = [t(a) for a in random_qp(seed)]
    ref = tadmm.admm_solve(*qp, XLA)
    ker = tadmm.admm_solve(*qp, PALLAS)
    assert bool(ref.converged) and bool(ker.converged)
    np.testing.assert_allclose(ker.x.numpy(), ref.x.numpy(), atol=2e-3)
    assert int(ker.iters) == int(ref.iters)


def test_pallas_with_inf_bounds_and_equalities():
    qp = [t(a) for a in inf_eq_qp()]
    ref = tadmm.admm_solve(*qp, XLA)
    ker = tadmm.admm_solve(*qp, PALLAS)
    assert bool(ker.converged)
    np.testing.assert_allclose(ker.x.numpy(), ref.x.numpy(), atol=2e-3)


def test_pallas_requires_condensed():
    with pytest.raises(ValueError, match="condensed"):
        tadmm.admm_solve(*[t(a) for a in random_qp(0)], PALLAS.replace(method="kkt"))


@pytest.mark.parametrize("seed", [0, 1])
def test_pallas_adaptive_rho_matches_xla(seed):
    """Kernel re-entry with rho refactorization between rounds: the "xla"
    loop's adapt-every-interval semantics."""
    st = XLA.replace(adaptive_rho=True, adaptive_rho_interval=50, rho=1e-4)
    qp = [t(a) for a in random_qp(seed)]
    before = tadmm._iterate_dense.entries
    ker = tadmm.admm_solve(*qp, st.replace(backend="pallas"))
    assert tadmm._iterate_dense.entries - before > 1  # re-entered after adapting
    ref = tadmm.admm_solve(*qp, st)
    assert bool(ref.converged) and bool(ker.converged)
    assert int(ker.iters) == int(ref.iters)
    np.testing.assert_allclose(ker.x.numpy(), ref.x.numpy(), atol=2e-3)
    assert np.isfinite(float(ker.r_prim)) and np.isfinite(float(ker.r_dual))


def test_pallas_infeasible_qp_certificate():
    P = (2 * np.eye(2)).astype(np.float32)
    A = np.array([[1.0, 1.0], [1.0, 1.0]], np.float32)
    lu = np.array([1.0, 3.0], np.float32)
    sol = tadmm.admm_solve(t(P), torch.zeros(2), t(A), t(lu), t(lu),
                           PALLAS.replace(max_iter=500))
    assert not bool(sol.converged)
    assert bool(sol.prim_inf)


# -- the dense "pallas" path's size guard: JAX's, copied --------------------


@pytest.mark.parametrize("n,m", [(1619, 1619), (10, 440_000)])
def test_pallas_size_guard_raises_where_jax_raises(n, m):
    """Above the JAX package's 40 MiB operator budget both packages refuse
    backend="pallas" with a ValueError before any work; the "xla" backend is
    not guarded (not run here: the problems are large)."""
    P = np.eye(n, dtype=np.float32)
    q = np.zeros(n, np.float32)
    A = np.zeros((m, n), np.float32)
    l = np.full(m, -1.0, np.float32)
    u = np.full(m, 1.0, np.float32)
    with pytest.raises(ValueError, match="VMEM"):
        jadmm.admm_solve(*map(jnp.asarray, (P, q, A, l, u)),
                         jadmm.ADMMSettings(method="condensed", backend="pallas"))
    st = ADMMSettings(method="condensed", backend="pallas")
    with pytest.raises(ValueError, match="VMEM"):
        tadmm.admm_solve(*map(t, (P, q, A, l, u)), st)
    with pytest.raises(ValueError, match="VMEM"):
        tadmm.admm_solve_batch(*(t(a)[None] for a in (P, q, A, l, u)), st)


def test_pallas_size_guard_boundary():
    """The guard's boundary is JAX's formula: 4 (2 n^2 + 2 m n + 4 (n + m))
    bytes against 40 MiB (n = m = 1618 passes, 1619 does not)."""
    tadmm.check_pallas_size(1618, 1618)
    tadmm.check_pallas_size(120, 236)
    with pytest.raises(ValueError, match=r"n=1619, m=1619"):
        tadmm.check_pallas_size(1619, 1619)
