"""Cases and helpers of the ``test_torch_admm_kernel*.py`` test files (a module of
helpers, not of tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from optimal_control_problem_tpu.ops.admm_kernel import admm_device_loop as j_loop
from optimal_control_problem_tpu.solvers import admm as jadmm
from optimal_control_problem_tpu_torch.interop import dense_prep_from_numpy
from optimal_control_problem_tpu_torch.ops import admm_kernel as ak
from optimal_control_problem_tpu_torch.solvers import admm as tadmm
from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings

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


# -- the single-problem "pallas" backend (tests/test_pallas_admm.py) --------

XLA = ADMMSettings(eps_abs=1e-4, eps_rel=1e-4, method="condensed", adaptive_rho=False)
PALLAS = XLA.replace(backend="pallas")
