"""Cases and helpers of ``test_torch_admm.py``, ``test_torch_admm_random.py``
and ``test_torch_admm_certificates.py`` (a module of helpers, not of tests)."""

import jax.numpy as jnp
import numpy as np
import torch

from optimal_control_problem_tpu.solvers import admm as jadmm
from optimal_control_problem_tpu_torch.solvers import admm as tadmm
from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings

JSET = jadmm.ADMMSettings(eps_abs=1e-4, eps_rel=1e-4)
TSET = ADMMSettings(eps_abs=1e-4, eps_rel=1e-4)


def t32(a):
    return torch.as_tensor(np.array(a, np.float32))


def j32(a):
    return jnp.asarray(np.asarray(a, np.float32))


def both(P, q, A, l, u, x0=None, y0=None, **kw):
    """Solve one QP in both packages with the same settings overrides."""
    js = jadmm.admm_solve(*(j32(a) for a in (P, q, A, l, u)), JSET.replace(**kw),
                          x0=None if x0 is None else j32(x0),
                          y0=None if y0 is None else j32(y0))
    ts = tadmm.admm_solve(*(t32(a) for a in (P, q, A, l, u)), TSET.replace(**kw),
                          x0=None if x0 is None else t32(x0),
                          y0=None if y0 is None else t32(y0))
    return js, ts


def random_qp(seed, n=8, m=12, shift=0.1):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, n))
    P = L @ L.T + shift * np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    center = A @ rng.normal(size=n)
    l = center - rng.uniform(0.1, 2.0, size=m)
    u = center + rng.uniform(0.1, 2.0, size=m)
    return P, q, A, l, u


SMALL_QPS = {
    # min x^2 + y^2 s.t. x + y = 1 -> (0.5, 0.5)
    "equality": (2 * np.eye(2), np.zeros(2), [[1.0, 1.0]], [1.0], [1.0], [0.5, 0.5]),
    # min (x-3)^2 + (y-4)^2 with x in [0,2], y in [0,3] -> (2, 3)
    "box": (2 * np.eye(2), [-6.0, -8.0], np.eye(2), np.zeros(2), [2.0, 3.0], [2.0, 3.0]),
    # min (x-2)^2 + (y-3)^2 s.t. x + y >= 1 -> (2, 3)
    "inactive": (2 * np.eye(2), [-4.0, -6.0], [[1.0, 1.0]], [1.0], [np.inf], [2.0, 3.0]),
    # rows with (-inf, inf) bounds must not perturb the solution
    "loose": (2 * np.eye(2), [-2.0, -2.0], np.vstack([np.eye(2), [[1.0, -1.0]]]),
              [-np.inf] * 3, [np.inf] * 3, [1.0, 1.0]),
    # m = 0: the stationary point
    "unconstrained": (np.diag([2.0, 4.0]), [-2.0, -8.0], np.zeros((0, 2)), [], [], [1.0, 2.0]),
}


CERTIFICATE_QPS = {
    # x+y == 1 AND x+y == 3
    "infeasible_equalities": (2 * np.eye(2), np.zeros(2), [[1.0, 1.0], [1.0, 1.0]],
                              [1.0, 3.0], [1.0, 3.0], 500, (True, False)),
    # x >= 1 and x <= 0
    "infeasible_box": (np.eye(1), np.zeros(1), [[1.0], [1.0]], [1.0, -np.inf], [np.inf, 0.0],
                       2000, (True, False)),
    # min -x s.t. x >= 0
    "unbounded": (np.zeros((1, 1)), [-1.0], [[1.0]], [0.0], [np.inf], 2000, (False, True)),
    "feasible": (2 * np.eye(2), [-2.0, -2.0], np.eye(2), np.zeros(2), [10.0, 10.0], 10000,
                 (False, False)),
}
