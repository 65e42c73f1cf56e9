"""The port's runtime-compiled C++ oracle (``solvers/native.py`` over its own
copy ``optimal_control_problem_tpu_torch/csrc/ref_admm.cpp``) against the
JAX package's ``native_admm_solve`` — mirrors ``tests/test_native.py``.

The two copies of the source differ only in a header comment and build
with the same ``g++`` flags, so on the same numpy inputs every output is
held bitwise equal, in both float32 and float64 internals.  The port's
ADMM is held to the oracle at ``test_native.py``'s 5e-3.
"""

import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.solvers.native import native_admm_solve as j_native
from optimal_control_problem_tpu.solvers.native import native_available as j_available
from optimal_control_problem_tpu_torch.solvers import native
from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings, admm_solve
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(
    not (native.native_available() and j_available()), reason="no C++ toolchain available"
)


def random_qp(seed, n=6, m=9):
    """The random QP of tests/test_native.py."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, n))
    P = L @ L.T + 0.5 * np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    c = A @ rng.normal(size=n)
    return P, q, A, c - rng.uniform(0.2, 1.5, size=m), c + rng.uniform(0.2, 1.5, size=m)


def assert_bitwise(a, b):
    assert a.iters == b.iters and a.converged == b.converged
    assert np.array_equal(a.x, b.x) and np.array_equal(a.y, b.y)
    assert (a.r_prim, a.r_dual) == (b.r_prim, b.r_dual)


@pytest.mark.parametrize("internal_f64", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_bitwise_equal_to_jax(seed, internal_f64):
    qp = random_qp(seed, n=6 + 3 * seed, m=9 + 4 * seed)
    kw = dict(eps_abs=1e-4, eps_rel=1e-4, internal_f64=internal_f64)
    assert_bitwise(native.native_admm_solve(*qp, **kw), j_native(*qp, **kw))


@pytest.mark.parametrize("seed", [0, 1])
def test_native_matches_port_admm_on_random_qps(seed):
    """tests/test_native.py::test_native_matches_jax_on_random_qps with the
    port's ADMM in JAX's place."""
    P, q, A, l, u = random_qp(seed)
    nat = native.native_admm_solve(P, q, A, l, u, eps_abs=1e-4, eps_rel=1e-4)
    assert nat.converged
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    st = ADMMSettings(eps_abs=1e-4, eps_rel=1e-4, method="condensed", adaptive_rho=False)
    sol = admm_solve(t(P), t(q), t(A), t(l), t(u), st)
    assert bool(sol.converged)
    np.testing.assert_allclose(nat.x, sol.x.numpy(), atol=5e-3)


def test_native_equality_and_inf_bounds():
    """tests/test_native.py's equality and +-inf cases, bitwise to JAX's."""
    cases = [
        (2 * np.eye(2), np.zeros(2), np.array([[1.0, 1.0]]), np.array([1.0]), np.array([1.0]),
         [0.5, 0.5]),
        (2 * np.eye(2), np.array([-6.0, -8.0]), np.vstack([np.eye(2), [[1.0, -1.0]]]),
         np.array([0.0, 0.0, -np.inf]), np.array([2.0, 3.0, np.inf]), [2.0, 3.0]),
    ]
    for P, q, A, l, u, x in cases:
        sol = native.native_admm_solve(P, q, A, l, u)
        assert sol.converged
        np.testing.assert_allclose(sol.x, x, atol=1e-3)
        assert_bitwise(sol, j_native(P, q, A, l, u))


def test_native_build_is_content_addressed(tmp_path, monkeypatch):
    """The library lands in the build directory named by the source hash,
    and a second load reuses it."""
    from optimal_control_problem_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    lib = native.build_native_lib()
    libs = list(tmp_path.glob("libref_admm_*.so"))
    assert len(libs) == 1 and native.build_native_lib() is lib
