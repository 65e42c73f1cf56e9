"""The port's ``Sym`` expression layer (``optimal_control_problem_tpu_torch/
sym.py``) against the JAX package's, case by case as ``tests/test_sym.py``:
the same expressions built in both packages and evaluated on the same numpy
inputs.  Arithmetic (``+ - * / **``, slices, ``vertcat``, ``sumsqr``,
``dot``, ``minimum``/``maximum``) is held exactly, transcendental functions
to rtol 1e-6 (the two frameworks' float32 libm differ in the last ulp).
Beyond ``test_sym.py``: ``torch.func`` derivatives and maps pass through a
compiled expression, and constants follow the bound tensor's dtype."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu import sym as J
from optimal_control_problem_tpu_torch import sym as T
from torch_threads import one_torch_thread  # noqa: F401


def both(build, env, exact=True):
    """Build an expression with each package's module, evaluate it on the
    same numpy bindings, and compare (exactly, or to rtol 1e-6)."""
    jv = np.asarray(J.evaluate(build(J), {k: jnp.asarray(v) for k, v in env.items()}))
    tv = T.evaluate(build(T), {k: torch.as_tensor(v) for k, v in env.items()}).numpy()
    assert tv.dtype == jv.dtype and tv.shape == jv.shape
    if exact:
        np.testing.assert_array_equal(tv, jv)
    else:
        np.testing.assert_allclose(tv, jv, rtol=1e-6)
    return tv


def f32(*v):
    return np.asarray(v, np.float32)


def test_leaf_and_eval():
    v = both(lambda S: S.sym("x", 3), {"x": f32(1.0, 2.0, 3.0)})
    np.testing.assert_array_equal(v, [1.0, 2.0, 3.0])


def test_arithmetic_and_slicing():
    def build(S):
        x = S.sym("x", 4)
        return 2.0 * x[0:2] + x[2:4] - 1.0

    v = both(build, {"x": f32(1.0, 2.0, 3.0, 4.0)})
    np.testing.assert_array_equal(v, [2 + 3 - 1, 4 + 4 - 1])
    rng = np.random.default_rng(0)

    def mixed(S):
        x = S.sym("x", 5)
        return (x[1:4] / 3.0 - (1.5 - x[0]) * x[2:5] + (-x[0:3]) / x[2:5]
                + x[::2] ** 3 + 2.0 ** x[0])

    both(mixed, {"x": rng.uniform(0.5, 2.0, 5).astype(np.float32)})


def test_scalar_index():
    def build(S):
        x = S.sym("x", 3)
        return x[0] * x[1] + x[2] ** 2

    np.testing.assert_array_equal(both(build, {"x": f32(2.0, 3.0, 4.0)}), [2 * 3 + 16])


def test_vertcat_and_functions():
    def build(S):
        x = S.sym("x", 2)
        return S.vertcat(S.sin(x[0]), S.cos(x[1]), x[0] + x[1], [0.25, -1.0])

    v = both(build, {"x": f32(0.5, 1.5)}, exact=False)
    np.testing.assert_allclose(v, [np.sin(0.5), np.cos(1.5), 2.0, 0.25, -1.0], rtol=1e-6)
    rng = np.random.default_rng(1)
    fns = ("sin", "cos", "tan", "exp", "log", "sqrt", "tanh", "abs_", "asin", "acos", "atan")
    for name in fns:
        both(lambda S: getattr(S, name)(S.sym("x", 4)),
             {"x": rng.uniform(0.1, 0.9, 4).astype(np.float32)}, exact=False)


def test_sumsqr_dot():
    env = {"x": f32(1.0, 2.0, 3.0)}
    np.testing.assert_array_equal(both(lambda S: S.sumsqr(S.sym("x", 3)), env), [14.0])
    np.testing.assert_array_equal(
        both(lambda S: S.dot(S.sym("x", 3), [1.0, 0.0, 2.0]), env), [7.0])
    np.testing.assert_array_equal(
        both(lambda S: S.sym("x", 3) @ S.sym("x", 3), env), [14.0])


def test_compile_fn_and_autodiff():
    fns = []
    for S in (J, T):
        x = S.sym("x", 2)
        p = S.sym("p", 1)
        fns.append(S.compile_fn((x[0] - p[0]) ** 2 + x[1] ** 2, [x, p]))
    jf, tf = fns
    np.testing.assert_array_equal(tf(torch.tensor([3.0, 1.0]), torch.tensor([1.0])).numpy(),
                                  np.asarray(jf(jnp.array([3.0, 1.0]), jnp.array([1.0]))))
    gj = jax.grad(lambda xx: jf(xx, jnp.array([1.0]))[0])(jnp.array([3.0, 1.0]))
    gt = torch.func.grad(lambda xx: tf(xx, torch.tensor([1.0]))[0])(torch.tensor([3.0, 1.0]))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(gt.numpy(), [4.0, 2.0])
    # Hessians and Jacobians under a batch map, as the dense assembly takes them.
    rng = np.random.default_rng(2)
    X = rng.normal(size=(5, 3)).astype(np.float32)
    hs = []
    for S, hess, vmap, arr in ((J, jax.hessian, jax.vmap, jnp.asarray),
                               (T, torch.func.hessian, torch.func.vmap, torch.as_tensor)):
        x = S.sym("x", 3)
        f = S.compile_fn(S.sumsqr(x) * S.sin(x[0]) + S.atan2(x[1], 2.0) - 0.5 * x[2] ** 3, [x])
        hs.append(np.asarray(vmap(hess(lambda xx: f(xx)[0]))(arr(X))))
    assert hs[1].dtype == np.float32
    np.testing.assert_allclose(hs[1], hs[0], rtol=1e-5, atol=1e-6)


def test_shared_subexpression_memoization():
    for S, arr in ((J, jnp.array), (T, torch.tensor)):
        calls = []

        def noisy(env, memo, calls=calls):
            calls.append(1)
            return env["x"] * 2

        shared = S.Sym(noisy, (1,), ())
        expr = shared + shared * 3.0
        np.testing.assert_array_equal(np.asarray(S.evaluate(expr, {"x": arr([1.0])})), [8.0])
        assert len(calls) == 1  # evaluated once despite two uses


def test_shape_errors():
    for S in (J, T):
        x = S.sym("x", 3)
        y = S.sym("y", 2)
        with pytest.raises(ValueError):
            _ = x + y
        with pytest.raises(IndexError):
            _ = x[5]
        with pytest.raises(ValueError):
            S.dot(x, [1.0, 2.0])


def test_binding_size_check():
    with pytest.raises(ValueError):
        J.evaluate(J.sym("x", 3), {"x": jnp.array([1.0, 2.0])})
    with pytest.raises(ValueError):
        T.evaluate(T.sym("x", 3), {"x": torch.tensor([1.0, 2.0])})


def test_extended_functions():
    env = {"x": f32(0.5, -0.5)}
    v = both(lambda S: S.atan2(S.sym("x", 2)[0], S.sym("x", 2)[1]), env, exact=False)
    np.testing.assert_allclose(v, [np.arctan2(0.5, -0.5)], rtol=1e-6)
    both(lambda S: S.atan2(0.5, S.sym("x", 2)), env, exact=False)
    np.testing.assert_array_equal(both(lambda S: S.minimum(S.sym("x", 2), 0.0), env), [0.0, -0.5])
    np.testing.assert_array_equal(both(lambda S: S.maximum(S.sym("x", 2), 0.0), env), [0.5, 0.0])
    both(lambda S: S.maximum(-1.0, S.sym("x", 2)), env)
    both(lambda S: S.power(S.sym("x", 2), 2.0) + S.power(2.0, S.sym("x", 2)), env, exact=False)
    v = both(lambda S: S.norm_2(S.sym("x", 2)), env, exact=False)
    np.testing.assert_allclose(v, [np.sqrt(0.5)], rtol=1e-6)

    def inv(S):
        x = S.sym("x", 2)
        return S.asin(x[0]) + S.acos(x[0]) + S.atan(x[1])

    v = both(inv, env, exact=False)
    np.testing.assert_allclose(v, [np.arcsin(0.5) + np.arccos(0.5) + np.arctan(-0.5)], rtol=1e-6)


def test_constants_follow_the_bound_dtype():
    """A constant combined with a symbol takes the symbol's dtype (and so
    its device): float64 bindings give float64 results, float32 float32;
    ``const(c) * x`` as ``c * x``."""
    for dt in (torch.float32, torch.float64):
        x = T.sym("x", 3)
        expr = T.vertcat(T.const(2.0) * x + [1.0, 2.0, 3.0], T.dot(x, [1.0, 1.0, 1.0]),
                         T.minimum(x, 0.5))
        v = T.evaluate(expr, {"x": torch.tensor([1.0, 2.0, 3.0], dtype=dt)})
        assert v.dtype == dt
        np.testing.assert_array_equal(v.numpy(), [3.0, 6.0, 9.0, 6.0, 0.5, 0.5, 0.5])
