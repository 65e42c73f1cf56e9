"""The port's horizon-sharded SPIKE solve (``parallel/horizon.py``), its
block right-hand-side solve (``ops/block_tridiag.btd_solve_mat``) and the
collectives of the in-process mesh (``parallel/mesh.py``) against the JAX
package — mirrors ``tests/test_horizon_sharding.py`` case for case.

* ``horizon_sharded_solve`` over the 8 shards of ``"h"`` equals the dense
  float64 solve to JAX's rtol 3e-3 / atol 3e-4, and JAX's sharded solve
  on its 8 virtual devices to 3e-4; a horizon that does not split raises.
* ``btd_solve_mat`` equals JAX's on JAX's factor (1e-5) and the dense
  solve.
* ``ppermute`` by +1 and -1 (JAX's ``[(i, (i + 1) % D)]`` and
  ``[(i, (i - 1) % D)]``), ``all_gather``, ``psum``, ``pmax`` and
  ``axis_index`` equal JAX's ``shard_map`` collectives at D=2 and D=8,
  exactly; on a ``("b", "h")`` mesh they act on their own axis only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from optimal_control_problem_tpu.ops import block_tridiag as jbt
from optimal_control_problem_tpu.parallel import make_mesh as jmake_mesh
from optimal_control_problem_tpu.parallel.horizon import horizon_sharded_solve as jhorizon
from optimal_control_problem_tpu_torch.interop import mesh_from_jax_layout
from optimal_control_problem_tpu_torch.ops import block_tridiag as tbt
from optimal_control_problem_tpu_torch.parallel import make_mesh
from optimal_control_problem_tpu_torch.parallel.horizon import horizon_sharded_solve
from torch_threads import one_torch_thread  # noqa: F401


def random_system(seed, N, w):
    rng = np.random.default_rng(seed)
    diag = np.stack(
        [(lambda L: L @ L.T + (2 * w) * np.eye(w))(rng.normal(size=(w, w))) for _ in range(N)]
    ).astype(np.float32)
    lower = np.zeros((N, w, w), np.float32)
    lower[1:] = 0.4 * rng.normal(size=(N - 1, w, w))
    M = np.zeros((N * w, N * w), np.float32)
    for k in range(N):
        M[k * w:(k + 1) * w, k * w:(k + 1) * w] = diag[k]
    for k in range(1, N):
        M[k * w:(k + 1) * w, (k - 1) * w:k * w] = lower[k]
        M[(k - 1) * w:k * w, k * w:(k + 1) * w] = lower[k].T
    b = rng.normal(size=(N, w)).astype(np.float32)
    return diag, lower, b, M


@pytest.fixture(scope="module")
def jmesh():
    mesh = jmake_mesh(("h",))
    assert mesh.shape["h"] == 8
    return mesh


@pytest.mark.parametrize("N,w", [(16, 4), (32, 3), (64, 5)])
def test_sharded_solve_matches_dense(N, w, jmesh):
    mesh = mesh_from_jax_layout(jmesh.shape, device="cpu")
    diag, lower, b, M = random_system(0, N, w)
    x = horizon_sharded_solve(torch.tensor(diag), torch.tensor(lower), torch.tensor(b),
                              mesh=mesh, axis="h")
    ref = np.linalg.solve(M.astype(np.float64), b.reshape(-1).astype(np.float64))
    np.testing.assert_allclose(x.numpy().reshape(-1), ref, rtol=3e-3, atol=3e-4)
    jx = jhorizon(jnp.asarray(diag), jnp.asarray(lower), jnp.asarray(b), mesh=jmesh, axis="h")
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=3e-4)


def test_sharded_solve_rejects_bad_split():
    mesh = make_mesh(("h",), shape=(8,), devices="cpu")
    diag, lower, b, _ = random_system(1, 12, 3)  # 12 not divisible by 8
    with pytest.raises(ValueError, match="split"):
        horizon_sharded_solve(torch.tensor(diag), torch.tensor(lower), torch.tensor(b),
                              mesh=mesh, axis="h")


def test_btd_solve_mat_matches_jax():
    N, w, k = 12, 4, 3
    diag, lower, _, M = random_system(2, N, w)
    B = np.random.default_rng(3).normal(size=(N, w, k)).astype(np.float32)
    jfac = jbt.btd_factor(jnp.asarray(diag), jnp.asarray(lower[1:]))
    jX = np.asarray(jbt.btd_solve_mat(jfac, jnp.asarray(B)))
    fac = tbt.BTDFactor(*(torch.tensor(np.array(a)) for a in jfac))
    X = tbt.btd_solve_mat(fac, torch.tensor(B)).numpy()
    np.testing.assert_allclose(X, jX, atol=1e-5)
    ref = np.linalg.solve(M.astype(np.float64), B.reshape(N * w, k).astype(np.float64))
    np.testing.assert_allclose(X.reshape(N * w, k), ref, rtol=3e-3, atol=3e-4)
    # A batch after the stage dim solves each system alone.
    Xb = tbt.btd_solve_mat(
        tbt.BTDFactor(*(torch.stack([a, a], dim=1) for a in fac)),
        torch.tensor(np.stack([B, 2 * B], axis=1)),
    ).numpy()
    np.testing.assert_allclose(Xb[:, 0], X, atol=1e-6)
    np.testing.assert_allclose(Xb[:, 1], 2 * X, rtol=1e-5, atol=1e-5)


def _jax_collectives(D, t):
    mesh = jmake_mesh(("h",), shape=(D,), devices=jax.devices()[:D])

    def body(v):
        return (
            jax.lax.ppermute(v, "h", [(i, (i + 1) % D) for i in range(D)]),
            jax.lax.ppermute(v, "h", [(i, (i - 1) % D) for i in range(D)]),
            jax.lax.all_gather(v[0], "h")[None],
            jax.lax.psum(v, "h"),
            jax.lax.pmax(v, "h"),
            jax.lax.axis_index("h")[None],
        )

    out = jax.shard_map(body, mesh=mesh, in_specs=P("h"),
                        out_specs=(P("h"),) * 6)(jnp.asarray(t))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("D", [2, 8])
def test_collectives_match_jax(D):
    t = np.random.default_rng(D).normal(size=(D, 3)).astype(np.float32)
    right, left, gathered, summed, maxed, index = _jax_collectives(D, t)
    ax = make_mesh(("h",), shape=(D,), devices="cpu").shards()
    v = torch.tensor(t)  # one row a shard: local (S=D, 3)
    np.testing.assert_array_equal(ax.ppermute(v, "h", 1).numpy(), right)
    np.testing.assert_array_equal(ax.ppermute(v, "h", -1).numpy(), left)
    np.testing.assert_array_equal(ax.all_gather(v, "h").numpy(), gathered)
    np.testing.assert_array_equal(ax.psum(v, "h").numpy(), summed)
    np.testing.assert_array_equal(ax.pmax(v, "h").numpy(), maxed)
    np.testing.assert_array_equal(ax.axis_index("h").numpy(), index)


def test_collectives_on_a_2d_mesh():
    """On ("b", "h") of (2, 4) a collective over "h" stays inside each
    "b" row; over both it spans all 8 shards; shard/unshard round-trip."""
    ax = make_mesh(("b", "h"), shape=(2, 4), devices="cpu").shards()
    v = torch.arange(8, dtype=torch.float32)[:, None]  # shard (b, h) holds 4 b + h
    np.testing.assert_array_equal(ax.psum(v, "h")[:, 0].numpy(), [6] * 4 + [22] * 4)
    np.testing.assert_array_equal(ax.psum(v, ("h", "b"))[:, 0].numpy(), [28] * 8)
    np.testing.assert_array_equal(ax.ppermute(v, "h", 1)[:, 0].numpy(),
                                  [3, 0, 1, 2, 7, 4, 5, 6])
    np.testing.assert_array_equal(ax.ppermute(v, "b", 1)[:, 0].numpy(),
                                  [4, 5, 6, 7, 0, 1, 2, 3])
    np.testing.assert_array_equal(ax.axis_index("b").numpy(), [0] * 4 + [1] * 4)
    g = torch.arange(6 * 8 * 2, dtype=torch.float32).reshape(6, 8, 2)
    local = ax.shard(g, ("b", "h"))
    assert local.shape == (8, 3, 2, 2)
    torch.testing.assert_close(ax.unshard(local, ("b", "h")), g, rtol=0, atol=0)
    # An axis the spec leaves out holds copies.
    rep = ax.shard(g[0], ("h",))
    assert rep.shape == (8, 2, 2)
    torch.testing.assert_close(rep[1], rep[5], rtol=0, atol=0)
    torch.testing.assert_close(ax.unshard(rep, ("h",)), g[0], rtol=0, atol=0)
