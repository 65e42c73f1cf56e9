"""The port's cyclic-reduction path (``banded_solver="cr"``) against the JAX
package on the same numpy inputs:

* ``ops/block_tridiag.cr_factor``/``cr_solve`` against a dense float64
  solve (the tolerances of ``tests/test_block_tridiag.py``) and against
  JAX's ``cr_solve`` on JAX's own factor, carried over with
  ``interop.cr_factor_from_numpy`` (f32 roundoff: rtol 1e-5);
* the per-scenario ``admm_solve_banded`` with ``"cr"`` against JAX's and
  against the port's ``"thomas"`` (``tests/test_admm_banded.py``'s equal
  iterations and 1e-4);
* the plain CR chunk against JAX's ``banded_admm_chunk_cr`` in interpret
  mode on the port's prepared inputs, under forced budgets: equal
  ``done``/``it_inc``, iterates at ``test_torch_banded_kernel``'s
  ATOL / RTOL (at w=16 at ``test_torch_banded_rolled``'s wide-block
  tolerances, and to the port's own float64 run: the f32 floor of ROADMAP
  Queue C);
* the batch driver with ``"cr"`` against JAX's driver
  (``tests/test_banded_batch.py``'s CR tolerances), the driver's kernel
  rule and the wrapper's device rules.

Split over this file and ``test_torch_cr_chunk.py`` (the plain chunk, its
wrapper and the driver), so that two test workers carry them; their helpers
are in ``torch_cr_cases.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.ops import banded_cr_kernel as jcrk
from optimal_control_problem_tpu.ops import block_tridiag as jbt
from optimal_control_problem_tpu.solvers.admm_banded import admm_solve_banded as j_solve
from optimal_control_problem_tpu_torch.interop import (
    banded_qp_from_numpy,
    cr_factor_from_numpy,
)
from optimal_control_problem_tpu_torch.ops import banded_cr_kernel as bck
from optimal_control_problem_tpu_torch.ops import block_tridiag as tbt
from optimal_control_problem_tpu_torch.solvers import admm_banded_batch as abb
from optimal_control_problem_tpu_torch.solvers.admm_banded import admm_solve_banded
from tests.test_admm_banded import random_stage_qp
from tests.test_block_tridiag import random_btd
from tests.test_torch_banded_kernel import SET, port, stacked
from torch_cr_cases import (
    CR,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("N,w", [(8, 4), (10, 3), (33, 5), (50, 8)])
def test_cr_solve_matches_dense_and_jax(N, w):
    diag, lower, M = random_btd(7, N, w)
    b = np.random.default_rng(11).normal(size=(N, w)).astype(np.float32)
    fac = tbt.cr_factor(torch.as_tensor(diag), torch.as_tensor(lower))
    assert fac.n_orig == N and len(fac.levels) == (N - 1).bit_length()
    x = tbt.cr_solve(fac, torch.as_tensor(b)).numpy()
    x_dense = np.linalg.solve(M.astype(np.float64), b.reshape(-1).astype(np.float64))
    np.testing.assert_allclose(x.reshape(-1), x_dense, rtol=3e-3, atol=3e-4)
    # JAX's solve on JAX's factor, and the port's solve on the same factor.
    jfac = jbt.cr_factor(jnp.asarray(diag), jnp.asarray(lower))
    jx = np.asarray(jbt.cr_solve(jfac, jnp.asarray(b)))
    x_on_jax = tbt.cr_solve(cr_factor_from_numpy(jfac, device="cpu"), torch.as_tensor(b))
    np.testing.assert_allclose(x_on_jax.numpy(), jx, rtol=1e-5, atol=1e-6)
    # The two packages' factors agree to f32 roundoff.
    for lv, jlv in zip(fac.levels, jfac.levels):
        for a, ja in zip(lv, jlv):
            np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-5)


def test_pad_pow2_pads_with_identity():
    diag, lower, _ = random_btd(3, 5, 2)
    d, lo = tbt._pad_pow2(torch.as_tensor(diag), torch.as_tensor(lower))
    assert d.shape == (8, 2, 2) and lo.shape == (7, 2, 2)
    assert torch.equal(d[5:], torch.eye(2).expand(3, 2, 2)) and not lo[4:].any()
    same = tbt._pad_pow2(torch.as_tensor(diag[:4]), torch.as_tensor(lower[:3]))
    assert same[0].shape == (4, 2, 2)


@pytest.mark.parametrize("seed", [0, 1])
def test_per_scenario_cr_matches_jax_and_thomas(seed):
    jqp = random_stage_qp(seed)
    tqp = banded_qp_from_numpy(jqp._asdict(), device="cpu")
    ref = j_solve(jqp, CR)
    cr = admm_solve_banded(tqp, port(CR))
    thomas = admm_solve_banded(tqp, port(SET))
    assert bool(cr.converged) and bool(ref.converged)
    assert int(cr.iters) == int(thomas.iters) == int(ref.iters)
    np.testing.assert_allclose(cr.x.numpy(), thomas.x.numpy(), atol=1e-4)
    np.testing.assert_allclose(cr.x.numpy(), np.asarray(ref.x), atol=1e-4)


def test_per_scenario_cr_polish_and_unknown_solver():
    jqp = random_stage_qp(2, N=7)
    tqp = banded_qp_from_numpy(jqp._asdict(), device="cpu")
    st = CR.replace(polish=True)
    ref = j_solve(jqp, st)
    ours = admm_solve_banded(tqp, port(st))
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x), atol=1e-4)
    bad = port(SET)
    object.__setattr__(bad, "banded_solver", "lu")
    with pytest.raises(ValueError, match="unknown banded_solver"):
        admm_solve_banded(tqp, bad)


@pytest.mark.parametrize("N", [2, 5, 7, 13, 25, 100])
def test_cr_level_plan_is_jax_plan(N):
    assert bck.cr_level_plan(N) == jcrk.cr_level_plan(N)


def test_cr_scratch_layout():
    # N=100, w=16, r=12, r2=1: operators 100 + 2 x 99 x 12 / 16 + 100 / 16
    # blocks, rows and state, 2 x 101 + 2 x 52 working blocks, 2 x (102 + 1)
    # inverses and transposes, 2 x 204 couplings and transposes, 3 x 50
    # products, 3 x 101 + 102 vectors.
    ov = 6 * 100 * 16 + 4 * 99 * 12 + 4 * 100
    st = 3 * 100 * 16 + 2 * 99 * 12 + 2 * 100
    assert bck.cr_slab_floats(100, 16, 12, 1) == (
        (100 + 2 * 101 + 2 * 52 + 2 * 103 + 2 * 204 + 150) * 256 + 2 * 99 * 12 * 16 + 100 * 16
        + ov + st + (3 * 101 + 102) * 16)
    # Every region is rounded up to 16 bytes: at N=50, w=3, r=2, r2=1, J0
    # and J1 hold 294 floats each, padded to 296.
    assert bck.cr_slab_floats(50, 3, 2, 1) % 4 == 0


def test_settings_carry_banded_solver_to_the_driver(monkeypatch):
    """``banded_solver`` reaches the chunk rule through ``ADMMSettings``."""
    seen = []
    real = abb.chunk_kernel

    def spy(*args, **kwargs):
        seen.append(kwargs.get("banded_solver"))
        return real(*args, **kwargs)

    monkeypatch.setattr(abb, "chunk_kernel", spy)
    _, tqp = stacked(range(2), N=4)
    abb.admm_solve_banded_batch(tqp, port(CR.replace(max_iter=4)), device="cpu")
    assert seen == ["cr"]
