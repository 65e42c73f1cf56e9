"""The banded batch solve's polish as one batched pass
(``solvers/admm_banded.banded_polish_T``) against the JAX package's
vmapped ``banded_polish`` and against the per-scenario loop it replaced.

The scaled iterates are the batch driver's own: a spy on
``admm_banded_batch.banded_polish_T`` records what the driver hands its
polish at the end of a solve (B=6 random stage QPs, N=6, w=5, r=4, r2=1,
a budget of 40 iterations, so scenarios stop unconverged).  The driver's
polish keeps every scenario's point there (its polished residuals are not
both lower; JAX's driver keeps them too), so the residuals the polish
compares against are made infinite for three of the six scenarios: their
polished points are taken, the others' refused.

The polish solve pins active rows with a weight of ``1/polish_delta``
(1e6 by default) against Hessian blocks of order one, so in float32 its
result carries the roundoff of the block sums times about 1e6: two sum
orders of one float32 polish differ by 105 in ``y`` here, and neither
package's float32 result is a reference for the other's.  So:

* the port equals JAX's ``jax.vmap(banded_polish)`` in float64 (JAX with
  x64) within ``test_torch_admm_banded.py``'s polish tolerance (atol
  5e-3, rtol 1e-2), with the same accept decisions;
* the port equals the per-scenario loop (``banded_polish`` on each
  scenario in turn, the driver's polish before the batched pass) with the
  same accept decisions: bitwise in float64 at the default
  ``polish_delta``, and in float32 at ``polish_delta`` 1e-2 (a weight of
  100) to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.ops.block_tridiag import btd_factor as jbtd_factor
from optimal_control_problem_tpu.ops.block_tridiag import btd_solve as jbtd_solve
from optimal_control_problem_tpu.solvers.admm import ADMMSettings as JSettings
from optimal_control_problem_tpu.solvers.admm_banded import BandedQP as JBandedQP
from optimal_control_problem_tpu.solvers.admm_banded import banded_polish as jbanded_polish
from optimal_control_problem_tpu_torch.ops.block_tridiag import btd_factor, btd_solve
from optimal_control_problem_tpu_torch.solvers import admm_banded_batch as abb
from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings
from optimal_control_problem_tpu_torch.solvers.admm_banded import BandedQP, banded_polish
from test_torch_export_kernels import banded_qp
from torch_threads import one_torch_thread  # noqa: F401

BUDGET = dict(method="banded", adaptive_rho=False, max_iter=40, check_every=5, polish=True,
              eps_abs=1e-4, eps_rel=1e-4)
TAKEN = [True] * 3 + [False] * 3


def polish_inputs(dtype, delta):
    """The settings and the polish's inputs (batch-last): what the driver
    hands it on the batch in ``dtype``, three scenarios' residuals made
    infinite."""
    st = ADMMSettings(**BUDGET, polish_delta=delta)
    seen = []
    real = abb.banded_polish_T

    def spy(*args):
        seen.append(args)
        return real(*args)

    abb.banded_polish_T = spy
    try:
        abb.admm_solve_banded_batch(BandedQP(*(a.to(dtype) for a in banded_qp(B=6, N=6))), st,
                                    device="cpu")
    finally:
        abb.banded_polish_T = real
    args, = seen
    inf = torch.tensor([float("inf")] * 3 + [1.0] * 3, dtype=dtype)
    return st, (*args[:5], args[5] * inf, args[6] * inf, *args[7:])


def taken(x, x_out):
    """The scenarios whose polished point was taken (it moved x)."""
    return (np.asarray(x_out) != np.asarray(x)).any(axis=0).tolist()


def test_batched_polish_matches_jax_vmap():
    st, args = polish_inputs(torch.float64, 1e-6)
    out = abb.banded_polish_T(*args)
    qpT, _, x, y, z, rp, rd, Einv, Dinv, cinv = args
    with jax.enable_x64():
        lead = lambda t: jnp.asarray(t.movedim(-1, 0).numpy())  # noqa: E731
        jst = JSettings(**BUDGET)
        pol = jax.jit(jax.vmap(
            lambda qp_, *a: jbanded_polish(qp_, jst, jbtd_factor, jbtd_solve, *a)))
        jout = [np.asarray(o) for o in pol(
            JBandedQP(*(lead(a) for a in qpT)), lead(x), lead(y), lead(z), jnp.asarray(rp.numpy()),
            jnp.asarray(rd.numpy()), lead(Einv), lead(Dinv), jnp.asarray(cinv.numpy()))]
    assert taken(x, out[0]) == taken(x, jout[0].T) == TAKEN
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.numpy(), b.T if b.ndim == 2 else b, atol=5e-3, rtol=1e-2)


@pytest.mark.parametrize("dtype,delta,tol", [(torch.float64, 1e-6, 0.0),
                                             (torch.float32, 1e-2, 1e-4)],
                         ids=["float64", "float32-delta-1e-2"])
def test_batched_polish_equals_per_scenario_loop(dtype, delta, tol):
    """The driver's polish before the batched pass: ``banded_polish`` on
    each scenario's columns in turn."""
    st, args = polish_inputs(dtype, delta)
    out = abb.banded_polish_T(*args)
    qpT, _, x, y, z, rp, rd, Einv, Dinv, cinv = args
    cols = [banded_polish(BandedQP(*(a[..., b] for a in qpT)), st, btd_factor, btd_solve,
                          x[:, b], y[:, b], z[:, b], rp[b], rd[b], Einv[:, b], Dinv[:, b],
                          cinv[b])
            for b in range(x.shape[-1])]
    loop = [torch.stack(c, dim=-1) for c in zip(*cols)]
    assert taken(x, out[0]) == taken(x, loop[0]) == TAKEN
    for a, b in zip(out, loop):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol, rtol=tol)
