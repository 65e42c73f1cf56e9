"""Port's rolled two-way chunk (plain PyTorch version), the driver's choice
between the two chunk kernels, and the driver on the rolled chunk, against
the JAX package: its rolled Pallas kernel in interpret mode and its batch
driver with ``rolled=True``.

Chunk inputs come from the port's own driver prepare on ``random_stage_qp``
batches and go to both kernels unchanged.  Under a forced budget (eps = 0)
both run the same iterations: ``done``/``it_inc`` equal, iterates to
ATOL / RTOL (the f32 floor recorded in ROADMAP Queue C: the equality rows'
rho x 1e3 makes M ill-conditioned, and the JAX kernel's ``jnp.sum``
reductions need not run in the ascending order the port keeps).  The
driver is held to ``tests/test_banded_batch.py``'s rolled-kernel
tolerances.

Split over this file (the plain chunk) and ``test_torch_banded_rolled_driver.py``
(the kernel rule, the wrappers' width guard and the driver), so that two
test workers carry them; their helpers are in
``torch_banded_rolled_cases.py``.
"""

import numpy as np
import pytest
import torch

from optimal_control_problem_tpu_torch.ops import banded_kernel as bk
from optimal_control_problem_tpu_torch.ops import banded_rolled_kernel as brk
from tests.test_torch_banded_kernel import ATOL, RTOL, SET, assert_chunk_close, chunk_case, port
from torch_banded_rolled_cases import WIDE_ATOL, WIDE_RTOL, cr1_of, run_jax_rolled, to_f64
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize(
    "N,w,r,it0,done0,interval,max_iter",
    [
        (6, 4, 3, None, None, 40, 40),  # two-way only
        (16, 4, 3, None, None, 40, 40),  # depth-1 CR level on
        (17, 4, 3, None, None, 40, 40),  # odd horizon: plain two-way
        (16, 4, 3, [0, 20, 0], [0, 0, 1], 30, 40),  # it0 near max_iter, one frozen
        (4, 16, 12, None, None, 10, 10),  # quadrotor width, two-way
    ],
)
def test_rolled_plain_matches_pallas_interpret(N, w, r, it0, done0, interval, max_iter):
    st = port(SET).replace(eps_abs=0.0, eps_rel=0.0, max_iter=max_iter,
                           adaptive_rho=False, check_every=5)
    args, kw = chunk_case(st, it0=it0, done0=done0, N=N, w=w, r=r)
    kw["interval"] = interval
    ours = brk.banded_admm_chunk_rolled_plain(*args, **kw, cr1=cr1_of(N))
    ref = run_jax_rolled(args, kw)
    if w == 16:
        assert_chunk_close(ours, ref, WIDE_ATOL, WIDE_RTOL)
        f64 = brk.banded_admm_chunk_rolled_plain(*to_f64(args), **kw, cr1=cr1_of(N))
        for a, b in zip(ours[:7], f64[:7]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=WIDE_ATOL / 2, rtol=WIDE_RTOL)
    else:
        assert_chunk_close(ours, ref)
    if done0 is not None:
        assert int(ours[8][2]) == 0 and np.isinf(ours[9][2].item())
        assert int(ours[8][1]) == 20  # froze at max_iter mid-chunk


def test_rolled_plain_quadrotor_width_cr1():
    """w=16, r=12 with the CR level (N=16): the quadrotor's block shapes."""
    st = port(SET).replace(eps_abs=0.0, eps_rel=0.0, max_iter=10,
                           adaptive_rho=False, check_every=5)
    args, kw = chunk_case(st, seeds=(0,), N=16, w=16, r=12)
    ours = brk.banded_admm_chunk_rolled_plain(*args, **kw, cr1=True)
    assert_chunk_close(ours, run_jax_rolled(args, kw), WIDE_ATOL, WIDE_RTOL)
    f64 = brk.banded_admm_chunk_rolled_plain(*to_f64(args), **kw, cr1=True)
    for a, b in zip(ours[:7], f64[:7]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=WIDE_ATOL / 2, rtol=WIDE_RTOL)


@pytest.mark.parametrize("N", [6, 16])
def test_rolled_plain_converging_matches_pallas_interpret(N):
    # At the reference's tolerance 1e-3 (see test_torch_banded_kernel).
    st = port(SET).replace(adaptive_rho=False, max_iter=200, check_every=5,
                           eps_abs=1e-3, eps_rel=1e-3)
    args, kw = chunk_case(st, seeds=(4, 5, 6), N=N)
    ours = brk.banded_admm_chunk_rolled_plain(*args, **kw, cr1=cr1_of(N))
    ref = run_jax_rolled(args, kw)
    np.testing.assert_array_equal(ours[7].numpy(), np.asarray(ref[7]))
    np.testing.assert_array_equal(ours[8].numpy(), np.asarray(ref[8]))
    assert bool((ours[7] == 1).all())
    for i, (a, b) in enumerate(zip(ours[:7], ref[:7])):
        atol, rtol = (1e-3, 1e-2) if i in (1, 2, 3) else (ATOL, RTOL)  # y: dual tolerance
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=rtol)


def test_cr1_level_is_exact():
    """The depth-1 CR level is an exact elimination: with and without it
    the plain chunk agrees to f32 roundoff under a forced budget."""
    st = port(SET).replace(eps_abs=0.0, eps_rel=0.0, max_iter=30,
                           adaptive_rho=False, check_every=5)
    args, kw = chunk_case(st, N=16)
    a = brk.banded_admm_chunk_rolled_plain(*args, **kw, cr1=True)
    b = brk.banded_admm_chunk_rolled_plain(*args, **kw, cr1=False)
    c = bk.banded_admm_chunk_plain(*args, **kw)
    for u, v, t in zip(a[:7], b[:7], c[:7]):
        torch.testing.assert_close(u, v, atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(u, t, atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="even horizon"):
        args17, kw17 = chunk_case(st, N=17)
        brk.banded_admm_chunk_rolled(*args17, **kw17, cr1=True)


def test_rolled_wrapper_takes_plain_version_for_cpu_tensors():
    st = port(SET).replace(eps_abs=0.0, eps_rel=0.0, max_iter=10, adaptive_rho=False)
    args, kw = chunk_case(st, N=8)
    before = brk.banded_admm_chunk_rolled.launches
    a = brk.banded_admm_chunk_rolled(*args, **kw, cr1=False)
    b = brk.banded_admm_chunk_rolled_plain(*args, **kw, cr1=False)
    assert brk.banded_admm_chunk_rolled.launches == before  # no launch on the CPU
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    meta = [
        {k: v.to("meta") for k, v in x.items()} if isinstance(x, dict) else x.to("meta")
        for x in args
    ]
    with pytest.raises(ValueError, match="unsupported device"):
        brk.banded_admm_chunk_rolled(*meta, **kw, cr1=False)
