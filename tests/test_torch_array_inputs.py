"""The port's public array functions take what the JAX package's take:
numpy arrays and Python sequences beside tensors (``device.as_tensors``),
and ``SQPResult`` has JAX's defaults for its four status fields.

Each case feeds the same float64 numpy arrays to the JAX function and to
the port's with ``device="cpu"``; JAX narrows them to float32
(``jnp.asarray`` with 64-bit types off) and so does the port.  Tolerances
are the existing f32 tests' for the same function: elementwise work
(equilibration, block factors) to rtol 1e-5; converged QPs to 2e-3 at eps
1e-4 (``tests/test_torch_admm.py``); forced budgets to the iterate
tolerances of ``tests/test_torch_admm_banded.py``.  The kernel wrappers'
layouts are the port's own, so each is held bitwise to itself on tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.ops import block_tridiag as jbt
from optimal_control_problem_tpu.parallel import make_mesh as jmake_mesh
from optimal_control_problem_tpu.parallel.dist import consensus_mean as jconsensus
from optimal_control_problem_tpu.parallel.horizon import horizon_sharded_solve as jhorizon
from optimal_control_problem_tpu.parallel.seq_admm import admm_solve_seq_parallel as jseq
from optimal_control_problem_tpu.solvers import admm as jadmm
from optimal_control_problem_tpu.solvers import admm_banded as jband
from optimal_control_problem_tpu.solvers import admm_banded_batch as jbb
from optimal_control_problem_tpu.solvers import admm_batched as jab
from optimal_control_problem_tpu.solvers.sqp import SQPResult as JResult
from optimal_control_problem_tpu_torch import SQPResult, admm_solve
from optimal_control_problem_tpu_torch.device import as_tensors
from optimal_control_problem_tpu_torch.ops import admm_kernel as ak
from optimal_control_problem_tpu_torch.ops import banded_cr_kernel as bck
from optimal_control_problem_tpu_torch.ops import banded_kernel as bk
from optimal_control_problem_tpu_torch.ops import banded_rolled_kernel as brk
from optimal_control_problem_tpu_torch.ops import block_tridiag as tbt
from optimal_control_problem_tpu_torch.ops import shared_kernel as sk
from optimal_control_problem_tpu_torch.parallel import make_mesh
from optimal_control_problem_tpu_torch.parallel.dist import consensus_mean
from optimal_control_problem_tpu_torch.parallel.horizon import horizon_sharded_solve
from optimal_control_problem_tpu_torch.parallel.seq_admm import (
    ShardedBandedQP,
    admm_solve_seq_parallel,
)
from optimal_control_problem_tpu_torch.solvers import admm as tadmm
from optimal_control_problem_tpu_torch.solvers import admm_banded as tband
from optimal_control_problem_tpu_torch.solvers import admm_banded_batch as tbb
from optimal_control_problem_tpu_torch.solvers import admm_batched as tab
from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings
from tests.test_admm_banded import random_stage_qp
from tests.test_seq_admm import random_stage_qp as seq_stage_qp
from tests.test_seq_admm import to_sharded
from tests.test_torch_admm import random_qp
from torch_threads import one_torch_thread  # noqa: F401

CPU = dict(device="cpu")
JSET = jadmm.ADMMSettings(eps_abs=1e-4, eps_rel=1e-4)
TSET = ADMMSettings(eps_abs=1e-4, eps_rel=1e-4)
BANDED = dict(method="banded", eps_abs=0.0, eps_rel=0.0, max_iter=100,
              check_infeasibility=False, scaling_iters=10)


def close(ours, ref, **tol):
    np.testing.assert_allclose(torch.as_tensor(ours).numpy(), np.asarray(ref), **tol)


def np_banded(seed, **kw):
    """A float64 numpy stage QP (fields as in JAX's ``BandedQP``)."""
    return {k: np.asarray(v, np.float64) for k, v in random_stage_qp(seed, **kw)._asdict().items()}


# -- the rule itself -------------------------------------------------------


def test_as_tensors_follows_jax_dtype_rule_and_devices(monkeypatch):
    f, i, b, s, none = as_tensors(np.eye(2), np.arange(3), np.ones(2, bool), [1.5, 2.5], None,
                                  **CPU)
    assert (f.dtype, i.dtype, b.dtype, s.dtype) == (
        torch.float32, torch.int32, torch.bool, torch.float32)
    assert none is None and all(t.device.type == "cpu" for t in (f, i, b, s))
    for a, t in zip((np.eye(2), np.arange(3), [1.5, 2.5]), (f, i, s)):
        assert jnp.asarray(a).dtype == np.dtype(str(t.dtype).removeprefix("torch."))
    # A tensor keeps its device and dtype; the rest follow its device.
    t64 = torch.ones(2, dtype=torch.float64)
    kept, moved = as_tensors(t64, np.ones(2))
    assert kept is t64 and moved.device == t64.device and moved.dtype == torch.float32
    # The caller's numpy is copied, never shared.
    a = np.ones(3, np.float32)
    as_tensors(a, **CPU)[0].add_(1.0)
    assert (a == 1.0).all()
    # No tensor and no device: cuda, and an error without one.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        as_tensors(np.ones(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        admm_solve(*random_qp(0))


# -- dense QPs (solvers/admm.py) -------------------------------------------


def test_admm_solve_and_batch_take_numpy():
    P, q, A, l, u = random_qp(1)
    ref = jadmm.admm_solve(P, q, A, l, u, JSET)
    sol = admm_solve(P, q, A, l, u, TSET, **CPU)
    assert sol.x.dtype == torch.float32 and bool(sol.converged) and bool(ref.converged)
    close(sol.x, ref.x, atol=2e-3)
    close(sol.y, ref.y, atol=2e-3)
    # Python sequences, and a tensor that sets the device for the rest.
    again = admm_solve(torch.as_tensor(P, dtype=torch.float32), q.tolist(), A.tolist(), l, u,
                       TSET)
    assert torch.equal(again.x, sol.x)
    # The batch: the port's jax.vmap(admm_solve).
    qps = [random_qp(s) for s in (2, 3)]
    stacked = [np.stack(f) for f in zip(*qps)]
    jref = jax.vmap(lambda *a: jadmm.admm_solve(*a, JSET))(*stacked)
    tsol = tadmm.admm_solve_batch(*stacked, TSET, **CPU)
    close(tsol.x, jref.x, atol=2e-3)
    assert tsol.iters.shape == (2,)


def test_ruiz_equilibrate_takes_numpy():
    P, q, A, _, _ = random_qp(5)
    ref = jadmm.ruiz_equilibrate(P, q, A, 10)
    ours = tadmm.ruiz_equilibrate(P, q, A, 10, **CPU)
    for a, b in zip(ours, ref):
        close(a, b, rtol=1e-5, atol=1e-7)


def test_shared_factor_functions_take_numpy():
    P, q, A, l, u = random_qp(6)
    qs = np.stack([q, -q])
    ls, us = np.stack([l, l]), np.stack([u, u])
    ref = jab.admm_solve_shared(P, A, qs, ls, us, JSET)
    sol = tab.admm_solve_shared(P, A, qs, ls, us, TSET, **CPU)
    close(sol.x, ref.x, atol=2e-3)
    fac = tab.prepare_shared(P, A, ls, us, qs, TSET, **CPU)
    jfac = jab.prepare_shared(P, A, ls, us, qs, JSET)
    close(fac.D, jfac.D, rtol=1e-5)
    # The factor's device carries the numpy arrays of the iteration.
    again = tab.admm_iterate_prepared(fac, qs, ls, us, TSET)
    assert torch.equal(again.x, sol.x)


# -- banded QPs (solvers/admm_banded*.py) ----------------------------------


def test_banded_functions_take_numpy():
    qp = np_banded(0)
    jqp, tqp = jband.BandedQP(**qp), tband.BandedQP(**qp)
    scaled, D, E, c = tband.ruiz_equilibrate_banded(tqp, 10, **CPU)
    jscaled, jD, jE, jc = jband.ruiz_equilibrate_banded(jqp, 10)
    for a, b in zip(scaled, jscaled):
        close(a, b, rtol=1e-5, atol=1e-6)
    close(D, jD, rtol=1e-5)
    jst = jadmm.ADMMSettings(**BANDED)
    ref = jband.admm_solve_banded(jqp, jst)
    sol = tband.admm_solve_banded(tqp, ADMMSettings(**BANDED), **CPU)
    assert int(sol.iters) == int(ref.iters) == 100
    close(sol.x, ref.x, atol=2e-4, rtol=1e-3)
    # Residuals and certificates on numpy iterates (JAX's own take jnp
    # arrays only: their stage products update in place with ``.at``).
    n, m = qp["q"].shape[0], qp["l"].shape[0]
    rng = np.random.default_rng(0)
    x, z, y = rng.normal(size=n), rng.normal(size=m), rng.normal(size=m)
    Dn, En = np.asarray(jD, np.float64), np.asarray(jE, np.float64)
    j = jnp.asarray
    jres = jband.banded_residuals(jscaled, j(x), j(z), j(y), j(1 / En), j(1 / Dn),
                                  1 / float(jc), jst)
    tres = tband.banded_residuals(tband.BandedQP(*(np.asarray(a) for a in jscaled)), x, z, y,
                                  1 / En, 1 / Dn, 1 / float(jc), ADMMSettings(**BANDED), **CPU)
    for a, b in zip(tres, jres):
        close(a, b, rtol=1e-5)
    jcert = jband.banded_certificates(jband.BandedQP(*map(j, jqp)), j(x), j(y), j(Dn), j(En),
                                      1 / float(jc), jst)
    tcert = tband.banded_certificates(tqp, x, y, Dn, En, 1 / float(jc), ADMMSettings(**BANDED),
                                      **CPU)
    assert [bool(a) for a in tcert] == [bool(a) for a in jcert]


def test_banded_batch_functions_take_numpy():
    qps = [np_banded(s) for s in (1, 2)]
    batch = {k: np.stack([q[k] for q in qps]) for k in qps[0]}
    jqp, tqp = jband.BandedQP(**batch), tband.BandedQP(**batch)
    for a, b in zip(tbb.ruiz_scalings_batch(tqp, 10, **CPU), jbb.ruiz_scalings_batch(jqp, 10)):
        close(a, b, rtol=1e-5)
    ref = jbb.admm_solve_banded_batch(jqp, jadmm.ADMMSettings(**BANDED))
    sol = tbb.admm_solve_banded_batch(tqp, ADMMSettings(**BANDED), **CPU)
    assert sol.iters.tolist() == np.asarray(ref.iters).tolist()
    close(sol.x, ref.x, atol=2e-4, rtol=1e-3)


# -- block-tridiagonal solves (ops/block_tridiag.py) -----------------------


def test_block_tridiag_functions_take_numpy():
    N, w = 5, 3
    rng = np.random.default_rng(4)
    L = rng.normal(size=(N, w, w))
    diag = L @ np.swapaxes(L, -1, -2) + 6 * np.eye(w)
    lower = 0.3 * rng.normal(size=(N - 1, w, w))
    b = rng.normal(size=(N, w))
    close(tbt.small_spd_inv(diag, **CPU), jbt.small_spd_inv(diag), rtol=1e-5, atol=1e-7)
    fac, jfac = tbt.btd_factor(diag, lower, **CPU), jbt.btd_factor(diag, lower)
    close(fac.dinv, jfac.dinv, rtol=1e-5, atol=1e-7)
    close(tbt.btd_solve(fac, b), jbt.btd_solve(jfac, b), rtol=1e-5, atol=1e-6)
    close(tbt.btd_matvec(diag, lower, b, **CPU), jbt.btd_matvec(diag, lower, b), rtol=1e-5,
          atol=1e-6)
    M = np.zeros((N * w, N * w))
    for k in range(N):
        M[k * w:(k + 1) * w, k * w:(k + 1) * w] = diag[k]
    for a, c in zip(tbt.dense_to_blocks(M, N, w, **CPU), jbt.dense_to_blocks(M, N, w)):
        close(a, c, rtol=0)


# -- the multi-device paths (parallel/) ------------------------------------


def test_parallel_functions_take_numpy():
    N, w = 16, 3
    rng = np.random.default_rng(2)
    L = rng.normal(size=(N, w, w))
    diag = L @ np.swapaxes(L, -1, -2) + 2 * w * np.eye(w)
    lower = np.zeros((N, w, w))
    lower[1:] = 0.4 * rng.normal(size=(N - 1, w, w))
    b = rng.normal(size=(N, w))
    jmesh = jmake_mesh(("h",), devices=jax.devices()[:4])
    mesh = make_mesh(("h",), shape=(4,), devices="cpu")
    close(horizon_sharded_solve(diag, lower, b, mesh=mesh),
          jhorizon(diag, lower, b, mesh=jmesh), rtol=3e-4, atol=3e-4)
    vals = rng.normal(size=(8, 2))
    close(consensus_mean(vals, make_mesh(("batch",), shape=(8,), devices="cpu")),
          jconsensus(vals, jmake_mesh(("batch",))), rtol=1e-6)
    # A sharded QP's numpy fields, under a forced budget.
    jqp = to_sharded(seq_stage_qp(3, N=8, w=3, r=2, r2=1))
    npqp = [np.asarray(a, np.float64) for a in jqp]
    st = dict(method="banded", eps_abs=0.0, eps_rel=0.0, max_iter=50, adaptive_rho=False,
              check_infeasibility=False)
    jx, jits, *_ = jseq(type(jqp)(*npqp), jadmm.ADMMSettings(**st), mesh=jmesh, axis="h")
    x, its, *_ = admm_solve_seq_parallel(ShardedBandedQP(*npqp), ADMMSettings(**st),
                                         mesh=make_mesh(("h",), shape=(4,), devices="cpu"))
    assert int(its) == int(jits) == 50
    close(x, jx, atol=2e-4, rtol=1e-3)


# -- the kernel wrappers (ops/*_kernel.py): numpy equals tensors -----------


def numpy_args(args):
    return [{k: v.numpy() for k, v in a.items()} if isinstance(a, dict) else a.numpy()
            for a in args]


def assert_same(a, b):
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("wrapper", ["one_way", "rolled", "cr"])
def test_banded_chunk_wrappers_take_numpy(wrapper):
    from tests.test_torch_banded_kernel import SET, chunk_case, port

    st = port(SET).replace(eps_abs=0.0, eps_rel=0.0, max_iter=20, adaptive_rho=False)
    args, kw = chunk_case(st)
    fn = {"one_way": bk.banded_admm_chunk, "rolled": brk.banded_admm_chunk_rolled,
          "cr": bck.banded_admm_chunk_cr}[wrapper]
    if wrapper == "rolled":
        kw["cr1"] = False
    assert_same(fn(*numpy_args(args), **kw, **CPU), fn(*args, **kw))


def test_shared_chunk_and_device_loop_wrappers_take_numpy():
    from tests.test_torch_shared import KW, chunk_inputs, factors, problem

    prob = problem(B=4)
    jfac, _ = factors(prob)
    args = [np.asarray(a) for a in chunk_inputs(jfac, prob)]
    done0 = np.zeros(4, np.int32)
    ours = sk.shared_admm_chunk(done0, 50, *args, batch_tile=4, **KW, **CPU)
    assert_same(ours, sk.shared_admm_chunk(torch.as_tensor(done0), 50,
                                           *(torch.as_tensor(a) for a in args),
                                           batch_tile=4, **KW))
    from tests.test_torch_admm_kernel import jax_prep, random_qp as dense_qp, stack, warm

    prep = jax_prep(*stack([dense_qp(s) for s in range(2)]))
    x0, y0 = warm(prep, 0)
    loop = [prep["OP"], prep["Ab"], prep["Pb"], prep["qb"], prep["lb"], prep["ub"],
            prep["rho_v"], 1.0 / prep["D"], 1.0 / prep["E"], 1.0 / prep["c"]]
    scal = (1e-6, 1.6, 1e-4, 1e-4)
    ours = ak.admm_device_loop(*loop, *scal, x0, y0, max_iter=50, **CPU)
    assert_same(ours, ak.admm_device_loop(*(torch.as_tensor(a) for a in loop), *scal,
                                          torch.as_tensor(x0), torch.as_tensor(y0),
                                          max_iter=50))


# -- C5: SQPResult's defaults ----------------------------------------------


def test_sqp_result_from_its_first_seven_fields():
    fields = [np.zeros(2), 0.0, np.zeros(3), np.zeros(4), np.zeros(2), np.zeros(2, np.int32),
              np.zeros(2)]
    jr = JResult(*fields)
    tr = SQPResult(*(torch.as_tensor(a) for a in fields))
    for name in ("qp_converged", "qp_prim_inf", "qp_dual_inf", "steps_taken"):
        j, t = np.asarray(getattr(jr, name)), getattr(tr, name)
        assert tuple(t.shape) == j.shape and str(t.dtype).removeprefix("torch.") == str(j.dtype)
    assert tr._replace(steps_taken=torch.tensor(3, dtype=torch.int32)).steps_taken == 3
    assert SQPResult._fields == JResult._fields
