"""The five hand kernels as ``torch.library`` custom ops, and the
device-side forms of the three batch drivers that reach them.

* Each op (``ocp_torch::banded_admm_chunk``, ``..._rolled`` with and
  without its CR level, ``..._cr``, ``shared_admm_chunk`` at each
  ``iter_precision``, ``admm_device_loop``) passes ``torch.library.opcheck``
  (schema, fake implementation, autograd registration, AOT dispatch) on a
  running call and on a call whose scenarios all enter frozen (the plain
  version then returns its inputs; the op returns copies).  On CPU tensors
  the op equals its plain version bitwise.
* Each driver's ``on_device`` form (the loop over chunks or rounds as a
  ``torch.while_loop``, the loop conditions on the device) gives the host
  loop's iterates, flags and iteration counts bitwise under a forced budget
  (a negative ``eps_abs``: no residual meets it), with and without adaptive
  rho: the banded batch on each of its three chunk kernels (and with
  ``polish=True``, whose batched polish both forms end with), the LTI batch
  on the shared chunk (``"pallas"``, both forms of B3) and on the
  ``"xla"`` loop, the dense batch on the device loop and on ``"xla"``.

The export round trips of the solves built on these forms are in
``test_torch_export_{solves,dense,rolled,cr,lti,xla}.py``.
"""

import numpy as np
import pytest
import torch

from optimal_control_problem_tpu_torch.ops import admm_kernel as ak
from optimal_control_problem_tpu_torch.ops import banded_cr_kernel as bck
from optimal_control_problem_tpu_torch.ops import banded_kernel as bk
from optimal_control_problem_tpu_torch.ops import banded_rolled_kernel as brk
from optimal_control_problem_tpu_torch.ops import shared_kernel as sk
from optimal_control_problem_tpu_torch.solvers import admm_banded_batch as abb
from optimal_control_problem_tpu_torch.solvers import admm_batched as ab
from optimal_control_problem_tpu_torch.solvers.admm import (
    ADMMSettings,
    admm_solve_batch,
    prepare_dense,
)
from optimal_control_problem_tpu_torch.solvers.admm_banded import BandedQP
from torch_threads import one_torch_thread  # noqa: F401

FORCED = dict(eps_abs=-1.0, eps_rel=0.0, max_iter=60, check_every=5, adaptive_rho_interval=15)


def f32(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def banded_qp(B=3, N=6, w=5, r=4, r2=1, seed=0):
    """A random batch of stage-structured QPs (batch-leading): SPD stage
    Hessians, dynamics rows pinned to 0, loose-ish boxes."""
    g = np.random.default_rng(seed)
    Hb = g.normal(size=(B, N, w, w))
    Hb = Hb @ Hb.transpose(0, 1, 3, 2) + np.eye(w)
    m = N * w + (N - 1) * r + N * r2
    lo = -np.abs(g.normal(size=(B, m))) - 0.1
    hi = np.abs(g.normal(size=(B, m))) + 0.1
    lo[:, N * w:N * w + (N - 1) * r] = hi[:, N * w:N * w + (N - 1) * r] = 0.0
    return BandedQP(f32(Hb), f32(g.normal(size=(B, N - 1, r, w))),
                    f32(g.normal(size=(B, N - 1, r, w))), f32(g.normal(size=(B, N, r2, w))),
                    f32(g.normal(size=(B, N * w))), f32(lo), f32(hi))


def shared_qp(B=4, n=8, m=12, seed=0):
    g = np.random.default_rng(seed)
    M = g.normal(size=(n, n))
    lo = -np.abs(g.normal(size=(B, m)))
    hi = np.abs(g.normal(size=(B, m)))
    lo[:, :3] = hi[:, :3] = 0.1
    return (f32(M @ M.T + np.eye(n)), f32(g.normal(size=(m, n))), f32(g.normal(size=(B, n))),
            f32(lo), f32(hi))


def dense_qp(B=4, n=8, m=12, seed=0):
    g = np.random.default_rng(seed)
    M = g.normal(size=(B, n, n))
    lo = -np.abs(g.normal(size=(B, m)))
    hi = np.abs(g.normal(size=(B, m)))
    lo[:, :3] = hi[:, :3] = 0.1
    return (f32(M @ M.transpose(0, 2, 1) + np.eye(n)), f32(g.normal(size=(B, n))),
            f32(g.normal(size=(B, m, n))), f32(lo), f32(hi))


# ---- the ops --------------------------------------------------------------


BANDED = {
    "one-way": ("banded_admm_chunk", bk.banded_admm_chunk_plain, 5, {}),
    "rolled": ("banded_admm_chunk_rolled", brk.banded_admm_chunk_rolled_plain, 7,
               {"cr1": False}),
    "rolled-cr1": ("banded_admm_chunk_rolled", brk.banded_admm_chunk_rolled_plain, 7,
                   {"cr1": True}),
    "cr": ("banded_admm_chunk_cr", bck.banded_admm_chunk_cr_plain, 7, {}),
}


def banded_call(w, frozen, N=6):
    st = ADMMSettings(method="banded", adaptive_rho=False, **FORCED)
    qpT = BandedQP(*(abb._t(a) for a in banded_qp(w=w, N=N)))
    prob = abb.prepare_banded_batch_T(qpT, st)
    B = qpT.Hb.shape[-1]
    stop = torch.full((B,), frozen, dtype=torch.bool)
    args, kw = abb.chunk_inputs(prob, st, torch.zeros(B, dtype=torch.int32), stop,
                                prob.x, prob.y, prob.z, prob.rho)
    inputs, _ = bk.chunk_contract("test", *args, kw["check_every"])
    return args, kw, inputs


@pytest.mark.parametrize("frozen", [False, True], ids=["running", "frozen"])
@pytest.mark.parametrize("kind", list(BANDED))
def test_banded_chunk_ops(kind, frozen):
    name, plain, w, flags = BANDED[kind]
    args, kw, inputs = banded_call(w, frozen)
    op = getattr(torch.ops.ocp_torch, name).default
    scalars = bk.chunk_scalars(**kw) + tuple(flags.values())
    torch.library.opcheck(op, (inputs, *scalars))
    out = op(inputs, *scalars)
    ref = plain(*args, **kw, **flags)
    assert len(out) == len(ref) == 13
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
        assert all(o.untyped_storage().data_ptr() != i.untyped_storage().data_ptr()
                   for i in inputs)
    if frozen:
        assert out[8].tolist() == [0, 0, 0]  # it_inc: no check block ran


def shared_call(frozen, precision):
    P, A, q, lo, hi = shared_qp()
    st = ADMMSettings(method="condensed", backend="pallas", adaptive_rho=False,
                      iter_precision=precision, **FORCED)
    fac = ab.prepare_shared(P, A, lo, hi, q, st)
    _, _, _, qb, lb, ub, x, z, y = ab._scaled_start(fac, q, lo, hi, None, None, "highest")
    B = q.shape[0]
    args = (torch.full((B,), int(frozen), dtype=torch.int32), torch.tensor(20),
            fac.OP.contiguous(), fac.Ab, fac.Pb, fac.rho_v, lb, ub, qb, 1.0 / fac.D, 1.0 / fac.E,
            (1.0 / fac.c).reshape(1), x, z, y)
    kw = dict(check_every=5, sigma=1e-6, alpha=1.6, eps_abs=-1.0, eps_rel=0.0, batch_tile=2,
              iter_precision=precision)
    return args, kw


@pytest.mark.parametrize("frozen", [False, True], ids=["running", "frozen"])
@pytest.mark.parametrize("precision", sk.ITER_PRECISIONS)
def test_shared_chunk_op(precision, frozen):
    args, kw = shared_call(frozen, precision)
    op = torch.ops.ocp_torch.shared_admm_chunk.default
    scalars = (kw["check_every"], kw["sigma"], kw["alpha"], kw["eps_abs"], kw["eps_rel"],
               kw["batch_tile"], precision, None)
    torch.library.opcheck(op, (*args, *scalars))
    out = op(*args, *scalars)
    ref = sk.shared_admm_chunk_plain(*args[:1], 20, *args[2:], **kw)
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    # The wrapper takes the budget as an int or as a 0-d tensor alike.
    for bound in (20, torch.tensor(20, dtype=torch.int32)):
        via = sk.shared_admm_chunk(args[0], bound, *args[2:], **kw)
        assert all(torch.equal(o, r) for o, r in zip(via, ref))
    assert out[4].tolist() == ([0] * 4 if frozen else [20] * 4)


@pytest.mark.parametrize("frozen", [False, True], ids=["running", "frozen"])
def test_device_loop_op(frozen):
    P, q, A, lo, hi = dense_qp()
    st = ADMMSettings(method="condensed", backend="pallas")
    prep = prepare_dense(P, q, A, torch.minimum(lo, hi), hi, st)
    B = q.shape[0]
    ops = [t.contiguous() for t in (prep.OP, prep.Ab, prep.Pb, prep.qb, prep.lb, prep.ub,
                                    prep.rho_v, 1.0 / prep.D, 1.0 / prep.E, 1.0 / prep.c)]
    x0, y0 = torch.zeros(B, 8), torch.zeros(B, 12)
    # A budget of 0 runs no check block: the plain version returns x0, y0.
    max_iter = 0 if frozen else 40
    args = (*ops, 1e-6, 1.6, -1.0, 0.0, x0, y0, max_iter, 5)
    op = torch.ops.ocp_torch.admm_device_loop.default
    torch.library.opcheck(op, args)
    out = op(*args)
    ref = ak.admm_device_loop_plain(*ops, 1e-6, 1.6, -1.0, 0.0, x0, y0, max_iter=max_iter,
                                    check_every=5)
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    assert out[3].tolist() == [max_iter] * B


def test_ops_are_registered_with_both_devices_and_no_mutation():
    for name in ("banded_admm_chunk", "banded_admm_chunk_rolled", "banded_admm_chunk_cr",
                 "shared_admm_chunk", "admm_device_loop"):
        op = getattr(torch.ops.ocp_torch, name).default
        assert not any(a.alias_info is not None and a.alias_info.is_write
                       for a in op._schema.arguments), name
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), key), (name, key)


# ---- the device-side driver forms -----------------------------------------


def assert_same(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("adaptive", [False, True], ids=["constant-rho", "adaptive-rho"])
@pytest.mark.parametrize("kernel", ["one-way", "rolled", "cr"])
def test_banded_batch_on_device_equals_host_loop(kernel, adaptive):
    st = ADMMSettings(method="banded", adaptive_rho=adaptive,
                      banded_solver="cr" if kernel == "cr" else "thomas", **FORCED)
    qp = banded_qp()
    rolled = True if kernel == "rolled" else None
    host = abb.admm_solve_banded_batch(qp, st, device="cpu", rolled=rolled)
    dev = abb.admm_solve_banded_batch(qp, st, device="cpu", rolled=rolled, on_device=True)
    assert_same(host, dev)
    assert host.iters.tolist() == [60] * 3


def test_banded_batch_on_device_polish_equals_host_polish():
    """``polish=True``: both forms end with the same batched polish pass."""
    st = ADMMSettings(method="banded", polish=True, **FORCED)
    host = abb.admm_solve_banded_batch(banded_qp(), st, device="cpu")
    dev = abb.admm_solve_banded_batch(banded_qp(), st, device="cpu", on_device=True)
    assert_same(host, dev)
    assert host.iters.tolist() == [60] * 3


@pytest.mark.parametrize("adaptive", [False, True], ids=["constant-rho", "adaptive-rho"])
@pytest.mark.parametrize("loop", ["pallas-highest", "pallas-high", "pallas-mixed", "xla",
                                  "xla-fused-gemm"])
def test_lti_batch_on_device_equals_host_loop(loop, adaptive):
    backend, _, rest = loop.partition("-")
    kw = {"iter_precision": rest} if backend == "pallas" else {"fused_gemm": bool(rest)}
    st = ADMMSettings(method="condensed", backend=backend, adaptive_rho=adaptive, **kw,
                      **FORCED)
    P, A, q, lo, hi = shared_qp()
    fac = ab.prepare_shared(P, A, lo, hi, q, st)
    before = ab._admm_iterate_fused.chunks
    host = ab.admm_iterate_prepared(fac, q, lo, hi, st)
    chunks = ab._admm_iterate_fused.chunks - before
    dev = ab.admm_iterate_prepared(fac, q, lo, hi, st, on_device=True)
    assert_same(host, dev)
    assert int(host.iters) == 60
    if backend == "pallas":
        # Adaptation points at 15, 30, 45 (each a check block's end), then
        # the rest of the budget; without adaptive rho one chunk.
        assert chunks == (4 if adaptive else 1)


@pytest.mark.parametrize("budget", ["forced", "eps-1e-3"])
@pytest.mark.parametrize("adaptive", [False, True], ids=["constant-rho", "adaptive-rho"])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_dense_batch_on_device_equals_host_loop(backend, adaptive, budget):
    """Also where the scenarios converge at their own counts (the device
    loop's rounds then end at different entries)."""
    eps = {"eps_abs": 1e-3, "eps_rel": 1e-3, "max_iter": 300} if budget == "eps-1e-3" else {}
    st = ADMMSettings(method="condensed", backend=backend, adaptive_rho=adaptive,
                      **{**FORCED, **eps})
    P, q, A, lo, hi = dense_qp()
    host = admm_solve_batch(P, q, A, lo, hi, st)
    dev = admm_solve_batch(P, q, A, lo, hi, st, on_device=True)
    assert_same(host, dev)
    if eps:
        assert bool(host.converged.all()) and len(set(host.iters.tolist())) > 1
    else:
        assert host.iters.tolist() == [60] * 4
