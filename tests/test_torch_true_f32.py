"""True float32 inside every solve entry point of the port, whatever the
caller set (``solvers/admm.f32_matmuls``, the JAX package's guard of the
same name).

The caller turns TF32 on (``torch.set_float32_matmul_precision("high")``
and cuDNN's switch).  Each entry point then runs under a
``TorchFunctionMode`` that reads the switches at every torch call it
makes.  At every product or factorization (the calls TF32 reaches:
matmul, einsum, linear algebra, ...) they must say true float32 (cuBLAS
``allow_tf32`` False, ``fp32_precision`` ``"ieee"`` where torch has it,
cuDNN off); the scope must show up in the reads even where a path makes
no product at these sizes (the banded solves' block products are
elementwise chains at w <= 8); and after the call the caller's settings
are back.  The switches act on the card only; the CPU run checks that
the scope is in force where the solver computes.  ``chip_smoke.py``
phase 7e checks the bits on the card.
"""

import re

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from optimal_control_problem_tpu_torch.models import cartpole as tcp
from optimal_control_problem_tpu_torch.models import double_integrator as tdi
from optimal_control_problem_tpu_torch.parallel import (
    BatchedSolver,
    DistributedSolver,
    ShardedBandedQP,
    admm_solve_seq_parallel,
    horizon_sharded_solve,
    make_mesh,
)
from optimal_control_problem_tpu_torch.solvers.admm import (
    ADMMSettings,
    admm_solve,
    admm_solve_batch,
    f32_matmuls,
)
from optimal_control_problem_tpu_torch.solvers.admm_banded import BandedQP, admm_solve_banded
from optimal_control_problem_tpu_torch.solvers.qp_interface import TpuQP
from torch_threads import one_torch_thread  # noqa: F401


def switches():
    b = torch.backends
    out = {"cudnn": b.cudnn.allow_tf32}
    try:
        out["cublas"] = b.cuda.matmul.allow_tf32
    except RuntimeError:  # a mix of the two APIs: only the string is read
        out["cublas"] = None
    try:
        out["fp32_precision"] = b.cuda.matmul.fp32_precision
    except AttributeError:
        pass
    return out


PRODUCT = re.compile(r"matmul|^mm$|bmm|^mv$|^addm|einsum|tensordot|^dot$|linalg|solve|inv|conv")


class Recorder(TorchFunctionMode):
    """The switches at every torch call, and which calls are products."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        self.seen.append((bool(PRODUCT.search(name)), switches()))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def tf32_on():
    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    caller = switches()
    assert caller["cublas"] and caller["cudnn"]
    yield caller
    torch.set_float32_matmul_precision(saved[0])
    torch.backends.cudnn.allow_tf32 = saved[1]


def dense_qp():
    rng = np.random.default_rng(0)
    L = rng.normal(size=(4, 4))
    P = torch.tensor(L @ L.T + np.eye(4), dtype=torch.float32)
    A = torch.tensor(rng.normal(size=(3, 4)), dtype=torch.float32)
    return P, torch.ones(4), A, -torch.ones(3), torch.ones(3)


def banded_qp(N=8, w=3, r=2):
    rng = np.random.default_rng(1)
    Hb = torch.tensor(np.stack([np.eye(w) * 2.0 + 0.1 * rng.normal(size=(w, w)) for _ in range(N)]),
                      dtype=torch.float32)
    Hb = 0.5 * (Hb + Hb.transpose(-1, -2))
    J0 = torch.tensor(0.3 * rng.normal(size=(N - 1, r, w)), dtype=torch.float32)
    J1 = torch.tensor(0.3 * rng.normal(size=(N - 1, r, w)), dtype=torch.float32)
    m = N * w + (N - 1) * r
    return BandedQP(Hb, J0, J1, torch.zeros((N, 0, w)), torch.ones(N * w),
                    -2.0 * torch.ones(m), 2.0 * torch.ones(m))


def sharded_qp(N=8, w=3, r=2):
    qp = banded_qp(N, w, r)
    pad = lambda J: torch.cat([J, torch.zeros((1,) + J.shape[1:])])  # noqa: E731
    n = N * w
    ld = torch.cat([qp.l[n:].reshape(N - 1, r), torch.zeros(1, r)])
    return ShardedBandedQP(qp.Hb, pad(qp.J0), pad(qp.J1), qp.Jc, qp.q.reshape(N, w),
                           qp.l[:n].reshape(N, w), qp.u[:n].reshape(N, w), ld, -ld.clone() + 0.0,
                           torch.zeros((N, 0)), torch.zeros((N, 0)))


def cartpole_batch():
    cfg = tcp.make_config(horizon=4, dt=0.05, alpha=0.3, step_num=1,
                          ADMM_settings={"method": "banded", "max_iter": 50})
    ocp = tcp.build(cfg, stagewise=True, device="cpu")
    frames = np.stack([tcp.initial_state(th=0.2), tcp.initial_state(th=-0.1)])
    return ocp, frames, np.full((2, 1), np.pi)


# Each entry: a set-up (problem building, outside the check) returning
# the solve call the check runs.


def tpu_qp():
    P, q, A, l, u = (t.numpy() for t in dense_qp())
    qp = TpuQP(device="cpu")
    qp.set_dimension(4, 3)
    qp.set_hessian_matrix(P)
    qp.set_gradient(q)
    qp.set_linear_constraints_matrix(A)
    qp.set_lower_bound(l)
    qp.set_upper_bound(u)
    qp.init_solver()
    return qp.solve


def solve_fn():
    ocp, frames, refs = cartpole_batch()
    return lambda: ocp.compute_optimal_trajectory(frames[0], refs[0])


def batch():
    ocp, frames, refs = cartpole_batch()
    b = BatchedSolver(ocp, device="cpu")
    state = b.init_state(2)
    return lambda: b.solve(frames, refs, state)


def distributed():
    ocp = tdi.build(tdi.make_config(horizon=4, step_num=1), device="cpu")
    d = DistributedSolver(BatchedSolver(ocp, device="cpu"),
                          make_mesh(("batch",), shape=(2,), devices="cpu"))
    state = d.init_state(2)
    return lambda: d.solve(np.zeros((2, tdi.FRAME)), np.zeros((2, ocp.reference_size)), state)


def horizon():
    qp = sharded_qp()
    lower = torch.zeros_like(qp.Hb)
    lower[1:] = 0.1
    mesh = make_mesh(("h",), shape=(2,), devices="cpu")
    return lambda: horizon_sharded_solve(qp.Hb + 2 * torch.eye(3), lower, qp.q, mesh=mesh)


def seq_admm():
    qp, mesh = sharded_qp(), make_mesh(("h",), shape=(2,), devices="cpu")
    return lambda: admm_solve_seq_parallel(qp, ADMMSettings(max_iter=50), mesh=mesh)


ENTRY_POINTS = {
    "admm_solve": lambda: lambda: admm_solve(*dense_qp(), ADMMSettings(max_iter=50)),
    "admm_solve_batch": lambda: lambda: admm_solve_batch(*(t[None] for t in dense_qp()),
                                                         ADMMSettings(max_iter=50)),
    "admm_solve_banded": lambda: lambda: admm_solve_banded(banded_qp(), ADMMSettings(max_iter=50)),
    "TpuQP": tpu_qp,
    "solve_fn": solve_fn,
    "solve_batch_banded_fn": batch,
    "DistributedSolver": distributed,
    "horizon_sharded_solve": horizon,
    "admm_solve_seq_parallel": seq_admm,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_solve_keeps_true_f32_after_caller_enables_tf32(name, tf32_on):
    call = ENTRY_POINTS[name]()
    rec = Recorder()
    with rec:
        call()
    true_f32 = lambda s: (s["cublas"] is False and s["cudnn"] is False  # noqa: E731
                          and s.get("fp32_precision", "ieee") == "ieee")
    assert sum(true_f32(s) for _, s in rec.seen) > 10  # the scope was in force
    for product, s in rec.seen:
        if product:
            assert true_f32(s), s
    assert switches() == tf32_on  # the caller's settings are back


def test_guard_nests_and_decorates(tf32_on):
    @f32_matmuls
    def inner():
        return switches()

    with f32_matmuls():
        assert inner()["cublas"] is False
        assert switches()["cublas"] is False  # the outer scope survives the inner's exit
    assert switches() == tf32_on
