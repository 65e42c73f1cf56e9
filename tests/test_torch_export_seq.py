"""``export_solver`` of the sequence-parallel solves (``parallel/seq_admm.py``,
``parallel/seq_sqp.py``) over an in-process mesh, against the direct call
and against the JAX package's export of the same call.

JAX exports ``sqp_solve_seq_parallel`` and ``admm_solve_seq_parallel``
whole (one ``jit`` of a ``shard_map``); the port's direct calls read their
loop conditions on the host, so each function carries an ``export_form``
(its loops as device-side ``while_loop``s, ``on_device=True``) that
``export_solver`` finds through the ``functools.partial`` a user writes
for JAX.  JAX runs on its 8 virtual CPU devices, the port on the
in-process mesh of the same layout (``interop.mesh_from_jax_layout``).

* The device form equals the host form bitwise, with the same iteration
  counts and flags: ``admm_solve_seq_parallel`` on a random stage QP
  (N=16, w=4 over ``"h"`` of 8) with constant and with adaptive rho (four
  rho rounds) and under a forced budget (a negative ``eps_abs``: 50
  iterations), ``sqp_solve_seq_parallel`` on ``tests/test_seq_sqp.py``'s
  cart-pole h16 over ``"h"`` of 8 (2 SQP iterations) and over the
  ``("b", "h")`` mesh (2, 4) at B=4 (one iteration), each from the pinned
  frames held over the horizon.
* The reloaded program equals the direct call (iteration counts and flags
  exactly, iterates within 1e-5) and JAX's reloaded artifact of the same
  call (JAX's called under the mesh's sharding) within 5e-3 with the same
  ADMM iterations: ``admm_solve_seq_parallel`` on the QP above (without
  the infeasibility certificates), and
  ``sqp_solve_seq_parallel`` on the cart-pole over ``"h"`` of 8, one SQP
  iteration from the pinned frame held over the horizon (350 ADMM
  iterations; the trace unrolls the SQP iterations, ~30 s each here).
* Over a ``torch.distributed`` mesh (one gloo rank, as phase 7d sets one
  up) the same two calls export one program a rank, which reloads and
  equals the direct call (two ranks: ``test_torch_export_dist.py``).
"""

import dataclasses
import functools
import socket

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from optimal_control_problem_tpu.parallel import make_mesh as jmake_mesh
from optimal_control_problem_tpu.parallel.seq_admm import ShardedBandedQP as JShardedBandedQP
from optimal_control_problem_tpu.parallel.seq_admm import (
    admm_solve_seq_parallel as jadmm_solve_seq_parallel,
)
from optimal_control_problem_tpu.parallel.seq_sqp import sqp_solve_seq_parallel as jseq_sqp
from optimal_control_problem_tpu.utils import serialization as jser
from optimal_control_problem_tpu_torch.interop import (
    mesh_from_jax_layout,
    settings_from_jax_dict,
    sharded_banded_qp_from_numpy,
)
from optimal_control_problem_tpu_torch.models import cartpole as tcp
from optimal_control_problem_tpu_torch.parallel import (
    initialize_distributed,
    make_mesh,
    sqp_solve_seq_parallel,
)
from optimal_control_problem_tpu_torch.parallel.seq_admm import admm_solve_seq_parallel
from optimal_control_problem_tpu_torch.utils.serialization import (
    export_solver,
    import_solver,
    rank_path,
)
from test_seq_admm import SET, random_stage_qp, to_sharded
from test_seq_sqp import ADMM, ALPHA, DT, H, problem
from torch_threads import one_torch_thread  # noqa: F401

ADAPTIVE = SET.replace(adaptive_rho=True, adaptive_rho_interval=50, rho=1e-3)
FORCED = SET.replace(max_iter=50, eps_abs=-1.0)
# The ADMM round trip leaves the certificates out (a fifth of its trace);
# the SQP round trip's program holds them.
NO_CERT = SET.replace(check_infeasibility=False)


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(("h",))


@pytest.fixture(scope="module")
def mesh(jmesh):
    return mesh_from_jax_layout(jmesh.shape, device="cpu")


def sharded_qp():
    """The random stage QP in both packages' sharded layout."""
    sq = to_sharded(random_stage_qp(4, 16, 4, 3, 1))
    return sq, sharded_banded_qp_from_numpy({k: np.asarray(v) for k, v in sq._asdict().items()},
                                            device="cpu")


def sqp_inputs(B=None, hold=False):
    """The port's stage structure and ``(x0, ref, lx, ux)`` of the cart-pole
    h16 (numpy), ``x0`` zero or (``hold``) the pinned frame at every
    stage; with ``B``, B scenarios with their own first frames."""
    _, lx, ux, ref = problem()
    ss = dataclasses.replace(tcp.stage_structure(H, DT), ref_frame_size=1)
    if B is None:
        x0 = np.tile(lx[:1], (H, 1)) if hold else np.zeros((H, tcp.FRAME), np.float32)
        return ss, (x0, ref, lx, ux)
    lxb, uxb = np.tile(lx[None], (B, 1, 1)), np.tile(ux[None], (B, 1, 1))
    for b in range(B):
        lxb[b, 0] = uxb[b, 0] = tcp.initial_state(th=0.2 + 0.1 * b).astype(np.float32)
    x0 = np.tile(lxb[:, :1], (1, H, 1)) if hold else np.zeros((B, H, tcp.FRAME), np.float32)
    return ss, (x0, np.tile(ref[None], (B, 1, 1)), lxb, uxb)


def assert_same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("st,iters", [(SET, 25), (ADAPTIVE, 75), (FORCED, 50)],
                         ids=["constant-rho", "adaptive-rho", "forced-budget"])
def test_admm_device_form_equals_host_form(st, iters, mesh):
    _, tq = sharded_qp()
    ts = settings_from_jax_dict(dataclasses.asdict(st))
    host = admm_solve_seq_parallel(tq, ts, mesh=mesh, axis="h")
    dev = admm_solve_seq_parallel(tq, ts, mesh=mesh, axis="h", on_device=True)
    assert_same(host, dev)
    assert int(host[1]) == iters and bool(host[2]) == (st is not FORCED)


@pytest.mark.parametrize("layout", ["h8", "b2h4"])
def test_sqp_device_form_equals_host_form(layout, jmesh):
    if layout == "h8":
        ss, args = sqp_inputs(hold=True)
        kw = dict(sqp_iters=2, mesh=mesh_from_jax_layout(jmesh.shape, device="cpu"))
    else:
        ss, args = sqp_inputs(B=4, hold=True)
        kw = dict(sqp_iters=1, batch_axis="b", mesh=mesh_from_jax_layout(
            jmake_mesh(("b", "h"), shape=(2, 4)).shape, device="cpu"))
    fn = functools.partial(sqp_solve_seq_parallel, ss, *(torch.tensor(a) for a in args),
                           alpha=ALPHA, admm=settings_from_jax_dict(dataclasses.asdict(ADMM)),
                           axis="h", **kw)
    host, dev = fn(), fn(on_device=True)
    assert_same(host, dev)
    assert host[1].shape[-1] == kw["sqp_iters"]


def jax_reloaded(tmp_path, fn, args, jmesh):
    """JAX's artifact of ``fn`` at ``args``, reloaded and called under the
    mesh's sharding (replicated inputs)."""
    path = tmp_path / "jax.bin"
    jser.export_solver(fn, args, str(path))
    call = jser.import_solver(str(path))
    rep = NamedSharding(jmesh, P())
    return [np.asarray(o) for o in jax.jit(call, in_shardings=(rep,) * len(args))(*args)]


def test_admm_export_round_trip(tmp_path, jmesh, mesh):
    sq, tq = sharded_qp()
    fn = functools.partial(admm_solve_seq_parallel,
                           settings=settings_from_jax_dict(dataclasses.asdict(NO_CERT)),
                           mesh=mesh, axis="h")
    export_solver(fn, (tq,), str(tmp_path / "admm.pt2"))
    out = import_solver(str(tmp_path / "admm.pt2"))(tq)
    direct = fn(tq)
    assert all(torch.equal(a, b) for a, b in zip(out[1:], direct[1:]))
    np.testing.assert_allclose(out[0].numpy(), direct[0].numpy(), atol=1e-5)
    jout = jax_reloaded(
        tmp_path, lambda *f: jadmm_solve_seq_parallel(JShardedBandedQP(*f), NO_CERT,
                                                      mesh=jmesh, axis="h"),
        tuple(np.asarray(a) for a in sq), jmesh)
    assert [int(v) for v in out[1:]] == [int(v) for v in jout[1:]]
    np.testing.assert_allclose(out[0].numpy(), jout[0], atol=5e-3)


def test_sqp_export_round_trip(tmp_path, jmesh, mesh):
    ss, args = sqp_inputs(hold=True)
    fn = functools.partial(sqp_solve_seq_parallel, ss, sqp_iters=1, alpha=ALPHA,
                           admm=settings_from_jax_dict(dataclasses.asdict(ADMM)), mesh=mesh,
                           axis="h")
    targs = tuple(torch.tensor(a) for a in args)
    export_solver(fn, targs, str(tmp_path / "sqp.pt2"))
    out = import_solver(str(tmp_path / "sqp.pt2"))(*targs)
    direct = fn(*targs)
    assert torch.equal(out[1], direct[1]) and torch.equal(out[2], direct[2])
    np.testing.assert_allclose(out[0].numpy(), direct[0].numpy(), atol=1e-5)
    jss, *_ = problem()
    jout = jax_reloaded(tmp_path, functools.partial(
        jseq_sqp, jss, sqp_iters=1, alpha=ALPHA, admm=ADMM, mesh=jmesh, axis="h"), args, jmesh)
    np.testing.assert_array_equal(out[1].numpy(), jout[1])
    np.testing.assert_array_equal(out[2].numpy(), jout[2])
    assert out[1].tolist() == [350] and bool(out[2][0, 0])
    np.testing.assert_allclose(out[0].numpy(), jout[0], atol=5e-3)


def test_export_round_trips_over_torch_distributed(tmp_path):
    """The same two calls over a ``torch.distributed`` mesh of one gloo rank
    (as phase 7d of ``chip_smoke.py`` sets one up): each rank's program
    (``rank_path``) reloads and equals the direct call."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    initialize_distributed(f"127.0.0.1:{port}", 1, 0, device="cpu")
    try:
        mesh_d = make_mesh(("h",), devices="distributed")
        ss, args = sqp_inputs()
        fn = functools.partial(sqp_solve_seq_parallel, ss, sqp_iters=1, alpha=ALPHA,
                               admm=settings_from_jax_dict(dataclasses.asdict(ADMM)),
                               mesh=mesh_d, axis="h")
        targs = tuple(torch.tensor(a) for a in args)
        path = str(tmp_path / "d.pt2")
        assert export_solver(fn, targs, path) == rank_path(path, 0, 1)
        out, direct = import_solver(path)(*targs), fn(*targs)
        assert torch.equal(out[1], direct[1]) and torch.equal(out[2], direct[2])
        np.testing.assert_allclose(out[0].numpy(), direct[0].numpy(), atol=1e-5)
        _, tq = sharded_qp()
        fn = functools.partial(admm_solve_seq_parallel, settings=SET, mesh=mesh_d)
        path = str(tmp_path / "a.pt2")
        export_solver(fn, (tq,), path)
        out, direct = import_solver(path)(tq), fn(tq)
        assert all(torch.equal(a, b) for a, b in zip(out[1:], direct[1:]))
        np.testing.assert_allclose(out[0].numpy(), direct[0].numpy(), atol=1e-5)
    finally:
        torch.distributed.destroy_process_group()
