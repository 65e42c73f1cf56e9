"""``export_solver`` / ``import_solver`` over a ``torch.distributed`` mesh: one
program a rank, as JAX's export of a ``shard_map`` program covers the whole
mesh.

Two gloo worker processes (importing no JAX) join a world of two ranks,
build a mesh over it and export, each its own program (``rank_path``):

* ``admm_solve_seq_parallel`` on ``test_torch_export_seq.py``'s random stage
  QP (N=16, w=4) over ``"h"`` of the two ranks, without the certificates;
* ``DistributedSolver.solve_jit``, the cart-pole h8 B=4 tick of
  ``torch_dist_cases.py`` over the two ranks (two scenarios a rank through
  B1's op);
* ``horizon_sharded_solve`` on ``test_torch_distributed_init.py``'s system
  (N=16, w=4), which has no loop to put on the device.

Then they leave the world, join a new one, build the same mesh and
solvers, and ``import_solver`` each rank's program.  Each reloaded program
equals its direct call: the ADMM iterations and flags exactly and the
iterate within 1e-5, the tick and the SPIKE solve bitwise; its graphs hold
the functional collectives (``_c10d_functional``) and the tick's B1's op
node.  Against the JAX package: the ADMM program agrees with JAX's
reloaded artifact of the same call over a 2-device mesh within
``test_torch_export_seq.py``'s 5e-3 with the same ADMM iterations, and the
tick with JAX's exported ``solve_jit`` within 2e-3
(``test_torch_export_solves.py``'s bound).

In this process: the two-rank program does not load into a world of one
rank, nor into a process with no world, and a program whose group this
process lacks does not load (each a ``ValueError`` naming it, before any
collective); built again, the mesh gives the group back and the program
loads and equals its direct call.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.models import cartpole as jcp
from optimal_control_problem_tpu.parallel import BatchedSolver as JBatchedSolver
from optimal_control_problem_tpu.parallel import make_mesh as jmake_mesh
from optimal_control_problem_tpu.parallel.seq_admm import ShardedBandedQP as JShardedBandedQP
from optimal_control_problem_tpu.parallel.seq_admm import (
    admm_solve_seq_parallel as jadmm_solve_seq_parallel,
)
from optimal_control_problem_tpu.utils import serialization as jser
from optimal_control_problem_tpu_torch.parallel import initialize_distributed, make_mesh
from optimal_control_problem_tpu_torch.utils.serialization import (
    export_solver,
    import_solver,
    rank_path,
)
from test_seq_admm import SET, random_stage_qp, to_sharded
from test_torch_export_seq import jax_reloaded
from test_torch_horizon_sharding import random_system
from torch_dist_cases import cases
from torch_threads import one_torch_thread  # noqa: F401

NO_CERT = SET.replace(check_infeasibility=False)

WORKER = r"""
import functools, json, sys
import numpy as np
import torch
import torch.distributed as dist

from optimal_control_problem_tpu_torch.interop import (
    settings_from_jax_dict, sharded_banded_qp_from_numpy)
from optimal_control_problem_tpu_torch.parallel import (
    BatchedSolver, DistributedSolver, initialize_distributed, make_mesh)
from optimal_control_problem_tpu_torch.parallel.horizon import horizon_sharded_solve
from optimal_control_problem_tpu_torch.parallel.seq_admm import admm_solve_seq_parallel
from optimal_control_problem_tpu_torch.utils.serialization import export_solver, import_solver
from torch_dist_cases import cases

torch.set_num_threads(1)
coords, pid, out = sys.argv[1].split(","), int(sys.argv[2]), sys.argv[3]
data = np.load(f"{out}/qp.npz")
qp = sharded_banded_qp_from_numpy({k: data[k] for k in data.files}, device="cpu")
system = tuple(torch.tensor(np.load(f"{out}/system.npz")[k]) for k in ("diag", "lower", "b"))
settings = settings_from_jax_dict(json.load(open(f"{out}/settings.json")))
_, ocp, frames, refs = next(cases())  # the banded cart-pole h8, B=4
batched = BatchedSolver(ocp, device="cpu")
args = (torch.tensor(frames, dtype=batched.dtype), torch.tensor(refs, dtype=batched.dtype),
        *batched.init_state(frames.shape[0]))


def solves(coord):
    # Join a world of two ranks, build the mesh and the solves over it.
    initialize_distributed(coord, 2, pid, device="cpu")
    mesh = make_mesh(("h",), devices="distributed")
    return (("admm", functools.partial(admm_solve_seq_parallel, settings=settings, mesh=mesh,
                                       axis="h"), (qp,)),
            ("tick", DistributedSolver(batched, mesh, axis="h").solve_jit, args),
            ("spike", functools.partial(horizon_sharded_solve, mesh=mesh, axis="h"), system))


files = [export_solver(fn, fargs, f"{out}/{name}.pt2") for name, fn, fargs in solves(coords[0])]
dist.destroy_process_group()

res, nodes = {}, {}
for name, fn, fargs in solves(coords[1]):  # the loading processes' world
    loaded = import_solver(f"{out}/{name}.pt2")
    nodes[name] = sorted({str(n.target) for gm in loaded.modules()
                          if isinstance(gm, torch.fx.GraphModule) for n in gm.graph.nodes
                          if n.op == "call_function"})
    for which, run in (("direct", fn), ("loaded", loaded)):
        outs = run(*fargs)
        for i, t in enumerate(outs if isinstance(outs, (tuple, list)) else (outs,)):
            res[f"{name}_{which}_{i}"] = t.numpy()
dist.destroy_process_group()
np.savez(f"{out}/rank{pid}.npz", **res)
json.dump({"files": files, "nodes": nodes}, open(f"{out}/rank{pid}.json", "w"))
print(f"proc {pid} ok", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cartpole(module, **kw):
    """``torch_dist_cases.cases()``'s banded cart-pole h8 in ``module``."""
    return module.build(module.make_config(
        horizon=8, dt=0.04, alpha=0.3, step_num=2,
        ADMM_settings={"method": "banded", "max_iter": 200, "adaptive_rho": False,
                       "rho": 0.05, "check_every": 2}), stagewise=True, **kw)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results and graphs from the two worker processes, and
    JAX's side (computed while the workers run)."""
    out = tmp_path_factory.mktemp("export_dist")
    sq = to_sharded(random_stage_qp(4, 16, 4, 3, 1))
    np.savez(out / "qp.npz", **{k: np.asarray(v) for k, v in sq._asdict().items()})
    diag, lower, b, _ = random_system(4, 16, 4)
    np.savez(out / "system.npz", diag=diag, lower=lower, b=b)
    (out / "settings.json").write_text(json.dumps(dataclasses.asdict(NO_CERT)))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([repo, os.path.join(repo, "tests"),
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    coords = f"127.0.0.1:{_free_port()},127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, coords, str(pid), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=repo)
             for pid in range(2)]
    try:
        jmesh = jmake_mesh(("h",), devices=jax.devices()[:2])
        jadmm = jax_reloaded(
            out, lambda *f: jadmm_solve_seq_parallel(JShardedBandedQP(*f), NO_CERT, mesh=jmesh,
                                                     axis="h"),
            tuple(np.asarray(a) for a in sq), jmesh)
        jb = JBatchedSolver(_cartpole(jcp))
        _, _, frames, refs = next(cases())
        st = jb.init_state(frames.shape[0])
        jargs = (frames.astype(np.float32), refs.astype(np.float32), st.x, st.qp_x, st.qp_y)
        jser.export_solver(jb.solve_jit, jargs, str(out / "tick.bin"))
        jtick = [np.asarray(o) for o in jser.import_solver(str(out / "tick.bin"))(*jargs)]
        logs = []
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"proc {pid} ok" in log, f"proc {pid} failed:\n{log}"
    return {"out": out, "jadmm": jadmm, "jtick": jtick,
            "res": [dict(np.load(out / f"rank{pid}.npz")) for pid in range(2)],
            "meta": [json.loads((out / f"rank{pid}.json").read_text()) for pid in range(2)]}


def test_each_rank_writes_and_reloads_its_own_program(ranks):
    """Each rank's file, its collectives and B1's node; and
    ``horizon_sharded_solve`` (no loop), reloaded, equals its direct call
    bitwise on every rank."""
    out, names = ranks["out"], ("admm", "tick", "spike")
    for pid, (meta, res) in enumerate(zip(ranks["meta"], ranks["res"])):
        assert meta["files"] == [rank_path(str(out / f"{n}.pt2"), pid, 2) for n in names]
        for name in names:
            assert any(t.startswith("_c10d_functional.") for t in meta["nodes"][name]), name
        assert "ocp_torch.banded_admm_chunk.default" in meta["nodes"]["tick"]
        np.testing.assert_array_equal(res["spike_loaded_0"], res["spike_direct_0"])


def test_seq_admm_rank_programs_equal_direct_calls_and_jax(ranks):
    jx, *jflags = ranks["jadmm"]
    for res in ranks["res"]:
        for i in range(1, 5):  # iterations, converged, prim_inf, dual_inf
            np.testing.assert_array_equal(res[f"admm_loaded_{i}"], res[f"admm_direct_{i}"])
        np.testing.assert_allclose(res["admm_loaded_0"], res["admm_direct_0"], atol=1e-5)
        assert [int(res[f"admm_loaded_{i}"]) for i in range(1, 5)] == [int(v) for v in jflags]
        np.testing.assert_allclose(res["admm_loaded_0"], jx, atol=5e-3)
        # The same global solution on both ranks.
        np.testing.assert_array_equal(res["admm_loaded_0"], ranks["res"][0]["admm_loaded_0"])


def test_distributed_tick_rank_programs_equal_direct_calls_and_jax(ranks):
    for res in ranks["res"]:
        for i in range(4):  # x, f, qp_x, qp_y
            np.testing.assert_array_equal(res[f"tick_loaded_{i}"], res[f"tick_direct_{i}"])
        np.testing.assert_allclose(res["tick_loaded_0"], ranks["jtick"][0], atol=2e-3)
        assert np.isfinite(res["tick_loaded_0"]).all()


def _world_of_one():
    initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu")


def test_import_checks_world_size_and_groups(ranks, tmp_path):
    path = str(ranks["out"] / "admm.pt2")
    with pytest.raises(ValueError, match="world of 2 ranks.*joined no process group"):
        import_solver(path)
    _world_of_one()
    try:
        with pytest.raises(ValueError, match="world of 2 ranks.*rank 0 of a world of 1"):
            import_solver(path)
        # A program on an axis group of a 2-axis mesh: groups "1" ("b") and
        # "2" ("h"), made when the mesh is built.
        ax = make_mesh(("b", "h"), shape=(1, 1), devices="distributed").shards()
        toy = str(tmp_path / "toy.pt2")
        t = torch.arange(3, dtype=torch.float32).reshape(1, 3)
        written = export_solver(lambda v: (ax.psum(v, "h") * 2.0,), (t,), toy)
        assert written == rank_path(toy, 0, 1)
    finally:
        torch.distributed.destroy_process_group()
    _world_of_one()  # a new world, no mesh built: no group "2"
    try:
        with pytest.raises(ValueError, match=r"process groups '2' \(ranks \[0\]\).*build the same"):
            import_solver(toy)
        ax = make_mesh(("b", "h"), shape=(1, 1), devices="distributed").shards()
        assert torch.equal(import_solver(toy)(t)[0], ax.psum(t, "h") * 2.0)
    finally:
        torch.distributed.destroy_process_group()
