"""The port's multi-process start-up (``parallel/mesh.initialize_distributed``)
— mirrors ``tests/test_distributed_init.py``.

Two fresh CPU processes call ``initialize_distributed`` against one
coordinator (gloo, since they compute on the CPU), make a 2-shard mesh
over the process group, and run one ``psum`` (1 + 2 = 3 on both).  Then
both solve ``horizon_sharded_solve`` at D=2, one shard a rank.  Each
rank's result equals the in-process D=2 solve of the same system to f32
roundoff; the gap measured here is 0 (a sum of two shards does not
depend on the order, and each shard runs the same ops on the same data).
Last, ``DistributedSolver`` over the two ranks, each solving its half of
a B=4 batch: the banded cart-pole equals the unsharded batch to 1e-5
(1.43e-6 here: each scenario stops on its own, only the batch width of
the plain chunk's sums differs); the shared-factorization double
integrator, whose batch stops when every scenario has converged, votes
within each rank's slice and ends 2.29e-5 away (held to 5e-3).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

from optimal_control_problem_tpu_torch.parallel import BatchedSolver, make_mesh
from optimal_control_problem_tpu_torch.parallel.horizon import horizon_sharded_solve
from test_torch_horizon_sharding import random_system
from torch_dist_cases import cases
from torch_threads import one_torch_thread  # noqa: F401

WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

from optimal_control_problem_tpu_torch.parallel import initialize_distributed, make_mesh
from optimal_control_problem_tpu_torch.parallel.horizon import horizon_sharded_solve
from torch_dist_cases import cases

torch.set_num_threads(1)
coord, pid, data, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
initialize_distributed(coordinator_address=coord, num_processes=2, process_id=pid,
                       device="cpu")
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
mesh = make_mesh(("dcn",), devices="distributed")
assert mesh.shape == {"dcn": 2} and mesh.distributed
ax = mesh.shards()
local = ax.shard(torch.arange(2, dtype=torch.float32).reshape(2, 1) + 1.0, ("dcn",))
summed = ax.psum(local, "dcn")  # each rank holds one row: 1 + 2 = 3
assert float(summed.reshape(-1)[0]) == 3.0, summed
d = np.load(data)
x = horizon_sharded_solve(*(torch.tensor(d[k]) for k in ("diag", "lower", "b")),
                          mesh=mesh, axis="dcn")
np.save(out, x.numpy())

# DistributedSolver over the ranks: each solves its slice of the batch.
from optimal_control_problem_tpu_torch.parallel import BatchedSolver, DistributedSolver

for name, ocp, frames, refs in cases():
    dsol = DistributedSolver(BatchedSolver(ocp, device="cpu"), mesh, axis="dcn")
    x, _, _ = dsol.solve(frames, refs, dsol.init_state(frames.shape[0]))
    np.save(out.replace(".npy", f"_{name}.npy"), x.numpy())
dist.destroy_process_group()
print(f"proc {pid} ok", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_init(tmp_path):
    diag, lower, b, _ = random_system(4, 16, 4)
    data = tmp_path / "system.npz"
    np.savez(data, diag=diag, lower=lower, b=b)
    coord = f"127.0.0.1:{_free_port()}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([repo, os.path.join(repo, "tests"),
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    outs = [tmp_path / f"x{pid}.npy" for pid in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, coord, str(pid), str(data), str(outs[pid])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=repo,
        )
        for pid in range(2)
    ]
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(log)
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{log}"
        assert f"proc {pid} ok" in log, log

    x_local = horizon_sharded_solve(
        torch.tensor(diag), torch.tensor(lower), torch.tensor(b),
        mesh=make_mesh(("dcn",), shape=(2,), devices="cpu"), axis="dcn",
    ).numpy()
    for out in outs:
        np.testing.assert_array_equal(np.load(out), x_local)

    # DistributedSolver: each rank's slice against the unsharded batch.
    gaps = {}
    for name, ocp, frames, refs in cases():
        b = BatchedSolver(ocp, device="cpu")
        x_ref, _, _ = b.solve(frames, refs, b.init_state(frames.shape[0]))
        for out in outs:
            x = np.load(str(out).replace(".npy", f"_{name}.npy"))
            gaps[name] = float(np.abs(x - x_ref.numpy()).max())
    assert gaps["cartpole"] <= 1e-5, gaps
    # The shared-factorization batch stops when all its scenarios have
    # converged: a rank's slice stops on its own (2.29e-5 here).
    assert gaps["double_integrator"] <= 5e-3, gaps
