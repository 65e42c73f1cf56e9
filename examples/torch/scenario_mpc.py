#!/usr/bin/env python
"""Scenario-consensus MPC across a mesh, on the PyTorch port.

The twin of ``examples/scenario_mpc.py`` on ``optimal_control_problem_tpu_torch``:
robust MPC under uncertainty -- sample B scenarios of the measured state
(sensor noise), solve all of them in one sharded batched SQP call, and
apply the consensus (mean over every scenario, a ``psum`` over the mesh)
first control.  The mesh holds ``--shards`` in-process shards on the one
device (default 8); under ``torchrun`` a ``torch.distributed`` mesh
(``make_mesh(devices="distributed")``) puts one shard on each rank.

Run: python examples/torch/scenario_mpc.py [--device cpu] [--shards 8]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

from optimal_control_problem_tpu_torch.models import double_integrator as di
from optimal_control_problem_tpu_torch.parallel import (
    BatchedSolver,
    DistributedSolver,
    make_mesh,
)


def run(ticks=50, batch=64, shards=8, device="cuda", out=print):
    """The consensus loop over ``ticks`` ticks, ``batch`` scenarios split
    over ``shards`` in-process shards on ``device``.  Returns
    ``(positions (ticks, 2), controls (ticks, 2))``: the plant's position
    and the consensus control after each tick (it prints every 10th).
    Fails unless the final position is within 0.5 of the target, the
    example's own gate."""
    H, dt = 10, 0.02
    B = batch  # scenarios (sharded over the mesh)
    noise = 0.05

    ocp = di.build(di.make_config(horizon=H, dt=dt, alpha=0.5, step_num=8), device=device)
    mesh = make_mesh(("batch",), shape=(shards,), devices=device)
    dist = DistributedSolver(BatchedSolver(ocp, device=device), mesh)
    out(f"devices: {dist.n_devices}, scenarios: {B}")

    rng = np.random.default_rng(0)
    pos = np.array([1.0, -0.5])
    vel = np.zeros(2)
    acc = np.zeros(2)
    target = np.zeros(2)
    refs = np.tile(np.tile(target, H)[None, :], (B, 1)).astype(np.float32)
    state = dist.init_state(B)
    positions, controls = [], []

    for tick in range(ticks):
        # Sample measurement scenarios around the nominal state.
        frames = np.tile(
            np.concatenate([pos, vel, acc])[None, :], (B, 1)
        ).astype(np.float32)
        frames[:, 0:4] += noise * rng.normal(size=(B, 4)).astype(np.float32)

        trajs, objs, state = dist.solve(frames, refs, state)
        # Consensus first control over ALL scenarios (psum over the mesh);
        # frame 0 is pinned, so the first free control is frame 1's.
        fs = di.FRAME
        u = dist.consensus_first_control(trajs[:, fs : 2 * fs], slice(4, 6)).cpu().numpy()

        pos = pos + dt * vel
        vel = vel + dt * u
        acc = u
        positions.append(pos)
        controls.append(u)
        if tick % 10 == 0:
            out(
                f"tick {tick:3d}  pos=({pos[0]:+.3f},{pos[1]:+.3f})  "
                f"|u|={np.linalg.norm(u):.2f}  err={np.linalg.norm(pos - target):.4f}"
            )

    assert np.linalg.norm(pos - target) < 0.5
    out("consensus MPC converged toward target")
    return np.array(positions), np.array(controls)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument("--shards", type=int, default=8,
                        help="in-process shards of the batch axis (default: 8)")
    args = parser.parse_args(argv)
    run(shards=args.shards, device=args.device)


if __name__ == "__main__":
    main()
