#!/usr/bin/env python
"""Sequence-parallel MPC on the PyTorch port: the horizon sharded across a
mesh.

The twin of ``examples/seq_parallel_mpc.py`` on ``optimal_control_problem_tpu_torch``:
the cart-pole swing-up with its trajectory stages split over a scenarios x
horizon 2-D mesh, then over a 1-D horizon mesh -- the OCP analog of data x
context parallelism.  :class:`HorizonShardedSolver` derives the stage
structure, bounds, pinning and settings from the built OCP.  The meshes
hold ``--shards`` in-process shards on the one device (default 8; the
layouts are the original's for that many devices, in its order).

Run: python examples/torch/seq_parallel_mpc.py [--device cpu] [--shards 8]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

from optimal_control_problem_tpu_torch.models import cartpole
from optimal_control_problem_tpu_torch.parallel import HorizonShardedSolver, make_mesh


def build_ocp(H, DT, device="cuda"):
    return cartpole.build(
        cartpole.make_config(
            horizon=H,
            dt=DT,
            alpha=0.3,
            step_num=6,
            # Round-based distributed rho adaptation recovers from a poor
            # rho start (each round refactorizes the SPIKE partition).
            ADMM_settings={
                "method": "banded",
                "eps_abs": 1e-3,
                "eps_rel": 1e-3,
                "adaptive_rho": True,
                "rho": 0.05,
                "max_iter": 2000,
            },
        ),
        stagewise=True,
        device=device,
    )


def run(horizon=16, shards=8, device="cuda", out=print):
    """Both layouts at ``horizon`` over ``shards`` shards on ``device``.
    Returns ``(xb, traj, qp_iters)``: the 2-D mesh's four scenario
    trajectories ``(4, horizon, 5)`` (None where ``shards`` is odd or below
    4), the 1-D solve's trajectory ``(horizon, 5)`` and its ADMM
    iterations per SQP step, which it prints."""
    H, DT = horizon, 0.04
    n_dev = shards
    out(f"devices: {n_dev}, horizon: {H} ({H // n_dev} stages/device)")
    ocp = build_ocp(H, DT, device)
    ref = np.array([np.pi])

    xb = None
    if n_dev % 2 == 0 and n_dev >= 4:
        B = 4
        mesh2 = make_mesh(("b", "h"), shape=(2, n_dev // 2), devices=device)
        sharded2 = HorizonShardedSolver(ocp, mesh2, axis="h", batch_axis="b")
        frames = np.stack(
            [cartpole.initial_state(th=0.2 + 0.15 * b) for b in range(B)]
        )
        xb = sharded2.compute_optimal_trajectory(
            frames, np.tile(ref[None], (B, 1))
        ).cpu().numpy()
        out(
            f"2-D (scenarios x horizon) mesh {dict(mesh2.shape)}: "
            f"result {xb.shape}, finite={np.isfinite(xb).all()}"
        )

    n_sub = max(2, n_dev // 2)
    mesh = make_mesh(("h",), shape=(n_sub,), devices=device)
    sharded = HorizonShardedSolver(ocp, mesh)
    traj = sharded.compute_optimal_trajectory(cartpole.initial_state(th=0.5), ref).cpu().numpy()
    stats = sharded.get_solver_stats()
    out(
        f"1-D horizon-sharded solve over {n_sub} devices: "
        f"finite={np.isfinite(traj).all()}, "
        f"th range [{traj[:, 2].min():+.2f}, {traj[:, 2].max():+.2f}], "
        f"ADMM iters/SQP step: {stats['qp_iters']}"
    )
    return xb, traj, stats["qp_iters"]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument("--shards", type=int, default=8,
                        help="in-process shards (default: 8)")
    args = parser.parse_args(argv)
    run(shards=args.shards, device=args.device)


if __name__ == "__main__":
    main()
