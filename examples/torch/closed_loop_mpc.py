#!/usr/bin/env python
"""Closed-loop MPC demo on the PyTorch port: double-integrator tracking a
circle.

The twin of ``examples/closed_loop_mpc.py`` on ``optimal_control_problem_tpu_torch``:
measure state -> compute_optimal_trajectory -> apply the first free
control -> advance the plant, at dt=0.005.  The QPs run on the
shared-factorization path (the double integrator is linear time-invariant).

Run: python examples/torch/closed_loop_mpc.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

from optimal_control_problem_tpu_torch.models import double_integrator as di


def run(ticks=200, horizon=20, device="cuda", out=print):
    """The closed loop at ``horizon`` over ``ticks`` ticks on ``device``.
    Returns ``(positions (ticks, 2), controls (ticks, 2), printed)``:
    the plant's positions and the applied controls after each tick, and
    the ``(t, x, y, err)`` of every printed line (every 20th tick)."""
    H, dt = horizon, 0.005
    cfg = di.make_config(horizon=H, dt=dt, alpha=0.5, step_num=10)
    ocp = di.build(cfg, device=device)

    pos = np.array([1.5, 0.0])
    vel = np.zeros(2)
    acc = np.zeros(2)
    positions, controls, printed = [], [], []
    for tick in range(ticks):
        t = tick * dt
        ref = di.reference_circle(H, dt, t0=t)
        frame = np.concatenate([pos, vel, acc])
        ocp.compute_optimal_trajectory(frame, ref)
        plan = ocp.get_optimal_frames()
        # Frame 0 is fully pinned (including control); apply the first FREE
        # control, frame 1's.
        u = np.asarray(plan[1, 4:6], dtype=np.float64)
        pos = pos + dt * vel
        vel = vel + dt * u
        acc = u
        positions.append(pos)
        controls.append(u)
        if tick % 20 == 0:
            target = ref[:2]
            err = np.linalg.norm(pos - target)
            printed.append((t, pos[0], pos[1], err))
            out(f"t={t:6.3f}s  pos=({pos[0]:+.3f},{pos[1]:+.3f})  err={err:.4f}")
    return np.array(positions), np.array(controls), printed


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
