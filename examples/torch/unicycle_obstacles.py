#!/usr/bin/env python
"""Unicycle waypoint tracking with half-space obstacle constraints, on the
PyTorch port.

The twin of ``examples/unicycle_obstacles.py`` on ``optimal_control_problem_tpu_torch``:
the robot tracks a reference that drifts through the keep-out half-space
``y <= 0.3`` (``(0, -1) . (x, y) >= -0.3``, registered with
``add_inequality_constraint``), and the closed-loop path must respect it.
The stage structure makes ``gen_solver`` pick the banded QP path.

Run: python examples/torch/unicycle_obstacles.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

from optimal_control_problem_tpu_torch.controller import MPCController
from optimal_control_problem_tpu_torch.models import unicycle


def run(ticks=80, horizon=30, device="cuda", out=print):
    """The closed loop at ``horizon`` over ``ticks`` ticks on ``device``.
    Returns ``(states (ticks, 5), controls (ticks, 2), max_y)``: the plant
    state and the applied ``(v, om)`` after each tick, and the largest y it
    prints.  Fails unless the banded path was picked and y stays below
    0.35, the example's own gates."""
    H, dt = horizon, 0.05
    # Keep-out: require  (0, -1) . (x, y) >= -0.3  <=>  y <= 0.3.
    halfspaces = (((0.0, -1.0), -0.3),)
    cfg = unicycle.make_config(horizon=H, dt=dt, alpha=0.4, step_num=8)
    ocp = unicycle.build(cfg, halfspaces=halfspaces, stagewise=True, device=device)
    assert ocp._solver.options.admm.method == "banded"  # auto-selected
    ctl = MPCController(ocp, control_slice=slice(3, 5))

    s = unicycle.initial_state(y=-0.2)
    max_y = -np.inf
    states, controls = [], []
    for tick in range(ticks):
        t = tick * dt
        # Reference drifts upward, trying to drag the robot into y > 0.3.
        tt = t + dt * np.arange(H)
        ref = np.stack([tt, 0.2 + 0.5 * tt], axis=1).reshape(-1)
        u = ctl.step(np.asarray(s, np.float64), ref)
        v, om = float(u[0]), float(u[1])
        x, y, th = s[0], s[1], s[2]
        s = np.array([x + dt * v * np.cos(th), y + dt * v * np.sin(th),
                      th + dt * om, v, om])
        max_y = max(max_y, s[1])
        states.append(s)
        controls.append((v, om))
        if tick % 16 == 0:
            out(f"t={t:5.2f}s  pos=({s[0]:+.2f},{s[1]:+.2f})  "
                f"v={v:+.2f} om={om:+.2f}")
    out(f"max y over the run: {max_y:.3f} (keep-out starts at 0.3)")
    assert max_y < 0.35, "obstacle constraint violated"
    return np.array(states), np.array(controls), max_y


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
