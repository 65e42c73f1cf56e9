#!/usr/bin/env python
"""Cart-pole swing-up with merit-function line search, on the PyTorch port.

The twin of ``examples/cartpole_swingup.py`` on ``optimal_control_problem_tpu_torch``:
the opt-in step-size rule (``SQP_settings.line_search: merit``) makes each
SQP iteration take the largest of ``ls_num`` candidate steps that improves
an L1 exact-penalty merit, against the reference's fixed damped update.
Each tick's QPs run as one dense batch-of-one solve (no stage structure).

Run: python examples/torch/cartpole_swingup.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

from optimal_control_problem_tpu_torch.controller import MPCController
from optimal_control_problem_tpu_torch.models import cartpole
from optimal_control_problem_tpu_torch.models.cartpole import cartpole_accel


def simulate(ticks=60, line_search="merit", step_num=6, device="cuda"):
    """The swing-up loop on ``device``; returns the pole angle after each
    tick, ``(ticks,)``."""
    H, dt = 20, 0.04
    sqp = {"alpha": 0.3, "step_num": step_num}
    if line_search != "none":
        sqp.update({"line_search": line_search, "ls_num": 8, "ls_alpha_max": 1.0})
    cfg = cartpole.make_config(
        horizon=H, dt=dt, formulation="reduced", SQP_settings=sqp,
        ADMM_settings={"method": "condensed", "max_iter": 500},
    )
    ocp = cartpole.build(cfg, device=device)
    ctl = MPCController(ocp, control_slice=slice(4, 5))

    # Plant state: x dx th dth (th=0 hanging down, target pi = upright).
    s = np.array([0.0, 0.0, 0.2, 0.0])
    ref = np.array([np.pi])
    ths = []
    for _ in range(ticks):
        frame = np.array([s[0], s[1], s[2], s[3], 0.0])
        u = float(ctl.step(frame, ref)[0])
        # Integrate the true nonlinear plant (euler at dt).
        ddx, ddth = cartpole_accel(s[1], s[2], s[3], u, device=device)
        s = s + dt * np.array([s[1], float(ddx), s[3], float(ddth)])
        ths.append(s[2])
    return np.array(ths)


def run(ticks=60, device="cuda", out=print):
    """Both loops; returns ``(th_merit, th_fixed, err_merit, err_fixed)``,
    the angles after each tick and the final angle errors it prints."""
    th_merit = simulate(ticks, line_search="merit", device=device)
    th_fixed = simulate(ticks, line_search="none", device=device)
    err_m = abs(np.pi - th_merit[-1])
    err_f = abs(np.pi - th_fixed[-1])
    out(f"final angle error after {len(th_merit)} ticks "
        f"(target pi): merit={err_m:.3f} rad, fixed alpha=0.3: {err_f:.3f} rad")
    out(f"merit-LS trajectory (every 10 ticks): "
        f"{np.round(th_merit[::10], 2).tolist()}")
    return th_merit, th_fixed, err_m, err_f


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
