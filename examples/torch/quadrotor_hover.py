#!/usr/bin/env python
"""Quadrotor-12D horizon-100 trajectory optimization on the PyTorch port
(BASELINE config 4).

The twin of ``examples/quadrotor_hover.py`` on ``optimal_control_problem_tpu_torch``:
a stage-structured problem (per-stage derivatives under ``torch.func``)
solved by the per-scenario block-tridiagonal (banded) ADMM, with no dense
operator at n = 1600; then the KKT quality of the last plan.

Run: python examples/torch/quadrotor_hover.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

from optimal_control_problem_tpu_torch.models import quadrotor
from optimal_control_problem_tpu_torch.utils.diagnostics import kkt_residuals


def run(horizon=100, ticks=4, device="cuda", out=print):
    """``ticks`` solves of the hover problem at ``horizon`` on ``device``.
    Returns ``(plan (horizon, 16), errors (ticks,), stats)``: the last
    plan's frames, the terminal position error it prints each tick, and the
    KKT quality numbers of the last plan.  Fails unless the constraint
    violation is below 0.05, the example's own gate."""
    H = horizon
    cfg = quadrotor.make_config(
        horizon=H,
        dt=0.02,
        alpha=0.3,
        step_num=5,
        formulation="reduced",
        ADMM_settings={"method": "banded", "max_iter": 250},
    )
    ocp = quadrotor.build(cfg, stagewise=True, device=device)
    out(f"variables: {ocp.ocp_config.num_variables}, constraints: {ocp.num_constraints}")

    frame = quadrotor.initial_state(pos=(0.5, -0.3, 0.8))
    target = (0.0, 0.0, 1.0)
    ref = quadrotor.reference_hover(H, target)
    errors = []
    for tick in range(ticks):
        ocp.compute_optimal_trajectory(frame, ref)
        plan = ocp.get_optimal_frames()
        err = np.linalg.norm(plan[-1, 0:3] - np.asarray(target))
        errors.append(err)
        out(f"tick {tick}: terminal position error {err:.4f}")

    f_fn, g_fn = ocp.nlp_functions
    cfg_ = ocp.ocp_config
    lbx = cfg_.lower_bounds_flat().copy()
    ubx = cfg_.upper_bounds_flat().copy()
    lbx[: quadrotor.FRAME] = frame
    ubx[: quadrotor.FRAME] = frame
    stats = kkt_residuals(
        f_fn,
        g_fn,
        ocp.get_optimal_trajectory(),
        ref,
        lbx,
        ubx,
        ocp.get_constraint_lower_bounds(),
        ocp.get_constraint_upper_bounds(),
    )
    out(f"solution quality: { {k: round(v, 5) for k, v in stats.items()} }")
    assert stats["constraint_violation"] < 0.05
    return plan, np.array(errors), stats


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
