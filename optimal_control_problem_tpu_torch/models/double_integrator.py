"""Double-integrator point-mass tracking — port of
``optimal_control_problem_tpu/models/double_integrator.py``.

A 2-D point mass with per-step fields ``pos(2), vel(2), acc(2)`` (frame
size 6, flat ``X = [frame_0; ...; frame_{H-1}]``), explicit-Euler dynamics
as equality constraints between consecutive frames, and a
position-tracking + effort cost.  Quadratic cost and linear dynamics: the
solver detects the shared system and the batch runs on one factorization
(``solvers/admm_batched.py``).  Every function is written with torch ops.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..problem import OptimalControlProblem, SolverSettings

FRAME = 6  # pos(2) vel(2) acc(2)
CONTROL_SLICE = slice(4, 6)  # control entries within one frame


def make_config(
    horizon: int = 20,
    dt: float = 0.005,
    solve_method: str = "TPU_SQP",
    v_max: float = 10.0,
    a_max: float = 50.0,
    alpha: float = 0.5,
    step_num: int = 10,
    **solver_overrides: Any,
) -> Dict[str, Any]:
    """Reference-schema YAML-equivalent config mapping."""
    settings = SolverSettings.default_node(solve_method)
    settings["SQP_settings"] = {"alpha": alpha, "step_num": step_num}
    settings.update(solver_overrides)
    return {
        "discretization_settings": {"dt": dt, "horizon": horizon},
        "solver_settings": settings,
        "OCP_variables": [
            {
                "name": "pos",
                "size": 2,
                "lower_bound": ["-.inf", "-.inf"],
                "upper_bound": [".inf", ".inf"],
            },
            {
                "name": "vel",
                "size": 2,
                "lower_bound": [-v_max, -v_max],
                "upper_bound": [v_max, v_max],
            },
            {
                "name": "acc",
                "size": 2,
                "lower_bound": [-a_max, -a_max],
                "upper_bound": [a_max, a_max],
            },
        ],
    }


class DoubleIntegratorOCP(OptimalControlProblem):
    """Tracking OCP: min sum_k w_p |pos_k - ref_k|^2 + w_v |vel_k|^2 + w_u |acc_k|^2
    s.t. Euler dynamics, box bounds."""

    def __init__(
        self,
        config: Optional[Dict[str, Any]] = None,
        w_pos: float = 10.0,
        w_vel: float = 0.1,
        w_acc: float = 1e-3,
        device=None,
    ):
        if config is None:
            config = make_config()
        super().__init__(config, device=device)
        self.w_pos, self.w_vel, self.w_acc = w_pos, w_vel, w_acc
        H = self.ocp_config.get_horizon()
        # Reference signal: target positions for every step (H*2,)
        self.set_reference(H * 2)
        self.deploy_constraints_and_add_cost()

    def deploy_constraints_and_add_cost(self) -> None:
        cfg = self.ocp_config
        H, dt = cfg.get_horizon(), cfg.get_dt()
        w_pos, w_vel, w_acc = self.w_pos, self.w_vel, self.w_acc

        def cost(X, P):
            fr = X.reshape(H, FRAME)
            ref = P.reshape(H, 2)
            pos, vel, acc = fr[:, 0:2], fr[:, 2:4], fr[:, 4:6]
            return (
                w_pos * torch.sum(torch.square(pos - ref))
                + w_vel * torch.sum(torch.square(vel))
                + w_acc * torch.sum(torch.square(acc))
            )

        self.add_scalar_cost(cost)

        def dynamics(X, P):
            fr = X.reshape(H, FRAME)
            pos, vel, acc = fr[:, 0:2], fr[:, 2:4], fr[:, 4:6]
            pos_next = pos[:-1] + dt * vel[:-1]
            vel_next = vel[:-1] + dt * acc[:-1]
            res_p = fr[1:, 0:2] - pos_next
            res_v = fr[1:, 2:4] - vel_next
            return torch.cat([res_p.reshape(-1), res_v.reshape(-1)])

        self.add_equation_constraint("dynamics", dynamics)


def build(config: Optional[Dict[str, Any]] = None, device=None, **kw) -> DoubleIntegratorOCP:
    """Build the double-integrator OCP on ``device`` (default: the GPU) and
    generate its solver."""
    ocp = DoubleIntegratorOCP(config, device=device, **kw)
    ocp.gen_solver()
    return ocp


def initial_state(pos=(0.0, 0.0), vel=(0.0, 0.0), acc=(0.0, 0.0)) -> np.ndarray:
    return np.concatenate([np.asarray(pos), np.asarray(vel), np.asarray(acc)])


def reference_circle(
    horizon: int, dt: float, t0: float = 0.0, radius: float = 1.0, omega: float = 1.0
) -> np.ndarray:
    """Target positions along a circle, one per step."""
    t = t0 + dt * np.arange(horizon)
    return np.stack([radius * np.cos(omega * t), radius * np.sin(omega * t)], axis=1).reshape(-1)
