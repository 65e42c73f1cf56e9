"""Quadrotor 12-state trajectory optimization, nonlinear dynamics, horizon
100 — port of ``optimal_control_problem_tpu/models/quadrotor.py``.

Frame fields: position ``p(3)``, velocity ``v(3)``, Euler angles ``eul(3)``
(roll, pitch, yaw), body rates ``om(3)``, and controls ``u(4)`` = collective
thrust + body torques — frame size 16.  Dynamics are the standard
small-rigid-body model with an Euler-angle kinematic chain, discretized
with explicit Euler and imposed as equality constraints between
consecutive frames.  Every function is written with torch ops; constants
become tensors on the input's device and dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..problem import OptimalControlProblem, SolverSettings

FRAME = 16  # p(3) v(3) eul(3) om(3) u(4)
CONTROL_SLICE = slice(12, 16)  # control entries within one frame

MASS = 1.0
G = 9.81
INERTIA = np.array([0.01, 0.01, 0.02])


def make_config(
    horizon: int = 100,
    dt: float = 0.02,
    solve_method: str = "TPU_SQP",
    thrust_max: float = 30.0,
    torque_max: float = 1.0,
    alpha: float = 0.3,
    step_num: int = 10,
    **solver_overrides: Any,
) -> Dict[str, Any]:
    settings = SolverSettings.default_node(solve_method)
    settings["SQP_settings"] = {"alpha": alpha, "step_num": step_num}
    settings.update(solver_overrides)
    inf, ninf = ".inf", "-.inf"
    free = {"size": 3, "lower_bound": [ninf] * 3, "upper_bound": [inf] * 3}
    return {
        "discretization_settings": {"dt": dt, "horizon": horizon},
        "solver_settings": settings,
        "OCP_variables": [
            {"name": "p", **free},
            {"name": "v", **free},
            {"name": "eul", **free},
            {"name": "om", **free},
            {
                "name": "u",
                "size": 4,
                "lower_bound": [0.0, -torque_max, -torque_max, -torque_max],
                "upper_bound": [thrust_max, torque_max, torque_max, torque_max],
            },
        ],
    }


def quadrotor_derivatives(v, eul, om, u):
    """Continuous-time state derivatives for the 12-state model.

    ``v``: (..., 3) world velocity; ``eul``: (..., 3) roll/pitch/yaw;
    ``om``: (..., 3) body rates; ``u``: (..., 4) thrust + torques.
    """
    phi, th, psi = eul[..., 0], eul[..., 1], eul[..., 2]
    sph, cph = torch.sin(phi), torch.cos(phi)
    sth, cth = torch.sin(th), torch.cos(th)
    sps, cps = torch.sin(psi), torch.cos(psi)
    thrust = u[..., 0]
    # Body z-axis in world frame (ZYX rotation).
    zb = torch.stack(
        [
            cps * sth * cph + sps * sph,
            sps * sth * cph - cps * sph,
            cth * cph,
        ],
        dim=-1,
    )
    gravity = torch.tensor([0.0, 0.0, G], dtype=v.dtype, device=v.device)
    dv = (thrust[..., None] / MASS) * zb - gravity
    # Euler-angle rates from body rates (ZYX chain); keep pitch away from
    # +-pi/2 in practice.
    tth = torch.tan(th)
    p_, q_, r_ = om[..., 0], om[..., 1], om[..., 2]
    deul = torch.stack(
        [
            p_ + sph * tth * q_ + cph * tth * r_,
            cph * q_ - sph * r_,
            (sph * q_ + cph * r_) / torch.clamp(cth, min=1e-3),
        ],
        dim=-1,
    )
    inertia = torch.tensor(INERTIA, dtype=om.dtype, device=om.device)
    torque = u[..., 1:4]
    Iom = inertia * om
    dom = (torque - torch.linalg.cross(om, Iom, dim=-1)) / inertia
    return dv, deul, dom


def _hover_offset(like):
    return torch.tensor([MASS * G, 0.0, 0.0, 0.0], dtype=like.dtype, device=like.device)


class QuadrotorOCP(OptimalControlProblem):
    """Waypoint tracking: min position error + attitude/rate/effort cost."""

    def __init__(
        self,
        config: Optional[Dict[str, Any]] = None,
        w_pos: float = 10.0,
        w_vel: float = 0.1,
        w_att: float = 1.0,
        w_om: float = 0.05,
        w_u: float = 1e-3,
        device=None,
    ):
        if config is None:
            config = make_config()
        super().__init__(config, device=device)
        self.weights = (w_pos, w_vel, w_att, w_om, w_u)
        H = self.ocp_config.get_horizon()
        self.set_reference(H * 3)  # target positions per step
        self.deploy_constraints_and_add_cost()

    def deploy_constraints_and_add_cost(self) -> None:
        cfg = self.ocp_config
        H, dt = cfg.get_horizon(), cfg.get_dt()
        w_pos, w_vel, w_att, w_om, w_u = self.weights

        def cost(X, P):
            fr = X.reshape(H, FRAME)
            ref = P.reshape(H, 3)
            p, v, eul, om, u = fr[:, 0:3], fr[:, 3:6], fr[:, 6:9], fr[:, 9:12], fr[:, 12:16]
            du = u - _hover_offset(u)
            return (
                w_pos * torch.sum(torch.square(p - ref))
                + w_vel * torch.sum(torch.square(v))
                + w_att * torch.sum(torch.square(eul))
                + w_om * torch.sum(torch.square(om))
                + w_u * torch.sum(torch.square(du))
            )

        self.add_scalar_cost(cost)

        def dynamics(X, P):
            fr = X.reshape(H, FRAME)
            p, v, eul, om, u = fr[:, 0:3], fr[:, 3:6], fr[:, 6:9], fr[:, 9:12], fr[:, 12:16]
            dv, deul, dom = quadrotor_derivatives(v[:-1], eul[:-1], om[:-1], u[:-1])
            res = torch.cat(
                [
                    fr[1:, 0:3] - (p[:-1] + dt * v[:-1]),
                    fr[1:, 3:6] - (v[:-1] + dt * dv),
                    fr[1:, 6:9] - (eul[:-1] + dt * deul),
                    fr[1:, 9:12] - (om[:-1] + dt * dom),
                ],
                dim=1,
            )
            return res.reshape(-1)

        self.add_equation_constraint("dynamics", dynamics)


def stage_structure(
    horizon: int,
    dt: float,
    w_pos: float = 10.0,
    w_vel: float = 0.1,
    w_att: float = 1.0,
    w_om: float = 0.05,
    w_u: float = 1e-3,
):
    """Stage-separable declaration of the same OCP (stagewise.py): per-stage
    derivatives mapped over the horizon, the only practical form at horizon
    100 (n = 1600)."""
    from ..stagewise import StageStructure

    def stage_cost(frame, ref, k):
        p, v, eul, om, u = frame[0:3], frame[3:6], frame[6:9], frame[9:12], frame[12:16]
        du = u - _hover_offset(u)
        return (
            w_pos * torch.sum(torch.square(p - ref))
            + w_vel * torch.sum(torch.square(v))
            + w_att * torch.sum(torch.square(eul))
            + w_om * torch.sum(torch.square(om))
            + w_u * torch.sum(torch.square(du))
        )

    def dynamics(frame, next_frame):
        p, v, eul, om, u = frame[0:3], frame[3:6], frame[6:9], frame[9:12], frame[12:16]
        dv, deul, dom = quadrotor_derivatives(v, eul, om, u)
        return torch.cat(
            [
                next_frame[0:3] - (p + dt * v),
                next_frame[3:6] - (v + dt * dv),
                next_frame[6:9] - (eul + dt * deul),
                next_frame[9:12] - (om + dt * dom),
            ]
        )

    return StageStructure(
        horizon=horizon,
        frame_size=FRAME,
        stage_cost=stage_cost,
        dynamics=dynamics,
        dynamics_size=12,
        ref_frame_size=3,
    )


def build(
    config: Optional[Dict[str, Any]] = None, stagewise: bool = False, device=None, **kw
) -> QuadrotorOCP:
    """Build the quadrotor OCP on ``device`` (default: the GPU) and generate
    its solver; ``stagewise=True`` registers the stage structure, which
    selects the banded QP path (the only one ported so far)."""
    ocp = QuadrotorOCP(config, device=device, **kw)
    if stagewise:
        cfg = ocp.ocp_config
        w_pos, w_vel, w_att, w_om, w_u = ocp.weights
        ocp.set_stage_structure(
            stage_structure(
                cfg.get_horizon(), cfg.get_dt(),
                w_pos=w_pos, w_vel=w_vel, w_att=w_att, w_om=w_om, w_u=w_u,
            )
        )
    ocp.gen_solver()
    return ocp


def initial_state(pos=(0.0, 0.0, 1.0)) -> np.ndarray:
    frame = np.zeros(FRAME)
    frame[0:3] = pos
    frame[12] = MASS * G  # hover thrust
    return frame


def reference_hover(horizon: int, pos=(0.0, 0.0, 1.0)) -> np.ndarray:
    return np.tile(np.asarray(pos, np.float64), horizon)
