"""Cart-pole swing-up with input/state inequality constraints — port of
``optimal_control_problem_tpu/models/cartpole.py``.

State fields per frame: ``x, dx, th, dth`` (cart position/velocity, pole
angle/rate; th=pi is upright) and control ``F`` — frame size 5.  Nonlinear
dynamics discretized with explicit Euler as equality constraints; force and
cart-position limits as box bounds; a pole-rate limit as a stage
inequality.  Every function is written with torch ops.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import as_tensors
from ..problem import OptimalControlProblem, SolverSettings

FRAME = 5  # x dx th dth F
CONTROL_SLICE = slice(4, 5)  # control entries within one frame


def make_config(
    horizon: int = 20,
    dt: float = 0.02,
    solve_method: str = "TPU_SQP",
    x_lim: float = 2.0,
    f_lim: float = 20.0,
    alpha: float = 0.1,
    step_num: int = 10,
    **solver_overrides: Any,
) -> Dict[str, Any]:
    settings = SolverSettings.default_node(solve_method)
    settings["SQP_settings"] = {"alpha": alpha, "step_num": step_num}
    settings.update(solver_overrides)
    unbounded = {"lower_bound": ["-.inf"], "upper_bound": [".inf"]}
    return {
        "discretization_settings": {"dt": dt, "horizon": horizon},
        "solver_settings": settings,
        "OCP_variables": [
            {"name": "x", "size": 1, "lower_bound": [-x_lim], "upper_bound": [x_lim]},
            {"name": "dx", "size": 1, **unbounded},
            {"name": "th", "size": 1, **unbounded},
            {"name": "dth", "size": 1, **unbounded},
            {"name": "F", "size": 1, "lower_bound": [-f_lim], "upper_bound": [f_lim]},
        ],
    }


def cartpole_accel(dx, th, dth, F, m_cart=1.0, m_pole=0.1, length=0.5, g=9.81, *,
                   device=None):
    """Continuous-time accelerations (standard cart-pole; th=0 hanging down).
    State and force that are not tensors (a plant simulated on the host
    passes numbers) go to ``device`` (:func:`..device.as_tensors`)."""
    dx, th, dth, F = as_tensors(dx, th, dth, F, device=device)
    s, c = torch.sin(th), torch.cos(th)
    total = m_cart + m_pole
    temp = (F + m_pole * length * dth**2 * s) / total
    ddth = (g * s - c * temp) / (length * (4.0 / 3.0 - m_pole * c**2 / total))
    ddx = temp - m_pole * length * ddth * c / total
    return ddx, ddth


class CartPoleOCP(OptimalControlProblem):
    """Swing-up: drive th -> pi (upright), x -> 0, with effort cost and a
    bounded pole rate."""

    def __init__(
        self,
        config: Optional[Dict[str, Any]] = None,
        w_th: float = 10.0,
        w_x: float = 1.0,
        w_rates: float = 0.1,
        w_u: float = 1e-3,
        dth_lim: float = 12.0,
        device=None,
    ):
        if config is None:
            config = make_config()
        super().__init__(config, device=device)
        self.w_th, self.w_x, self.w_rates, self.w_u = w_th, w_x, w_rates, w_u
        self.dth_lim = dth_lim
        self.set_reference(1)  # target angle (pi for upright)
        self.deploy_constraints_and_add_cost()

    def deploy_constraints_and_add_cost(self) -> None:
        cfg = self.ocp_config
        H, dt = cfg.get_horizon(), cfg.get_dt()
        w_th, w_x, w_rates, w_u = self.w_th, self.w_x, self.w_rates, self.w_u

        def cost(X, P):
            fr = X.reshape(H, FRAME)
            x, dx, th, dth, F = (fr[:, i] for i in range(5))
            th_target = P[0]
            return (
                w_th * torch.sum(torch.square(torch.cos(th) - torch.cos(th_target))
                                 + torch.square(torch.sin(th) - torch.sin(th_target)))
                + w_x * torch.sum(torch.square(x))
                + w_rates * torch.sum(torch.square(dx) + torch.square(dth))
                + w_u * torch.sum(torch.square(F))
            )

        self.add_scalar_cost(cost)

        def dynamics(X, P):
            fr = X.reshape(H, FRAME)
            x, dx, th, dth, F = (fr[:, i] for i in range(5))
            ddx, ddth = cartpole_accel(dx[:-1], th[:-1], dth[:-1], F[:-1])
            res = torch.stack(
                [
                    fr[1:, 0] - (x[:-1] + dt * dx[:-1]),
                    fr[1:, 1] - (dx[:-1] + dt * ddx),
                    fr[1:, 2] - (th[:-1] + dt * dth[:-1]),
                    fr[1:, 3] - (dth[:-1] + dt * ddth),
                ],
                dim=1,
            )
            return res.reshape(-1)

        self.add_equation_constraint("dynamics", dynamics)

        dth_lim = self.dth_lim

        def rate_limit(X, P):
            return X.reshape(H, FRAME)[:, 3]

        self.add_inequality_constraint("pole_rate", [-dth_lim] * H, rate_limit, [dth_lim] * H)


def stage_structure(
    horizon: int,
    dt: float,
    w_th: float = 10.0,
    w_x: float = 1.0,
    w_rates: float = 0.1,
    w_u: float = 1e-3,
    dth_lim: float = 12.0,
):
    """Stage-separable declaration of the same OCP (stagewise.py)."""
    from ..stagewise import StageStructure

    def stage_cost(frame, ref, k):
        x, dx, th, dth, F = frame[0], frame[1], frame[2], frame[3], frame[4]
        th_target = ref[0]
        return (
            w_th
            * (
                (torch.cos(th) - torch.cos(th_target)) ** 2
                + (torch.sin(th) - torch.sin(th_target)) ** 2
            )
            + w_x * x**2
            + w_rates * (dx**2 + dth**2)
            + w_u * F**2
        )

    def dynamics(frame, next_frame):
        x, dx, th, dth, F = frame[0], frame[1], frame[2], frame[3], frame[4]
        ddx, ddth = cartpole_accel(dx, th, dth, F)
        return torch.stack(
            [
                next_frame[0] - (x + dt * dx),
                next_frame[1] - (dx + dt * ddx),
                next_frame[2] - (th + dt * dth),
                next_frame[3] - (dth + dt * ddth),
            ]
        )

    def rate_limit(frame, ref, k):
        return frame[3:4]

    return StageStructure(
        horizon=horizon,
        frame_size=FRAME,
        stage_cost=stage_cost,
        dynamics=dynamics,
        dynamics_size=4,
        stage_constraints=(rate_limit, [-dth_lim], [dth_lim]),
        ref_frame_size=0,
    )


def build(
    config: Optional[Dict[str, Any]] = None, stagewise: bool = False, device=None, **kw
) -> CartPoleOCP:
    """Build the cart-pole OCP on ``device`` (default: the GPU) and generate
    its solver; ``stagewise=True`` registers the stage structure, which
    selects the banded QP path."""
    ocp = CartPoleOCP(config, device=device, **kw)
    if stagewise:
        cfg = ocp.ocp_config
        ocp.set_stage_structure(
            stage_structure(
                cfg.get_horizon(),
                cfg.get_dt(),
                w_th=ocp.w_th,
                w_x=ocp.w_x,
                w_rates=ocp.w_rates,
                w_u=ocp.w_u,
                dth_lim=ocp.dth_lim,
            )
        )
    ocp.gen_solver()
    return ocp


def initial_state(x=0.0, dx=0.0, th=0.0, dth=0.0, F=0.0) -> np.ndarray:
    return np.array([x, dx, th, dth, F])
