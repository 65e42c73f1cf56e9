"""Unicycle / differential-drive path tracking with obstacle half-space
constraints, horizon 50 — port of
``optimal_control_problem_tpu/models/unicycle.py``.

Frame fields: ``x, y, th`` pose plus ``v, om`` controls — frame size 5.
Nonlinear unicycle kinematics (Euler) as equality constraints; obstacles as
half-space inequality rows ``a^T [x;y] >= b`` applied at every step.
Every function is written with torch ops.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..problem import OptimalControlProblem, SolverSettings

FRAME = 5  # x y th v om
CONTROL_SLICE = slice(3, 5)  # control entries within one frame


def make_config(
    horizon: int = 50,
    dt: float = 0.05,
    solve_method: str = "TPU_SQP",
    v_max: float = 2.0,
    om_max: float = 3.0,
    alpha: float = 0.3,
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
            {"name": "x", "size": 1, **unbounded},
            {"name": "y", "size": 1, **unbounded},
            {"name": "th", "size": 1, **unbounded},
            {"name": "v", "size": 1, "lower_bound": [-v_max], "upper_bound": [v_max]},
            {"name": "om", "size": 1, "lower_bound": [-om_max], "upper_bound": [om_max]},
        ],
    }


class UnicycleOCP(OptimalControlProblem):
    """Track reference (x, y) waypoints while staying on the feasible side of
    each half-space obstacle ``normal . [x, y] >= offset``."""

    def __init__(
        self,
        config: Optional[Dict[str, Any]] = None,
        halfspaces: Sequence[Tuple[Tuple[float, float], float]] = (),
        w_pos: float = 5.0,
        w_u: float = 0.05,
        device=None,
    ):
        if config is None:
            config = make_config()
        super().__init__(config, device=device)
        self.halfspaces = [(np.asarray(n, np.float64), float(b)) for n, b in halfspaces]
        self.w_pos, self.w_u = w_pos, w_u
        H = self.ocp_config.get_horizon()
        self.set_reference(H * 2)  # (x, y) waypoints per step
        self.deploy_constraints_and_add_cost()

    def deploy_constraints_and_add_cost(self) -> None:
        cfg = self.ocp_config
        H, dt = cfg.get_horizon(), cfg.get_dt()
        w_pos, w_u = self.w_pos, self.w_u

        def cost(X, P):
            fr = X.reshape(H, FRAME)
            ref = P.reshape(H, 2)
            return (w_pos * torch.sum(torch.square(fr[:, 0:2] - ref))
                    + w_u * torch.sum(torch.square(fr[:, 3:5])))

        self.add_scalar_cost(cost)

        def dynamics(X, P):
            fr = X.reshape(H, FRAME)
            x, y, th, v, om = (fr[:, i] for i in range(5))
            res = torch.stack(
                [
                    fr[1:, 0] - (x[:-1] + dt * v[:-1] * torch.cos(th[:-1])),
                    fr[1:, 1] - (y[:-1] + dt * v[:-1] * torch.sin(th[:-1])),
                    fr[1:, 2] - (th[:-1] + dt * om[:-1]),
                ],
                dim=1,
            )
            return res.reshape(-1)

        self.add_equation_constraint("dynamics", dynamics)

        for i, (normal, offset) in enumerate(self.halfspaces):
            n0, n1 = float(normal[0]), float(normal[1])

            def hs(X, P, n0=n0, n1=n1):
                fr = X.reshape(H, FRAME)
                return n0 * fr[:, 0] + n1 * fr[:, 1]

            self.add_inequality_constraint(f"obstacle_{i}", [offset] * H, hs, [np.inf] * H)


def stage_structure(
    horizon: int,
    dt: float,
    halfspaces: Sequence[Tuple[Tuple[float, float], float]] = (),
    w_pos: float = 5.0,
    w_u: float = 0.05,
):
    """Stage-separable declaration of the same OCP (stagewise.py); the
    half-space obstacle rows become per-stage inequality constraints."""
    from ..stagewise import StageStructure

    normals = np.asarray([n for n, _ in halfspaces], np.float32).reshape(-1, 2)
    offsets = np.asarray([b for _, b in halfspaces], np.float32)

    def stage_cost(frame, ref, k):
        return (w_pos * torch.sum(torch.square(frame[0:2] - ref))
                + w_u * torch.sum(torch.square(frame[3:5])))

    def dynamics(frame, next_frame):
        x, y, th, v, om = frame[0], frame[1], frame[2], frame[3], frame[4]
        return torch.stack(
            [
                next_frame[0] - (x + dt * v * torch.cos(th)),
                next_frame[1] - (y + dt * v * torch.sin(th)),
                next_frame[2] - (th + dt * om),
            ]
        )

    sc = None
    if len(halfspaces):
        def hs(frame, ref, k):
            nrm = torch.as_tensor(normals, dtype=frame.dtype, device=frame.device)
            return nrm @ frame[0:2]

        sc = (hs, offsets.tolist(), [np.inf] * len(halfspaces))

    return StageStructure(
        horizon=horizon,
        frame_size=FRAME,
        stage_cost=stage_cost,
        dynamics=dynamics,
        dynamics_size=3,
        stage_constraints=sc,
        ref_frame_size=2,
    )


def build(
    config: Optional[Dict[str, Any]] = None,
    halfspaces: Sequence[Tuple[Tuple[float, float], float]] = (((0.0, 1.0), -0.5),),
    stagewise: bool = False,
    device=None,
    **kw,
) -> UnicycleOCP:
    """Build the unicycle OCP on ``device`` (default: the GPU) and generate
    its solver; ``stagewise=True`` registers the stage structure, which
    selects the banded QP path."""
    ocp = UnicycleOCP(config, halfspaces=halfspaces, device=device, **kw)
    if stagewise:
        cfg = ocp.ocp_config
        ocp.set_stage_structure(
            stage_structure(
                cfg.get_horizon(), cfg.get_dt(), halfspaces=halfspaces,
                w_pos=ocp.w_pos, w_u=ocp.w_u,
            )
        )
    ocp.gen_solver()
    return ocp


def initial_state(x=0.0, y=0.0, th=0.0, v=0.0, om=0.0) -> np.ndarray:
    return np.array([x, y, th, v, om])


def reference_line(horizon: int, dt: float, speed: float = 1.0, t0: float = 0.0) -> np.ndarray:
    """Waypoints along the +x axis."""
    t = t0 + dt * np.arange(horizon)
    return np.stack([speed * t, np.zeros_like(t)], axis=1).reshape(-1)
