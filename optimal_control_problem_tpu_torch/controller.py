"""Closed-loop MPC controller conveniences — port of
``optimal_control_problem_tpu/controller.py``.

The reference leaves the receding-horizon loop to user code.  Two
conventions trip users up, so this module packages them:

* **first-free-control extraction** — the measured frame pins ALL of frame 0
  including its control entries (``OptimalControlProblem.cpp:93-96``), so
  the first control the optimizer actually chose is frame 1's;
* **shift warm start** — on each tick the previous plan is advanced by one
  stage (last frame duplicated) before re-solving, so the warm start aligns
  with the shifted horizon.  The reference reuses the unshifted trajectory
  (``cpp:113``); shifting is on by default (``shift_warm_start=False`` for
  reference behavior).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .problem import OptimalControlProblem, SolverType

__all__ = ["MPCController"]


class MPCController:
    """Receding-horizon driver around a generated :class:`OptimalControlProblem`.

    ``control_slice`` selects the control entries within one frame (models
    export ``CONTROL_SLICE``).  ``step`` returns the first free control.
    """

    def __init__(self, ocp: OptimalControlProblem, control_slice: slice,
                 shift_warm_start: bool = True):
        if ocp.solver is None and ocp.get_solver_type() not in (
            SolverType.IPOPT,
            SolverType.SQP,
        ):
            raise ValueError("OCP must be generated (gen_solver) first")
        self.ocp = ocp
        self.control_slice = control_slice
        self.shift_warm_start = shift_warm_start
        self._fs = ocp.ocp_config.get_frame_size()
        self._H = ocp.ocp_config.get_horizon()

    def step(self, measured_frame, reference=None) -> np.ndarray:
        """One MPC tick: solve and return the first free control."""
        ocp = self.ocp
        if self.shift_warm_start and ocp.get_optimal_trajectory() is not None:
            prev = ocp.get_optimal_frames()
            shifted = np.concatenate([prev[1:], prev[-1:]], axis=0).reshape(-1)
            # Seed both the problem's warm start and the solver's
            # persistent iterate.
            ocp._optimal_trajectory = torch.as_tensor(shifted, device=ocp.device)
            if ocp.solver is not None:
                ocp.solver.set_iterate(shifted)
        ocp.compute_optimal_trajectory(measured_frame, reference)
        plan = ocp.get_optimal_frames()
        return np.asarray(plan[1, self.control_slice], dtype=np.float64)

    @property
    def plan(self) -> Optional[np.ndarray]:
        if self.ocp.get_optimal_trajectory() is None:
            return None
        return self.ocp.get_optimal_frames()
