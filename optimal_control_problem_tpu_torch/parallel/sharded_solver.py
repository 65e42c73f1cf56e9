"""Horizon-sharded MPC front end: the reference user flow
(``computeOptimalTrajectory``) driving the sequence-parallel SQP engine —
port of ``optimal_control_problem_tpu/parallel/sharded_solver.py``.

:class:`HorizonShardedSolver` takes a built
:class:`~..problem.OptimalControlProblem` (stage structure registered,
``gen_solver()`` called) and a mesh, and derives everything
:func:`.seq_sqp.sqp_solve_seq_parallel` needs:

* the :class:`StageStructure` (re-keyed to per-stage references when the
  model shares one flat reference across stages),
* per-stage box bounds from :class:`~..config.OCPConfig` with first-frame
  pinning each tick,
* the SQP iteration count, damping, line search, Hessian regularization
  and ADMM settings from the parsed ``solver_settings``,
* the cross-tick warm start of the trajectory,

so a user moves from the single-device ``compute_optimal_trajectory`` to a
horizon-sharded (optionally scenario x horizon) solve without touching
the sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import same_device
from ..problem import OptimalControlProblem
from .mesh import Mesh
from .seq_sqp import sqp_solve_seq_parallel

__all__ = ["HorizonShardedSolver"]


class HorizonShardedSolver:
    """Solve a built OCP each MPC tick with the horizon sharded over a mesh.

    Usage::

        ocp = cartpole.build(cartpole.make_config(horizon=32), stagewise=True)
        mesh = make_mesh(("h",), shape=(4,))          # 4 shards on the card
        sharded = HorizonShardedSolver(ocp, mesh)     # axis="h"
        traj = sharded.compute_optimal_trajectory(frame, reference)

    Batched scenario x horizon (2-D mesh)::

        mesh = make_mesh(("b", "h"), shape=(2, 4))
        sharded = HorizonShardedSolver(ocp, mesh, axis="h", batch_axis="b")
        trajs = sharded.compute_optimal_trajectory(frames, references)

    The OCP must have a registered stage structure (reduced formulation),
    live on the mesh's device, and its horizon must split into >= 2
    stages a shard along ``mesh[axis]``.
    """

    def __init__(self, ocp: OptimalControlProblem, mesh: Mesh, axis: str = "h",
                 batch_axis: Optional[str] = None):
        if ocp._stage_structure is None:
            raise ValueError(
                "HorizonShardedSolver requires a stage-structured OCP "
                "(call set_stage_structure() before gen_solver())"
            )
        st = ocp.solver_settings
        if getattr(st, "parity", False):
            raise ValueError(
                "the parity preset pins the reference's dense augmented-z "
                "flow; horizon sharding requires the reduced formulation"
            )
        if axis not in mesh.shape:
            raise ValueError(f"mesh has no axis {axis!r}: {mesh.shape}")
        if batch_axis is not None and batch_axis not in mesh.shape:
            raise ValueError(f"mesh has no batch axis {batch_axis!r}: {mesh.shape}")
        if not same_device(mesh.device, ocp.device):
            raise ValueError(f"problem lives on {ocp.device}, mesh on {mesh.device}")

        ss = ocp._stage_structure
        cfg = ocp.ocp_config
        N, w = ss.horizon, ss.frame_size
        D = mesh.shape[axis]
        if N % D or N // D < 2:
            raise ValueError(
                f"horizon {N} must split into >= 2 stages per device over "
                f"the {D}-way {axis!r} axis"
            )

        n_p = ocp.reference_size
        if ss.ref_frame_size > 0:
            if n_p != N * ss.ref_frame_size:
                raise ValueError(
                    f"per-stage references: expected reference size "
                    f"{N * ss.ref_frame_size}, OCP declares {n_p}"
                )
            self._ref_dim = ss.ref_frame_size
            self._tile_ref = False
        else:
            # One flat reference shared by every stage: the sharded engine
            # wants per-stage rows, so tile it and re-key the structure.
            # Reference-free models (n_p = 0) get an inert 1-wide zero
            # column (their stage_cost ignores it).
            self._ref_dim = max(n_p, 1)
            self._tile_ref = True
            ss = dataclasses.replace(ss, ref_frame_size=self._ref_dim)

        self.ocp = ocp
        self.ss = ss
        self.mesh = mesh
        self.axis = axis
        self.batch_axis = batch_axis
        self.horizon, self.frame_size = N, w
        self.dtype = st.dtype
        self.device = mesh.device

        self._lx = np.asarray(cfg.lower_bounds_flat(), np.float64).reshape(N, w)
        self._ux = np.asarray(cfg.upper_bounds_flat(), np.float64).reshape(N, w)

        self._sqp_iters = st.step_num
        self._alpha = st.alpha
        self._admm = st.admm
        self._line_search = getattr(st, "line_search", "none")
        self._ls_num = getattr(st, "ls_num", 8)
        self._ls_alpha_max = getattr(st, "ls_alpha_max", 1.0)
        self._ls_merit_mu = getattr(st, "ls_merit_mu", 10.0)
        hr = getattr(st, "hessian_reg", "auto")
        # seq_sqp applies the Gershgorin rule with a float floor; the
        # string modes map to the default floor.
        self._hessian_reg = float(hr) if not isinstance(hr, str) else 1e-6

        self._first_time = True
        self._x: Optional[torch.Tensor] = None  # (N, w) or (B, N, w)
        self._last_its = None
        self._last_qp_status = None

    # ------------------------------------------------------------------
    def _prep_ref(self, reference, B: Optional[int]):
        N = self.horizon
        n_p = self.ocp.reference_size
        if reference is None:
            reference = np.zeros((n_p,) if B is None else (B, n_p))
        ref = np.asarray(reference, np.float64)
        if B is None:
            ref = ref.reshape(-1)
            if ref.shape[0] != n_p:
                raise ValueError(
                    f"Reference dimension mismatch: received {ref.shape[0]}, expected {n_p}"
                )
            if self._tile_ref:
                if n_p == 0:
                    return np.zeros((N, 1))
                return np.tile(ref[None, :], (N, 1))
            return ref.reshape(N, self._ref_dim)
        ref = ref.reshape(B, -1)
        if ref.shape[1] != n_p:
            raise ValueError(
                f"Reference dimension mismatch: received {ref.shape[1]}, expected {n_p}"
            )
        if self._tile_ref:
            if n_p == 0:
                return np.zeros((B, N, 1))
            return np.tile(ref[:, None, :], (1, N, 1))
        return ref.reshape(B, N, self._ref_dim)

    def compute_optimal_trajectory(self, frame, reference=None) -> torch.Tensor:
        """One MPC tick; returns the trajectory as ``(N, w)`` frames (or
        ``(B, N, w)`` on a 2-D mesh).  First-frame pinning and the
        cross-tick warm start follow ``computeOptimalTrajectory``."""
        N, w = self.horizon, self.frame_size
        frame = np.asarray(frame, np.float64)
        if self.batch_axis is None:
            frame = frame.reshape(-1)
            if frame.shape[0] != w:
                raise ValueError(
                    f"State dimension mismatch: received {frame.shape[0]}, expected {w}"
                )
            B = None
            lx = self._lx.copy()
            ux = self._ux.copy()
            lx[0] = frame  # first-frame pinning (cpp:95-96)
            ux[0] = frame
        else:
            frame = frame.reshape(-1, w)
            B = frame.shape[0]
            Bd = self.mesh.shape[self.batch_axis]
            if B % Bd:
                raise ValueError(
                    f"scenario batch {B} must divide over the {Bd}-way {self.batch_axis!r} axis"
                )
            lx = np.tile(self._lx[None], (B, 1, 1))
            ux = np.tile(self._ux[None], (B, 1, 1))
            lx[:, 0, :] = frame
            ux[:, 0, :] = frame
        ref = self._prep_ref(reference, B)
        as_t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)  # noqa: E731

        if self._first_time or self._x is None:
            ig = self.ocp.ocp_config.get_initial_guess()
            x0 = np.zeros((N, w)) if ig is None else np.asarray(ig).reshape(N, w)
            if B is not None:
                x0 = np.tile(x0[None], (B, 1, 1))
            x0 = as_t(x0)
        else:
            x0 = self._x  # warm start (cpp:102-113)

        x, its, qp_status = sqp_solve_seq_parallel(
            self.ss, x0, as_t(ref), as_t(lx), as_t(ux),
            sqp_iters=self._sqp_iters,
            alpha=self._alpha,
            admm=self._admm,
            mesh=self.mesh,
            axis=self.axis,
            batch_axis=self.batch_axis,
            hessian_reg=self._hessian_reg,
            line_search=self._line_search,
            ls_num=self._ls_num,
            ls_alpha_max=self._ls_alpha_max,
            ls_merit_mu=self._ls_merit_mu,
        )
        self._first_time = False
        self._x = x
        self._last_its = its
        self._last_qp_status = qp_status
        return x

    # ------------------------------------------------------------------
    def get_optimal_trajectory(self) -> torch.Tensor:
        """Latest solution, flat: ``(N*w,)`` or ``(B, N*w)``
        (``getOptimalTrajectory``)."""
        if self._x is None:
            raise RuntimeError("no solution available")
        if self.batch_axis is None:
            return self._x.reshape(-1)
        return self._x.reshape(self._x.shape[0], -1)

    def get_optimal_frames(self) -> torch.Tensor:
        """Latest solution as frames: ``(N, w)`` or ``(B, N, w)``."""
        if self._x is None:
            raise RuntimeError("no solution available")
        return self._x

    def get_solver_stats(self):
        """Per-tick stats: the ADMM iterations of each SQP iteration and
        their QP (converged, prim_inf, dual_inf) flags — the sharded analog
        of ``OptimalControlProblem.get_solver_stats``."""
        if self._last_its is None:
            return {}
        return {
            "qp_iters": self._last_its.cpu().numpy(),
            "qp_status": self._last_qp_status.cpu().numpy(),
        }
