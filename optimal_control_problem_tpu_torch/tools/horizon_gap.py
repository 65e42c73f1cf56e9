"""Phase 7c's comparison on its own: the quadrotor h100 ticked by
``HorizonShardedSolver`` over ``"h"`` of 4 in-process shards and by the
single-device banded ``BatchedSolver`` (B=1), a cold and a warm tick at
the JAX bench's settings (``chip_smoke.QUAD_ADMM``), with each SQP step's
ADMM iterations and QP flags in both and the largest trajectory gap.

    python3 -m optimal_control_problem_tpu_torch.tools.horizon_gap \\
        [--device cuda] [--precision f32|f64] [--eps 1e-3] \\
        [--max-iter 250 1000 4000] [--horizon 100]

Prints one JSON object a tick.  It answers whether the gap between the
two paths is their ADMM budget (raise ``--max-iter``), their tolerance
and precision (``--precision f64 --eps 1e-8``: both paths then solve each
QP to the same point), or different QPs (neither closes it).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..models import quadrotor
from ..parallel import BatchedSolver, HorizonShardedSolver, make_mesh

# chip_smoke.QUAD_ADMM: the JAX bench's quadrotor h100 settings
# (bench_models.py:335-379).
QUAD_ADMM = {"method": "banded", "max_iter": 250, "adaptive_rho": False, "rho": 0.05,
             "check_every": 2, "scaling_refresh": "tick"}


def ticks(device, precision, eps, max_iter, horizon, shards=4, n_ticks=2):
    """Yield one record a tick of both paths from the same frame."""
    admm = dict(QUAD_ADMM, max_iter=max_iter, eps_abs=eps, eps_rel=eps)
    cfg = quadrotor.make_config(horizon=horizon, dt=0.02, alpha=0.3, step_num=5,
                                formulation="reduced", ADMM_settings=admm)
    cfg["solver_settings"]["precision"] = precision
    frame = quadrotor.initial_state(pos=(0.3, -0.2, 1.0))
    ref = quadrotor.reference_hover(horizon)
    sharded = HorizonShardedSolver(quadrotor.build(cfg, stagewise=True, device=device),
                                   make_mesh(("h",), shape=(shards,), devices=device))
    single = BatchedSolver(quadrotor.build(cfg, stagewise=True, device=device), device=device)
    state = single.init_state(1)
    for t in range(n_ticks):
        traj = sharded.compute_optimal_trajectory(frame, ref).cpu().numpy()
        x1, _, state = single.solve(frame[None], ref[None], state)
        res = single.last_result
        stats = sharded.get_solver_stats()
        yield {
            "device": str(device), "precision": precision, "eps": eps, "max_iter": max_iter,
            "tick": "cold" if t == 0 else "warm",
            "sharded_iters": stats["qp_iters"].tolist(),
            "sharded_converged": stats["qp_status"][:, 0].astype(int).tolist(),
            "single_iters": res.qp_iters[:, 0].tolist(),
            "single_converged": res.qp_converged[:, 0].int().tolist(),
            "gap": float(np.abs(traj.reshape(-1) - x1[0].cpu().numpy()).max()),
        }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--precision", default="f32", choices=("f32", "f64"))
    p.add_argument("--eps", type=float, default=1e-3)
    p.add_argument("--max-iter", type=int, nargs="+", default=[250])
    p.add_argument("--horizon", type=int, default=100)
    a = p.parse_args(argv)
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no GPU: pass --device cpu", file=sys.stderr)
        return 2
    for mi in a.max_iter:
        for rec in ticks(dev, a.precision, a.eps, mi, a.horizon):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
