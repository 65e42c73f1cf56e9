"""The port's profiling utilities (``utils/timing.py``) — mirrors
``tests/test_timing.py``: the same phase bookkeeping and the same keys and
split of ``profile_solver`` as JAX's (times themselves differ by nature;
on the CPU they say nothing of the card)."""

import numpy as np
import torch

from optimal_control_problem_tpu import SQPOptimizationSolver as JSolver
from optimal_control_problem_tpu import SQPOptions as JOptions
from optimal_control_problem_tpu import sym as JS
from optimal_control_problem_tpu.solvers.admm import ADMMSettings as JSettings
from optimal_control_problem_tpu.utils.timing import profile_solver as j_profile
from optimal_control_problem_tpu_torch import SQPOptimizationSolver, SQPOptions
from optimal_control_problem_tpu_torch import sym as S
from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings
from optimal_control_problem_tpu_torch.utils import timing
from optimal_control_problem_tpu_torch.utils.timing import Timer, profile_solver
from torch_threads import one_torch_thread  # noqa: F401


def test_timer_phases(monkeypatch):
    seen = []
    monkeypatch.setattr(timing, "synchronize", lambda *o: seen.append(o))
    t = Timer()
    with t.phase("a"):
        sum(range(1000))
    with t.phase("b", sync=torch.ones(2)):
        sum(range(1000))
    with t.phase("a", sync=lambda: (torch.ones(1), [torch.zeros(1)])):
        sum(range(1000))
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    assert len(seen) == 2 and isinstance(seen[1][0], tuple)
    report = t.report()
    assert "a:" in report and "%" in report


def test_synchronize_walks_tensors_and_skips_the_cpu():
    # CPU tensors need no wait: nothing reaches torch.cuda here.
    timing.synchronize(torch.ones(1), {"x": [torch.zeros(2)]}, 3.0)


def test_profile_solver_reports_split():
    arg = {"lbx": np.array([-5.0, -5.0]), "ubx": np.array([5.0, 5.0]),
           "lbg": np.array([0.0]), "ubg": np.array([0.0])}
    x = S.sym("x", 2)
    solver = SQPOptimizationSolver(
        {"x": x, "f": x[0] ** 2 + x[1] ** 2, "g": x[0] + x[1] - 1.0},
        SQPOptions(max_iter=4, alpha=0.5, admm=ADMMSettings(max_iter=500)), device="cpu")
    stats = profile_solver(solver, arg, repeats=3)
    jx = JS.sym("x", 2)
    jsolver = JSolver({"x": jx, "f": jx[0] ** 2 + jx[1] ** 2, "g": jx[0] + jx[1] - 1.0},
                      JOptions(max_iter=4, alpha=0.5, admm=JSettings(max_iter=500)))
    jstats = j_profile(jsolver, arg, repeats=3)
    assert set(stats) == set(jstats)
    for key in ("local_system_ms", "qp_ms", "solve_ms", "qp_pct", "local_system_pct"):
        assert stats[key] >= 0.0
    assert abs(stats["local_system_pct"] + stats["qp_pct"] - 100.0) < 1e-6
    assert stats["sqp_iters"] == jstats["sqp_iters"] == 4
