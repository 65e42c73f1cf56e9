"""Profiling utilities — port of ``optimal_control_problem_tpu/utils/timing.py``
(the reference's per-phase wall-clock instrumentation in the SQP loop,
``SQPOptimizationSolver.cpp:133-213``: per-iteration local-system ms, QP
ms, totals, percentage split).

:class:`Timer` times host phases; a phase given ``sync`` waits for the
device work of those tensors to finish (``torch.cuda.synchronize`` of
their device) before its clock stops, so a phase that only enqueues card
work is not timed as free.  :func:`profile_solver` times the local-system
assembly, one QP solve and the whole SQP solve of one configuration
separately.  For a timeline use ``torch.profiler`` around the call.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

import numpy as np
import torch

__all__ = ["Timer", "profile_solver", "synchronize"]


def synchronize(*objs) -> None:
    """Wait for the card work behind every CUDA tensor in ``objs`` (nested
    tuples, lists, dicts and named tuples are walked); CPU tensors need no
    wait."""
    devices = set()

    def walk(o):
        if isinstance(o, torch.Tensor):
            if o.device.type == "cuda":
                devices.add(o.device)
        elif isinstance(o, dict):
            for v in o.values():
                walk(v)
        elif isinstance(o, (tuple, list)):
            for v in o:
                walk(v)

    walk(objs)
    for dev in devices:
        torch.cuda.synchronize(dev)


class Timer:
    """Accumulating phase timer (host wall clock, device-synchronized)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextmanager
    def phase(self, name: str, sync=None):
        """Time the ``with`` body as phase ``name``; ``sync`` (tensors, or a
        callable returning them) is waited for before the clock stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                synchronize(sync() if callable(sync) else sync)
            dt = (time.perf_counter() - t0) * 1e3
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.totals.values())
        lines = [f"total: {total:.3f} ms"]
        for name, ms in self.totals.items():
            pct = 100.0 * ms / total if total > 0 else 0.0
            lines.append(f"  {name}: {ms:.3f} ms ({pct:.1f}%) over {self.counts[name]} calls")
        return "\n".join(lines)


def profile_solver(solver, arg: Dict, repeats: int = 10) -> Dict[str, float]:
    """Measure the local-system vs QP time split for one SQP configuration
    on the solver's device: ``local_system_ms`` (derivative evaluation +
    matrix assembly) and ``qp_ms`` (one ADMM solve), per SQP iteration,
    plus the whole ``solve_ms`` (the reference's verbose breakdown,
    ``SQPOptimizationSolver.cpp:204-209``).  Each is a mean over
    ``repeats`` calls after one warm-up call, device-synchronized."""
    from ..solvers.admm import admm_solve

    dt, dev = solver.dtype, solver.device

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev).reshape(-1)

    lbx, ubx = t(arg["lbx"]), t(arg["ubx"])
    lbg, ubg = t(arg.get("lbg", np.zeros(0))), t(arg.get("ubg", np.zeros(0)))
    p = t(arg.get("p", np.zeros(solver.n_p)))
    x = t(arg.get("x0", np.zeros(solver.n_x)))
    local_fn = solver.get_local_system_function()
    st = solver.options.admm
    full_args = (x, p, lbx, ubx, lbg, ubg,
                 torch.zeros((solver._qp_n,), dtype=dt, device=dev),
                 torch.zeros((solver._qp_m,), dtype=dt, device=dev))

    def mean_ms(fn):
        synchronize(fn())  # warm-up
        t0 = time.perf_counter()
        for _ in range(repeats):
            out = fn()
        synchronize(out)
        return (time.perf_counter() - t0) * 1e3 / repeats

    H, g, A, low, up = local_fn(x, p, lbx, ubx, lbg, ubg)
    local_ms = mean_ms(lambda: local_fn(x, p, lbx, ubx, lbg, ubg))
    qp_ms = mean_ms(lambda: admm_solve(H, g, A, low, up, st))
    solve_ms = mean_ms(lambda: solver.solve_fn(*full_args))
    denom = local_ms + qp_ms
    return {
        "local_system_ms": local_ms,
        "qp_ms": qp_ms,
        "local_system_pct": 100.0 * local_ms / denom if denom else 0.0,
        "qp_pct": 100.0 * qp_ms / denom if denom else 0.0,
        "solve_ms": solve_ms,
        "sqp_iters": solver.options.max_iter,
    }
