"""Solution diagnostics: constraint reports and KKT-quality checks — port
of ``optimal_control_problem_tpu/utils/diagnostics.py``.

* :func:`constraint_report` — per-row constraint values, bounds,
  violations, grouped by the registered constraint names;
* :func:`dump_constraints_csv` — the CSV artifact the reference's ``log/``
  dir was reserved for;
* :func:`kkt_residuals` — stationarity/feasibility norms of an NLP
  iterate.

Host-side checks: the problem's functions are evaluated on float64 CPU
copies of the point (``torch.func`` for the derivatives), whatever device
the problem solves on.
"""

from __future__ import annotations

import csv
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["constraint_report", "dump_constraints_csv", "kkt_residuals"]


def _f64(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return torch.as_tensor(np.asarray(a, dtype=np.float64)).reshape(-1)


def constraint_report(ocp, X, P=None) -> List[Dict]:
    """Evaluate every registered constraint at ``X`` and report violations.

    Returns a list of rows: ``{name, index, value, lower, upper, violation}``.
    """
    X = _f64(X)
    P = torch.zeros((ocp.reference_size,), dtype=torch.float64) if P is None else _f64(P)
    _, g_fn = ocp.nlp_functions if ocp.nlp_functions else ocp._build_nlp_fns()
    if g_fn is None:
        return []
    values = g_fn(X, P).numpy()
    lb = ocp.get_constraint_lower_bounds()
    ub = ocp.get_constraint_upper_bounds()
    names = ocp.get_constraint_names()
    rows = []
    for i, (v, l, u, name) in enumerate(zip(values, lb, ub, names)):
        rows.append({
            "name": name,
            "index": i,
            "value": float(v),
            "lower": float(l),
            "upper": float(u),
            "violation": float(max(0.0, l - v, v - u)),
        })
    return rows


def dump_constraints_csv(path: str, ocp, X, P=None) -> None:
    """Write the constraint report as CSV (the reference's ``log/`` artifact)."""
    rows = constraint_report(ocp, X, P)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(
            f, fieldnames=["name", "index", "value", "lower", "upper", "violation"]
        )
        writer.writeheader()
        writer.writerows(rows)


def kkt_residuals(
    f_fn,
    g_fn,
    x,
    p,
    lbx,
    ubx,
    lbg,
    ubg,
    y_g: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """Solution-quality metrics for an NLP iterate.

    Returns primal feasibility (box + general constraints) always, plus
    stationarity of the Lagrangian when general-constraint multipliers
    ``y_g`` are provided.
    """
    x, p = _f64(x), _f64(p)
    zero = torch.zeros((), dtype=torch.float64)
    box_viol = torch.maximum(torch.maximum(_f64(lbx) - x, zero), torch.maximum(x - _f64(ubx), zero))
    out = {"box_violation": float(box_viol.max())}
    if g_fn is not None:
        g = g_fn(x, p)
        g_viol = torch.maximum(torch.maximum(_f64(lbg) - g, zero),
                               torch.maximum(g - _f64(ubg), zero))
        out["constraint_violation"] = float(g_viol.max())
        if y_g is not None:
            grad_f = torch.func.grad(lambda xx: f_fn(xx, p))(x)
            _, vjp = torch.func.vjp(lambda xx: g_fn(xx, p), x)
            stat = grad_f + vjp(_f64(y_g))[0]
            out["stationarity"] = float(stat.abs().max())
    out["objective"] = float(f_fn(x, p))
    return out
