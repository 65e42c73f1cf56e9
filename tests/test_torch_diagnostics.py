"""The port's diagnostics (``utils/diagnostics.py``) against the JAX
package's — mirrors ``tests/test_diagnostics.py``.

Both are evaluated at the same numpy point (the port's own MPC solution):
the port evaluates in float64 on the CPU, JAX in its default float32, so
values agree to float32 roundoff of their magnitudes (1e-5 absolute here).
"""

import numpy as np

from optimal_control_problem_tpu.models import double_integrator as jdi
from optimal_control_problem_tpu.utils.diagnostics import constraint_report as j_report
from optimal_control_problem_tpu.utils.diagnostics import kkt_residuals as j_kkt
from optimal_control_problem_tpu_torch.models import double_integrator as di
from optimal_control_problem_tpu_torch.utils.diagnostics import (
    constraint_report,
    dump_constraints_csv,
    kkt_residuals,
)
from torch_threads import one_torch_thread  # noqa: F401

H = 6


def solved():
    cfg = dict(horizon=H, dt=0.05, alpha=0.8, step_num=6)
    ocp = di.build(di.make_config(**cfg), device="cpu")
    frame = di.initial_state(pos=(0.3, 0.0))
    ref = np.zeros(H * 2)
    for _ in range(3):
        ocp.compute_optimal_trajectory(frame, ref)
    return ocp, jdi.build(jdi.make_config(**cfg)), frame, ref


def test_constraint_report_and_csv(tmp_path):
    ocp, jocp, frame, ref = solved()
    X = ocp.get_optimal_trajectory().numpy()
    rows = constraint_report(ocp, X, ref)
    assert len(rows) == (H - 1) * 4
    assert all(r["name"] == "dynamics" for r in rows)
    assert max(r["violation"] for r in rows) < 1e-2
    jrows = j_report(jocp, X, ref)
    for r, j in zip(rows, jrows):
        assert (r["name"], r["index"], r["lower"], r["upper"]) == (
            j["name"], j["index"], j["lower"], j["upper"])
        assert abs(r["value"] - j["value"]) <= 1e-5
        assert abs(r["violation"] - j["violation"]) <= 1e-5
    path = tmp_path / "constraints.csv"
    dump_constraints_csv(str(path), ocp, X, ref)
    text = path.read_text()
    assert text.startswith("name,index,value,lower,upper,violation")
    assert text.count("dynamics") == (H - 1) * 4


def test_kkt_residuals():
    ocp, jocp, frame, ref = solved()
    X = ocp.get_optimal_trajectory().numpy()
    cfg = ocp.ocp_config
    lbx, ubx = cfg.lower_bounds_flat().copy(), cfg.upper_bounds_flat().copy()
    lbx[:6] = frame
    ubx[:6] = frame
    bounds = (lbx, ubx, ocp.get_constraint_lower_bounds(), ocp.get_constraint_upper_bounds())
    f_fn, g_fn = ocp.nlp_functions
    y_g = np.linspace(-1.0, 1.0, (H - 1) * 4)
    res = kkt_residuals(f_fn, g_fn, X, ref, *bounds, y_g=y_g)
    assert res["box_violation"] < 1e-2 and res["constraint_violation"] < 1e-2
    assert res["objective"] >= 0.0
    jf, jg = jocp.nlp_functions
    jres = j_kkt(jf, jg, X, ref, *bounds, y_g=y_g)
    assert set(res) == set(jres) == {"box_violation", "constraint_violation", "stationarity",
                                     "objective"}
    for k in res:
        assert abs(res[k] - jres[k]) <= 1e-5 * max(1.0, abs(jres[k])), k
