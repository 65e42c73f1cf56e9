"""The port's parity oracle (``solvers/oracle.py``) against the JAX package's
and against the port's own product path — mirrors
``tests/test_parity_oracle.py``.

* The oracle itself: the same scripted frames and references as JAX's
  (exactly), and on them the same closed loop: torch's float64
  derivatives feed the same C++ QP as JAX's, so the trajectories agree
  bitwise through the float32 QPs and to 1e-15 through the float64 ones.
  JAX's oracle needs ``jax_enable_x64``; it runs here in process under
  ``jax.enable_x64()``.
* The product path against the oracle, at JAX's bounds: controls within
  1e-4 in the float64-vs-float64 comparison (the BASELINE target, loop
  semantics without the f32 drift floor) and within the f32 floor of
  5e-3 in the float32-vs-float32 one.  Cart-pole's parity preset diverges
  to NaN in both packages (raw nonconvex Hessian): there the oracle and
  the product must agree on where (JAX's test passes there because
  Python's ``max`` drops a NaN).

``test_oracle_requires_x64`` has no counterpart: torch has no process-wide
precision switch (float64 is a dtype), so the port's oracle runs in any
process and needs no such guard.  Cart-pole runs 1 tick here (its NaN QPs
run the whole 10,000-iteration budget each); the other models 3, as in
JAX.
"""

import jax
import numpy as np
import pytest

from optimal_control_problem_tpu.solvers import oracle as joracle
from optimal_control_problem_tpu_torch.solvers import oracle
from optimal_control_problem_tpu_torch.solvers.native import native_available
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(not native_available(), reason="g++ unavailable")

CONTROL_SLICES = {
    "double_integrator": slice(4, 6),
    "cartpole": slice(4, 5),
    "unicycle": slice(3, 5),
    "quadrotor": slice(12, 16),
}
F32_FLOOR_BOUND = 5e-3
TICKS = {"double_integrator": 3, "cartpole": 1, "unicycle": 3, "quadrotor": 3}


@pytest.mark.parametrize("model", ["double_integrator", "unicycle"])
def test_oracle_equals_jax_oracle(model):
    frames, ref = oracle.scripted_scenario(model, 2)
    jframes, jref = joracle.scripted_scenario(model, 2)
    np.testing.assert_array_equal(frames, jframes)
    np.testing.assert_array_equal(ref, jref)
    with jax.enable_x64():
        j32 = joracle.oracle_closed_loop(model, 2)["trajectories"]
        j64 = joracle.oracle_closed_loop(model, 2, qp_internal_f64=True)["trajectories"]
    t32 = oracle.oracle_closed_loop(model, 2)["trajectories"]
    t64 = oracle.oracle_closed_loop(model, 2, qp_internal_f64=True)["trajectories"]
    np.testing.assert_array_equal(t32, j32)
    np.testing.assert_allclose(t64, j64, rtol=0, atol=1e-15)


def _ctrl(traj, ocp, cs):
    cfg = ocp.ocp_config
    return np.asarray(traj, np.float64).reshape(
        -1, cfg.get_horizon(), cfg.get_frame_size())[:, :, cs]


@pytest.mark.parametrize("model", oracle.ORACLE_MODELS)
def test_controls_match_reference_loop(model):
    ticks = TICKS[model]
    cs = CONTROL_SLICES[model]
    ocp = oracle.build_parity_ocp(model, gen=False)
    o32 = oracle.oracle_closed_loop(model, ticks)["trajectories"]
    o64 = oracle.oracle_closed_loop(model, ticks, qp_internal_f64=True)["trajectories"]
    p64 = oracle.product_closed_loop(model, ticks, precision="f64", device="cpu")
    p32 = oracle.product_closed_loop(model, ticks, precision="f32", device="cpu")
    sem = np.abs(_ctrl(p64, ocp, cs) - _ctrl(o64, ocp, cs))
    f32 = np.abs(_ctrl(p32, ocp, cs) - _ctrl(o32, ocp, cs))
    if model == "cartpole":
        for a, b in ((p64, o64), (p32, o32)):
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        assert np.isnan(p32).any()
        sem, f32 = sem[np.isfinite(sem)], f32[np.isfinite(f32)]
    assert np.isfinite(sem).all() and np.isfinite(f32).all()
    assert sem.max(initial=0.0) <= 1e-4, f"{model}: f64 control deviation {sem.max():.2e}"
    assert f32.max(initial=0.0) <= F32_FLOOR_BOUND, f"{model}: f32 deviation {f32.max():.2e}"


def test_cli_writes_the_jax_keys(tmp_path):
    out = tmp_path / "oracle.npz"
    oracle.main(["--model", "unicycle", "--ticks", "1", "--device", "cpu", "--out", str(out)])
    data = np.load(out)
    assert set(data.files) == {"trajectories", "frames", "reference", "trajectories_f64qp",
                               "trajectories_product_f64"}
    assert np.abs(data["trajectories_product_f64"] - data["trajectories_f64qp"]).max() <= 1e-4
