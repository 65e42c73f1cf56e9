"""Full fixed-iteration SQP parity oracle — f64 derivatives + native f32 QP;
port of ``optimal_control_problem_tpu/solvers/oracle.py``.

The reference's complete per-tick loop (``SQPOptimizationSolver.cpp:
127-216``) re-implemented on the host, as the strongest available stand-in
for a run of the reference itself:

* **f64 derivative evaluation** — ``torch.func`` on float64 CPU tensors
  plays CasADi's double-precision ``localSystemFunction_``;
* **f32 QP solves through the independent C++ ADMM oracle**
  (``csrc/ref_admm.cpp`` via :mod:`.native`) play OSQP built with
  ``OSQP_USE_FLOAT=ON``, cold-started every SQP iteration like the
  reference's full ``initSolver()`` re-init;
* the reference's loop semantics verbatim: augmented z=[p;x],
  objective-only Hessian (no regularization), ``l - c(z)`` bound shifts,
  ``x += alpha*dx`` for exactly ``step_num`` iterations, a persistent
  ``result_`` across MPC ticks starting from zeros;
* the MPC tick assembly of ``computeOptimalTrajectory``: first-frame
  pinning via ``lbx = ubx = frame`` and per-tick constraint bounds.

The JAX package runs its oracle in a subprocess with ``jax_enable_x64``.
torch has no such process-wide switch: float64 is a dtype, so the port's
oracle runs in process (:func:`oracle_closed_loop` needs no guard), and
:func:`product_closed_loop` runs the port's own product path (the parity
preset on the problem's device, ``cuda`` unless asked for the CPU) in
float32 or float64.

Run standalone (writes the same ``.npz`` keys as the JAX CLI)::

    python -m optimal_control_problem_tpu_torch.solvers.oracle \\
        --model cartpole --ticks 3 --out oracle.npz [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import numpy as np
import torch

from .admm import f32_matmuls

__all__ = [
    "ORACLE_MODELS",
    "REFERENCE_QP_SETTINGS",
    "scripted_scenario",
    "build_parity_ocp",
    "oracle_closed_loop",
    "product_closed_loop",
]

# Reference inner-QP constants (SQPOptimizationSolver.cpp:80-85 + the OSQP
# defaults OSQP-Eigen leaves untouched).  The C++ oracle has no adaptive
# rho, so the product side of the comparison runs with adaptive_rho=False.
REFERENCE_QP_SETTINGS: Dict[str, Any] = dict(
    rho=0.1,
    sigma=1e-6,
    alpha=1.6,
    eps_abs=1e-3,
    eps_rel=1e-3,
    max_iter=10000,
    check_every=25,
    scaling_iters=10,
)

ORACLE_MODELS = ("double_integrator", "cartpole", "unicycle", "quadrotor")


def _model_spec(model: str, horizon: Optional[int] = None):
    """(module, build_kwargs, horizon, dt) for one oracle scenario."""
    from ..models import cartpole, double_integrator, quadrotor, unicycle

    if model == "double_integrator":
        return double_integrator, {}, horizon or 20, 0.005
    if model == "cartpole":
        return cartpole, {}, horizon or 20, 0.02
    if model == "unicycle":
        return unicycle, {"halfspaces": (((0.0, 1.0), -0.5),)}, horizon or 20, 0.05
    if model == "quadrotor":
        return quadrotor, {}, horizon or 10, 0.02
    raise ValueError(f"unknown oracle model {model!r}")


def scripted_scenario(model: str, ticks: int, horizon: Optional[int] = None):
    """Deterministic (frames (ticks, fs), reference (n_p,)) shared by the
    oracle and the product side: an initial state plus small sinusoidal
    excursions, clipped into the frame's box bounds (the JAX package's
    scenario, number for number)."""
    mod, _, H, dt = _model_spec(model, horizon)
    fs = mod.FRAME
    frames = np.zeros((ticks, fs), np.float64)
    t = np.arange(ticks, dtype=np.float64)[:, None]
    j = np.arange(fs, dtype=np.float64)[None, :]
    if model == "double_integrator":
        base, ref, amp = mod.initial_state(), mod.reference_circle(H, dt), 0.3
    elif model == "cartpole":
        base, ref, amp = mod.initial_state(th=0.3), np.full((1,), np.pi), 0.1
    elif model == "unicycle":
        base, ref, amp = mod.initial_state(th=0.2), mod.reference_line(H, dt), 0.2
    else:  # quadrotor
        base, ref, amp = mod.initial_state(), mod.reference_hover(H), 0.1
    frames[:] = base[None, :] + amp * np.sin(0.7 * t + 0.9 * j) * np.cos(0.3 + 0.5 * j)
    probe = build_parity_ocp(model, horizon, gen=False)
    lb = probe.ocp_config.lower_bounds_flat()[:fs]
    ub = probe.ocp_config.upper_bounds_flat()[:fs]
    frames = np.clip(frames, lb + 1e-3, ub - 1e-3)
    return frames, np.asarray(ref, np.float64)


def build_parity_ocp(
    model: str,
    horizon: Optional[int] = None,
    gen: bool = True,
    precision: str = "f32",
    device=None,
):
    """The model OCP at exact reference settings (parity preset, fixed-rho
    reference QP constants, non-stagewise NLP construction).

    ``gen=True``: built with its solver on ``device`` (``cuda`` unless
    asked otherwise); ``precision="f64"`` runs the same product path in
    double.  ``gen=False``: the NLP functions and bounds only, on the CPU
    (the oracle side), without a solver.
    """
    mod, build_kw, H, dt = _model_spec(model, horizon)
    config = mod.make_config(
        horizon=H,
        dt=dt,
        alpha=0.1,
        step_num=10,
        SQP_settings={"alpha": 0.1, "step_num": 10, "parity": True},
        precision=precision,
        ADMM_settings=dict(REFERENCE_QP_SETTINGS, adaptive_rho=False, method="condensed"),
    )
    if gen:
        return mod.build(config, device=device, **build_kw)
    for attr in dir(mod):
        obj = getattr(mod, attr)
        if isinstance(obj, type) and attr.endswith("OCP"):
            return obj(config, device="cpu" if device is None else device, **build_kw)
    raise RuntimeError(f"no OCP subclass found in {mod.__name__}")


def _local_system_f64(ocp):
    """The reference's localSystemFunction_ on the CPU in float64:
    augmented z, objective-only Hessian, no regularization; returns
    ``(x, p, lbx, ubx, lbg, ubg) -> (H, grad, A, l - c, u - c)``."""
    from .sqp import build_local_system_fn, normalize_nlp

    f_fn, g_fn = ocp._build_nlp_fns()
    nlp = {"x": ocp.ocp_config.get_variables(), "f": f_fn, "g": g_fn,
           "p": ocp.reference_size}
    f_n, g_n, n_x, n_p, n_g = normalize_nlp(nlp)
    local_system = build_local_system_fn(
        f_n, g_n, n_x, n_p, n_g, "augmented", torch.float64, hessian_reg=0.0
    )
    return local_system, n_x, n_p


@f32_matmuls
def oracle_closed_loop(
    model: str,
    ticks: int = 3,
    horizon: Optional[int] = None,
    step_num: int = 10,
    alpha: float = 0.1,
    qp_internal_f64: bool = False,
) -> Dict[str, np.ndarray]:
    """Run the reference-loop oracle over the scripted scenario, on the
    host: f64 derivatives, each QP a cold native solve (f32 internals, or
    the same C++ in double with ``qp_internal_f64``, the trajectory free of
    the f32 drift floor).  Returns ``{"trajectories": (ticks, n_x) f64,
    "frames", "reference"}``."""
    from .native import native_admm_solve

    ocp = build_parity_ocp(model, horizon, gen=False)
    local_system, n_x, n_p = _local_system_f64(ocp)
    frames, reference = scripted_scenario(model, ticks, horizon)
    cfg = ocp.ocp_config
    fs = cfg.get_frame_size()
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
    lbx0, ubx0 = cfg.lower_bounds_flat(), cfg.upper_bounds_flat()
    lbg = f64(ocp.get_constraint_lower_bounds())
    ubg = f64(ocp.get_constraint_upper_bounds())
    p = f64(reference)
    # result_ persists across ticks, zeros at start; the per-tick x0 is
    # ignored by the reference's SQP backend.
    x = np.zeros(n_x, np.float64)
    trajs = np.zeros((ticks, n_x), np.float64)
    for t in range(ticks):
        lbx, ubx = lbx0.copy(), ubx0.copy()
        lbx[:fs] = frames[t]  # first-frame pinning (cpp:95-96)
        ubx[:fs] = frames[t]
        for _ in range(step_num):
            H, grad, A, l_lin, u_lin = local_system(f64(x), p, f64(lbx), f64(ubx), lbg, ubg)
            sol = native_admm_solve(  # f32 QP, cold start (initSolver re-init)
                H.numpy(), grad.numpy(), A.numpy(), l_lin.numpy(), u_lin.numpy(),
                internal_f64=qp_internal_f64, **REFERENCE_QP_SETTINGS,
            )
            x = x + alpha * sol.x[n_p:].astype(np.float64)  # damped fixed step
        trajs[t] = x
    return {"trajectories": trajs, "frames": frames, "reference": reference}


@f32_matmuls
def product_closed_loop(
    model: str,
    ticks: int = 3,
    horizon: Optional[int] = None,
    precision: str = "f32",
    device=None,
) -> np.ndarray:
    """Run the port's product solve path (``OptimalControlProblem`` ->
    ``SQPOptimizationSolver``, parity preset) on ``device`` (``cuda``
    unless asked otherwise) over the scripted scenario; per-tick
    trajectories ``(ticks, n_x)`` as float64 numpy."""
    ocp = build_parity_ocp(model, horizon, precision=precision, device=device)
    frames, reference = scripted_scenario(model, ticks, horizon)
    trajs = []
    for t in range(ticks):
        ocp.compute_optimal_trajectory(frames[t], reference)
        trajs.append(ocp.get_optimal_trajectory().double().cpu().numpy())
    return np.stack(trajs)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", choices=ORACLE_MODELS, required=True)
    parser.add_argument("--ticks", type=int, default=3)
    parser.add_argument("--horizon", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="device of the product path (default: cuda)")
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    out = oracle_closed_loop(args.model, args.ticks, args.horizon)
    # The same loop with the C++ QP iterating in double.
    out["trajectories_f64qp"] = oracle_closed_loop(
        args.model, args.ticks, args.horizon, qp_internal_f64=True
    )["trajectories"]
    # The product path in f64: agreement with trajectories_f64qp shows
    # loop-semantics parity without the f32 drift floor.
    out["trajectories_product_f64"] = product_closed_loop(
        args.model, args.ticks, args.horizon, precision="f64", device=args.device
    )
    np.savez(args.out, **out)
    print(f"oracle[{args.model}] wrote {args.out}")


if __name__ == "__main__":
    main()
