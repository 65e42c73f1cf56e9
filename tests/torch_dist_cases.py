"""Two small batches for ``DistributedSolver`` over ``torch.distributed``
ranks (``tests/test_torch_distributed_init.py``), importable without JAX
by the test's worker processes."""

import numpy as np

from optimal_control_problem_tpu_torch.models import cartpole, double_integrator


def cases():
    """``(name, ocp, frames, refs)`` on the CPU: the banded cart-pole h8
    (per-scenario termination) and the shared-factorization double
    integrator h8 (batch-wide termination), B=4 each."""
    cp = cartpole.build(cartpole.make_config(
        horizon=8, dt=0.04, alpha=0.3, step_num=2,
        ADMM_settings={"method": "banded", "max_iter": 200, "adaptive_rho": False,
                       "rho": 0.05, "check_every": 2}), stagewise=True, device="cpu")
    frames = np.zeros((4, cartpole.FRAME))
    frames[:, 2] = np.linspace(-0.3, 0.3, 4)
    yield "cartpole", cp, frames, np.full((4, 1), np.pi)
    di = double_integrator.build(double_integrator.make_config(
        horizon=8, dt=0.05, alpha=0.7, step_num=2,
        ADMM_settings={"eps_abs": 1e-4, "eps_rel": 1e-4, "adaptive_rho": False,
                       "method": "condensed"}), device="cpu")
    frames = np.zeros((4, double_integrator.FRAME))
    frames[:, 0:2] = np.linspace(-1, 1, 8).reshape(4, 2)
    yield "double_integrator", di, frames, np.zeros((4, di.reference_size))
