"""``export_solver`` / ``import_solver`` on the batched cart-pole banded
tick, which reaches B1, against the direct call and against the JAX
package's export (``torch_export_cases.round_trip``: the program holds the kernel's
op nodes and its trace ran no plain version; the reloaded program gives
the direct call's ``qp_iters`` exactly, its trajectory within 1e-5 and
runs the op as often as the direct call runs the kernel; it matches JAX's
exported artifact of the same tick within 2e-3, JAX's Pallas kernels in
interpret mode).  h4, one SQP step, the bench settings (every QP
converges):

* the cart-pole banded batch (B=4): B1, the one-way chunk, one op node a
  step (no adaptive rho: one chunk);
* with ``polish=True`` the banded batch has no export form, and
  ``export_solver`` raises a ``ValueError`` naming it.

The other kernels' ticks: ``test_torch_export_dense.py`` (B5),
``test_torch_export_rolled.py`` (B2), ``test_torch_export_cr.py`` (B4),
``test_torch_export_lti.py`` (B3) and ``test_torch_export_xla.py`` (the
LTI ``"xla"`` loop).
"""

import pytest

from optimal_control_problem_tpu.models import cartpole as jcp
from optimal_control_problem_tpu.parallel import BatchedSolver as JBatchedSolver
from optimal_control_problem_tpu_torch.parallel import BatchedSolver
from optimal_control_problem_tpu_torch.utils.serialization import export_solver
from torch_export_cases import BANDED, cartpole, inputs, round_trip, solve_args, tcp
from torch_threads import one_torch_thread  # noqa: F401


def test_cartpole_banded_batch_exports_b1(monkeypatch, tmp_path):
    tb = BatchedSolver(cartpole(tcp), device="cpu")
    jb = JBatchedSolver(cartpole(jcp))
    direct = round_trip(monkeypatch, tmp_path, tb, jb, "cartpole", 4, "banded_admm_chunk",
                        {("top", "banded_admm_chunk"): 1}, lambda: 1)
    assert bool(direct.qp_converged.all())


def test_banded_batch_with_polish_has_no_export_form(tmp_path):
    """``polish=True`` (opt-in, per scenario on the host) has no device-side
    form: ``export_solver`` says so instead of tracing."""
    cfg = tcp.make_config(horizon=4, dt=0.04, alpha=0.3, step_num=1, formulation="reduced",
                          ADMM_settings={**BANDED, "polish": True})
    tb = BatchedSolver(tcp.build(cfg, stagewise=True, device="cpu"), device="cpu")
    frames, refs = inputs("cartpole", 2)
    args = solve_args(tb, frames, refs, tb.init_state(2))
    assert tb._solve_batch.export_form is None
    with pytest.raises(ValueError, match="polish=True"):
        export_solver(tb._solve_batch, args, str(tmp_path / "polish.pt2"))
