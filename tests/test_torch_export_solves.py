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
* the same with ``polish=True``: the batched polish pass after the
  chunk, one B1 op node a step all the same.

The other kernels' ticks: ``test_torch_export_dense.py`` (B5),
``test_torch_export_rolled.py`` (B2), ``test_torch_export_cr.py`` (B4),
``test_torch_export_lti.py`` (B3) and ``test_torch_export_xla.py`` (the
LTI ``"xla"`` loop).
"""

from optimal_control_problem_tpu.models import cartpole as jcp
from optimal_control_problem_tpu.parallel import BatchedSolver as JBatchedSolver
from optimal_control_problem_tpu_torch.parallel import BatchedSolver
from torch_export_cases import BANDED, cartpole, round_trip, tcp
from torch_threads import one_torch_thread  # noqa: F401


def test_cartpole_banded_batch_exports_b1(monkeypatch, tmp_path):
    tb = BatchedSolver(cartpole(tcp), device="cpu")
    jb = JBatchedSolver(cartpole(jcp))
    direct = round_trip(monkeypatch, tmp_path, tb, jb, "cartpole", 4, "banded_admm_chunk",
                        {("top", "banded_admm_chunk"): 1}, lambda: 1)
    assert bool(direct.qp_converged.all())


def test_banded_batch_with_polish_exports_b1(monkeypatch, tmp_path):
    """``polish=True`` (opt-in; one batched polish pass after the chunk
    loop, plain PyTorch as in JAX): still one B1 op node a step."""
    admm = {**BANDED, "polish": True}
    cfg = lambda m: m.make_config(horizon=4, dt=0.04, alpha=0.3, step_num=1,  # noqa: E731
                                  formulation="reduced", ADMM_settings=dict(admm))
    tb = BatchedSolver(tcp.build(cfg(tcp), stagewise=True, device="cpu"), device="cpu")
    jb = JBatchedSolver(jcp.build(cfg(jcp), stagewise=True))
    assert tb.solver.options.admm.polish
    direct = round_trip(monkeypatch, tmp_path, tb, jb, "cartpole", 4, "banded_admm_chunk",
                        {("top", "banded_admm_chunk"): 1}, lambda: 1)
    assert bool(direct.qp_converged.all())
