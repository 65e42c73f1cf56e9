"""``export_solver`` / ``import_solver`` on the batched cart-pole tick
without a stage structure (h4, B=3, one SQP step, ``"pallas"``, the bench
settings: every QP converges), which reaches B5, the device loop: one op
node in the device-side loop of kernel entries; the reloaded program
runs it as often as the direct call enters the kernel, and is held to
the direct call and to JAX's exported artifact of the same tick as
``torch_export_cases.round_trip`` sets out.
"""

from optimal_control_problem_tpu.models import cartpole as jcp
from optimal_control_problem_tpu.parallel import BatchedSolver as JBatchedSolver
from optimal_control_problem_tpu_torch.parallel import BatchedSolver
from optimal_control_problem_tpu_torch.solvers import admm as tadmm
from torch_export_cases import cartpole, inputs, round_trip, solve_args, tcp
from torch_threads import one_torch_thread  # noqa: F401


def test_cartpole_dense_batch_exports_b5(monkeypatch, tmp_path):
    tb = BatchedSolver(cartpole(tcp, dense=True), device="cpu")
    jb = JBatchedSolver(cartpole(jcp, dense=True))
    B = 3
    frames, refs = inputs("cartpole", B)
    before = tadmm._iterate_dense.entries
    tb._solve_batch(*solve_args(tb, frames, refs, tb.init_state(B)))
    entries = tadmm._iterate_dense.entries - before
    direct = round_trip(monkeypatch, tmp_path, tb, jb, "cartpole_dense", B, "admm_device_loop",
                        {("while_loop_body_graph_0", "admm_device_loop"): 1}, lambda: entries)
    assert bool(direct.qp_converged.all())
