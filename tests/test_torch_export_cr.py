"""``export_solver`` / ``import_solver`` on the quadrotor's banded batch
tick with ``banded_solver="cr"`` (h4, B=2, one SQP step, the bench
settings), which reaches B4, the cyclic-reduction chunk: one op node a
step; held to the direct call and to JAX's exported artifact of the same
tick (on JAX's CR kernel) as ``torch_export_cases.round_trip`` sets out.
"""

from optimal_control_problem_tpu.models import quadrotor as jqr
from optimal_control_problem_tpu.parallel import BatchedSolver as JBatchedSolver
from optimal_control_problem_tpu_torch.parallel import BatchedSolver
from torch_export_cases import quadrotor, round_trip, tqr
from torch_threads import one_torch_thread  # noqa: F401


def test_quadrotor_cr_batch_exports_b4(monkeypatch, tmp_path):
    tb = BatchedSolver(quadrotor(tqr, "cr"), device="cpu")
    jb = JBatchedSolver(quadrotor(jqr, "cr"))
    direct = round_trip(monkeypatch, tmp_path, tb, jb, "quadrotor", 2, "banded_admm_chunk_cr",
                        {("top", "banded_admm_chunk_cr"): 1}, lambda: 1)
    assert bool(direct.qp_converged.all())
