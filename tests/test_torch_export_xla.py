"""``export_solver`` / ``import_solver`` on the double integrator's LTI
batch tick on ``backend="xla"`` (h4, B=8, one SQP step, adaptive rho, a
forced budget): its loop of products, which reaches no kernel, runs on the
device (``admm_iterate_prepared(on_device=True)``); the program holds no
op node, and the reloaded tick is held to the direct call and to JAX's
exported artifact as ``torch_export_cases.round_trip`` sets out.  The
``"pallas"`` ticks (B3) are in ``test_torch_export_lti.py``.
"""

from torch_export_cases import double_integrator_round_trip
from torch_threads import one_torch_thread  # noqa: F401


def test_double_integrator_xla_batch_exports(monkeypatch, tmp_path):
    double_integrator_round_trip(monkeypatch, tmp_path, "xla", "highest")
