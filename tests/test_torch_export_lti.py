"""``export_solver`` / ``import_solver`` on the double integrator's LTI
batch tick (h4, B=8, one SQP step, adaptive rho), held to the direct call
and to JAX's exported artifact of the same tick as
``torch_export_cases.round_trip`` sets out:

* ``"pallas"`` at ``iter_precision`` ``"highest"`` and ``"high"``: B3 in its
  FP32 and its tensor-core form (on the CPU their plain versions), one op
  node for the first chunk and one in the device-side loop of chunks; the
  reloaded program runs the op once a chunk (two: the adaptation at 100 of
  the 150 iterations);
* ``"xla"`` (``test_torch_export_xla.py``): the loop of products, which
  holds no kernel, on the device.

A forced budget (eps 1e-7, max_iter 150): every QP runs the same 150
iterations in both packages (at eps 1e-3 JAX's own backends stop at
different counts, ``test_torch_slice.py``).
"""

import pytest

from torch_export_cases import double_integrator_round_trip
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_double_integrator_batch_exports_b3(monkeypatch, tmp_path, precision):
    double_integrator_round_trip(monkeypatch, tmp_path, "pallas", precision)
