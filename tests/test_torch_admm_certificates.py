"""The dense ``admm_solve``'s infeasibility certificates against JAX's (the
certificate cases of ``test_torch_admm.py``; helpers in
``torch_admm_cases.py``).
"""

import pytest
from torch_admm_cases import CERTIFICATE_QPS, both
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", sorted(CERTIFICATE_QPS))
def test_infeasibility_certificates_match_jax(name):
    P, q, A, l, u, max_iter, (pinf, dinf) = CERTIFICATE_QPS[name]
    js, ts = both(P, q, A, l, u, max_iter=max_iter)
    assert (bool(ts.prim_inf), bool(ts.dual_inf)) == (pinf, dinf)
    assert (bool(js.prim_inf), bool(js.dual_inf)) == (pinf, dinf)
    assert bool(ts.converged) == bool(js.converged) == (not (pinf or dinf))
    assert int(ts.iters) == int(js.iters)
    if pinf or dinf:
        assert int(ts.iters) < max_iter  # early exit on the certificate
