"""The port's horizon-sharded ADMM (``parallel/seq_admm.py``) against the
JAX package — mirrors ``tests/test_seq_admm.py`` case for case, on the same
random stage QPs (JAX's ``random_stage_qp``/``to_sharded``, fed to the port
through ``interop.sharded_banded_qp_from_numpy``).

JAX runs on its 8 virtual CPU devices, the port on the in-process mesh of
the same layout.  Each case holds the port to the single-device banded
path at JAX's 5e-3 and, since both run the same algorithm, to JAX's
sharded solve: equal iteration counts and flags, iterates within 1e-5
(f32 roundoff).  Under a forced budget (50 iterations, a negative
``eps_abs`` no residual meets) the counts are equal and the iterates agree
to 1e-5 for every case.  The distributed Ruiz, round-based adaptive rho
and the primal-infeasibility certificate each have their case (there the
verdict and its iteration are held, not the drifting iterates).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.parallel import make_mesh as jmake_mesh
from optimal_control_problem_tpu.parallel.seq_admm import (
    admm_solve_seq_parallel as jadmm_solve_seq_parallel,
)
from optimal_control_problem_tpu.solvers.admm_banded import admm_solve_banded as jadmm_banded
from optimal_control_problem_tpu_torch.interop import (
    banded_qp_from_numpy,
    mesh_from_jax_layout,
    settings_from_jax_dict,
    sharded_banded_qp_from_numpy,
)
from optimal_control_problem_tpu_torch.parallel.seq_admm import admm_solve_seq_parallel
from optimal_control_problem_tpu_torch.solvers.admm_banded import admm_solve_banded
from test_seq_admm import SET, random_stage_qp, to_sharded
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(("h",))


@pytest.fixture(scope="module")
def mesh(jmesh):
    return mesh_from_jax_layout(jmesh.shape, device="cpu")


def _np_fields(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def both(qp, st, jmesh, mesh):
    """The sharded solve in both packages on one QP: (port, JAX) tuples
    of ``(x (N*w,), iters, converged, prim_inf, dual_inf)``."""
    sq = to_sharded(qp)
    jout = jadmm_solve_seq_parallel(sq, st, mesh=jmesh, axis="h")
    out = admm_solve_seq_parallel(
        sharded_banded_qp_from_numpy(_np_fields(sq), device="cpu"),
        settings_from_jax_dict(dataclasses.asdict(st)), mesh=mesh, axis="h",
    )
    port = (out[0].numpy().reshape(-1),) + tuple(v.item() for v in out[1:])
    jax_ = (np.asarray(jout[0]).reshape(-1),) + tuple(np.asarray(v).item() for v in jout[1:])
    return port, jax_


def check_against_jax(port, jax_):
    assert port[1:] == jax_[1:]  # iterations and the three flags
    np.testing.assert_allclose(port[0], jax_[0], atol=1e-5)


def forced(qp, st, jmesh, mesh):
    port, jax_ = both(qp, st.replace(max_iter=50, eps_abs=-1.0), jmesh, mesh)
    assert port[1] == jax_[1] == 50
    np.testing.assert_allclose(port[0], jax_[0], atol=1e-5)


@pytest.mark.parametrize("seed,N,w,r,r2", [(0, 16, 4, 3, 1), (1, 32, 3, 2, 1)])
def test_seq_parallel_matches_single_device(seed, N, w, r, r2, jmesh, mesh):
    qp = random_stage_qp(seed, N, w, r, r2)
    ref = admm_solve_banded(banded_qp_from_numpy(_np_fields(qp), device="cpu"),
                            settings_from_jax_dict(dataclasses.asdict(SET)))
    assert bool(ref.converged)
    port, jax_ = both(qp, SET, jmesh, mesh)
    assert port[2]
    np.testing.assert_allclose(port[0], ref.x.numpy(), atol=5e-3)
    check_against_jax(port, jax_)
    forced(qp, SET, jmesh, mesh)


def test_seq_parallel_rejects_bad_split(mesh):
    qp = random_stage_qp(2, 12, 3, 2, 1)  # 12 not divisible by 8
    with pytest.raises(ValueError, match="split"):
        admm_solve_seq_parallel(
            sharded_banded_qp_from_numpy(_np_fields(to_sharded(qp)), device="cpu"),
            settings_from_jax_dict(dataclasses.asdict(SET)), mesh=mesh, axis="h",
        )


@pytest.mark.parametrize("seed,N,w,r,r2", [(3, 16, 4, 3, 1)])
def test_seq_parallel_ruiz_matches_single_device(seed, N, w, r, r2, jmesh, mesh):
    """Distributed Ruiz (vs the structured one) on a QP whose stage
    Hessians span 1e5."""
    st = SET.replace(scaling_iters=10)
    qp = random_stage_qp(seed, N, w, r, r2)
    Hb = np.asarray(qp.Hb).copy()
    Hb[0] *= 1e3
    Hb[-1] *= 1e-2
    qp = qp._replace(Hb=jnp.asarray(Hb))
    ref = jadmm_banded(qp, st)
    assert bool(ref.converged)
    port, jax_ = both(qp, st, jmesh, mesh)
    assert port[2]
    np.testing.assert_allclose(port[0], np.asarray(ref.x), atol=5e-3)
    check_against_jax(port, jax_)
    forced(qp, st, jmesh, mesh)


def test_seq_parallel_adaptive_rho_matches_banded(jmesh, mesh):
    """Round-based rho adaptation: the banded path's rule and cadence, so
    the same answer at the same iteration count."""
    st = SET.replace(adaptive_rho=True, adaptive_rho_interval=50, rho=1e-3)
    qp = random_stage_qp(4, 16, 4, 3, 1)
    ref = admm_solve_banded(banded_qp_from_numpy(_np_fields(qp), device="cpu"),
                            settings_from_jax_dict(dataclasses.asdict(st)))
    assert bool(ref.converged)
    port, jax_ = both(qp, st, jmesh, mesh)
    assert port[2]
    np.testing.assert_allclose(port[0], ref.x.numpy(), atol=5e-3)
    assert port[1] < st.max_iter
    assert port[1] == int(ref.iters)
    check_against_jax(port, jax_)
    forced(qp, st, jmesh, mesh)


def test_seq_parallel_infeasibility_certificate(jmesh, mesh):
    """A stage constraint pinned outside the box: prim_inf certified and an
    early exit, as the single-device banded path and JAX decide."""
    N, w, r, r2 = 16, 4, 3, 1
    qp = random_stage_qp(5, N, w, r, r2)
    Jc = np.zeros((N, r2, w), np.float32)
    Jc[:, 0, 0] = 1.0
    l = np.asarray(qp.l).copy()
    u = np.asarray(qp.u).copy()
    n = N * w
    l[n + (N - 1) * r:] = 5.0
    u[n + (N - 1) * r:] = 5.0
    qp = qp._replace(Jc=jnp.asarray(Jc), l=jnp.asarray(l), u=jnp.asarray(u))
    st = SET.replace(max_iter=4000)
    ref = admm_solve_banded(banded_qp_from_numpy(_np_fields(qp), device="cpu"),
                            settings_from_jax_dict(dataclasses.asdict(st)))
    assert bool(ref.prim_inf) and not bool(ref.converged)
    port, jax_ = both(qp, st, jmesh, mesh)
    _, iters, done, pinf, dinf = port
    assert pinf and not done and not dinf
    assert iters < 4000  # early exit on the certificate
    # The same verdict at the same check; the iterates of an infeasible
    # QP drift (their deltas are the certificate), so they are not held.
    assert port[1:] == jax_[1:]
