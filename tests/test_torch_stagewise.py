"""Port's derivative layer (``optimal_control_problem_tpu_torch/stagewise.py``,
``torch.func`` under a flattened stage x batch vmap) against the JAX
package's batch-last blocks and vectors for cart-pole h6 at the same
``(x, p)``: rtol 1e-5, atol 1e-6 (f32; the two frameworks' trig and AD
round differently in the last ulps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu import stagewise as jsw
from optimal_control_problem_tpu.models import cartpole as jcp
from optimal_control_problem_tpu_torch import stagewise as tsw
from optimal_control_problem_tpu_torch.models import cartpole as tcp
from torch_threads import one_torch_thread  # noqa: F401

H, B = 6, 3


def point(seed):
    rng = np.random.default_rng(seed)
    xT = rng.normal(size=(H * tcp.FRAME, B)).astype(np.float32)
    pT = rng.uniform(2.0, 4.0, size=(1, B)).astype(np.float32)
    return xT, pT


@pytest.mark.parametrize("hessian_reg", ["auto", 0.5, "eigh"])
def test_stage_blocks_batch_match_jax(hessian_reg):
    xT, pT = point(0)
    ours = tsw.build_stage_blocks_batch(tcp.stage_structure(H, 0.04), torch.float32, hessian_reg)(
        torch.as_tensor(xT), torch.as_tensor(pT)
    )
    ref = jsw.build_stage_blocks_batch(jcp.stage_structure(H, 0.04), jnp.float32, hessian_reg)(
        jnp.asarray(xT), jnp.asarray(pT)
    )
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32 and a.is_contiguous()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_stage_vectors_batch_match_jax():
    xT, pT = point(1)
    g, c = tsw.build_stage_vectors_batch(tcp.stage_structure(H, 0.04), torch.float32)(
        torch.as_tensor(xT), torch.as_tensor(pT)
    )
    gj, cj = jsw.build_stage_vectors_batch(jcp.stage_structure(H, 0.04), jnp.float32)(
        jnp.asarray(xT), jnp.asarray(pT)
    )
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-6)


def test_stagewise_fns_match_jax():
    xT, pT = point(2)
    x, p = xT[:, 0], pT[:, 0]
    ss_t, ss_j = tcp.stage_structure(H, 0.04), jcp.stage_structure(H, 0.04)
    f, g, lbg, ubg = tsw.build_stagewise_fns(ss_t)
    fj, gj, lbgj, ubgj = jsw.build_stagewise_fns(ss_j)
    np.testing.assert_allclose(
        float(f(torch.as_tensor(x), torch.as_tensor(p))),
        float(fj(jnp.asarray(x), jnp.asarray(p))), rtol=1e-5,
    )
    np.testing.assert_allclose(
        g(torch.as_tensor(x), torch.as_tensor(p)).numpy(),
        np.asarray(gj(jnp.asarray(x), jnp.asarray(p))), rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_array_equal(lbg, lbgj)
    np.testing.assert_array_equal(ubg, ubgj)
    # per-scenario blocks are the batch-last evaluator at a batch of one
    ours = tsw.build_stage_blocks(ss_t, torch.float32)(torch.as_tensor(x), torch.as_tensor(p))
    batch = tsw.build_stage_blocks_batch(ss_t, torch.float32)(
        torch.as_tensor(xT), torch.as_tensor(pT)
    )
    for a, b in zip(ours, batch):
        torch.testing.assert_close(a, b[..., 0], rtol=1e-6, atol=1e-7)


# ---- quadrotor (w=16, r=12, per-stage reference slices) ----------------

from optimal_control_problem_tpu.models import quadrotor as jqr  # noqa: E402
from optimal_control_problem_tpu_torch.models import quadrotor as tqr  # noqa: E402

HQ = 5


def quad_point(seed):
    """Frames near hover with random attitudes and rates; per-stage
    reference positions."""
    rng = np.random.default_rng(seed)
    fr = np.tile(tqr.initial_state(), (HQ, B, 1)) + 0.3 * rng.normal(size=(HQ, B, tqr.FRAME))
    xT = np.ascontiguousarray(np.moveaxis(fr, 1, -1).reshape(HQ * tqr.FRAME, B), np.float32)
    pT = rng.normal(size=(HQ * 3, B)).astype(np.float32)
    return xT, pT


@pytest.mark.parametrize("hessian_reg", ["auto", 0.5])
def test_quadrotor_stage_blocks_batch_match_jax(hessian_reg):
    xT, pT = quad_point(3)
    ours = tsw.build_stage_blocks_batch(tqr.stage_structure(HQ, 0.02), torch.float32, hessian_reg)(
        torch.as_tensor(xT), torch.as_tensor(pT)
    )
    ref = jsw.build_stage_blocks_batch(jqr.stage_structure(HQ, 0.02), jnp.float32, hessian_reg)(
        jnp.asarray(xT), jnp.asarray(pT)
    )
    assert tuple(ours[0].shape) == (HQ, 16, 16, B) and tuple(ours[1].shape) == (HQ - 1, 12, 16, B)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32 and a.is_contiguous()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_quadrotor_stage_vectors_and_derivatives_match_jax():
    xT, pT = quad_point(4)
    g, c = tsw.build_stage_vectors_batch(tqr.stage_structure(HQ, 0.02), torch.float32)(
        torch.as_tensor(xT), torch.as_tensor(pT)
    )
    gj, cj = jsw.build_stage_vectors_batch(jqr.stage_structure(HQ, 0.02), jnp.float32)(
        jnp.asarray(xT), jnp.asarray(pT)
    )
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-6)
    fr = xT[:, 0].reshape(HQ, tqr.FRAME)
    ours = tqr.quadrotor_derivatives(*(torch.as_tensor(fr[:, s]) for s in (
        slice(3, 6), slice(6, 9), slice(9, 12), slice(12, 16))))
    ref = jqr.quadrotor_derivatives(*(jnp.asarray(fr[:, s]) for s in (
        slice(3, 6), slice(6, 9), slice(9, 12), slice(12, 16))))
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
