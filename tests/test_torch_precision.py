"""The ``precision`` / ``iter_precision`` variants of the port's shared and
dense ADMM against the JAX package — mirrors
``tests/test_shared_fused.py::test_iter_precision_*`` on both backends,
and adds the outer ``precision`` dispatch and the bf16_3x product itself.

What is compared.  On the TPU ``HIGH`` is bf16_3x and the JAX tests pin
only dispatch, because JAX on the CPU computes every precision in exact
f32.  The port's plain version rounds as the TPU does (each f32 operand
split into bf16 hi + lo, ``hi hi + hi lo + lo hi`` summed in f32), so a
converged port solve is held to JAX's at the converged tolerance of
``test_shared_fused.py`` (rtol 1e-3, atol 2e-3), and the split product to
its float64 evaluation at f32 roundoff.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_problem_tpu.solvers import admm_batched as jab
from optimal_control_problem_tpu.solvers.admm import ADMMSettings as JSettings
from optimal_control_problem_tpu_torch.ops import shared_kernel as sk
from optimal_control_problem_tpu_torch.solvers import admm_batched as tab
from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings
from torch_threads import one_torch_thread  # noqa: F401

BASE = dict(eps_abs=1e-4, eps_rel=1e-4, method="condensed", adaptive_rho=True)


def problem(B=16, n=6, m=9, seed=0):
    """The random shared QP batch of tests/test_shared_fused.py::_problem."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, n))
    P = (L @ L.T + 0.5 * np.eye(n)).astype(np.float32)
    A = rng.normal(size=(m, n)).astype(np.float32)
    qs = rng.normal(size=(B, n)).astype(np.float32)
    centers = rng.normal(size=(B, n)) @ A.T
    ls = (centers - rng.uniform(0.2, 1.5, size=(B, m))).astype(np.float32)
    us = (centers + rng.uniform(0.2, 1.5, size=(B, m))).astype(np.float32)
    return P, A, qs, ls, us


def solve_jax(prob, **kw):
    P, A, qs, ls, us = map(jnp.asarray, prob)
    st = JSettings(**{**BASE, **kw})
    fac = jab.prepare_shared(P, A, ls, us, qs, st)
    return jab.admm_iterate_prepared(fac, qs, ls, us, st)


def solve_port(prob, **kw):
    P, A, qs, ls, us = (torch.as_tensor(a) for a in prob)
    st = ADMMSettings(**{**BASE, **kw})
    fac = tab.prepare_shared(P, A, ls, us, qs, st)
    return tab.admm_iterate_prepared(fac, qs, ls, us, st)


@pytest.mark.parametrize("mode", ["high", "mixed"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_iter_precision_variants_converge_to_same_solution(mode, backend, monkeypatch):
    """Both backends take the variant (``"pallas"`` through the chunk's
    plain version with ``iter_precision`` passed on), converge, and land
    on JAX's default-precision solution and on JAX's own variant."""
    calls = []
    real = tab.shared_admm_chunk
    monkeypatch.setattr(tab, "shared_admm_chunk",
                        lambda *a, **k: calls.append(k["iter_precision"]) or real(*a, **k))
    prob = problem()
    base = solve_jax(prob, backend=backend)
    jlow = solve_jax(prob, backend=backend, iter_precision=mode)
    low = solve_port(prob, backend=backend, iter_precision=mode)
    assert bool(low.converged.all()) and bool(jnp.all(base.converged))
    assert calls == ([mode] * len(calls) if backend == "pallas" else []) and (
        backend == "xla" or calls)
    for ref in (base, jlow):
        np.testing.assert_allclose(low.x.numpy(), np.asarray(ref.x), rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_outer_precision_takes_the_xla_loop(precision, monkeypatch):
    """``precision != "highest"`` sends ``backend="pallas"`` to the XLA
    loop, as JAX does (its kernel computes at f32): no chunk is called.
    ``"high"`` converges to JAX's solution; ``"default"`` (every product,
    residuals too, one bf16 pass) floats at bf16's floor, as JAX measured
    on the TPU, and stays within bf16 accuracy (5e-2) of it."""
    calls = []
    monkeypatch.setattr(tab, "shared_admm_chunk", lambda *a, **k: calls.append(1))
    prob = problem()
    ref = solve_jax(prob, backend="pallas", precision=precision)
    low = solve_port(prob, backend="pallas", precision=precision,
                     **({"max_iter": 400} if precision == "default" else {}))
    assert not calls
    if precision == "high":
        assert bool(low.converged.all())
        np.testing.assert_allclose(low.x.numpy(), np.asarray(ref.x), rtol=1e-3, atol=2e-3)
    else:
        np.testing.assert_allclose(low.x.numpy(), np.asarray(ref.x), atol=5e-2)


def test_iter_precision_validated():
    with pytest.raises(ValueError):
        ADMMSettings(iter_precision="hi")
    with pytest.raises(ValueError):
        ADMMSettings(precision="f16")
    with pytest.raises(ValueError, match="iter_precision"):
        sk.shared_admm_chunk_plain(*([None] * 15), check_every=1, sigma=0.0, alpha=1.0,
                                   eps_abs=0.0, eps_rel=0.0, batch_tile=1, iter_precision="hi")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_product_equals_its_float64_evaluation(seed):
    """The plain bf16_3x product is the float64 value of the same split
    (``hi hi + hi lo + lo hi`` of the bf16 parts, exact) to f32 roundoff of
    its terms: |error| <= 4 eps32 (|a| @ |w|) elementwise.  The split is
    exact where it should be: ``hi`` is bf16(a), ``hi + lo`` carries a to
    ~2^-17 relative, and NaN stays NaN."""
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(rng.normal(size=(37, 53)) * 10 ** rng.uniform(-3, 3, (37, 1)),
                        dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(53, 29)), dtype=torch.float32)
    got = sk.precision_matmul(a, w, "high")
    (a_hi, a_lo), (w_hi, w_lo) = sk.split_bf16(a), sk.split_bf16(w)
    assert torch.equal(a_hi, a.to(torch.bfloat16).float())
    assert torch.equal(a_lo.to(torch.bfloat16).float(), a_lo)
    assert float(((a_hi + a_lo - a).abs() / a.abs()).max()) <= 2.0 ** -16
    d = lambda t: t.double()  # noqa: E731
    exact = d(a_hi) @ d(w_hi) + d(a_hi) @ d(w_lo) + d(a_lo) @ d(w_hi)
    bound = 4 * np.finfo(np.float32).eps * (d(a).abs() @ d(w).abs())
    assert bool(((d(got) - exact).abs() <= bound).all())
    # Against the true product: bf16_3x's own error (lo lo dropped, the
    # parts' representation) is ~2^-16 of the terms.
    true = d(a) @ d(w)
    assert bool(((d(got) - true).abs() <= 2.0 ** -14 * (d(a).abs() @ d(w).abs())).all())
    # One bf16 pass ("default") is ~2^-8 of the terms.
    one = sk.precision_matmul(a, w, "default")
    assert bool(((d(one) - true).abs() <= 2.0 ** -6 * (d(a).abs() @ d(w).abs())).all())
    assert torch.equal(sk.precision_matmul(a, w, "highest"), a @ w)
    nan = a.clone()
    nan[3, 5] = float("nan")
    out = sk.precision_matmul(nan, w, "high")
    assert bool(torch.isnan(out[3]).all()) and bool(torch.isfinite(out[:3]).all())


def test_fused_gemm_keeps_jax_zt_precision(monkeypatch):
    """The single-GEMM form computes its one product at the x products'
    precision, zt included, even at ``"mixed"`` (JAX's quirk, kept): under
    ``"mixed"`` every product of its loop goes through the bf16_3x split,
    and the solve still lands on JAX's."""
    seen = []
    real = tab.matmul_split
    monkeypatch.setattr(tab, "matmul_split", lambda a, ws: seen.append(a.shape) or real(a, ws))
    prob = problem()
    low = solve_port(prob, fused_gemm=True, iter_precision="mixed")
    ref = solve_jax(prob, fused_gemm=True, iter_precision="mixed")
    n, m = prob[0].shape[0], prob[1].shape[0]
    assert seen and all(s == (16, n + m) for s in seen)
    assert bool(low.converged.all())
    np.testing.assert_allclose(low.x.numpy(), np.asarray(ref.x), rtol=1e-3, atol=2e-3)


def test_mma_fragments_follow_the_ptx_layout():
    """``tc_operator_slices`` holds each operator entry where the
    tensor-core kernel's matrix descriptors read it: ``A[j, k] = w[k, j]``
    in K-major core matrices of 8 rows by 8 k (16 bytes a row), the k
    halves of a row group 128 bytes apart and the row groups 256 bytes
    apart, one k16 slice (hi, then lo) after another, in passes of 256
    output columns; rebuilt from the flat values, hi and lo are
    ``split_bf16`` of the zero-padded operator."""
    w = torch.as_tensor(np.random.default_rng(3).normal(size=(37, 300)), dtype=torch.float32)
    flat = sk.tc_operator_slices(w)
    Kp, Jp = 48, 320  # 37 -> 48, 300 -> 320: passes of 256 and 64 columns
    assert flat.dtype == torch.bfloat16 and flat.shape == (2 * Kp * Jp,)
    vals = flat.float()
    hi, lo = torch.zeros(Kp, Jp), torch.zeros(Kp, Jp)
    off = 0
    for p0, W in ((0, 256), (256, 64)):
        for s_ in range(Kp // 16):
            for part, dst in ((0, hi), (1, lo)):
                for j in range(W):
                    for k in range(16):
                        at = off + part * W * 32 + (j // 8) * 256 + (k // 8) * 128 \
                            + (j % 8) * 16 + (k % 8) * 2
                        dst[16 * s_ + k, p0 + j] = vals[at // 2]
            off += W * 16 * 2 * 2  # bytes of the slice: hi and lo
    wp = torch.zeros(Kp, Jp)
    wp[:37, :300] = w
    h, lo_ = sk.split_bf16(wp)
    assert torch.equal(hi, h) and torch.equal(lo, lo_)


def test_tc_block_rows_rule():
    """The tensor-core form holds 16 or 32 scenarios a block, its split
    panel and two ring slots in the budget: 32 at the main path's B=4096,
    n=120, m=196 (and at the augmented n=160, m=236), 16 at the B=64
    latency batch."""
    assert sk.shared_block_rows(4096, 4096, 120, 196, 132, tensor_cores=True) == 32
    assert sk.shared_block_rows(4096, 4096, 160, 236, 132, tensor_cores=True) == 32
    assert sk.shared_block_rows(64, 64, 120, 196, 132, tensor_cores=True) == 16
    assert sk.tc_split_floats(120, 196) == 208
    assert sk.tc_block_bytes(32, 120, 196) == 128 + 2 * 16384 + 26624 + 121344 + 640
    with pytest.raises(ValueError, match="16 scenarios"):
        sk.shared_block_rows(64, 64, 1200, 1960, 132, tensor_cores=True)
