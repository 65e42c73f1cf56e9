"""B3's tensor-core form (``csrc/shared_chunk_tc.cu``) emulated on the CPU,
held to its plain version at its tolerance, and its packing kernel bitwise
against ``tc_operator_slices`` (the CUDA emulation of
``torch_emulation.py``).
"""

import numpy as np
import pytest
import torch

from optimal_control_problem_tpu_torch.ops import shared_kernel as sk
from torch_emulation import (  # noqa: F401  (module fixtures)
    TC_CASES,
    TC_CHUNK,
    TC_CONVERGED,
    TC_ONE_ITER,
    _run_entry,
    cr_layout,
    dl_smem,
    emu_lib,
    emulate,
    rel_gap,
    run_tc,
    stage_rows,
    tc_case,
    tc_layout,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("B,n,m,rows,mode,variation", TC_CASES,
                         ids=[f"B{c[0]}-n{c[1]}-m{c[2]}-rows{c[3]}-{c[4]}-{c[5]}" for c in TC_CASES])
def test_shared_chunk_tc_emulated_matches_plain(emulate, B, n, m, rows, mode, variation):
    args, kw = tc_case(B, n, m, mode, variation)
    out_p = sk.shared_admm_chunk_plain(*args, **kw)
    out_k = run_tc(args, kw, rows)
    assert emulate.rcs == [0]
    if variation == "converging":
        assert int((out_k[4] - out_p[4]).abs().max()) <= kw["check_every"]
    else:
        assert torch.equal(out_k[4], out_p[4])
    limit = {"one": TC_ONE_ITER, "converging": TC_CONVERGED}.get(variation, TC_CHUNK)
    gaps = {nm: rel_gap(a, b) for nm, a, b in zip(("x", "z", "y"), out_k[:3], out_p[:3])}
    assert max(gaps.values()) <= limit, gaps
    # The residuals are FP32 chains of iterates that differ by the above;
    # a residual is a difference of nearly equal terms, so its gap is held
    # against the magnitude it is relative to (max_prim = rp / rp_rel).
    for i in (5, 6):
        fin = torch.isfinite(out_p[i]) & (out_p[i + 2] > 0)
        assert torch.equal(torch.isfinite(out_k[i]), torch.isfinite(out_p[i]))
        scale = (out_p[i] / out_p[i + 2])[fin]
        assert bool(((out_k[i][fin] - out_p[i][fin]).abs() <= 10 * limit * scale).all())
        assert bool(((out_k[i + 2][fin] - out_p[i + 2][fin]).abs() <= 10 * limit).all())
    if variation == "converging":
        assert bool(out_k[3].all()) and bool(out_p[3].all())
        assert 0 < int(out_k[4][0]) < 1000
    elif variation == "nan":
        assert not bool(out_k[3][1]) and bool((out_k[4] == 10).all())
        assert bool(torch.isnan(out_k[0][1]).all())
    elif variation == "groups":
        g = slice(B // 2, 3 * B // 4)
        assert bool((out_k[4][g] == 0).all()) and bool((out_k[4][:B // 2] == 10).all())
        assert all(torch.equal(out_k[i][g], args[12 + i][g]) for i in range(3))
    else:
        assert torch.equal(out_k[3], out_p[3])


@pytest.mark.parametrize("K,J", [(196, 120), (120, 196), (37, 300), (12, 232)])
def test_tc_pack_kernel_matches_tc_operator_slices(emu_lib, K, J):
    """The entry point's packing kernel lays an operator out bit for bit as
    its plain version ``tc_operator_slices`` does: the main path's Ab
    (196 x 120) and Ab^T, an operator of two passes (300 output columns:
    256 and 64), and one whose k pads from 12 to 16."""
    w = torch.as_tensor(np.random.default_rng(K + J).normal(size=(K, J)), dtype=torch.float32)
    w[0, 0] = float("nan")
    want = sk.tc_operator_slices(w)
    out = torch.zeros_like(want)
    rc = _run_entry(emu_lib, "shared_chunk_tc", "ocp_shared_tc_pack_f32", [w, out], (K, J), ())
    assert rc == 0
    # A NaN's bits are not specified (torch's CPU conversion gives 0xffff
    # here, the emulated cvt.rn 0x7fc0): NaN where NaN, every other half
    # bitwise.
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(out), nan) and bool(nan.any())
    assert torch.equal(out.view(torch.int16)[~nan], want.view(torch.int16)[~nan])
