"""B3's FP32 form (``csrc/shared_chunk.cu``) emulated on the CPU, bitwise
against its plain version, and its stage rows at 8 scenarios a block (the
CUDA emulation of ``torch_emulation.py``).
"""

import pytest
import torch

from optimal_control_problem_tpu_torch.ops import shared_kernel as sk
from torch_emulation import (  # noqa: F401  (module fixtures)
    SHARED_CASES,
    assert_bitwise,
    cr_layout,
    dl_smem,
    emu_lib,
    emulate,
    shared_chunk_case,
    stage_rows,
    tc_layout,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("B,n,m,rows,variation", SHARED_CASES,
                         ids=[f"B{c[0]}-n{c[1]}-m{c[2]}-rows{c[3]}-{c[4]}" for c in SHARED_CASES])
def test_shared_chunk_emulated_matches_plain(emulate, B, n, m, rows, variation):
    args, kw = shared_chunk_case(B, n, m)
    args = list(args)
    if variation == "forced":
        kw = {**kw, "eps_abs": 0.0, "eps_rel": 0.0}
        args[1] = 7
    elif variation == "converging":
        args[1] = 1000
    elif variation == "nan":
        # One scenario diverged: its NaN residual keeps its group open to
        # the budget, as in the plain version.
        args[8] = args[8].clone()
        args[8][1] = float("nan")
        args[1] = 100
    else:
        kw = {**kw, "eps_abs": 0.0, "eps_rel": 0.0, "batch_tile": B // 4}
        args[0] = torch.zeros(B, dtype=torch.bool)
        args[0][B // 2:3 * B // 4] = True
        args[1] = 10
    out_p = sk.shared_admm_chunk_plain(*args, **kw)
    B_, n_, m_, bound, done0, cinv = sk._contract(
        *args[:11], args[11], *args[12:], kw["check_every"], kw["batch_tile"])
    out_k = sk._launch(done0, bound, *args[2:11], cinv, *args[12:], rows, **kw)
    assert_bitwise(out_k, out_p)
    assert emulate.rcs == [0]
    if variation == "forced":
        assert bool((out_k[4] == 10).all())
    elif variation == "converging":
        assert bool(out_k[3].all()) and 0 < int(out_k[4][0]) < 1000
    elif variation == "nan":
        assert not bool(out_k[3][1]) and bool((out_k[4] == 100).all())
    else:
        g = slice(B // 2, 3 * B // 4)
        assert bool((out_k[4][g] == 0).all()) and bool((out_k[4][:B // 2] == 10).all())


@pytest.mark.parametrize("rows", [sk.ROWS_PER_BLOCK[i] for i in (0,)])
@pytest.mark.parametrize("n,m", [(120, 196), (6, 9), (40, 36), (600, 1200), (700, 1000),
                                 (118, 195), (2400, 40)])
def test_stage_rows_are_the_most_that_fit(stage_rows, rows, n, m):
    """Three slices of ``ks`` operator rows fit beside the panels, twice as
    many would not (or ``ks`` is the cap of 32); ``0`` where no slice fits
    or ``max(n, m)`` is no multiple of 4, ``-1`` where the panels alone
    do not fit."""
    J = max(n, m)
    ks = stage_rows(rows, n, m)

    def bytes_(k):
        return (rows * (3 * n + 3 * m) + 3 * k * J + 5 * rows) * 4

    if bytes_(0) > sk.SMEM_LIMIT:
        assert ks == -1
    elif J % 4 or bytes_(4) > sk.SMEM_LIMIT:
        assert ks == 0
    else:
        assert ks in (4, 8, 16, 32) and bytes_(ks) <= sk.SMEM_LIMIT
        assert ks == 32 or bytes_(2 * ks) > sk.SMEM_LIMIT
