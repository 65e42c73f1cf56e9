"""B3's FP32 form: the operator slices it stages at 16 and 32 scenarios a
block, the most that fit, in the emulated build (the CUDA emulation of
``torch_emulation.py``).
"""

import pytest

from optimal_control_problem_tpu_torch.ops import shared_kernel as sk
from torch_emulation import (  # noqa: F401  (module fixtures)
    cr_layout,
    dl_smem,
    emu_lib,
    emulate,
    stage_rows,
    tc_layout,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("rows", [sk.ROWS_PER_BLOCK[i] for i in (1, 2)])
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
