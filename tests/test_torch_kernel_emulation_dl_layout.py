"""B5's layout as its C entry point derives it in the emulated build: the
tier rule either side of each boundary and each tier's shared memory (the
CUDA emulation of ``torch_emulation.py``).
"""

import pytest

from optimal_control_problem_tpu_torch.ops import admm_kernel as ak
from torch_emulation import (  # noqa: F401  (module fixtures)
    cr_layout,
    dl_smem,
    emu_lib,
    emulate,
    stage_rows,
    tc_layout,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("n,m,tier", [
    (100, 196, 1), (120, 236, 2), (200, 392, 3),
    (91, 258, 1), (91, 259, 2),     # tier 1 at exactly 232,448 bytes, then one row more
    (100, 444, 2), (100, 445, 3),   # the last m of tier 2 at n=100, then one more
    (7, 13, 1), (1, 1, 1), (700, 10, 3),
])
def test_device_loop_tier_rule(dl_smem, n, m, tier):
    """``kernel_tier`` is the first tier whose block (the C entry point's
    count) fits the card's 232,448 bytes: pinned at the dense cart-pole
    QP, at n=120, m=236 and n=200, m=392, and either side of each
    boundary."""
    assert ak.kernel_tier(n, m) == tier
    assert dl_smem(tier, n, m) <= ak.SMEM_LIMIT
    assert all(dl_smem(t, n, m) > ak.SMEM_LIMIT for t in range(1, tier))
    assert dl_smem(1, 91, 258) == ak.SMEM_LIMIT


@pytest.mark.parametrize("tier,n,m,nbytes", [
    (1, 100, 196, 204_544),
    (2, 100, 196, 126_144),
    (1, 120, 236, 299_120),
    (2, 120, 236, 185_840),
    (2, 200, 392, 498_304),
    (1, 7, 13, 2_384),
])
def test_device_loop_smem_of_each_tier(dl_smem, tier, n, m, nbytes):
    assert dl_smem(tier, n, m) == nbytes
