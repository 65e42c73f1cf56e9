"""B5 (``csrc/admm_device_loop.cu``) emulated on the CPU in its tiers 2 and 3,
bitwise against its plain version (the CUDA emulation of
``torch_emulation.py``; tier 1 and the other kernels in the other
``test_torch_kernel_emulation*.py`` files).
"""

import pytest

from optimal_control_problem_tpu_torch.ops import admm_kernel as ak
from torch_emulation import (  # noqa: F401  (module fixtures)
    DEVICE_LOOP_CASES,
    assert_bitwise,
    cr_layout,
    device_loop_case,
    dl_smem,
    emu_lib,
    emulate,
    stage_rows,
    tc_layout,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("tier", [2, 3])
@pytest.mark.parametrize("B,n,m,max_iter,check_every,diverging,eps", DEVICE_LOOP_CASES,
                         ids=[f"B{c[0]}-n{c[1]}-m{c[2]}" + ("-nan" if c[5] else "")
                              for c in DEVICE_LOOP_CASES])
def test_device_loop_tier_emulated_matches_plain(emulate, tier, B, n, m, max_iter,
                                                  check_every, diverging, eps):
    """Each tier (forced through the wrapper's launch path) bitwise equal to
    the plain version: iterates, NaN where NaN, signs of zeros, ``it``."""
    args = list(device_loop_case(B, n, m, diverging))
    args[12] = args[13] = eps
    out_p = ak.admm_device_loop_plain(*args, max_iter=max_iter, check_every=check_every)
    out_k = ak._launch(*args, max_iter, check_every, tier)
    assert_bitwise(out_k, out_p)
    assert emulate.rcs == [0]
    if eps == 0.0:
        assert bool((out_k[3] == -(-max_iter // check_every) * check_every).all())
    if diverging:
        assert bool(out_k[0].isnan().any())
    elif eps:
        assert len(set(out_k[3].tolist())) > 1  # masked: scenarios stop apart
