"""B4 (``csrc/banded_cr_chunk.cu``) emulated on the CPU, bitwise against its
plain version, and its slab layout at the sizes it takes and refuses (the
CUDA emulation of ``torch_emulation.py``).
"""

import pytest

from optimal_control_problem_tpu_torch.ops import banded_cr_kernel as bck
from torch_emulation import (  # noqa: F401  (module fixtures)
    CR_CASES,
    cr_layout,
    dl_smem,
    emu_lib,
    emulate,
    run_banded,
    stage_chunk_case,
    stage_rows,
    tc_layout,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("N,w,r,r2,B,case_kw", CR_CASES,
                         ids=[f"N{c[0]}-w{c[1]}-B{c[4]}" for c in CR_CASES])
def test_cr_chunk_emulated_matches_plain(emulate, N, w, r, r2, B, case_kw):
    out = run_banded(bck, {}, stage_chunk_case(N, w, r, r2, B, **case_kw))
    assert emulate.rcs == [0] and int(out[8].max()) > 0


def test_cr_layout_refuses_sizes_the_kernel_does_not_take(cr_layout):
    assert cr_layout(1, 16, 12, 1) != 0
    assert cr_layout(100, 17, 12, 1) != 0
    assert cr_layout(100, 16, 0, 1) != 0


@pytest.mark.parametrize("N,w,r,r2", [
    (2, 3, 2, 1),
    (7, 5, 4, 1),
    (25, 16, 12, 1),
    (100, 16, 12, 1),
    (101, 16, 12, 1),
    (150, 16, 12, 1),
])
def test_cr_layout_fits_and_fills_greedily(cr_layout, N, w, r, r2):
    """The layout the C entry point derives (and checks ``per`` against):
    its slab is ``cr_slab_floats``; its shared memory fits the card's
    232,448 bytes; the region holds level 0's three products where they
    fit, else nothing, and J0, J1 where both fit in it; a tier left in the
    slab would not have fitted after the ones placed before it."""
    t = cr_layout(N, w, r, r2)
    limit = 232448
    _, nd, nl = bck.cr_level_plan(N)
    ww = w * w

    def r4(n):
        return -(-n // 4) * 4

    assert t["per"] == bck.cr_slab_floats(N, w, r, r2)
    assert t["smem_bytes"] <= limit
    fl = 16 * 7 + 8 + 256  # the residual maxima of 16 warps and a zero block
    products = r4(3 * ((N + 1) // 2) * ww)
    assert t["region"] == (products if (fl + products) * 4 <= limit else 0)
    assert t["j_region"] == int(2 * (N - 1) * r * w <= t["region"])
    fl += t["region"]
    sizes = {"vec": 3 * (N + 1) * w + nd * w, "st": 3 * N * w + 2 * (N - 1) * r + 2 * N * r2,
             "ov": 6 * N * w + 4 * (N - 1) * r + 4 * N * r2, "dinvt": (nd + 1) * ww,
             "lp": nl * ww, "lpt": nl * ww}
    for k, n in sizes.items():
        if t[k]:
            fl += r4(n)
        else:
            assert (fl + r4(n)) * 4 > limit, k
    assert fl * 4 == t["smem_bytes"]
