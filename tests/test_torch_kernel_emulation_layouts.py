"""Layouts the C entry points derive in the emulated builds against the host
rules that mirror them: B4's slab, B5's shared memory of each tier, and
B3's block rows in both forms (the CUDA emulation of
``torch_emulation.py``).
"""

import pytest

from optimal_control_problem_tpu_torch.ops import banded_cr_kernel as bck
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


@pytest.mark.parametrize("N,w,r,r2", [
    (400, 16, 12, 1),
    (600, 3, 2, 1),
    (1500, 3, 2, 1),
    (9, 7, 5, 3),
    (60, 1, 1, 1),
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


@pytest.mark.parametrize("tier,n,m,nbytes", [
    (2, 7, 13, 1_824),
    (3, 200, 392, 256),
    (0, 7, 13, -1),
    (4, 7, 13, -1),
])
def test_device_loop_smem_of_each_tier(dl_smem, tier, n, m, nbytes):
    assert dl_smem(tier, n, m) == nbytes


def test_block_rows_rule_takes_only_shapes_the_entry_point_takes(stage_rows):
    """The block-shape rule's panel check agrees with the C entry point's:
    it picks a shape whose panels fit, and raises only where not even a
    block of 8 fits."""
    for n, m in [(120, 196), (6, 9), (40, 36), (232, 12), (600, 1200), (1000, 2000),
                 (700, 1000), (2400, 40), (1600, 3200)]:
        for B in (64, 4096):
            try:
                rows = sk.shared_block_rows(B, B, n, m, 132)
            except ValueError:
                assert stage_rows(8, n, m) == -1, (n, m)
            else:
                assert stage_rows(rows, n, m) >= 0, (n, m, rows)


@pytest.mark.parametrize("n,m", [(120, 196), (160, 236), (40, 36), (232, 12), (600, 1200)])
def test_tc_block_rows_rule_takes_only_shapes_the_entry_point_takes(tc_layout, n, m):
    """The tensor-core form's block-shape rule (its split panel and two
    ring slots in the bytes, ``tc_block_bytes``) agrees with the C entry
    point: a shape it picks fits there in both modes, and it raises only
    where not even 16 rows fit.  At the main path's n=120, m=196 (B=4096)
    it takes 32 rows with five ring slots of 16 KiB at "high" and FP32
    slices of 32 rows in the ring (230,656 bytes with the static results),
    at "mixed" five slots of 8 KiB and FP32 slices of 16 rows beside them;
    at the augmented n=160, m=236 32 rows with two slots of 16 KiB at
    "high" and three of 12 KiB at "mixed"."""
    try:
        rows = sk.shared_block_rows(4096, 4096, n, m, 132, tensor_cores=True)
    except ValueError:
        assert tc_layout(16, n, m, 1) is None
        return
    for mode in (1, 2):
        lay = tc_layout(rows, n, m, mode)
        assert lay is not None and lay[3] + 5 * rows * 4 <= sk.SMEM_LIMIT
    assert tc_layout(rows, n, m, 1)[0] >= sk.TC_MIN_STAGES
    assert sk.tc_block_bytes(rows, n, m) <= sk.SMEM_LIMIT
    if (n, m) == (120, 196):
        assert rows == 32
        assert tc_layout(32, n, m, 1) == (5, 16384, 32, 230656 - 640)
        assert tc_layout(32, n, m, 2)[:3] == (5, 8192, 16)
    if (n, m) == (160, 236):
        assert rows == 32
        assert tc_layout(32, n, m, 1)[:2] == (2, 16384)
        assert tc_layout(32, n, m, 2)[:2] == (3, 12288)
