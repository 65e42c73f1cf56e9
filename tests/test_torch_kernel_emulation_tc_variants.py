"""B3's tensor-core form: the two-slot variant the ablation times, a copy
whose descriptors carry a wrong leading byte offset (which must fail), and
the kernel's own count of the bytes its bulk copies bring (the CUDA
emulation of ``torch_emulation.py``).
"""

import pytest
import torch

from optimal_control_problem_tpu_torch.ops import shared_kernel as sk
from torch_emulation import (  # noqa: F401  (module fixtures)
    TC_CHUNK,
    TC_ONE_ITER,
    cr_layout,
    dl_smem,
    emu_lib,
    emulate,
    rel_gap,
    run_tc,
    stage_rows,
    tc_case,
    tc_layout,
    tc_variant_launch,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name,old,new", [
    ("stages2", "constexpr int kRingStages = 5;", "constexpr int kRingStages = 2;"),
], ids=["stages2"])
def test_shared_chunk_tc_variant_emulated_matches_plain(emu_lib, monkeypatch, name, old, new):
    """A variant ``tools/kernel_ablation.py`` times on the card: a ring of
    two slots (the fewest it runs with; the producer then waits on every
    slot), held to its plain version like the shipped kernel."""
    lib = emu_lib.variant(f"shared_chunk_tc_{name}", "shared_chunk_tc", old, new)
    rcs = tc_variant_launch(emu_lib, monkeypatch, lib)
    for rows, mode in ((32, "high"), (16, "mixed")):
        args, kw = tc_case(32, 232, 12, mode, "one") if mode == "high" else \
            tc_case(16, 40, 36, mode, "forced")
        out_p = sk.shared_admm_chunk_plain(*args, **kw)
        out_k = run_tc(args, kw, rows)
        assert torch.equal(out_k[4], out_p[4]) and torch.equal(out_k[3], out_p[3])
        gaps = [rel_gap(a, b) for a, b in zip(out_k[:3], out_p[:3])]
        assert max(gaps) <= (TC_ONE_ITER if mode == "high" else TC_CHUNK), gaps
    assert rcs == [0, 0]


def test_tc_descriptor_stand_in_reads_the_layout_it_is_given(emu_lib, monkeypatch):
    """The wgmma stand-in is not vacuous: with the descriptors' leading
    byte offset (between the k halves of a core-matrix pair) doubled, the
    products read the wrong core matrices and one iteration leaves its
    plain version far behind the tolerance."""
    lib = emu_lib.variant("shared_chunk_tc_lbo256", "shared_chunk_tc",
                          "constexpr unsigned kCoreLbo = 128;", "constexpr unsigned kCoreLbo = 256;")
    rcs = tc_variant_launch(emu_lib, monkeypatch, lib)
    args, kw = tc_case(16, 40, 36, "high", "one")
    out_p = sk.shared_admm_chunk_plain(*args, **kw)
    out_k = run_tc(args, kw, 16)
    assert rcs == [0]
    assert max(rel_gap(a, b) for a, b in zip(out_k[:3], out_p[:3])) > 100 * TC_ONE_ITER


@pytest.mark.parametrize("B,n,m,rows,mode", [(64, 40, 36, 16, "mixed"),
                                              (96, 40, 260, 16, "high")])
def test_tc_l2_byte_count_is_the_slices_each_open_block_streams(emulate, B, n, m, rows, mode):
    """The kernel's own count of the bytes its bulk copies bring (asked for
    with ``l2_bytes``; a launch without it passes a null counter): every
    thread block of an open group streams the packed slices of each
    tensor-core product once an iteration.  Four groups, one done at entry;
    at B=96 in blocks of 16 each group is a block of 16 and a ragged one of
    8, and zt's operator (260 columns, padded to 320) streams in passes of
    256 and 64 columns."""
    args, kw = tc_case(B, n, m, mode, "groups")
    counter = torch.zeros(1, dtype=torch.int64)
    run_kw = {k: v for k, v in kw.items() if k != "iter_precision"}
    _, _, _, bound, done0, cinv = sk._contract(*args, kw["check_every"], kw["batch_tile"])
    out_k = sk._launch_tc(done0, bound, *args[2:11], cinv, *args[12:], rows, **run_kw,
                          iter_precision=mode, l2_bytes=counter)
    assert emulate.rcs == [0]
    per_iter = sk.tc_operator_slices(args[3]).numel() + sk.tc_operator_slices(args[2]).numel()
    if mode == "high":
        per_iter += sk.tc_operator_slices(args[3].T).numel()
    per_iter *= 2  # bytes of bf16
    tile = kw["batch_tile"]
    open_blocks = 3 * -(-tile // rows)
    assert int(out_k[4].max()) == 10
    assert int(counter) == open_blocks * 10 * per_iter
