"""The port's CUDA kernels (five sources and B3's tensor-core form) run on
the CPU through a thread emulation of CUDA, each held bitwise to its plain
PyTorch version (B3's tensor-core form at a tolerance: see its test).

There is no GPU or ``nvcc`` here, so each ``csrc/*.cu`` is compiled with
``g++ -std=c++20 -ffp-contract=off`` (no FMA contraction, as ``nvcc
-fmad=false``) against a small header, :data:`EMU_HEADER`, that stands in
for the CUDA runtime:

* every CUDA thread of a block is one fiber (a ``ucontext`` user-level
  thread with its own stack); a scheduler on one OS thread runs the
  block's fibers in turn, each until it reaches a barrier or exits, and
  the blocks of a launch one after another.  So the emulation needs one
  core, whatever else runs beside it, and a barrier no thread can pass
  (a deadlock) aborts at once;
* ``__syncthreads()`` releases when every thread of the block waits at
  it (one reached after a thread exited, or a thread exiting while others
  wait at it, aborts: on the card that barrier would never release),
  ``__syncwarp()`` when every thread of the warp that has not exited does;
  ``__syncthreads_or/and``, ``__any_sync`` and the shuffles go through
  exchange arrays between two barriers;
* Hopper's asynchronous primitives, for ``csrc/shared_chunk_tc.cu``
  (behind the ``OCP_MMA_EMULATED`` guard): a shared address is the
  offset into the launch's dynamic shared memory; an ``mbarrier`` counts
  its phase's arrivals and transaction bytes, and a thread whose parity
  wait finds the phase open gives way to the others (a sweep in which
  every runnable thread only waits on an mbarrier, and nothing arrives
  or lands, is a deadlock and aborts); a bulk copy (``cp.async.bulk``,
  16-byte aligned, a multiple of 16 bytes) lands when the scheduler's
  sweep ends and then completes its bytes on the mbarrier; ``bar.sync id,
  count`` releases at its count; ``wgmma``'s fence, commit and wait are
  warpgroup barriers, and the product is a warpgroup-collective stand-in
  (every thread must pass the same descriptors) that is carried out at
  the ``wait_group`` that retires it: it decodes each matrix descriptor
  (start address, leading and stride byte offsets; a swizzle or base
  offset aborts), reads A and B from the emulated shared memory and adds
  each thread's k16 dot products, summed exactly and rounded once;
* ``__shared__`` arrays are ``static``, ``extern __shared__`` is a buffer of
  the launch's size, ``__ldg`` a plain load, the ``cuda_pipeline.h`` copies
  synchronous ones, and the attribute and occupancy calls are stubs with
  the H100's limits (232,448 bytes of shared memory a block, 132 SMs);
* a ``kernel<<<grid, block, smem, stream>>>(args)`` launch is rewritten to
  ``emu::launch(kernel, {grid, block, smem, stream}, args)`` before
  compiling.

The kernel is called through its wrapper's own launch path
(``_launch``-style private functions of each ``ops`` module) on CPU
tensors: the wrapper's ``launch_chunk`` is replaced by a recorder that runs
the C entry point in a child process with its own time limit (there is no
``pytest-timeout``; a hang must fail, not stall the suite) and copies the
outputs back.  The emulation reproduces every rounding of the
kernel's arithmetic, but says nothing of its speed or of what ``nvcc``
accepts.  Skips only where ``g++`` is missing.

Split over nine files, so that several test workers carry them:
this one (B1, B2 and B5's emulated runs, B5's tier 1),
``test_torch_kernel_emulation_dl_tiers.py`` (B5's tiers 2 and 3),
``test_torch_kernel_emulation_dl_layout.py`` (B5's tier rule and shared
memory), ``test_torch_kernel_emulation_cr.py`` (B4),
``test_torch_kernel_emulation_layouts.py`` (B4's slab, B3's block shapes),
``test_torch_kernel_emulation_shared.py`` and ``..._shared_rows.py`` (B3's
FP32 form and its slices), ``test_torch_kernel_emulation_tc.py`` and
``..._tc_variants.py`` (B3's tensor-core form).  The header, the build and
the launch path are in ``torch_emulation.py``; each library is built once
for all of them.
"""

import ctypes

import numpy as np
import pytest

from optimal_control_problem_tpu_torch.ops import admm_kernel as ak
from optimal_control_problem_tpu_torch.ops import banded_kernel as bk
from optimal_control_problem_tpu_torch.ops import banded_rolled_kernel as brk
from torch_emulation import (  # noqa: F401  (module fixtures)
    DEVICE_LOOP_CASES,
    assert_bitwise,
    cr_layout,
    device_loop_case,
    dl_smem,
    emu_lib,
    emulate,
    run_banded,
    stage_chunk_case,
    stage_rows,
    tc_layout,
)
from torch_threads import one_torch_thread  # noqa: F401


def test_banded_chunk_emulated_matches_plain(emulate):
    # Scenario 1 diverged (NaN): its clipped z stays NaN, as in the plain
    # version (an fmaxf/fminf clip would put it on a bound).
    out = run_banded(bk, {}, stage_chunk_case(6, 5, 4, 1, 8, max_iter=41, near_budget=True,
                                              nan_scenario=1))
    assert emulate.rcs == [0] and int(out[8].max()) > 0 and bool(out[4][..., 1].isnan().all())


@pytest.mark.parametrize("stage_bounds", [(0.5, np.inf), (-np.inf, np.inf)],
                         ids=["active-halfspace", "free-row"])
def test_banded_chunk_emulated_at_unicycle_shapes(emulate, stage_bounds):
    """The unicycle's stage shapes (w=5, r=3, r2=1) with a half-space stage
    row lb <= a^T x, ub = +inf that binds (lb 0.5 above the random rows'
    values near 0), and a row free on both sides (+-inf): the projection
    and its NaN-keeping clip against the plain version, bitwise."""
    out = run_banded(bk, {}, stage_chunk_case(8, 5, 3, 1, 4, eps=1e-4, max_iter=60,
                                              stage_bounds=stage_bounds))
    assert emulate.rcs == [0] and int(out[8].max()) > 0


def test_rolled_chunk_emulated_matches_plain(emulate):
    out = run_banded(brk, {"cr1": True}, stage_chunk_case(8, 4, 3, 1, 2, max_iter=6,
                                                          nan_scenario=0))
    assert emulate.rcs == [0] and int(out[8].max()) == 6 and bool(out[4][..., 0].isnan().all())


@pytest.mark.parametrize("diverging", [False, True])
def test_device_loop_emulated_matches_plain(emulate, diverging):
    """A converging batch, and one whose operator is no ADMM operator, so
    that a scenario's iterates overflow to NaN: its NaN residual keeps it
    running to ``max_iter`` in both (a maximum that drops NaN would stop
    it early as converged)."""
    args = device_loop_case(3, 6, 9, diverging)
    out_p = ak.admm_device_loop_plain(*args, max_iter=100, check_every=5)
    out_k = ak._launch(*args, 100, 5)
    assert_bitwise(out_k, out_p)
    assert emulate.rcs == [0]
    if diverging:
        assert bool(out_k[0].isnan().any()) and int(out_k[3].max()) == 100
    else:
        assert len(set(out_k[3].tolist())) > 1


def test_device_loop_rule_tier_emulated_at_n120_m236(emulate):
    """n=120, m=236 (row stride 124) runs in tier 2 by the rule, and the C
    entry point refuses tier 1 there (299,120 bytes)."""
    assert ak.kernel_tier(120, 236) == 2
    args = device_loop_case(1, 120, 236, seed=1)
    args = args[:12] + (0.0, 0.0) + args[14:]
    out_p = ak.admm_device_loop_plain(*args, max_iter=2, check_every=1)
    assert_bitwise(ak._launch(*args, 2, 1), out_p)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        ak._launch(*args, 2, 1, 1)
    assert emulate.rcs == [0, 1]


def test_device_loop_slab_of_tier3(emu_lib):
    """Tier 3's vector slab, which the wrapper sizes from this count: five
    n-vectors and seven m-vectors a scenario, each padded to a multiple of
    4."""
    fn = ctypes.CDLL(str(emu_lib("admm_device_loop"))).ocp_admm_device_loop_slab_floats
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_longlong
    assert fn(120, 236) == 5 * 120 + 7 * 236
    assert fn(7, 13) == 5 * 8 + 7 * 16
    assert fn(0, 13) == fn(7, 0) == -1


@pytest.mark.parametrize("tier", [1])
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
