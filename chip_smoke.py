#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; exits non-zero on any failure
    python3 chip_smoke.py --profile  # also a torch.profiler window of one banded
                                     # and one dense cart-pole tick, tables
                                     # written to OUT_DIR

Phases:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel of the main paths from the sources in this
     checkout (one nvcc per source, all started together);
  3. hold each kernel against its plain PyTorch version on the card, on the
     same inputs, bitwise (gap 0, equal done/it_inc): random stage-QP
     batches scaled and padded by the port's own driver prepare -- the
     one-way chunk at cart-pole shapes (N=20, w=5, r=4, r2=1, B=1024;
     forced budget, converging, entry counts near max_iter with every
     fifth scenario frozen), at w=4 and w=3 (forced and converging) and at
     N=2; the rolled two-way chunk at quadrotor shapes (N=100, w=16, r=12,
     r2=1) at B=64 (CR level on, also with entry counts near max_iter and
     scenarios frozen at entry) and B=128 (off), at the odd horizon N=25,
     at N=2, and at w=5 as the driver's rolled=True picks it; the
     shared-operator chunk at B=4096, n=120, m=196 on the double
     integrator's own first chunk of a cold tick and on a random shared QP
     batch (forced budget that is no multiple of check_every, converging,
     all done at entry, four termination groups with one done at entry),
     with each of 8, 16 and 32 scenarios a block, the first chunk of
     random shared solves at B=64 and at n=118, m=195 (operators read
     through L1, no slices), at B=6144 (one group beyond the grid the card
     holds resident) and B=8192 (two of JAX's tiles of 6536); the dense
     device loop at B=256, n=100, m=196 on the
     cart-pole h20 dense tick's own inputs (a forced budget of 60 with
     check_every 25 in each of the kernel's three tiers, the first SQP
     step of a cold tick, a later step whose scenarios stop at different
     counts, one scenario alone), on a QP with +-inf bounds and equality
     rows, and on the first entry of random dense solves at n=120, m=236
     (tier 2) and n=200, m=392 (tier 3); the cyclic-reduction chunk at
     quadrotor shapes (N=100, w=16, r=12, r2=1) at B=64, 8 and 1 (a forced
     budget of 41 with check_every 2, entry counts near it and every fifth
     scenario frozen at entry; converging), at w=5 and w=3, at the odd horizons N=7 and
     N=25 and at N=2 (w=16), and at N=150 and N=400, w=16 and N=1500, w=3
     (shared-memory tiers in the slab); and at the shapes of phases 4f-4h:
     the one-way chunk at the unicycle's N=50, w=5, r=3, r2=1 with a binding
     half-space stage row and with one free on both sides, the device loop
     at the augmented cart-pole's odd n=101, m=197 (its own cold tick, each
     tier forced, then converging), the shared chunk at the augmented double
     integrator's n=160, m=236 (its own cold tick, in JAX's groups); and
     the shared chunk's tensor-core form (``iter_precision`` "high" and
     "mixed", bf16_3x on the tensor cores) against its plain version at a
     stated tolerance, at B=4096 and B=64, n=120, m=196 and at n=160,
     m=236: one forced iteration and a forced budget (converging chunks:
     4i's);
  4. the short-horizon main path: the batched cart-pole h20 MPC tick at
     B=1024 through ``BatchedSolver`` (2 warm-up + 5 timed ticks), checking
     the launch counts, finite trajectories, and that each warm tick lowers
     the objective or the constraint violation (see ``drive``);
  4b. the long-horizon main path: the batched quadrotor h100 tick at the
     JAX bench's settings, B=64 and B=128, with the same checks;
  4c. the LTI main path: the batched double-integrator h20 tick at the JAX
     bench's settings (shared factorization, condensed, adaptive rho),
     B=4096 and B=64, with backend="pallas" (the shared-operator chunk
     kernel) and the same checks, then the same ticks with backend="xla"
     (the torch.matmul loop), tick by tick from the same state; then two
     backend="pallas" ticks at B=6144 and B=8192 (termination groups
     beyond the grid the card holds resident at once);
  4d. the per-scenario dense main path: the batched cart-pole h20 tick
     without a stage structure (the JAX bench's ``cartpole_h20_pallas``),
     B=256, with backend="pallas" (the dense device-loop kernel) and the
     same checks, then the same ticks with backend="xla" (the torch.matmul
     loop), tick by tick from the same state;
  4e. the cyclic-reduction banded path: the quadrotor h100 tick with
     ``banded_solver: "cr"`` at B=64 and B=8 (the cyclic-reduction chunk
     kernel) with the same checks, then the same ticks with
     ``banded_solver: "thomas"`` (the rolled chunk), tick by tick from the
     same state: both medians and the largest trajectory gap (findings,
     not gates);
  4f. the augmented dense path: the cart-pole h20 tick of 4d with the
     formulation left at its default (QP n=101, m=197), B=256, "pallas" with
     the same checks, then interleaved with "xla"; then 3 ticks of the
     reference-parity preset on both backends (its nonconvex QPs diverge to
     NaN, as in the JAX package: the backends must agree on where, on the
     flags and on the iteration counts);
  4g. the unicycle h50 banded tick (``unicycle_h50_banded``: a live
     half-space row, adaptive rho, check_every 5), B=256, with the same
     checks, then the same with the merit line search;
  4h. the augmented LTI path: the double integrator tick of 4c with the
     formulation at its default (n=160, m=236), B=4096, 3 ticks;
  4i. the double integrator B=4096 tick of 4c with ``iter_precision``
     "high" and "mixed" (the tensor-core form), each tick beside the
     "highest" tick from the same state: ms/tick, QP iterations, the
     trajectories' gap;
  5. the cart-pole tick at B=64 on the card and on the CPU (plain chunk)
     agree; 5b. the quadrotor h100 tick at B=8 likewise; 5c. the double
     integrator tick at B=64 likewise; 5d. the dense cart-pole tick at B=4
     over 3 ticks likewise; 5e. the quadrotor h100 CR tick at B=8 over 2
     ticks likewise; 5f-5h. the ticks of 4f (also under the parity preset:
     NaN, flags and iteration counts equal), 4g (both step rules) and 4h at
     B=4 likewise; 5i. ``MPCController`` on the double integrator h10, 40
     closed-loop steps on the card and on the CPU (the CPU sides of 5-5i
     run in worker processes beside the card's, ``process_map``); 5j. a
     ``MIXED`` dense
     cart-pole h20 tick loop (tick 1 on the host backend, ticks 2+ through
     the device loop); 5k. the parity oracle (f64 derivatives, native C++
     QPs) against the port's product loop on the card, double integrator
     and cart-pole; 5l. ``TpuQP`` solves on the card; 5m. an
     ``export_solver``/``import_solver`` round trip of a toy solve
     (``toy_export_job``), then the batched kernel ticks exported and
     reloaded (``export_job``), all in three worker processes on the card
     started before phase 5, each batched solve cut
     to ``EXPORT_STEPS`` SQP steps): cart-pole h20 banded B=1024 (B1), the
     quadrotor h100 B=64 with "thomas" (B2) and "cr" (B4), the double
     integrator B=4096 "pallas" at "highest" and "high" (B3 in both forms)
     and the dense cart-pole B=256 "pallas" (B5); each loaded tick from
     phase 4's state gives the direct tick's QP iterations exactly and its
     plan within 1e-5, holds its kernel's op node and raises the kernel
     counters as the direct tick does;
  6. time each kernel at its main path's own inputs beside its plain
     version and its bound, the banded ones with their prologue and the
     mean and largest iteration count per launch (the rolled one also
     without its CR level, the shared one and the dense device loop also
     beside a loop of torch.matmul products; the shared one also on one
     group of 6144 and at the B=64 latency batch, each with 8, 16 and 32
     scenarios a block and beside its -fmad=false ceiling; the device loop
     on a cold and on a steady-state tick with its iteration counts, the
     steady tick's slowest scenario alone at B=1 (ms and us per
     iteration), and in tiers 2 and 3 at n=120, m=236 and n=200, m=392; the CR
     chunk at a steady B=64 and a B=8 tick beside the rolled chunk on the
     very same inputs; and at the new shapes: the one-way chunk on the
     unicycle tick's launches, the device loop on the augmented cart-pole's
     cold and steady ticks, the shared chunk on the augmented double
     integrator's steady tick; the tensor-core form on 4i's steady ticks,
     beside its plain version and a loop of torch.matmul bf16_3x
     products); and each kernel's custom op against its direct ctypes
     launch on one recorded call: the op's dispatch overhead a launch;
  7. the multi-device paths of ``parallel/`` on the card (see ``phase7``):
     ``DistributedSolver`` in-process over the cart-pole B=1024 batch
     (kernel B1), ``HorizonShardedSolver`` on the cart-pole YAML h20 over
     4 shards (3 ticks) and on a (2, 4) scenario x horizon mesh, the
     quadrotor h100 over 4 shards, a world-size-1 NCCL group against the
     in-process mesh, and the solves' bits with the caller's TF32 on;
  8. the six example twins (``examples/torch/``) at the JAX examples' own
     settings on the card (see ``phase8``), each with its original's
     asserts as gates: seconds per twin and the launches of every kernel.
The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

# Phase 5j's host backend runs scipy on small matrices, where OpenBLAS's
# threads spin (one trust-constr tick of the double integrator h8: 19.9 s
# with eight threads, 3.0 s with one, on the CPU).  Set before numpy loads.
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# NVIDIA H100 SXM data-sheet peaks (dense, no sparsity), used for bounds.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12

CHUNK_REPLACES = "optimal_control_problem_tpu/ops/banded_kernel.py:403"
CHUNK_SOURCE = "optimal_control_problem_tpu_torch/csrc/banded_chunk.cu"
ROLLED_REPLACES = "optimal_control_problem_tpu/ops/banded_rolled_kernel.py:666"
ROLLED_SOURCE = "optimal_control_problem_tpu_torch/csrc/banded_rolled_chunk.cu"
SHARED_REPLACES = "optimal_control_problem_tpu/ops/shared_kernel.py:233"
SHARED_SOURCE = "optimal_control_problem_tpu_torch/csrc/shared_chunk.cu"
SHARED_TC_SOURCE = "optimal_control_problem_tpu_torch/csrc/shared_chunk_tc.cu"
DEVLOOP_REPLACES = "optimal_control_problem_tpu/ops/admm_kernel.py:149"
DEVLOOP_SOURCE = "optimal_control_problem_tpu_torch/csrc/admm_device_loop.cu"
CR_REPLACES = "optimal_control_problem_tpu/ops/banded_cr_kernel.py:682"
CR_SOURCE = "optimal_control_problem_tpu_torch/csrc/banded_cr_chunk.cu"

MAIN_ADMM = {
    "method": "banded",
    "max_iter": 500,
    "adaptive_rho": False,
    "rho": 0.05,
    "check_every": 2,
    "scaling_refresh": "tick",
}
# The JAX bench's quadrotor h100 settings (bench_models.py:335-379).
QUAD_ADMM = {
    "method": "banded",
    "max_iter": 250,
    "adaptive_rho": False,
    "rho": 0.05,
    "check_every": 2,
    "scaling_refresh": "tick",
}


# The same with the opt-in cyclic-reduction solver (phase 4e).
QUAD_CR_ADMM = {**QUAD_ADMM, "banded_solver": "cr"}


# The JAX bench's double-integrator settings (bench.py:109-124); the backend
# is added per solver.
DI_ADMM = {
    "method": "condensed",
    "eps_abs": 1e-3,
    "eps_rel": 1e-3,
    "max_iter": 1000,
    "adaptive_rho": True,
}


# The JAX bench's unicycle_h50_banded settings (bench_models.py:310-333).
UNI_ADMM = {"method": "banded", "max_iter": 500, "check_every": 5}


# The JAX bench's cartpole_h20_pallas settings (bench_models.py:257-283);
# the backend is added per solver.
DENSE_ADMM = {
    "method": "condensed",
    "max_iter": 500,
    "adaptive_rho": False,
    "rho": 0.05,
}


# Phase 5m exports the batched ticks with their SQP steps cut to this many
# (the trace unrolls the step loop: host time grows with it); the ticks it
# compares are of that solve, direct and reloaded.
EXPORT_STEPS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def random_stage_qp_batch(seed, B, N, w, r, r2, stage_bounds=(-1.0, np.inf)):
    """Batch-last random stage QP (the shape of tests' random_stage_qp);
    ``stage_bounds``: the stage rows' (lower, upper)."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(B, N, w, w))
    Hb = L @ np.swapaxes(L, -1, -2) + 2 * np.eye(w)
    J0 = 0.5 * rng.normal(size=(B, N - 1, r, w))
    J1 = 0.5 * rng.normal(size=(B, N - 1, r, w))
    Jc = 0.5 * rng.normal(size=(B, N, r2, w))
    n = N * w
    q = rng.normal(size=(B, n))
    l = np.concatenate(
        [np.full(n, -2.0), np.zeros((N - 1) * r), np.full(N * r2, stage_bounds[0])]
    )
    u = np.concatenate(
        [np.full(n, 2.0), np.zeros((N - 1) * r), np.full(N * r2, stage_bounds[1])]
    )
    m = l.shape[0]
    last = lambda a: np.ascontiguousarray(np.moveaxis(a, 0, -1), np.float32)  # noqa: E731
    return (
        [last(a) for a in (Hb, J0, J1, Jc, q)]
        + [np.repeat(l[:, None], B, 1).astype(np.float32),
           np.repeat(u[:, None], B, 1).astype(np.float32)],
        rng.normal(size=(n, B)).astype(np.float32) * 0.1,
        rng.normal(size=(m, B)).astype(np.float32) * 0.1,
    )


def gj_flops(w):
    """Operations of one w x w Gauss-Jordan inverse: per pivot, the pivot
    row of both halves scaled (2w divisions) and the w-1 other rows
    updated (a multiply and a subtract on 2w entries each)."""
    return w * (2 * w + 4 * w * (w - 1))


def assemble_flops(N, w, r, r2):
    """Operations of M = P + sigma I + A^T R A from the stage blocks:
    sigma + rho_x onto the diagonal; rho[t] J[t, a] once per stage, row t
    and column a; then a multiply and an add per term of the J0 and J1
    chains into the diagonal blocks, of the chain into the subdiagonal
    block (which reuses rho J1[a]) and of the stage-row chain."""
    nd = N - 1
    return (2 * N * w + 2 * nd * r * w + N * r2 * w
            + nd * w * w * 3 * 2 * r + N * w * w * 2 * r2)


def chunk_flops(N, w, r, r2, iters, checks):
    """Arithmetic operations one chunk launch needs for one scenario that
    runs ``iters`` iterations and ``checks`` termination checks (counted
    from the algorithm's shapes, multiply and add each one)."""
    n, nd = N * w, N - 1
    m = n + nd * r + N * r2
    assemble = assemble_flops(N, w, r, r2)
    factor = nd * 4 * w**3 + N * gj_flops(w)
    a_x = 4 * nd * r * w + 2 * N * r2 * w  # A x
    at_y = 4 * nd * r * w + 2 * N * r2 * w  # A^T y
    per_iter = (
        5 * n + 2 * (m - n) + at_y  # rhs
        + 2 * nd * w * w + 2 * N * w * w + 2 * nd * w * w  # sweeps
        + a_x + 10 * m + 3 * n  # A xt, relaxation, projection, duals
    )
    per_check = a_x + 2 * N * w * w + at_y + 12 * m
    return assemble + factor + iters * per_iter + checks * per_check


def rolled_chunk_flops(N, w, r, r2, iters, checks, cr1):
    """Arithmetic operations of one rolled two-way chunk launch for one
    scenario (multiply and add each one): the assembly and iteration terms
    of :func:`chunk_flops`, with the two-way factorization and solves, and
    the depth-1 CR level's elimination, fold and recovery when ``cr1``:
    H odd-stage inverses and 5H - 3 block products (Vb = dinv_o Lb and
    Lb^T Vb per odd stage; Ya = La dinv_o, Ya La^T and Ya Lb per coupling),
    and per solve the fold (Vb^T, Ya) and the recovery (Lb, La^T, dinv_o)."""
    n, nd = N * w, N - 1
    m = n + nd * r + N * r2
    H = N // 2
    n_sys = H if cr1 else N
    gj = gj_flops(w)
    mm = 2 * w**3  # one block product
    mv = 2 * w * w  # one block-vector product
    assemble = assemble_flops(N, w, r, r2)
    factor = n_sys * gj + (n_sys - 1) * 2 * mm
    if cr1:
        factor += H * gj + (5 * H - 3) * mm
    a_x = 4 * nd * r * w + 2 * N * r2 * w
    at_y = 4 * nd * r * w + 2 * N * r2 * w
    solve = (3 * n_sys - 2) * mv + (5 * H - 2) * mv * cr1
    per_iter = 5 * n + 2 * (m - n) + at_y + solve + a_x + 10 * m + 3 * n
    per_check = a_x + 2 * N * w * w + at_y + 12 * m
    return assemble + factor + iters * per_iter + checks * per_check


def cr_chunk_flops(N, w, r, r2, iters, checks):
    """Arithmetic operations of one cyclic-reduction chunk launch for one
    scenario (multiply and add each one), from ``cr_level_plan``: the
    assembly and iteration terms of :func:`chunk_flops`; per level the
    ``half`` odd-pivot inverses and the block products the elimination
    needs (G_lo and G_lo LT_lo for the survivors above the first,
    LT_odd dinv_odd and its product with L_odd for every survivor, and
    when a level follows, G_lo^T and the two next-level couplings for the
    survivors above the first) with the two subtractions per survivor; the
    root inverse; per solve, down each level ``3 half - 1`` block-vector
    products and the fold's subtractions, the root's, and up each level
    the same again."""
    from optimal_control_problem_tpu_torch.ops.banded_cr_kernel import cr_level_plan

    n, nd = N * w, N - 1
    m = n + nd * r + N * r2
    gj = gj_flops(w)
    mm = 2 * w**3
    mv = 2 * w * w
    levels, _, _ = cr_level_plan(N)
    factor = gj
    solve = mv
    for _, _, half, _, _ in levels:
        factor += half * gj + (2 * (half - 1) + 2 * half) * mm + 2 * half * w * w
        if half > 1:
            factor += 3 * (half - 1) * mm
        solve += 2 * ((3 * half - 1) * mv + 2 * half * w)
    a_x = 4 * nd * r * w + 2 * N * r2 * w
    at_y = 4 * nd * r * w + 2 * N * r2 * w
    per_iter = 5 * n + 2 * (m - n) + at_y + solve + a_x + 10 * m + 3 * n
    per_check = a_x + 2 * N * w * w + at_y + 12 * m
    return assemble_flops(N, w, r, r2) + factor + iters * per_iter + checks * per_check


def shared_chunk_flops(n, m, iters, checks):
    """Arithmetic operations of one shared-operator chunk for one scenario
    (multiply and add each one): per iteration the three panel products
    and the elementwise updates (rho z - y; sigma x - qb + .; the x and z
    relaxations; y / rho, the sum, the two clips; the dual update), per
    check the three residual products and the scaled differences."""
    per_iter = 2 * (m * n + n * n + n * m) + 6 * n + 12 * m
    per_check = 2 * (n * m + n * n + m * n) + 4 * m + 6 * n
    return iters * per_iter + checks * per_check


def shared_tc_flops(n, m, iters, checks, mode):
    """(float32 operations, bf16 tensor-core operations) of one scenario's
    chunk in the tensor-core form: each product at HIGH is three bf16
    passes of 2 K J (hi hi, hi lo, lo hi; padding not counted), the rest
    as :func:`shared_chunk_flops` (at "mixed" zt stays an f32 product)."""
    tc_products = (m * n + n * n + n * m) if mode == "high" else (m * n + n * n)
    f32 = shared_chunk_flops(n, m, iters, checks) - iters * 2 * tc_products
    return f32, iters * 3 * 2 * tc_products


def device_loop_flops(n, m, iters, checks):
    """Arithmetic operations of one scenario's device loop: the entry's
    ``z = clip(x @ Ab^T)`` (a multiply and an add per term, two clips) and
    the iterations and checks of :func:`shared_chunk_flops` (the same
    algorithm, one operator per scenario)."""
    return 2 * m * n + 2 * m + shared_chunk_flops(n, m, iters, checks)


def random_shared_qp(seed, B, n, m):
    """A random shared QP batch (the shape of tests' ``problem``)."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, n))
    P = L @ L.T + 0.5 * np.eye(n)
    A = rng.normal(size=(m, n))
    qs = rng.normal(size=(B, n))
    centers = rng.normal(size=(B, n)) @ A.T
    ls = centers - rng.uniform(0.2, 1.5, size=(B, m))
    us = centers + rng.uniform(0.2, 1.5, size=(B, m))
    return [np.ascontiguousarray(a, np.float32) for a in (P, A, qs, ls, us)]


def random_dense_qp(seed, B, n, m):
    """B random dense QPs of their own, each ``P (n, n)`` SPD, ``A (m, n)``
    and a box around a feasible point (the shape of tests' ``random_qp``)."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(B, n, n))
    P = L @ np.swapaxes(L, 1, 2) + 0.5 * np.eye(n)
    A = rng.normal(size=(B, m, n))
    c = np.einsum("bmn,bn->bm", A, rng.normal(size=(B, n)))
    q = rng.normal(size=(B, n))
    lo = c - rng.uniform(0.2, 1.5, size=(B, m))
    hi = c + rng.uniform(0.2, 1.5, size=(B, m))
    return [np.ascontiguousarray(a, np.float32) for a in (P, q, A, lo, hi)]


def launch_shapes(args):
    """(N, w, r, r2) of one recorded chunk launch."""
    N, w = args[6].shape[0], args[6].shape[1]
    return N, w, args[3].shape[1], args[5].shape[1]


def time_ms(fn, reps, sync):
    """Median wall ms of ``fn`` over ``reps`` calls, each synchronised."""
    out = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def ticks_on(model, cfg, build_kw, device, fr, rf, n_ticks):
    """``n_ticks`` ticks of ``models.<model>.build(cfg, **build_kw)`` from a
    fresh state on ``device``: the plans, each tick's QP flags and
    iteration counts, and the seconds they took."""
    import importlib

    from optimal_control_problem_tpu_torch.parallel import BatchedSolver

    mod = importlib.import_module(f"optimal_control_problem_tpu_torch.models.{model}")
    s_ = BatchedSolver(mod.build(cfg, **build_kw, device=device), device=device)
    st_ = s_.init_state(fr.shape[0])
    t0 = time.perf_counter()
    out, fl = [], []
    for _ in range(n_ticks):
        tr, _, st_ = s_.solve(fr, rf, st_)
        out.append(tr.cpu().numpy())
        res_ = s_.last_result
        fl.append([getattr(res_, k).cpu().numpy() for k in (
            "qp_converged", "qp_prim_inf", "qp_dual_inf", "qp_iters")])
    return out, fl, time.perf_counter() - t0


def closed_loop(device):
    """tests/test_controller.py's closed loop on ``device``: the double
    integrator h10 (dense single-scenario path, augmented), 40
    ``MPCController`` steps towards (1, 0.5); the position errors, states,
    controls and seconds."""
    from optimal_control_problem_tpu_torch.controller import MPCController
    from optimal_control_problem_tpu_torch.models import double_integrator

    H_c, dt_c = 10, 0.05
    ocp_c = double_integrator.build(double_integrator.make_config(
        horizon=H_c, dt=dt_c, alpha=0.7, step_num=8), device=device)
    ctl = MPCController(ocp_c, double_integrator.CONTROL_SLICE)
    target = np.array([1.0, 0.5])
    ref_c = np.tile(target, H_c)
    pos, vel, acc = np.zeros(2), np.zeros(2), np.zeros(2)
    errs, states, us = [], [], []
    t0 = time.perf_counter()
    for _ in range(40):
        u = ctl.step(np.concatenate([pos, vel, acc]), ref_c)
        pos, vel, acc = pos + dt_c * vel, vel + dt_c * u, u
        errs.append(float(np.linalg.norm(pos - target)))
        states.append(np.r_[pos, vel])
        us.append(u)
    return np.array(errs), np.array(states), np.array(us), time.perf_counter() - t0


def export_job(case):
    """Phase 5m's round trip of one batched solve, in a worker process on
    the card: ``models.<model>.build(cfg)``'s batch function exported by
    ``export_solver`` at the tick's inputs (``case``: the frames,
    references and the phase 4 state it ticks from, numpy), saved, reloaded
    by ``import_solver``; then the direct tick and the loaded program's tick
    from that state, the kernels' launch counters reset before each and
    read after, and ``reps`` more of each, interleaved, for their ms.
    Returns what phase 5m checks and logs."""
    import importlib

    import torch

    from optimal_control_problem_tpu_torch.ops import admm_kernel as ak
    from optimal_control_problem_tpu_torch.ops import banded_cr_kernel as bck
    from optimal_control_problem_tpu_torch.ops import banded_kernel as bk
    from optimal_control_problem_tpu_torch.ops import banded_rolled_kernel as brk
    from optimal_control_problem_tpu_torch.ops import shared_kernel as sk
    from optimal_control_problem_tpu_torch.parallel import BatchedSolver
    from optimal_control_problem_tpu_torch.utils.serialization import (
        export_program,
        import_solver,
    )

    counted = ((bk.banded_admm_chunk, "launches"), (brk.banded_admm_chunk_rolled, "launches"),
               (bck.banded_admm_chunk_cr, "launches"), (sk.shared_admm_chunk, "launches"),
               (sk.shared_admm_chunk, "tc_launches"), (ak.admm_device_loop, "launches"))

    def launches(run):
        for fn, attr in counted:
            setattr(fn, attr, 0)
        out = run()
        torch.cuda.synchronize()
        return out, {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn, attr in counted}

    t_job = time.perf_counter()
    mod = importlib.import_module(f"optimal_control_problem_tpu_torch.models.{case['model']}")
    ocp = mod.build(case["cfg"], **case["build_kw"], device="cuda")
    if "iter_precision" in case:  # not a key of the configuration: set, then generate again
        ocp.solver_settings.admm = ocp.solver_settings.admm.replace(
            iter_precision=case["iter_precision"])
        ocp.gen_solver()
    solver = BatchedSolver(ocp)
    dev = solver.device
    fr = torch.as_tensor(case["frames"], device=dev)
    B, fs = fr.shape[0], solver.frame_size
    lbx = solver._lbx_tail.expand(B, -1).clone()
    ubx = solver._ubx_tail.expand(B, -1).clone()
    lbx[:, :fs] = fr
    ubx[:, :fs] = fr
    x, qp_x, qp_y = (torch.as_tensor(a, device=dev) for a in case["state"])
    args = (x, torch.as_tensor(case["refs"], device=dev), lbx, ubx,
            solver._lbg.expand(B, -1).contiguous(), solver._ubg.expand(B, -1).contiguous(),
            qp_x, qp_y)
    fn = solver._solve_batch
    t0 = time.perf_counter()
    program = export_program(fn, args)
    t_trace = time.perf_counter() - t0
    nodes = {}
    for gname, gm in program.graph_module.named_modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                if str(node.target).startswith("ocp_torch."):
                    key = f"{gname or 'top'}:{str(node.target).split('.')[1]}"
                    nodes[key] = nodes.get(key, 0) + 1
    torch.export.save(program, case["path"])
    t0 = time.perf_counter()
    loaded = import_solver(case["path"])
    t_load = time.perf_counter() - t0
    direct, n_direct = launches(lambda: fn(*args))
    out, n_loaded = launches(lambda: loaded(*args))
    # One more tick of each under torch.profiler: the device's kernel time
    # against the tick's wall time (the rest is the host's share).
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    busy = {}
    for which, run in (("direct", lambda: fn(*args)), ("loaded", lambda: loaded(*args))):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dev_ms = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                     if getattr(e, "device_type", None) == DeviceType.CUDA) / 1e3
        busy[which] = (dev_ms, wall)
    ms = {"direct": [], "loaded": []}
    for _ in range(case["reps"]):
        for which, run in (("direct", lambda: fn(*args)), ("loaded", lambda: loaded(*args))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            ms[which].append((time.perf_counter() - t0) * 1e3)
    return {
        "trace_s": t_trace, "load_s": t_load, "bytes": os.path.getsize(case["path"]),
        "nodes": nodes, "n_direct": n_direct, "n_loaded": n_loaded,
        "iters_equal": bool(torch.equal(direct.qp_iters, out[5])),
        "qp_iters": direct.qp_iters.float().mean().item(),
        "gap": float((direct.x - out[0]).abs().max()),
        "qp_x_gap": float((direct.qp_x - out[2]).abs().max()),
        "device": str(out[0].device), "finite": bool(torch.isfinite(out[0]).all()),
        "direct_ms": statistics.median(ms["direct"]),
        "loaded_ms": statistics.median(ms["loaded"]), "job_s": time.perf_counter() - t_job,
        "device_ms": {k: v[0] for k, v in busy.items()},
        "profiled_ms": {k: v[1] for k, v in busy.items()},
    }


def toy_export_job(path):
    """Phase 5m's first round trip, in a worker process on the card: the
    dense SQP solve of tests/test_serialization.py (2 SQP steps here, 5
    there), exported on CUDA tensors to ``path``, reloaded, and called
    beside the direct call on the same inputs."""
    import torch

    from optimal_control_problem_tpu_torch import SQPOptimizationSolver, SQPOptions
    from optimal_control_problem_tpu_torch import sym as S
    from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings
    from optimal_control_problem_tpu_torch.utils.serialization import (
        export_solver,
        import_solver,
    )

    xs_ = S.sym("x", 2)
    solver = SQPOptimizationSolver(
        {"x": xs_, "f": xs_[0] ** 2 + xs_[1] ** 2, "g": xs_[0] + xs_[1] - 1.0},
        SQPOptions(max_iter=2, alpha=0.5, admm=ADMMSettings(eps_abs=1e-4, eps_rel=1e-4)),
        device="cuda")
    c32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")  # noqa: E731
    args = (c32([0.3, -0.2]), c32(np.zeros(0)), c32([-50.0, -100.0]), c32([50.0, 100.0]),
            c32([0.0]), c32([0.0]), c32(np.zeros(2)), c32(np.zeros(3)))
    t0 = time.perf_counter()
    export_solver(solver.solve_fn, args, path)
    t_trace = time.perf_counter() - t0
    direct = solver.solve_fn(*args)
    loaded = import_solver(path)(*args)
    torch.cuda.synchronize()
    return {"trace_s": t_trace, "bytes": os.path.getsize(path), "device": str(loaded[0].device),
            "gap": float((direct.x - loaded[0]).abs().max()),
            "iters_equal": bool(torch.equal(direct.qp_iters, loaded[5]))}


def _cpu_worker(todo, done, threads):
    import torch

    torch.set_num_threads(threads)
    while (job := todo.get()) is not None:
        i, fn, args = job
        try:
            done.put((i, fn(*args), None))
        except BaseException as e:  # noqa: BLE001 -- handed to the parent
            done.put((i, None, f"{type(e).__name__}: {e}"))


def process_map(jobs, workers, threads):
    """Run ``jobs`` (``(function, args)`` pairs of this module, taken in
    the order given) in ``workers`` new processes with ``threads`` torch
    threads each, while the caller goes on; returns a function that waits
    for them and gives their results in that order.  The processes are
    spawned, not forked: a fork of this process could not run autograd
    (its engine's threads) and shares its CUDA context.  A job that
    raises, or a worker that dies, fails the wait."""
    import multiprocessing
    import queue

    ctx = multiprocessing.get_context("spawn")
    todo, done = ctx.Queue(), ctx.Queue()
    for i, (fn, args) in enumerate(jobs):
        todo.put((i, fn, args))
    for _ in range(workers):
        todo.put(None)
    procs = [ctx.Process(target=_cpu_worker, args=(todo, done, threads), daemon=True)
             for _ in range(workers)]
    for p_ in procs:
        p_.start()

    def results():
        got = {}
        try:
            while len(got) < len(jobs):
                try:
                    i, r, err = done.get(timeout=5)
                except queue.Empty:
                    if not any(p_.is_alive() for p_ in procs):
                        raise SystemExit("a CPU worker died before its results came")
                    continue
                if err is not None:
                    raise SystemExit(f"a CPU worker failed: {err}")
                got[i] = r
        finally:
            for p_ in procs:
                if len(got) < len(jobs):
                    p_.terminate()
                p_.join()
            # The queues live until here: a worker opens their semaphores
            # by name, which they unlink when collected.
            todo.close()
            done.close()
        return [got[i] for i in range(len(jobs))]

    return results


def phase7(dev) -> dict:
    """Phase 7: the multi-device paths of ``parallel/`` on one card, each
    part timed.  Returns the parts' seconds and findings.

    (a) ``DistributedSolver`` in-process over ``"batch"`` of 4: the
        cart-pole h20 banded batch of phase 4 in one call (kernel B1,
        counted), equal to ``BatchedSolver`` within 1e-5; the consensus
        first control equal to the mean taken by hand.
    (b) ``HorizonShardedSolver`` on the shipped cart-pole YAML (h20) over
        ``"h"`` of 4, 3 warm-started ticks, against the single-device front
        end (5e-2), no infeasibility certificate, first-frame pinning; then
        the ``("b", "h")`` mesh (2, 4): each scenario equals its 1-D solve
        within 5e-3.
    (c) The quadrotor h100 over ``"h"`` of 4 (25 stages a shard), a cold
        and a warm tick: finite, pinned, no certificate; its gap to the
        single-device banded tick (``BatchedSolver`` at B=1) is a finding.
    (d) A world-size-1 NCCL group through ``initialize_distributed``: its
        ``psum``, ``consensus_mean`` and ``horizon_sharded_solve`` equal
        the in-process D=1 results bitwise.
    (e) True f32 under a caller's TF32: a dense cart-pole tick and a
        double-integrator tick with ``backend="xla"`` (cuBLAS loops) give
        the same bits with TF32 switched on globally as without.

    On the CPU (a rehearsal) no kernel launch is counted and gloo stands in
    for NCCL.
    """
    import socket

    import torch
    import torch.distributed as tdist

    from optimal_control_problem_tpu_torch.config import load_config
    from optimal_control_problem_tpu_torch.models import cartpole, double_integrator, quadrotor
    from optimal_control_problem_tpu_torch.ops import banded_kernel as bk
    from optimal_control_problem_tpu_torch.parallel import (
        BatchedSolver,
        DistributedSolver,
        HorizonShardedSolver,
        consensus_mean,
        horizon_sharded_solve,
        initialize_distributed,
        make_mesh,
    )

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        out[f"{name}_s"] = time.perf_counter() - t0
        return res

    # (a) -----------------------------------------------------------------
    def part_a():
        B = 1024
        cfg = cartpole.make_config(horizon=20, dt=0.04, alpha=0.3, step_num=10,
                                   formulation="reduced", ADMM_settings=dict(MAIN_ADMM))
        batched = BatchedSolver(cartpole.build(cfg, stagewise=True, device=dev), device=dev)
        rng = np.random.default_rng(0)
        frames = np.zeros((B, cartpole.FRAME), np.float32)
        frames[:, 2] = rng.uniform(-0.5, 0.5, B).astype(np.float32)
        refs = np.full((B, 1), np.pi, np.float32)
        dist = DistributedSolver(batched, make_mesh(("batch",), shape=(4,), devices=dev))
        bk.banded_admm_chunk.launches = 0
        trajs, _, _ = dist.solve(frames, refs, dist.init_state(B))
        sync()
        launches = bk.banded_admm_chunk.launches
        ref, _, _ = batched.solve(frames, refs, batched.init_state(B))
        gap = float((trajs - ref).abs().max())
        u = dist.consensus_first_control(trajs, slice(4, 5))
        u_gap = float((u - trajs[:, 4:5].mean(dim=0)).abs().max())
        log(f"phase 7a DistributedSolver in-process over 'batch' of 4, cart-pole h20 banded "
            f"B={B}: one-way chunk launches {launches}; max |sharded - BatchedSolver| {gap:.3g} "
            f"(limit 1e-5); consensus first control {u.tolist()}, gap to the mean by hand "
            f"{u_gap:.3g} (limit 1e-6)")
        if on_card and launches != 10:
            raise SystemExit("phase 7a: the sharded tick did not go through the one-way chunk")
        if not (gap <= 1e-5 and u_gap <= 1e-6 and bool(torch.isfinite(trajs).all())):
            raise SystemExit("phase 7a: the sharded batch differs from the unsharded one")
        out["a_launches"], out["a_gap"] = launches, gap

    timed("a", part_a)

    # (b) -----------------------------------------------------------------
    def yaml_cartpole(step_num, max_iter):
        node = load_config(os.path.join(HERE, "configs", "cartpole.yaml"))
        node["solver_settings"]["SQP_settings"] = {"alpha": 0.3, "step_num": step_num}
        node["solver_settings"]["ADMM_settings"] = {
            "method": "banded", "max_iter": max_iter, "adaptive_rho": False, "rho": 0.05,
            "eps_abs": 1e-4, "eps_rel": 1e-4,
        }
        return cartpole.build(node, stagewise=True, device=dev)

    def part_b():
        frame = cartpole.initial_state(th=0.4)
        ref = np.array([np.pi])
        h4 = make_mesh(("h",), shape=(4,), devices=dev)
        sharded = HorizonShardedSolver(yaml_cartpole(6, 800), h4)
        single = yaml_cartpole(6, 800)
        gaps, tick_s = [], []
        for t in range(3):
            sync()
            t0 = time.perf_counter()
            traj = sharded.compute_optimal_trajectory(frame, ref)
            sync()
            tick_s.append(time.perf_counter() - t0)
            single.compute_optimal_trajectory(frame, ref)
            traj = traj.cpu().numpy()
            gaps.append(float(np.abs(traj - single.get_optimal_frames()).max()))
            stats = sharded.get_solver_stats()
            pin_tol = (1 - 0.3) ** (6 * (t + 1)) * np.abs(frame).max() * 1.5 + 1e-3
            pin = float(np.abs(traj[0] - frame).max())
            log(f"phase 7b HorizonShardedSolver cart-pole YAML h20 over 'h' of 4, tick {t + 1}: "
                f"{tick_s[-1]:.3f} s, ADMM iterations {stats['qp_iters'].tolist()}, max |sharded "
                f"- single-device| {gaps[-1]:.3g} (limit 5e-2), first-frame gap {pin:.3g} "
                f"(limit {pin_tol:.3g})")
            if not (np.isfinite(traj).all() and gaps[-1] <= 5e-2 and pin <= pin_tol):
                raise SystemExit(f"phase 7b: the horizon-sharded tick {t + 1} is wrong")
            if stats["qp_status"][:, 1:].any():
                raise SystemExit("phase 7b: an infeasibility certificate on cart-pole")
        mesh2 = make_mesh(("b", "h"), shape=(2, 4), devices=dev)
        sharded2 = HorizonShardedSolver(yaml_cartpole(3, 400), mesh2, batch_axis="b")
        frames = np.stack([cartpole.initial_state(th=0.2 + 0.1 * b) for b in range(4)])
        refs = np.full((4, 1), np.pi)
        sync()
        t0 = time.perf_counter()
        trajs = sharded2.compute_optimal_trajectory(frames, refs).cpu().numpy()
        sync()
        t2d = time.perf_counter() - t0
        gaps2 = []
        for b in range(4):
            one = HorizonShardedSolver(yaml_cartpole(3, 400), h4)
            x1 = one.compute_optimal_trajectory(frames[b], refs[b]).cpu().numpy()
            gaps2.append(float(np.abs(trajs[b] - x1).max()))
        log(f"phase 7b ('b', 'h') mesh (2, 4), B=4: {t2d:.3f} s; max |scenario - its 1-D "
            f"solve| by scenario {', '.join(f'{g:.3g}' for g in gaps2)} (limit 5e-3)")
        if not (np.isfinite(trajs).all() and max(gaps2) <= 5e-3):
            raise SystemExit("phase 7b: a scenario of the 2-D mesh differs from its 1-D solve")
        out["b_tick_s"], out["b_gaps"], out["b_2d_s"], out["b_2d_gaps"] = tick_s, gaps, t2d, gaps2

    timed("b", part_b)

    # (c) -----------------------------------------------------------------
    def part_c():
        H = 100
        qcfg = quadrotor.make_config(horizon=H, dt=0.02, alpha=0.3, step_num=5,
                                     formulation="reduced", ADMM_settings=dict(QUAD_ADMM))
        frame = quadrotor.initial_state(pos=(0.3, -0.2, 1.0))
        ref = quadrotor.reference_hover(H)
        sharded = HorizonShardedSolver(quadrotor.build(qcfg, stagewise=True, device=dev),
                                       make_mesh(("h",), shape=(4,), devices=dev))
        single = BatchedSolver(quadrotor.build(qcfg, stagewise=True, device=dev), device=dev)
        sstate = single.init_state(1)
        tick_s, gaps = [], []
        for t in range(2):
            sync()
            t0 = time.perf_counter()
            traj = sharded.compute_optimal_trajectory(frame, ref)
            sync()
            tick_s.append(time.perf_counter() - t0)
            traj = traj.cpu().numpy()
            x1, _, sstate = single.solve(frame[None], ref[None], sstate)
            gaps.append(float(np.abs(traj.reshape(-1) - x1[0].cpu().numpy()).max()))
            stats = sharded.get_solver_stats()
            pin_tol = (1 - 0.3) ** (5 * (t + 1)) * np.abs(frame).max() * 1.5 + 1e-3
            pin = float(np.abs(traj[0] - frame).max())
            log(f"phase 7c quadrotor h{H} over 'h' of 4 ({H // 4} stages a shard), "
                f"{'cold' if t == 0 else 'warm'} tick: {tick_s[-1]:.3f} s, ADMM iterations "
                f"{stats['qp_iters'].tolist()}, first-frame gap {pin:.3g} (limit {pin_tol:.3g}); "
                f"finding: max |sharded - single-device banded tick (B=1)| {gaps[-1]:.3g}")
            if not (np.isfinite(traj).all() and pin <= pin_tol):
                raise SystemExit("phase 7c: the horizon-sharded quadrotor tick is wrong")
            if stats["qp_status"][:, 1:].any():
                raise SystemExit("phase 7c: an infeasibility certificate on the quadrotor")
        out["c_tick_s"], out["c_gaps"] = tick_s, gaps

    timed("c", part_c)

    # (d) -----------------------------------------------------------------
    def part_d():
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        initialize_distributed(f"127.0.0.1:{port}", 1, 0, device=dev)
        try:
            backend = tdist.get_backend()
            mesh_d = make_mesh(("h",), devices="distributed")
            mesh_l = make_mesh(("h",), shape=(1,), devices=dev)
            rng = np.random.default_rng(11)
            v = torch.as_tensor(rng.normal(size=(1, 7)), dtype=torch.float32, device=dev)
            same = {"psum": torch.equal(mesh_d.shards().psum(v, "h"),
                                        mesh_l.shards().psum(v, "h"))}
            vals = torch.as_tensor(rng.normal(size=(64, 3)), dtype=torch.float32, device=dev)
            same["consensus_mean"] = torch.equal(consensus_mean(vals, mesh_d, "h"),
                                                 consensus_mean(vals, mesh_l, "h"))
            N, w = 16, 4
            diag = np.stack([(lambda L: L @ L.T + 2 * w * np.eye(w))(rng.normal(size=(w, w)))
                             for _ in range(N)])
            lower = np.zeros((N, w, w))
            lower[1:] = 0.4 * rng.normal(size=(N - 1, w, w))
            sysm = [torch.as_tensor(a, dtype=torch.float32, device=dev)
                    for a in (diag, lower, rng.normal(size=(N, w)))]
            same["horizon_sharded_solve"] = torch.equal(
                horizon_sharded_solve(*sysm, mesh=mesh_d, axis="h"),
                horizon_sharded_solve(*sysm, mesh=mesh_l, axis="h"))
            sync()
        finally:
            tdist.destroy_process_group()
        log(f"phase 7d {backend} world size 1 through initialize_distributed: bitwise equal to "
            f"the in-process D=1 run: {same}")
        if not all(same.values()):
            raise SystemExit("phase 7d: the process-group run differs from the in-process run")
        out["d_backend"] = backend

    timed("d", part_d)

    # (e) -----------------------------------------------------------------
    def part_e():
        B = 16
        ccfg = cartpole.make_config(horizon=20, dt=0.02, alpha=0.3, step_num=10,
                                    ADMM_settings={**DENSE_ADMM, "backend": "xla"})
        cocp = cartpole.build(ccfg, stagewise=False, device=dev)
        rng = np.random.default_rng(0)
        cframes = np.zeros((B, cartpole.FRAME), np.float32)
        cframes[:, 2] = rng.uniform(-0.5, 0.5, B).astype(np.float32)
        crefs = np.full((B, 1), np.pi, np.float32)
        dcfg = double_integrator.make_config(horizon=20, dt=0.005, alpha=0.1, step_num=10,
                                             formulation="reduced",
                                             ADMM_settings={**DI_ADMM, "backend": "xla"})
        docp = double_integrator.build(dcfg, device=dev)
        dframes = np.zeros((64, double_integrator.FRAME), np.float32)
        dframes[:, 0:2] = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
        drefs = np.tile(double_integrator.reference_circle(20, 0.005)[None], (64, 1))
        cases = (("dense cart-pole h20 B=16", cocp, cframes, crefs),
                 ("double integrator h20 B=64", docp, dframes, drefs))
        saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
        a = torch.as_tensor(rng.normal(size=(256, 256)), dtype=torch.float32, device=dev)
        res = {}
        for tf32 in (False, True):
            torch.set_float32_matmul_precision("high" if tf32 else "highest")
            torch.backends.cudnn.allow_tf32 = tf32
            for name, ocp_, fr, rf in cases:
                b = BatchedSolver(ocp_, device=dev)
                x, _, _ = b.solve(fr, rf, b.init_state(fr.shape[0]))
                res[name, tf32] = x.cpu()
            res["raw", tf32] = (a @ a).cpu()
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
        same = {name: torch.equal(res[name, False], res[name, True]) for name, *_ in cases}
        raw_gap = float((res["raw", False] - res["raw", True]).abs().max())
        log(f"phase 7e true f32 under a caller's TF32 (backend='xla'): ticks bitwise equal with "
            f"TF32 on and off: {same}; a plain torch.matmul outside the solver moves by "
            f"{raw_gap:.3g} when TF32 is on (the switch bites on this card)")
        if not all(same.values()):
            raise SystemExit("phase 7e: a solve changed its bits when the caller turned TF32 on")
        out["e_raw_gap"] = raw_gap

    timed("e", part_e)
    log("phase 7: " + ", ".join(f"({k[0]}) {out[k]:.1f} s" for k in sorted(out) if
                                 k.endswith("_s") and len(k) == 3))
    return out


# The example twins of phase 8, each with its function's arguments at the
# JAX example's own settings (``examples/*.py``).  The unicycle runs the
# first 20 of its 80 ticks: from tick 20 on, the robot rides the keep-out
# boundary and every other tick's first QPs stop at the 10,000-iteration
# budget unconverged (in the JAX package too), ~750,000 ADMM iterations in
# all, beyond this script's time limit on the eager per-scenario banded
# loop (PERF.md section 6).
TWINS = (
    ("cartpole_swingup", dict(ticks=60)),
    ("closed_loop_mpc", dict(ticks=200, horizon=20)),
    ("quadrotor_hover", dict(horizon=100, ticks=4)),
    ("unicycle_obstacles", dict(ticks=20, horizon=30)),
    ("scenario_mpc", dict(ticks=50, batch=64, shards=8)),
    ("seq_parallel_mpc", dict(horizon=16, shards=8)),
)


def phase8(dev) -> dict:
    """Phase 8: the six example twins (``examples/torch/<name>.py``) on
    ``dev`` at the JAX examples' own settings, through their own
    functions; the multi-device twins over 8 in-process shards, the
    port's counterpart of the JAX examples' 8 devices.  A twin's asserts
    (the quadrotor's constraint violation, the unicycle's keep-out, the
    scenario loop's final error) fail the phase; every returned array must
    be finite.  Logs each twin's seconds and the launches of each kernel
    during it, and for the twins that step an ``MPCController`` the QPs
    solved, their ADMM iterations and how many stopped at ``max_iter``.
    Returns ``{name: (seconds, launches)}``."""
    import importlib.util

    import torch

    from optimal_control_problem_tpu_torch.ops import admm_kernel as ak
    from optimal_control_problem_tpu_torch.ops import banded_cr_kernel as bck
    from optimal_control_problem_tpu_torch.ops import banded_kernel as bk
    from optimal_control_problem_tpu_torch.ops import banded_rolled_kernel as brk
    from optimal_control_problem_tpu_torch.ops import shared_kernel as sk

    counters = {
        "B1": lambda: bk.banded_admm_chunk.launches,
        "B2": lambda: brk.banded_admm_chunk_rolled.launches,
        "B3": lambda: sk.shared_admm_chunk.launches,
        "B3_tc": lambda: sk.shared_admm_chunk.tc_launches,
        "B4": lambda: bck.banded_admm_chunk_cr.launches,
        "B5": lambda: ak.admm_device_loop.launches,
    }
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {}
    for name, kw in TWINS:
        path = os.path.join(HERE, "examples", "torch", f"{name}.py")
        spec = importlib.util.spec_from_file_location(f"torch_example_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        qps = []
        if hasattr(mod, "MPCController"):
            class Counted(mod.MPCController):
                def step(self, *a, **k):
                    u = super().step(*a, **k)
                    st = self.ocp.get_solver_stats()
                    qps.append((np.asarray(st["qp_iters"]),
                                self.ocp._solver.options.admm.max_iter))
                    return u

            mod.MPCController = Counted
        before = {k: c() for k, c in counters.items()}
        sync()
        t0 = time.perf_counter()
        result = mod.run(**kw, device=dev, out=lambda msg, n=name: log(f"  {n}: {msg}"))
        sync()
        sec = time.perf_counter() - t0
        launches = {k: c() - before[k] for k, c in counters.items()}
        arrays = [np.asarray(a, np.float64) for a in result
                  if isinstance(a, np.ndarray) or np.isscalar(a)]
        if not arrays or not all(np.isfinite(a).all() for a in arrays):
            raise SystemExit(f"phase 8: {name} returned non-finite values")
        log(f"phase 8: {name} {kw}: {sec:.1f} s, kernel launches {launches}")
        if qps:
            its = np.concatenate([q for q, _ in qps])
            capped = sum(int((q >= cap).sum()) for q, cap in qps)
            log(f"phase 8: {name}: {len(qps)} ticks, {its.size} QPs, {int(its.sum())} ADMM "
                f"iterations ({sec * 1e3 / max(1, int(its.sum())):.3f} ms each), {capped} "
                f"stopped at max_iter")
        out[name] = (sec, launches)
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from optimal_control_problem_tpu_torch.models import (
        cartpole,
        double_integrator,
        quadrotor,
        unicycle,
    )
    from optimal_control_problem_tpu_torch.ops import admm_kernel as ak
    from optimal_control_problem_tpu_torch.ops import banded_cr_kernel as bck
    from optimal_control_problem_tpu_torch.ops import banded_kernel as bk
    from optimal_control_problem_tpu_torch.ops import banded_rolled_kernel as brk
    from optimal_control_problem_tpu_torch.ops import build
    from optimal_control_problem_tpu_torch.ops import shared_kernel as sk
    from optimal_control_problem_tpu_torch.parallel import BatchedSolver
    from optimal_control_problem_tpu_torch.parallel.batch import BatchState
    from optimal_control_problem_tpu_torch.solvers import admm as tadmm
    from optimal_control_problem_tpu_torch.solvers import admm_banded_batch as abb
    from optimal_control_problem_tpu_torch.solvers import admm_batched as tab
    from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings
    from optimal_control_problem_tpu_torch.solvers.admm_banded import BandedQP

    t_start = time.perf_counter()
    profile = "--profile" in argv
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize

    # -- 1. the card ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"phase 1: device {kind!r}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build()
    log(f"phase 2: built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k}: {v:.1f} s' for k, v in built.items())})")
    for name in build.SOURCES:
        for line in build.ptxas_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # -- 3. kernels vs plain versions on the card -----------------------
    names = ("x", "yx", "yd", "yc", "zx", "zd", "zc", "done", "it_inc", "rp", "rd", "mp", "md")

    def compare(kernel, plain, shapes, st, label, extra=None, it0=None, done0=None,
                stage_bounds=(-1.0, np.inf)):
        """Kernel and plain version on one random batch; ``it0``/``done0``
        (numpy, per scenario) default to 0."""
        N, w, r, r2, B = shapes
        fields, x0, y0 = random_stage_qp_batch(0, B, N, w, r, r2, stage_bounds)
        qpT = BandedQP(*(torch.as_tensor(a, device=dev) for a in fields))
        x0T, y0T = torch.as_tensor(x0, device=dev), torch.as_tensor(y0, device=dev)
        prob = abb.prepare_banded_batch_T(qpT, st, x0T, y0T)
        per_b = lambda a: torch.as_tensor(  # noqa: E731
            np.zeros(B) if a is None else a, dtype=torch.int32, device=dev)
        args, kw = abb.chunk_inputs(prob, st, per_b(it0), per_b(done0),
                                    prob.x, prob.y, prob.z, prob.rho)
        kw.update(extra or {})
        out_k = kernel(*args, **kw)
        sync()
        out_p = plain(*args, **kw)
        sync()
        errs = {}
        for nm, a, b in zip(names, out_k, out_p):
            d = (a.double() - b.double()).abs()
            fin = torch.isfinite(b.double())
            errs[nm] = float(d[fin].max()) if bool(fin.any()) else 0.0
        log(f"phase 3 [{label}]: max |kernel - plain| " + ", ".join(
            f"{k}={v:.3g}" for k, v in errs.items()))
        return out_k, out_p, errs

    def check_exact(out_k, out_p, errs, label):
        """Equal done/it_inc and every output bitwise equal (gap 0): both
        sum each product as the same ascending chain without FMA
        contraction.  Returns the largest iterate gap (0)."""
        if not (torch.equal(out_k[7], out_p[7]) and torch.equal(out_k[8], out_p[8])):
            raise SystemExit(f"phase 3 [{label}]: done/it_inc differ between kernel and plain")
        for nm, a, b in zip(names, out_k, out_p):
            if not torch.equal(torch.isfinite(a), torch.isfinite(b)) or errs[nm] != 0.0:
                raise SystemExit(f"phase 3 [{label}]: {nm} differs between kernel and plain "
                                 f"(gap {errs[nm]:.3g}, limit 0)")
        log(f"phase 3 [{label}]: it_inc {sorted(set(out_k[8].tolist()))[:10]}, converged "
            f"{float((out_k[7] == 1).float().mean()):.4f}, gap 0 (limit 0)")
        return max(errs[k] for k in names[:7])

    # Entry counts near max_iter (some scenarios get one or two check
    # blocks, some none) and every fifth scenario frozen at entry, as the
    # adaptive-rho driver's later chunks see them.
    def near_budget(B_):
        it0_ = np.array([0, 10, 30, 36, 38, 39, 40, 41])[np.arange(B_) % 8]
        return it0_, (np.arange(B_) % 5 == 0).astype(np.int32)

    def check_counts(out_k, it0_, done0_, max_iter, label):
        # One check block of 2 runs while it0 + kb < max_iter.
        blocks = (np.clip(max_iter - it0_, 0, None) + 1) // 2
        if not torch.equal(out_k[8].cpu(), torch.as_tensor(
                np.where(done0_ == 1, 0, 2 * blocks).astype(np.int32))):
            raise SystemExit(f"phase 3 [{label}]: iteration counts do not follow it0/done0")

    cart_shapes = (20, 5, 4, 1, 1024)
    st_forced = ADMMSettings(method="banded", eps_abs=0.0, eps_rel=0.0, max_iter=100,
                             adaptive_rho=False, check_infeasibility=False, check_every=25)
    st_conv = ADMMSettings(method="banded", eps_abs=1e-4, eps_rel=1e-4, max_iter=500,
                           adaptive_rho=False, check_infeasibility=False, check_every=2)
    st_rforced = ADMMSettings(method="banded", eps_abs=0.0, eps_rel=0.0, max_iter=40,
                              adaptive_rho=False, check_infeasibility=False, check_every=2)
    st_rconv = ADMMSettings(method="banded", eps_abs=1e-3, eps_rel=1e-3, max_iter=250,
                            adaptive_rho=False, check_infeasibility=False, check_every=2)
    max_abs_err = 0.0
    one_way_cases = [
        (cart_shapes, st_forced, "forced budget, 100 iterations"),
        (cart_shapes, st_conv, "converging, eps 1e-4"),
        ((20, 4, 3, 1, 1024), st_rforced, "w=4, forced budget, 40 iterations"),
        ((20, 4, 3, 1, 1024), st_conv, "w=4, converging, eps 1e-4"),
        ((20, 3, 2, 1, 1024), st_rforced, "w=3, forced budget, 40 iterations"),
        ((20, 3, 2, 1, 1024), st_conv, "w=3, converging, eps 1e-4"),
        ((2, 5, 4, 1, 64), st_rforced, "N=2, forced budget, 40 iterations"),
    ]
    for shapes, st_, what in one_way_cases:
        label = "one-way N={} w={} r={} r2={} B={}".format(*shapes) + f", {what}"
        out_k, out_p, errs = compare(bk.banded_admm_chunk, bk.banded_admm_chunk_plain,
                                     shapes, st_, label)
        max_abs_err = max(max_abs_err, check_exact(out_k, out_p, errs, label))
    # The unicycle h50's shapes (phase 4g): a half-space stage row
    # lb <= a^T x, ub = +inf that binds (lb 0.5 above the random rows'
    # values near 0), and a row free on both sides.
    uni_shapes = (50, 5, 3, 1, 256)
    for st_, what, sb in ((st_rforced, "forced budget, 40 iterations", (0.5, np.inf)),
                          (st_conv, "converging, eps 1e-4", (0.5, np.inf)),
                          (st_rforced, "forced budget, 40 iterations", (-np.inf, np.inf))):
        label = ("one-way N={} w={} r={} r2={} B={}".format(*uni_shapes)
                 + f", stage row [{sb[0]}, {sb[1]}], {what}")
        out_k, out_p, errs = compare(bk.banded_admm_chunk, bk.banded_admm_chunk_plain,
                                     uni_shapes, st_, label, stage_bounds=sb)
        max_abs_err = max(max_abs_err, check_exact(out_k, out_p, errs, label))
    it0, done0 = near_budget(1024)
    label = "one-way N=20 w=5 B=1024, forced budget, it0 up to 41, done0 every 5th"
    out_k, out_p, errs = compare(bk.banded_admm_chunk, bk.banded_admm_chunk_plain, cart_shapes,
                                 st_rforced, label, None, it0, done0)
    max_abs_err = max(max_abs_err, check_exact(out_k, out_p, errs, label))
    check_counts(out_k, it0, done0, 40, label)

    rolled_err = 0.0
    rolled_cases = [
        ((100, 16, 12, 1, 64), abb.use_cr1(100, 64)),
        ((100, 16, 12, 1, 128), abb.use_cr1(100, 128)),
        ((25, 16, 12, 1, 64), False),  # odd horizon
        ((2, 16, 12, 1, 64), False),
    ]
    # w=5 through rolled=True: the driver's choice of kernel and CR level.
    fn5, kw5 = abb.chunk_kernel(20, 5, 64, rolled=True)
    if fn5 is not brk.banded_admm_chunk_rolled:
        raise SystemExit("phase 3: rolled=True did not pick the rolled chunk at w=5")
    rolled_cases.append(((20, 5, 4, 1, 64), kw5["cr1"]))
    for shapes, cr1 in rolled_cases:
        extra = {"cr1": cr1}
        Bq = shapes[-1]
        label = "rolled N={} w={} r={} r2={} B={}".format(*shapes) + f" cr1={cr1}"
        out_k, out_p, errs = compare(brk.banded_admm_chunk_rolled,
                                     brk.banded_admm_chunk_rolled_plain, shapes, st_rforced,
                                     f"{label}, forced budget, 40 iterations", extra)
        rolled_err = max(rolled_err, check_exact(out_k, out_p, errs, label))
        if shapes[0] == 100 and Bq == 64:
            it0, done0 = near_budget(Bq)
            out_k, out_p, errs = compare(brk.banded_admm_chunk_rolled,
                                         brk.banded_admm_chunk_rolled_plain, shapes, st_rforced,
                                         f"{label}, forced budget, it0 up to 41, done0 every 5th",
                                         extra, it0, done0)
            rolled_err = max(rolled_err, check_exact(out_k, out_p, errs, f"{label}, frozen"))
            check_counts(out_k, it0, done0, 40, label)
        if shapes[0] == 100:
            out_k, out_p, errs = compare(brk.banded_admm_chunk_rolled,
                                         brk.banded_admm_chunk_rolled_plain, shapes, st_rconv,
                                         f"{label}, converging, eps 1e-3", extra)
            check_exact(out_k, out_p, errs, f"{label}, converging")
    log(f"phase 3: largest gap kernel vs plain: one-way {max_abs_err:.3g}, "
        f"rolled {rolled_err:.3g}")

    # -- 3 (continued). the cyclic-reduction chunk vs its plain version ---
    # Bitwise, as the other chunks, in every layout tier: what the kernel
    # keeps in shared memory, as its C entry point derives it.
    cr_err = 0.0
    cr_layout_fn = build.load_library("banded_cr_chunk").ocp_banded_cr_layout
    cr_layout_fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    cr_tier_names = ("vec", "st", "ov", "dinvt", "lp", "lpt", "j_region")

    def cr_case(shapes, st_, what, it0=None, done0=None):
        nonlocal cr_err
        lay = (ctypes.c_longlong * 10)()
        if cr_layout_fn(*shapes[:4], lay) != 0:
            raise SystemExit(f"phase 3: the CR kernel refuses {shapes}")
        label = ("cr N={} w={} r={} r2={} B={}".format(*shapes) + f", {what}; shared memory: "
                 + ", ".join(k for k, on in zip(cr_tier_names, lay[3:10]) if on)
                 + f" (product region {lay[2]} floats, {lay[1]} bytes in all)")
        out_k, out_p, errs = compare(bck.banded_admm_chunk_cr, bck.banded_admm_chunk_cr_plain,
                                     shapes, st_, label, None, it0, done0)
        cr_err = max(cr_err, check_exact(out_k, out_p, errs, label))
        return out_k

    # A forced budget that is no multiple of check_every: one check block
    # of 2 runs while it0 + kb < 41.
    st_cforced = ADMMSettings(method="banded", eps_abs=0.0, eps_rel=0.0, max_iter=41,
                              adaptive_rho=False, check_infeasibility=False, check_every=2)
    quad = (100, 16, 12, 1)
    for Bc in (64, 8, 1):
        it0, done0 = near_budget(Bc)
        if Bc == 1:  # its one scenario runs
            done0 = np.zeros(1, np.int32)
        out_k = cr_case(quad + (Bc,), st_cforced, "forced budget 41, it0 up to 41, done0 every "
                        "5th", it0=it0, done0=done0)
        blocks = (np.clip(41 - it0, 0, None) + 1) // 2
        if not torch.equal(out_k[8].cpu(), torch.as_tensor(
                np.where(done0 == 1, 0, 2 * blocks).astype(np.int32))):
            raise SystemExit(f"phase 3 [cr B={Bc}]: iteration counts do not follow it0/done0")
    for Bc in (64, 8):
        cr_case(quad + (Bc,), st_rconv, "converging, eps 1e-3")
    # Tiers: everything in shared memory up to N=25, w=16; at N=150, w=16
    # all but the product region in the slab; at N=400, w=16 the products
    # and J0, J1 too; at N=1500, w=3 the state, rows and couplings.
    for shapes in ((20, 5, 4, 1, 1024), (20, 3, 2, 1, 64), (7, 16, 12, 1, 64),
                   (25, 16, 12, 1, 64), (2, 16, 12, 1, 64), (150, 16, 12, 1, 8),
                   (400, 16, 12, 1, 8), (1500, 3, 2, 1, 8)):
        cr_case(shapes, st_cforced, "forced budget 41")
    log(f"phase 3: largest gap kernel vs plain, cyclic-reduction chunk: {cr_err:.3g}")

    # Recording wrappers: each driver looks its kernels up on its own
    # module at every call, so these see whichever was dispatched.
    homes = {"banded_admm_chunk": abb, "banded_admm_chunk_rolled": abb, "shared_admm_chunk": tab,
             "admm_device_loop": tadmm, "banded_admm_chunk_cr": abb}
    captured = {k: [] for k in homes}
    real = {k: getattr(mod, k) for k, mod in homes.items()}

    def record(solve):
        def recorder(name):
            def fn(*args, **kw):
                captured[name].append((args, kw))
                return real[name](*args, **kw)
            return fn

        for k, mod in homes.items():
            setattr(mod, k, recorder(k))
        try:
            return solve()
        finally:
            for k, mod in homes.items():
                setattr(mod, k, real[k])

    def reset_counts():
        bk.banded_admm_chunk.launches = 0
        brk.banded_admm_chunk_rolled.launches = 0
        sk.shared_admm_chunk.launches = 0
        sk.shared_admm_chunk.tc_launches = 0
        tab._admm_iterate_fused.chunks = 0
        ak.admm_device_loop.launches = 0
        tadmm._iterate_dense.entries = 0
        bck.banded_admm_chunk_cr.launches = 0

    def counts():
        return (bk.banded_admm_chunk.launches, brk.banded_admm_chunk_rolled.launches,
                sk.shared_admm_chunk.launches, ak.admm_device_loop.launches,
                bck.banded_admm_chunk_cr.launches)

    # -- 3 (continued). the shared-operator chunk vs its plain version ----
    H_di, dt_di, B_di = 20, 0.005, 4096

    def di_config(backend, augmented=False):
        """The JAX bench's double integrator; ``augmented``: with the
        formulation left at its default (the reference's z = [p; x])."""
        form = {} if augmented else {"formulation": "reduced"}
        return double_integrator.make_config(
            horizon=H_di, dt=dt_di, solve_method="TPU_SQP", alpha=0.1, step_num=10,
            ADMM_settings={**DI_ADMM, "backend": backend}, **form)

    def di_solver(backend, device="cuda", augmented=False):
        return BatchedSolver(double_integrator.build(di_config(backend, augmented),
                                                     device=device), device=device)

    rng_di = np.random.default_rng(0)  # frames and references as bench.py:129-133
    di_frames = np.zeros((B_di, double_integrator.FRAME), np.float32)
    di_frames[:, 0:2] = rng_di.uniform(-1, 1, size=(B_di, 2)).astype(np.float32)
    di_refs = np.tile(double_integrator.reference_circle(H_di, dt_di)[None, :],
                      (B_di, 1)).astype(np.float32)
    di_pallas = di_solver("pallas")
    if not di_pallas.solver.shared_system or di_pallas._solve_batch is not di_pallas.solver.solve_batch_fn:
        raise SystemExit("phase 3: the double integrator was not routed to the shared-system path")
    record(lambda: di_pallas.solve(di_frames, di_refs, di_pallas.init_state(B_di)))
    sync()
    di_args, di_kw = captured["shared_admm_chunk"][0]
    captured["shared_admm_chunk"].clear()
    s_names = ("x", "z", "y", "conv", "it_inc", "rp", "rd", "rp_rel", "rd_rel")
    shared_err = 0.0

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # The operator slice rows the kernel's C entry point derives (0: the
    # operators through L1).
    stage_rows_fn = build.load_library("shared_chunk").ocp_shared_stage_rows
    stage_rows_fn.argtypes = [ctypes.c_int] * 3

    def compare_shared(args, kw, label, check, rows=None):
        """Kernel (``rows`` scenarios per block, default the launcher's
        rule) and plain version on the same inputs: conv, it_inc and the
        pattern of infinite residuals equal, every float output bitwise
        equal (gap 0: both sum each product as the same ascending chain
        without FMA contraction)."""
        nonlocal shared_err
        B_, n_k, m_k = args[12].shape[0], args[12].shape[1], args[13].shape[1]
        rows_k = rows or sk.shared_block_rows(B_, kw["batch_tile"], n_k, m_k, sms)
        label = (f"{label}; {rows_k} scenarios a block"
                 + (" (launcher's rule)" if rows is None else "")
                 + f", operator slices of {stage_rows_fn(rows_k, n_k, m_k)} rows")
        out_k = sk.shared_admm_chunk(*args, **kw, rows_per_block=rows)
        sync()
        out_p = sk.shared_admm_chunk_plain(*args, **kw)
        sync()
        errs = {}
        for nm, a, b in zip(s_names, out_k, out_p):
            if a.dtype in (torch.bool, torch.int32):
                if not torch.equal(a, b):
                    raise SystemExit(f"phase 3 [{label}]: {nm} differs between kernel and plain")
                continue
            fin = torch.isfinite(b)
            if not torch.equal(torch.isfinite(a), fin):
                raise SystemExit(f"phase 3 [{label}]: {nm} is infinite in other places")
            errs[nm] = float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0
        B_ = out_k[0].shape[0]
        log(f"phase 3 [{label}]: B={B_} n={out_k[0].shape[1]} m={out_k[1].shape[1]}: max "
            f"|kernel - plain| " + ", ".join(f"{k}={v:.3g}" for k, v in errs.items())
            + f"; it_inc {sorted(set(out_k[4].tolist()))}, converged {float(out_k[3].float().mean()):.4f}")
        if max(errs.values()) != 0.0:
            raise SystemExit(f"phase 3 [{label}]: kernel and plain version disagree (limit 0)")
        check(out_k)
        shared_err = max(shared_err, max(errs.values()))
        return out_k

    def expect(cond, label):
        if not cond:
            raise SystemExit(f"phase 3 [{label}]: unexpected chunk result")

    def shared_cases(args, kw, where):
        done0 = args[0]
        B_ = done0.shape[0]
        forced = {**kw, "eps_abs": 0.0, "eps_rel": 0.0}
        # check_every is 25: a budget of 60 ends after the third whole block.
        compare_shared((done0, 60) + args[2:], forced, f"{where}, forced budget 60",
                       lambda o: expect(bool((o[4] == 75).all()) and not bool(o[3].any()), where))
        compare_shared((done0, 1000) + args[2:], kw, f"{where}, converging, eps 1e-3",
                       lambda o: expect(int(o[4][0]) % 25 == 0 and 0 < int(o[4][0]) <= 1000 and (
                           bool(o[3].all()) or int(o[4][0]) == 1000), where))
        ones = torch.ones_like(done0)
        compare_shared((ones, 60) + args[2:], forced, f"{where}, all done at entry",
                       lambda o: expect(
                           bool((o[4] == 0).all()) and bool(o[3].all())
                           and all(torch.equal(o[i], args[12 + i]) for i in range(3))
                           and bool(torch.isinf(o[5]).all()) and bool(torch.isinf(o[8]).all()),
                           where))
        # Four termination groups; the third enters all done and must come
        # back untouched while the others iterate.
        tile = B_ // 4
        part = torch.zeros_like(done0)
        part[2 * tile:3 * tile] = 1
        g3 = slice(2 * tile, 3 * tile)

        def check_groups(o):
            expect(bool((o[4][g3] == 0).all()) and bool((o[4][:2 * tile] == 75).all())
                   and bool((o[4][3 * tile:] == 75).all())
                   and all(torch.equal(o[i][g3], args[12 + i][g3]) for i in range(3))
                   and bool(torch.isinf(o[5][g3]).all())
                   and bool(torch.isfinite(o[5][:2 * tile]).all()), where)

        compare_shared((part, 60) + args[2:], {**forced, "batch_tile": tile},
                       f"{where}, 4 groups of {tile}, one done at entry", check_groups)

    shared_cases(di_args, di_kw, "shared chunk, double integrator cold tick")
    P_r, A_r, q_r, l_r, u_r = (torch.as_tensor(a, device=dev)
                               for a in random_shared_qp(0, B_di, 120, 196))
    st_r = ADMMSettings(**DI_ADMM, backend="pallas")
    fac_r = tab.prepare_shared(P_r, A_r, l_r, u_r, q_r, st_r)
    record(lambda: tab.admm_iterate_prepared(fac_r, q_r, l_r, u_r, st_r))
    sync()
    r_args, r_kw = captured["shared_admm_chunk"][0]
    captured["shared_admm_chunk"].clear()
    shared_cases(r_args, r_kw, "shared chunk, random shared QP")
    # Each block shape the launcher can pick, on the same forced budget.
    for rows in sk.ROWS_PER_BLOCK:
        compare_shared((r_args[0], 60) + r_args[2:], {**r_kw, "eps_abs": 0.0, "eps_rel": 0.0},
                       f"shared chunk, random shared QP, forced budget 60", lambda o: expect(
                           bool((o[4] == 75).all()), "forced"), rows=rows)
    # The latency batch B=64, and a width that is no multiple of 4 (the
    # operators read through L1, no slices): the first chunk of a solve.
    for Bs, ns, ms in ((64, 120, 196), (256, 118, 195)):
        P_s, A_s, q_s, l_s, u_s = (torch.as_tensor(a, device=dev)
                                   for a in random_shared_qp(2, Bs, ns, ms))
        fac_s = tab.prepare_shared(P_s, A_s, l_s, u_s, q_s, st_r)
        record(lambda: tab.admm_iterate_prepared(fac_s, q_s, l_s, u_s, st_r))
        sync()
        s_args, s_kw = captured["shared_admm_chunk"][0]
        captured["shared_admm_chunk"].clear()
        where = f"shared chunk, random shared QP B={Bs} n={ns} m={ms}"
        compare_shared((s_args[0], 60) + s_args[2:], {**s_kw, "eps_abs": 0.0, "eps_rel": 0.0},
                       f"{where}, forced budget 60",
                       lambda o: expect(bool((o[4] == 75).all()), "forced"))
        compare_shared(s_args, s_kw, f"{where}, converging",
                       lambda o: expect(bool((o[4] % 25 == 0).all()), "converging"))
    # Groups beyond the ~4,200 scenarios the card holds resident at once at
    # n=120, m=196: one group of 6,144, and 8,192 scenarios in two of the
    # JAX package's tiles of 6,536 (the driver pads the batch to 13,072
    # with replicas).  The driver's
    # first chunk of each solve, kernel against plain.
    big_calls = {}
    for Bb in (6144, 8192):
        P_b, A_b, q_b, l_b, u_b = (torch.as_tensor(a, device=dev)
                                   for a in random_shared_qp(1, Bb, 120, 196))
        fac_b = tab.prepare_shared(P_b, A_b, l_b, u_b, q_b, st_r)
        sol_b = record(lambda: tab.admm_iterate_prepared(fac_b, q_b, l_b, u_b, st_r))
        sync()
        big_calls[Bb] = list(captured["shared_admm_chunk"])
        captured["shared_admm_chunk"].clear()
        b_args, b_kw = big_calls[Bb][0]
        tile = sk.pick_shared_tile(Bb, 120, 196)
        groups = b_args[12].shape[0] // b_kw["batch_tile"]
        if b_kw["batch_tile"] != tile or groups != -(-Bb // tile):
            raise SystemExit(f"phase 3: the B={Bb} solve did not vote in JAX's groups of {tile}")
        log(f"phase 3: backend=pallas random shared QP B={Bb}: {groups} group(s) of {tile}, "
            f"{len(big_calls[Bb])} chunks, {int(sol_b.iters)} iterations, converged "
            f"{float(sol_b.converged.float().mean()):.4f}, finite "
            f"{bool(torch.isfinite(sol_b.x).all())}")
        if not bool(torch.isfinite(sol_b.x).all()):
            raise SystemExit(f"phase 3: the B={Bb} shared solve is not finite")
        compare_shared(b_args, b_kw, f"shared chunk, random shared QP B={Bb}, {groups} group(s)",
                       lambda o: expect(bool((o[4] % 25 == 0).all()), f"B={Bb}"))
    # The augmented double integrator (phase 4h): the reference joins the
    # QP, n = 40 + 120, m = 160 + 76.  The first chunk of its own cold tick
    # at B=4096, voting in JAX's termination groups for this shape (the
    # whole batch up to 5,430 scenarios here, 6,538 at n=120, m=196).
    dia_pallas = di_solver("pallas", augmented=True)
    if not dia_pallas.solver.shared_system or dia_pallas.solver._qp_n != 160:
        raise SystemExit("phase 3: the augmented double integrator did not take the shared "
                         "path at n=160")
    record(lambda: dia_pallas.solve(di_frames, di_refs, dia_pallas.init_state(B_di)))
    sync()
    a_args, a_kw = captured["shared_admm_chunk"][0]
    captured["shared_admm_chunk"].clear()
    tile_a = sk.pick_shared_tile(B_di, 160, 236)
    if (a_args[12].shape[1], a_args[13].shape[1]) != (160, 236) or a_kw["batch_tile"] != tile_a:
        raise SystemExit(f"phase 3: the augmented double integrator did not vote in JAX's "
                         f"groups of {tile_a} at n=160, m=236")
    log(f"phase 3: augmented double integrator B={B_di}: n=160, m=236, "
        f"{a_args[12].shape[0] // tile_a} group(s) of {tile_a} (JAX's pick_shared_tile)")
    shared_cases(a_args, a_kw, "shared chunk, augmented double integrator cold tick")
    log(f"phase 3: largest gap kernel vs plain, shared chunk: {shared_err:.3g}")

    # -- 3 (continued). the shared chunk's tensor-core form --------------
    # iter_precision "high" / "mixed": bf16_3x products on the tensor
    # cores.  Both versions split every operand into the same bf16 bits
    # and sum exact products, the kernel in the tensor cores' order, the
    # plain version in float32 through torch.matmul, so they are held at a
    # tolerance, relative to each output's largest finite magnitude.  The
    # scale of that gap is the data's: where dual updates multiply a
    # cancelling difference by rho (1e3 x rho on the equality rows), the
    # float32 sums alone move y by ~6e-4 of its largest value after one
    # iteration.  So after one forced iteration and after a forced budget
    # of 60 (75 iterations) each output is held to three times the plain
    # version's own distance from the same computation with its products
    # summed in float64 (at least 1e-5); a converging chunk (the first two
    # of phase 4i's steady ticks: a cold tick's first chunk at its fixed
    # rho does not converge in 1000 iterations) to iteration counts within
    # one check block, conv equal except at the knife edge of eps (counted
    # and reported: at most 1% of the batch, each with its residual within
    # a factor 2 of its threshold: the two runs' residuals are differences
    # of near-equal terms), and where the counts agree its iterates to the
    # same rule as a forced budget (a converged step is small, so a fixed
    # bound relative to it is not a scale).
    tc_err = {"high": 0.0, "mixed": 0.0}

    def rel_gap(a, b):
        fin = torch.isfinite(b)
        if not torch.equal(torch.isfinite(a), fin):
            return float("inf")
        if not bool(fin.any()):
            return 0.0
        return float((a[fin] - b[fin]).abs().max() / b[fin].abs().max().clamp(min=1e-30))

    def at_knife_edge(out, kw):
        """Scenarios whose larger residual-to-threshold ratio is in [0.5, 2]."""
        rp, rd, rpr, rdr = out[5], out[6], out[7], out[8]
        ep = kw["eps_abs"] + kw["eps_rel"] * rp / rpr
        ed = kw["eps_abs"] + kw["eps_rel"] * rd / rdr
        ratio = torch.maximum(rp / ep, rd / ed)
        return (ratio >= 0.5) & (ratio <= 2.0)

    def split_f64(a, w_split):
        a_hi, a_lo = sk.split_bf16(a)
        d = [t_.double() for t_ in (a_hi, a_lo, *w_split)]
        return (d[0] @ d[2] + d[0] @ d[3] + d[1] @ d[2]).float()

    def plain_f64_sums(args, kw):
        """The plain version with its bf16_3x products summed in float64."""
        real_split = sk.matmul_split
        sk.matmul_split = split_f64
        try:
            return sk.shared_admm_chunk_plain(*args, **kw)
        finally:
            sk.matmul_split = real_split

    def compare_tc(args, kw, mode, what, where, rows=None):
        label = f"phase 3 [shared chunk tensor-core form, {mode}, {where}, {what}]"
        kw = {**kw, "iter_precision": mode}
        before = sk.shared_admm_chunk.tc_launches
        out_k = sk.shared_admm_chunk(*args, **kw, rows_per_block=rows)
        sync()
        if sk.shared_admm_chunk.tc_launches != before + 1:
            raise SystemExit(f"{label}: the tensor-core form was not launched")
        out_p = sk.shared_admm_chunk_plain(*args, **kw)
        sync()
        gaps = {nm: rel_gap(a, b) for nm, a, b in zip(("x", "z", "y"), out_k[:3], out_p[:3])}
        diff = out_k[3] != out_p[3]
        edge = int(diff.sum())
        it_gap = int((out_k[4] - out_p[4]).abs().max())
        if it_gap == 0:
            out_d = plain_f64_sums(args, kw)
            limits = {nm: max(3 * rel_gap(b, d), 1e-5)
                      for nm, b, d in zip(("x", "z", "y"), out_p[:3], out_d[:3])}
        else:  # stopped a check block apart: the iterates are not comparable
            limits = {nm: float("inf") for nm in gaps}
        B_ = out_k[0].shape[0]
        rows_k = rows or sk.shared_block_rows(B_, kw["batch_tile"], out_k[0].shape[1],
                                               out_k[1].shape[1], sms, tensor_cores=True)
        log(f"{label}: B={B_} n={out_k[0].shape[1]} m={out_k[1].shape[1]}, {rows_k} scenarios "
            f"a block: max |kernel - plain| / max |plain| "
            + ", ".join(f"{k}={v:.3g} (limit {limits[k]:.3g})" for k, v in gaps.items())
            + f"; it_inc {sorted(set(out_k[4].tolist()))[:4]} vs "
            f"{sorted(set(out_p[4].tolist()))[:4]}; converged {float(out_k[3].float().mean()):.4f}"
            f"; scenarios whose conv differs (knife edge): {edge}")
        ok = all(gaps[k] <= limits[k] for k in gaps)
        if what == "converging":
            ok &= (it_gap <= kw["check_every"] and edge <= max(1, B_ // 100)
                   and bool(at_knife_edge(out_p, kw)[diff].all()))
        else:
            ok &= it_gap == 0 and edge == 0
        if not ok:
            raise SystemExit(f"{label}: the tensor-core form and its plain version disagree")
        if it_gap == 0:
            tc_err[mode] = max(tc_err[mode], max(gaps.values()))

    def b64_slice(args, kw):
        per = (0, 6, 7, 8, 12, 13, 14)  # done0, lb, ub, qb, x, z, y
        cut = tuple(a[:64].contiguous() if i in per else a for i, a in enumerate(args))
        return cut, {**kw, "batch_tile": 64}

    # The tensor-core entry point's packing kernel (the operators' bf16
    # hi / lo slices, once per call) against its plain version
    # tc_operator_slices, bitwise, on the operators of both cold ticks.
    pack_fn = build.load_library("shared_chunk_tc").ocp_shared_tc_pack_f32
    pack_fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p]
    pack_fn.restype = ctypes.c_int
    for where, op_args in (("double integrator", di_args), ("augmented double integrator",
                                                             a_args)):
        OP_c, Ab_c = op_args[2], op_args[3]
        for name, w_c in (("Ab", Ab_c), ("OP", OP_c), ("Ab^T", Ab_c.T.contiguous())):
            want = sk.tc_operator_slices(w_c)
            got = torch.full_like(want, float("nan"))
            ptrs = (ctypes.c_void_p * 2)(w_c.data_ptr(), got.data_ptr())
            rc = pack_fn(ctypes.cast(ptrs, ctypes.c_void_p), 2, *w_c.shape,
                         ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
            sync()
            if rc != 0:
                raise SystemExit(f"phase 3: the packing kernel's launch failed: cudaError {rc}")
            same = torch.equal(got.view(torch.int16), want.view(torch.int16))
            log(f"phase 3 [shared chunk tensor-core form, {where} {name} "
                f"{tuple(w_c.shape)}]: packing kernel vs tc_operator_slices bitwise equal: {same}")
            if not same:
                raise SystemExit(f"phase 3: the tensor-core form's packing of {name} ({where}) "
                                 "differs from tc_operator_slices")
    for where, (t_args, t_kw) in (
            ("double integrator cold tick", (di_args, di_kw)),
            ("double integrator cold tick B=64", b64_slice(di_args, di_kw)),
            ("augmented double integrator cold tick", (a_args, a_kw))):
        for mode in ("high", "mixed"):
            forced = {**t_kw, "eps_abs": 0.0, "eps_rel": 0.0}
            compare_tc((t_args[0], 1) + t_args[2:], {**forced, "check_every": 1}, mode,
                       "one iteration", where)
            compare_tc((t_args[0], 60) + t_args[2:], forced, mode, "forced budget 60", where)
    for rows in sk.ROWS_PER_BLOCK_TC:
        compare_tc((di_args[0], 1) + di_args[2:], {**di_kw, "eps_abs": 0.0, "eps_rel": 0.0,
                                                   "check_every": 1}, "high", "one iteration",
                   "double integrator cold tick", rows=rows)
    log(f"phase 3: largest relative gap kernel vs plain, shared chunk tensor-core form: "
        f"high {tc_err['high']:.3g}, mixed {tc_err['mixed']:.3g}")

    # -- 3 (continued). the dense device loop vs its plain version --------
    B_cd, steps_cd = 256, 10
    cd_frames = np.zeros((B_cd, cartpole.FRAME), np.float32)
    cd_frames[:, 2] = np.random.default_rng(0).uniform(-0.5, 0.5, B_cd).astype(np.float32)
    cd_refs = np.full((B_cd, 1), np.pi, np.float32)

    def cd_config(backend, augmented=False, parity=False):
        """The JAX bench's cartpole_h20_pallas; ``augmented``: with the
        formulation left at its default; ``parity``: and the parity
        preset on."""
        form = {} if augmented else {"formulation": "reduced"}
        cfg_ = cartpole.make_config(
            horizon=20, dt=0.02, alpha=0.3, step_num=steps_cd,
            ADMM_settings={**DENSE_ADMM, "backend": backend}, **form)
        if parity:
            cfg_["solver_settings"]["SQP_settings"]["parity"] = True
        return cfg_

    def cd_build(backend, device="cuda", augmented=False, parity=False):
        return cartpole.build(cd_config(backend, augmented, parity), stagewise=False,
                              device=device)

    cd_pallas = BatchedSolver(cd_build("pallas"))
    if cd_pallas._solve_batch is not cd_pallas.solver.solve_batch_dense_fn:
        raise SystemExit("phase 3: cart-pole without a stage structure was not routed to the "
                         "dense batch path")
    # One cold tick records the device loop's inputs of each SQP step.
    record(lambda: cd_pallas.solve(cd_frames, cd_refs, cd_pallas.init_state(B_cd)))
    sync()
    cd_cold = list(captured["admm_device_loop"])
    captured["admm_device_loop"].clear()
    if len(cd_cold) != steps_cd:
        raise SystemExit(f"phase 3: the cold dense tick entered the device loop {len(cd_cold)} "
                         f"times, expected {steps_cd}")
    loop_err = 0.0

    def compare_loop(args, kw, label, check, tier=None):
        """Kernel (in ``tier``, default the rule's) and plain version on the
        same inputs: equal ``it`` and every float output bitwise equal (NaN
        where NaN, the sign of a zero included; gap 0): both sum each
        product as the same ascending chain without FMA contraction."""
        nonlocal loop_err
        out_k = (ak.admm_device_loop(*args, **kw) if tier is None else
                 ak._launch(*args, kw["max_iter"], kw["check_every"], tier))
        sync()
        t0 = time.perf_counter()
        out_p = ak.admm_device_loop_plain(*args, **kw)
        sync()
        plain_s = time.perf_counter() - t0
        if not torch.equal(out_k[3], out_p[3]):
            raise SystemExit(f"phase 3 [{label}]: iteration counts differ between kernel and plain")
        errs = {}
        same = True
        for nm, a, b in zip("xyz", out_k, out_p):
            if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
                raise SystemExit(f"phase 3 [{label}]: {nm} is infinite in other places")
            fin = torch.isfinite(b)
            errs[nm] = float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0
            same &= bool((torch.isnan(a) & torch.isnan(b)
                          | (a == b) & (torch.signbit(a) == torch.signbit(b))).all())
        its = sorted(set(out_k[3].tolist()))
        n_, m_ = out_k[0].shape[1], out_k[1].shape[1]
        log(f"phase 3 [{label}]: B={out_k[0].shape[0]} n={n_} m={m_} tier "
            f"{tier or ak.kernel_tier(n_, m_)}: max |kernel - plain| "
            + ", ".join(f"{k}={v:.3g}" for k, v in errs.items())
            + f"; it {its[:8]}{' ...' if len(its) > 8 else ''} (plain side {plain_s:.1f} s)")
        if not same:
            raise SystemExit(f"phase 3 [{label}]: kernel and plain version differ in their bits "
                             "(limit: gap 0)")
        if not check(out_k[3]):
            raise SystemExit(f"phase 3 [{label}]: unexpected iteration counts")
        loop_err = max(loop_err, max(errs.values()))

    args0, kw0 = cd_cold[0]
    forced_args = args0[:12] + (0.0, 0.0) + args0[14:]
    if ak.kernel_tier(100, 196) != 1:
        raise SystemExit("phase 3: the cart-pole h20 QP did not take the device loop's tier 1")
    for tier in (1, 2, 3):
        compare_loop(forced_args, {**kw0, "max_iter": 60}, "device loop, cart-pole cold step 1, "
                     f"forced budget 60 (check_every 25), tier {tier} forced",
                     lambda it: bool((it == 75).all()), tier=tier)
    compare_loop(args0, kw0, "device loop, cart-pole cold step 1, eps 1e-3, max_iter 500",
                 lambda it: bool((it % 25 == 0).all() and (it <= 500).all()))
    args2, kw2 = cd_cold[2]
    compare_loop(args2, kw2, "device loop, cart-pole cold step 3",
                 lambda it: len(set(it.tolist())) > 1)
    one = tuple(a[:1] if torch.is_tensor(a) else a for a in args0)
    compare_loop(one, kw0, "device loop, cart-pole cold step 1, B=1",
                 lambda it: it.shape == (1,))
    # The +-inf / equality QP of tests/test_pallas_admm.py:48, prepared by
    # the port's own driver, from 8 random warm starts.
    P_e = torch.as_tensor(2 * np.eye(3), dtype=torch.float32, device=dev)
    q_e = torch.as_tensor([-2.0, 0.0, 1.0], device=dev)
    A_e = torch.as_tensor(np.vstack([np.eye(3), [[1.0, 1.0, 1.0]]]), dtype=torch.float32,
                          device=dev)
    l_e = torch.as_tensor([0.5, -np.inf, -1.0, 1.0], dtype=torch.float32, device=dev)
    u_e = torch.as_tensor([0.5, np.inf, 1.0, 1.0], dtype=torch.float32, device=dev)
    B_e = 8
    st_e = ADMMSettings(method="condensed", eps_abs=1e-4, eps_rel=1e-4, adaptive_rho=False)
    prep_e = tadmm.prepare_dense(*(a.expand((B_e,) + a.shape).contiguous()
                                   for a in (P_e, q_e, A_e, l_e, u_e)), st_e)
    rng_e = np.random.default_rng(0)
    w_e = [torch.as_tensor(rng_e.normal(size=(B_e, k)) * 0.3, dtype=torch.float32, device=dev)
           for k in (3, 4)]
    args_e = (prep_e.OP.contiguous(), prep_e.Ab, prep_e.Pb, prep_e.qb, prep_e.lb, prep_e.ub,
              prep_e.rho_v, 1.0 / prep_e.D, 1.0 / prep_e.E, 1.0 / prep_e.c,
              st_e.sigma, st_e.alpha, st_e.eps_abs, st_e.eps_rel, *w_e)
    compare_loop(args_e, {"max_iter": 1000, "check_every": 25},
                 "device loop, +-inf bounds and equality rows, eps 1e-4",
                 lambda it: bool((it > 0).all()))
    # Larger QPs take the kernel's other tiers: random batches at n=120,
    # m=236 (tier 2: OP^T and Ab in shared memory) and n=200, m=392 (tier
    # 3: operators read from global memory) solved by the dense "pallas"
    # path (the JAX package's guard admits both), and the kernel's first
    # entry of each against its plain version.
    dense_tiers = {}
    for (n_g, m_g, B_g, tier_g) in ((120, 236, 64, 2), (200, 392, 32, 3)):
        if ak.kernel_tier(n_g, m_g) != tier_g:
            raise SystemExit(f"phase 3: n={n_g}, m={m_g} did not take the device loop's "
                             f"tier {tier_g}")
        P_g, q_g, A_g, l_g, u_g = (torch.as_tensor(a, device=dev)
                                   for a in random_dense_qp(2, B_g, n_g, m_g))
        st_g = ADMMSettings(method="condensed", eps_abs=1e-3, eps_rel=1e-3, max_iter=500,
                            adaptive_rho=False, backend="pallas")
        sol_g = record(lambda: tadmm.admm_solve_batch(P_g, q_g, A_g, l_g, u_g, st_g))
        sync()
        calls_g = list(captured["admm_device_loop"])
        captured["admm_device_loop"].clear()
        log(f"phase 3: backend=pallas dense QPs B={B_g} n={n_g} m={m_g} (tier {tier_g}): "
            f"{len(calls_g)} kernel entries, converged {float(sol_g.converged.float().mean()):.4f}, "
            f"iterations {sorted(set(sol_g.iters.tolist()))[:8]}, finite "
            f"{bool(torch.isfinite(sol_g.x).all())}")
        if not bool(torch.isfinite(sol_g.x).all()):
            raise SystemExit(f"phase 3: the n={n_g}, m={m_g} dense solve is not finite")
        g_args, g_kw = calls_g[0]
        compare_loop(g_args, g_kw, f"device loop, tier {tier_g}, B={B_g} n={n_g} m={m_g}",
                     lambda it: bool((it % 25 == 0).all()))
        dense_tiers[(n_g, m_g)] = calls_g
    # The augmented cart-pole (phase 4f): the reference angle joins the
    # QP, n = 1 + 100, m = 101 + 96, both odd, so every chain ends in a
    # one-term tail inside the padded rows.  One cold tick records its
    # inputs: each tier forced, then the rule's tier at eps 1e-3.
    ca_pallas = BatchedSolver(cd_build("pallas", augmented=True))
    if ca_pallas._solve_batch is not ca_pallas.solver.solve_batch_dense_fn or (
            ca_pallas.solver._qp_n, ca_pallas.solver._qp_m) != (101, 197):
        raise SystemExit("phase 3: the augmented cart-pole was not routed to the dense batch "
                         "path at n=101, m=197")
    if ak.kernel_tier(101, 197) != 1:
        raise SystemExit("phase 3: the n=101, m=197 QP did not take the device loop's tier 1")
    record(lambda: ca_pallas.solve(cd_frames, cd_refs, ca_pallas.init_state(B_cd)))
    sync()
    ca_cold = list(captured["admm_device_loop"])
    captured["admm_device_loop"].clear()
    if len(ca_cold) != steps_cd:
        raise SystemExit(f"phase 3: the cold augmented tick entered the device loop "
                         f"{len(ca_cold)} times, expected {steps_cd}")
    args_a, kw_a = ca_cold[0]
    for tier in (1, 2, 3):
        compare_loop(args_a[:12] + (0.0, 0.0) + args_a[14:], {**kw_a, "max_iter": 60},
                     "device loop, augmented cart-pole cold step 1, forced budget 60, "
                     f"tier {tier} forced", lambda it: bool((it == 75).all()), tier=tier)
    compare_loop(args_a, kw_a, "device loop, augmented cart-pole cold step 1, eps 1e-3",
                 lambda it: bool((it % 25 == 0).all() and (it <= 500).all()))
    compare_loop(*ca_cold[2], "device loop, augmented cart-pole cold step 3",
                 lambda it: bool((it % 25 == 0).all()))
    log(f"phase 3: largest gap kernel vs plain, dense device loop: {loop_err:.3g}")

    def drive(solver, frames, refs, ticks, label, expect_launches, pinned=False):
        """Run ``ticks`` ticks of one main path with the launch counts
        reset just before and read just after; check and report.
        ``expect_launches``: the (one-way, rolled, shared, device-loop,
        cyclic-reduction) launch counts, or a function of the counted five
        that says whether they are right.

        The frames are the same every tick, so each tick warm-starts the
        SQP from the last.  The plan's objective alone need not fall: as
        the dynamics defect closes, the cost of the (now feasible) plan can
        rise.  So every tick after the first must lower the objective
        (rtol 1e-3) or the defect, the defect must end below its value at
        the first warm tick, and the objective must not end above the
        first tick's.

        ``pinned`` (the double integrator): its dynamics are linear, so
        the zero start satisfies them exactly and the only rows violated
        are the box rows that pin the first frame to the measurement; the
        violation then counts those rows too, and closing the pin raises
        the tracking cost from the cold tick on, so in place of "not above
        the first tick's" the objective must settle: its last change
        smaller than its first."""
        state = solver.init_state(frames.shape[0])
        refs_t = torch.as_tensor(refs, device=dev)
        lbg, ubg = (torch.as_tensor(b, dtype=torch.float32, device=dev) for b in (
            solver.ocp.get_constraint_lower_bounds(), solver.ocp.get_constraint_upper_bounds()))
        g_batch = torch.func.vmap(solver.solver.g_fn)
        pin = torch.as_tensor(frames, device=dev)
        tick_ms, f_mean, defect = [], [], []
        reset_counts()
        for _ in range(ticks):
            sync()
            t0 = time.perf_counter()
            traj, f, state = solver.solve(frames, refs, state)
            sync()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            if not bool(torch.isfinite(traj).all()):
                raise SystemExit(f"{label}: non-finite trajectory")
            f_mean.append(float(f.mean()))
            g = g_batch(traj, refs_t)
            viol = torch.clamp(torch.maximum(lbg - g, g - ubg), min=0).sum(dim=1)
            if pinned:
                viol = viol + (traj[:, :pin.shape[1]] - pin).abs().sum(dim=1)
            defect.append(float(viol.mean()))  # mean l1 violation
        n = counts()
        log(f"{label}: {ticks} ticks: one-way launches {n[0]}, rolled launches {n[1]}, "
            f"shared launches {n[2]}, device-loop launches {n[3]}, cyclic-reduction launches "
            f"{n[4]}, mean f by tick "
            + ", ".join(f"{v:.4f}" for v in f_mean)
            + "; mean l1 constraint violation by tick " + ", ".join(f"{v:.3e}" for v in defect))
        ok = expect_launches(n) if callable(expect_launches) else n == tuple(expect_launches)
        if not ok:
            raise SystemExit(f"{label}: unexpected launch counts (one-way, rolled, shared, "
                             f"device loop, cyclic reduction) {n}")
        if pinned:
            if not abs(f_mean[-1] - f_mean[-2]) < abs(f_mean[1] - f_mean[0]):
                raise SystemExit(f"{label}: the objective did not settle")
        elif f_mean[-1] > f_mean[0] * (1 + 1e-3):
            raise SystemExit(f"{label}: the objective rose between the first and last tick")
        for t in range(1, ticks):
            if f_mean[t] > f_mean[t - 1] * (1 + 1e-3) and defect[t] >= defect[t - 1]:
                raise SystemExit(f"{label}: tick {t + 1} raised the objective and the "
                                 "constraint violation")
        if not defect[-1] < defect[1]:
            raise SystemExit(f"{label}: the constraint violation did not fall after the "
                             "first warm tick")
        B = frames.shape[0]
        med = statistics.median(tick_ms[warm:])
        res = solver.last_result
        qp_iters = res.qp_iters.float()
        if qp_iters.dim() > 1:  # per scenario: (steps, B) banded, (B, steps) dense
            qp_iters = qp_iters.mean(dim=0 if res.f_history.shape[0] == B else 1)
        log(f"{label}: ms/tick {', '.join(f'{t:.2f}' for t in tick_ms)}; median of "
            f"timed {med:.3f} ms, {B / (med / 1e3):.1f} solves/s; mean QP iterations "
            f"per step at the last tick {', '.join(f'{v:.1f}' for v in qp_iters.tolist())}")
        return state, sum(n)

    # -- 4. the short-horizon main path: cart-pole h20 --------------------
    step_num, ticks, warm = 10, 7, 2
    cfg = cartpole.make_config(horizon=20, dt=0.04, alpha=0.3, step_num=step_num,
                               formulation="reduced", ADMM_settings=dict(MAIN_ADMM))
    ocp = cartpole.build(cfg, stagewise=True, device="cuda")
    solver = BatchedSolver(ocp)
    rng = np.random.default_rng(0)
    Bm = 1024
    frames = np.zeros((Bm, cartpole.FRAME), np.float32)
    frames[:, 2] = rng.uniform(-0.5, 0.5, Bm).astype(np.float32)
    refs = np.full((Bm, 1), np.pi, np.float32)
    state, launches = drive(solver, frames, refs, ticks, f"phase 4 cart-pole h20 B={Bm}",
                            (step_num * ticks, 0, 0, 0, 0))
    # Phase 5m's solves tick from the states phase 4 leaves: (config,
    # frames, references, state) by kernel.
    export_from = {"B1": (cfg, frames, refs, state)}
    # One more tick records the chunk inputs the main path produces.
    record(lambda: solver.solve(frames, refs, state))
    sync()

    def profile_tick(solver, frames, refs, state, tag):
        """One more tick under torch.profiler: its wall time, the device's
        kernel time and busy share, and a table by op in ``OUT_DIR``."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as tprofile

        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sync()
            t0 = time.perf_counter()
            solver.solve(frames, refs, state)
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        os.makedirs(OUT_DIR, exist_ok=True)
        name = f"profile_tick_{tag}.txt"
        avg = prof.key_averages()
        with open(os.path.join(OUT_DIR, name), "w") as fh:
            fh.write(f"{smi}\none profiled {tag} tick at B={frames.shape[0]}: {wall:.3f} ms wall\n"
                     f"{avg.table(sort_by='cuda_time_total', row_limit=25)}\n"
                     f"{avg.table(sort_by='cpu_time_total', row_limit=25)}\n")
        dev_us = sum(getattr(e, "self_device_time_total", 0) for e in avg
                     if getattr(e, "device_type", None) == DeviceType.CUDA)
        log(f"profile {tag}: tick wall {wall:.3f} ms, device kernel time {dev_us / 1e3:.3f} ms "
            f"({100 * dev_us / 1e3 / wall:.1f}% busy); table in {os.path.join(OUT_DIR, name)}")

    if profile:
        profile_tick(solver, frames, refs, state, "cartpole_banded")

    # -- 4b. the long-horizon main path: quadrotor h100 -------------------
    q_steps, q_ticks = 5, 7

    def quad_case(Bq, H=100, admm=QUAD_ADMM):
        rq = np.random.default_rng(0)
        fr = np.tile(quadrotor.initial_state()[None, :], (Bq, 1)).astype(np.float32)
        fr[:, 0:2] += rq.uniform(-0.5, 0.5, (Bq, 2)).astype(np.float32)
        rf = np.tile(quadrotor.reference_hover(H)[None, :], (Bq, 1)).astype(np.float32)
        qcfg = quadrotor.make_config(horizon=H, dt=0.02, alpha=0.3, step_num=q_steps,
                                     formulation="reduced", ADMM_settings=dict(admm))
        return qcfg, fr, rf

    rolled_launches = 0
    for Bq in (64, 128):
        qcfg, qfr, qrf = quad_case(Bq)
        qsolver = BatchedSolver(quadrotor.build(qcfg, stagewise=True, device="cuda"))
        qstate, n = drive(qsolver, qfr, qrf, q_ticks, f"phase 4b quadrotor h100 B={Bq}",
                          (0, q_steps * q_ticks, 0, 0, 0))
        rolled_launches += n
        if Bq == 64:
            record(lambda: qsolver.solve(qfr, qrf, qstate))
            sync()
            export_from["B2"] = (qcfg, qfr, qrf, qstate)
    if len(captured["banded_admm_chunk_rolled"]) != q_steps or len(
            captured["banded_admm_chunk"]) != step_num:
        raise SystemExit("phase 4/4b: the recorded ticks did not go through the expected kernels")

    # -- 4c. the LTI main path: double integrator h20 ---------------------
    di_steps = 10

    def di_launch_rule(n):
        # Adaptive rho makes the chunk count depend on the data: every SQP
        # step enters the kernel at least once, each driver chunk is one
        # launch, and the banded kernels stay out of this path.
        return (n[0], n[1], n[3], n[4]) == (0, 0, 0, 0) and (
            n[2] == tab._admm_iterate_fused.chunks >= di_steps * ticks)

    di_xla = di_solver("xla")
    shared_launches = 0
    di_state = None
    for Bd in (B_di, 64):
        label = f"phase 4c double integrator h20 B={Bd}"
        fr_d, rf_d = di_frames[:Bd], di_refs[:Bd]
        state_d, n = drive(di_pallas, fr_d, rf_d, ticks, f"{label} backend=pallas",
                           di_launch_rule, pinned=True)
        shared_launches += n
        log(f"{label} backend=pallas: {n / ticks:.1f} chunk launches per tick over {ticks} ticks")
        if Bd == B_di:
            di_state = state_d
        else:
            di_state64 = state_d
        # The same ticks on the "xla" backend (the torch.matmul loop), each
        # from the state the "pallas" backend started that tick from, so a
        # difference stays within one tick.
        st_p = di_pallas.init_state(Bd)
        xla_ms, pal_ms, gap_pv, gap_acc, same_conv = [], [], 0.0, 0.0, True
        iters_p, iters_x = [], []
        reset_counts()
        for _ in range(ticks):
            st_in = BatchState(*(a.clone() for a in st_p))
            sync()
            t0 = time.perf_counter()
            tp, _, st_p = di_pallas.solve(fr_d, rf_d, st_p)
            sync()
            pal_ms.append((time.perf_counter() - t0) * 1e3)
            rp_ = di_pallas.last_result
            t0 = time.perf_counter()
            tx, _, _ = di_xla.solve(fr_d, rf_d, st_in)
            sync()
            xla_ms.append((time.perf_counter() - t0) * 1e3)
            rx_ = di_xla.last_result
            iters_p.append(rp_.qp_iters.tolist())
            iters_x.append(rx_.qp_iters.tolist())
            same_conv &= torch.equal(rp_.qp_converged, rx_.qp_converged)
            d = (tp - tx).abs().reshape(Bd, H_di, double_integrator.FRAME)
            gap_pv = max(gap_pv, float(d[..., 0:4].max()))
            gap_acc = max(gap_acc, float(d[..., 4:6].max()))
        if counts()[2] != tab._admm_iterate_fused.chunks or counts()[:2] != (0, 0) or any(
                counts()[3:]):
            raise SystemExit(f"{label}: the xla backend launched a chunk kernel")
        # The kernel sums each product as an ascending chain, cuBLAS in
        # its own order, so a scenario whose residual sits within an ulp
        # of eps at a check can stop the batch one check block apart (the
        # knife edge of the termination test; a CPU rehearsal at B=16 saw
        # it in 6 of 70 steps, all in ticks 2 and 3).  The counts must be
        # equal at the last tick (steady state: every QP ends at its first
        # check, far from the edge) and in at least 8 of 10 steps overall;
        # the differing steps are listed.
        steps_all = sum(len(a) for a in iters_p)
        steps_same = sum(a == b for p_, x_ in zip(iters_p, iters_x) for a, b in zip(p_, x_))
        for t_, (p_, x_) in enumerate(zip(iters_p, iters_x)):
            if p_ != x_:
                log(f"{label}: tick {t_ + 1} qp_iters pallas {p_} xla {x_}")
        log(f"{label}: backend=xla ms/tick {', '.join(f'{t:.2f}' for t in xla_ms)} (median of "
            f"timed {statistics.median(xla_ms[warm:]):.3f}) beside backend=pallas "
            f"{', '.join(f'{t:.2f}' for t in pal_ms)} (median of timed "
            f"{statistics.median(pal_ms[warm:]):.3f}); qp_iters equal in {steps_same} of "
            f"{steps_all} steps, at the last tick: {iters_p[-1] == iters_x[-1]}; "
            f"qp_converged equal: {same_conv}, converged share at the last tick "
            f"{float(rp_.qp_converged.float().mean()):.4f}; max |pallas - xla| positions and "
            f"velocities {gap_pv:.3g} (limit 5e-3), accelerations {gap_acc:.3g} (limit 0.1, "
            f"range +-50)")
        if not (same_conv and iters_p[-1] == iters_x[-1] and steps_same >= 0.8 * steps_all):
            raise SystemExit(f"{label}: the two backends disagree on qp_iters or qp_converged")
        if not (gap_pv <= 5e-3 and gap_acc <= 0.1):
            raise SystemExit(f"{label}: the two backends' trajectories disagree")
    # The same model at batches whose termination group is larger than the
    # grid the card holds resident at once (~4,200 at n=120, m=196): one
    # group of 6,144 and two JAX tiles at 8,192; two ticks each.
    for Bd in (6144, 8192):
        rng_b = np.random.default_rng(0)
        fr_b = np.zeros((Bd, double_integrator.FRAME), np.float32)
        fr_b[:, 0:2] = rng_b.uniform(-1, 1, size=(Bd, 2)).astype(np.float32)
        rf_b = np.tile(di_refs[:1], (Bd, 1))
        st_b = di_pallas.init_state(Bd)
        reset_counts()
        ms_b = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            tr_b, f_b, st_b = di_pallas.solve(fr_b, rf_b, st_b)
            sync()
            ms_b.append((time.perf_counter() - t0) * 1e3)
        n = counts()
        ok_b = bool(torch.isfinite(tr_b).all()) and n[2] > 0 and n[:2] == (0, 0)
        log(f"phase 4c double integrator h20 B={Bd} backend=pallas (termination groups of "
            f"{sk.pick_shared_tile(Bd, 120, 196)}): ms/tick "
            f"{', '.join(f'{t:.2f}' for t in ms_b)}, shared launches {n[2]}, mean f "
            f"{float(f_b.mean()):.4f}, converged share {float(di_pallas.last_result.qp_converged.float().mean()):.4f}, "
            f"finite {bool(torch.isfinite(tr_b).all())}")
        if not ok_b:
            raise SystemExit(f"phase 4c: the double integrator at B={Bd} failed on the card")
    # One more B=64 and B=4096 tick each records the chunk inputs of a
    # steady-state tick.
    record(lambda: di_pallas.solve(di_frames[:64], di_refs[:64], di_state64))
    sync()
    scalls64 = list(captured["shared_admm_chunk"])
    captured["shared_admm_chunk"].clear()
    record(lambda: di_pallas.solve(di_frames, di_refs, di_state))
    sync()
    if not (captured["shared_admm_chunk"] and scalls64) or len(
            captured["banded_admm_chunk"]) != step_num:
        raise SystemExit("phase 4c: the recorded tick did not go through the shared chunk")

    # -- 4d. the per-scenario dense main path: cart-pole h20, B=256 ---------
    label = f"phase 4d cart-pole h20 dense B={B_cd}"

    def cd_launch_rule(n):
        # Adaptive rho is off: one kernel entry per SQP step, unless the
        # kernel stops a scenario on its own test that the driver's torch
        # residuals find not done (the knife edge), which re-enters.
        return n[:3] == (0, 0, 0) and n[4] == 0 and n[3] == tadmm._iterate_dense.entries and (
            n[3] >= steps_cd * ticks)

    cd_state, n_cd = drive(cd_pallas, cd_frames, cd_refs, ticks, f"{label} backend=pallas",
                           cd_launch_rule)
    dense_launches = n_cd
    log(f"{label} backend=pallas: {n_cd} device-loop launches over {ticks} ticks "
        f"(step_num x ticks = {steps_cd * ticks}: {n_cd == steps_cd * ticks})")
    def dense_interleave(label, pal, xla, n_ticks, nan_ok=False):
        """``n_ticks`` ticks of the dense path on the "pallas" backend, each
        followed by the same tick on the "xla" backend (the torch.matmul
        loop) from the state the "pallas" tick started from: equal
        qp_converged every tick and qp_iters at the last, trajectories
        within 5e-3.  ``nan_ok`` (a diverging preset): NaN in the same
        places, the gap over the finite entries, and equal certificates."""
        st_p = pal.init_state(B_cd)
        xla_ms, pal_ms, gap, same_conv = [], [], 0.0, True
        iters_p, iters_x = [], []
        same_nan = same_cert = True
        reset_counts()
        for _ in range(n_ticks):
            st_in = BatchState(*(a.clone() for a in st_p))
            sync()
            t0 = time.perf_counter()
            tp, _, st_p = pal.solve(cd_frames, cd_refs, st_p)
            sync()
            pal_ms.append((time.perf_counter() - t0) * 1e3)
            rp_ = pal.last_result
            t0 = time.perf_counter()
            tx, _, _ = xla.solve(cd_frames, cd_refs, st_in)
            sync()
            xla_ms.append((time.perf_counter() - t0) * 1e3)
            rx_ = xla.last_result
            iters_p.append(rp_.qp_iters.cpu())
            iters_x.append(rx_.qp_iters.cpu())
            same_conv &= torch.equal(rp_.qp_converged, rx_.qp_converged)
            same_cert &= torch.equal(rp_.qp_prim_inf, rx_.qp_prim_inf) and torch.equal(
                rp_.qp_dual_inf, rx_.qp_dual_inf)
            fin = torch.isfinite(tp)
            same_nan &= torch.equal(fin, torch.isfinite(tx))
            if nan_ok:
                if bool(fin.any()):
                    gap = max(gap, float((tp[fin] - tx[fin]).abs().max()))
            else:
                gap = max(gap, float((tp - tx).abs().max()))
        n = counts()
        if n[3] != tadmm._iterate_dense.entries or n[:3] != (0, 0, 0) or n[4] or (
                n[3] < steps_cd * n_ticks):
            raise SystemExit(f"{label}: the launch counts do not follow the dense driver's "
                             f"entries {n}")
        # Per scenario and step (B x steps per tick); the differing ones listed.
        for t_, (p_, x_) in enumerate(zip(iters_p, iters_x)):
            diff = (p_ != x_).nonzero().tolist()
            if diff:
                log(f"{label}: tick {t_ + 1}: qp_iters differ in {len(diff)} of {p_.numel()} "
                    "(scenario, step): " + ", ".join(
                        f"({b}, {k}) pallas {int(p_[b, k])} xla {int(x_[b, k])}"
                        for b, k in diff[:12]))
        same_last = torch.equal(iters_p[-1], iters_x[-1])
        n_same = sum(int((p_ == x_).sum()) for p_, x_ in zip(iters_p, iters_x))
        log(f"{label}: backend=xla ms/tick {', '.join(f'{t:.2f}' for t in xla_ms)} (median of "
            f"timed {statistics.median(xla_ms[min(warm, n_ticks - 1):]):.3f}) beside "
            f"backend=pallas {', '.join(f'{t:.2f}' for t in pal_ms)} (median of timed "
            f"{statistics.median(pal_ms[min(warm, n_ticks - 1):]):.3f}); device-loop launches "
            f"{n[3]} (pallas), qp_iters equal in {n_same} of {n_ticks * iters_p[0].numel()} "
            f"(scenario, step) pairs, at the last tick: {same_last}; qp_converged equal: "
            f"{same_conv}, certificates equal: {same_cert}, converged share at the last tick "
            f"{float(rp_.qp_converged.float().mean()):.4f}; finite share of the trajectories "
            f"{float(fin.float().mean()):.4f}, in the same places: {same_nan}; max |pallas - "
            f"xla| trajectory {gap:.3g} (limit 5e-3)")
        if not (same_conv and same_last and same_nan and (same_cert or not nan_ok)):
            raise SystemExit(f"{label}: the two backends disagree on qp_iters, qp_converged, "
                             "certificates or where the trajectories are finite")
        if not gap <= 5e-3:
            raise SystemExit(f"{label}: the two backends' trajectories disagree")
        return rp_, n[3]

    dense_interleave(label, cd_pallas, BatchedSolver(cd_build("xla")), ticks)
    # One more tick records the device loop's inputs of a steady-state tick.
    record(lambda: cd_pallas.solve(cd_frames, cd_refs, cd_state))
    sync()
    cd_steady = list(captured["admm_device_loop"])
    captured["admm_device_loop"].clear()
    if len(cd_steady) < steps_cd:
        raise SystemExit("phase 4d: the recorded tick did not go through the device loop")
    if profile:
        profile_tick(cd_pallas, cd_frames, cd_refs, cd_state, "cartpole_dense")

    # -- 4e. the cyclic-reduction banded path: quadrotor h100, "cr" -------
    cr_launches = 0
    cr_calls = {}
    for Bq in (64, 8):
        label = f"phase 4e quadrotor h100 banded_solver=cr B={Bq}"
        qcfg, qfr, qrf = quad_case(Bq, admm=QUAD_CR_ADMM)
        crs = BatchedSolver(quadrotor.build(qcfg, stagewise=True, device="cuda"))
        cr_state, n = drive(crs, qfr, qrf, q_ticks, label, (0, 0, 0, 0, q_steps * q_ticks))
        if Bq == 64:
            export_from["B4"] = (qcfg, qfr, qrf, cr_state)
        cr_launches += n
        # One more tick records the chunk inputs of a steady-state tick.
        record(lambda: crs.solve(qfr, qrf, cr_state))
        sync()
        cr_calls[Bq] = list(captured["banded_admm_chunk_cr"])
        captured["banded_admm_chunk_cr"].clear()
        if len(cr_calls[Bq]) != q_steps:
            raise SystemExit(f"{label}: the recorded tick did not go through the CR chunk")
        # The same ticks with banded_solver "thomas" (the rolled chunk), each
        # from the state the CR tick started from: different eliminations,
        # same fixed point.  Findings, not gates.
        tcfg, _, _ = quad_case(Bq)
        ths = BatchedSolver(quadrotor.build(tcfg, stagewise=True, device="cuda"))
        st_c = crs.init_state(Bq)
        cr_ms, th_ms, gap = [], [], 0.0
        reset_counts()
        for _ in range(q_ticks):
            st_in = BatchState(*(a.clone() for a in st_c))
            sync()
            t0 = time.perf_counter()
            tc, _, st_c = crs.solve(qfr, qrf, st_c)
            sync()
            cr_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            tt, _, _ = ths.solve(qfr, qrf, st_in)
            sync()
            th_ms.append((time.perf_counter() - t0) * 1e3)
            gap = max(gap, float((tc - tt).abs().max()))
        n = counts()
        log(f"{label}: interleaved with banded_solver=thomas from the same states: cr ms/tick "
            f"{', '.join(f'{t:.2f}' for t in cr_ms)} (median of timed "
            f"{statistics.median(cr_ms[warm:]):.3f}), thomas "
            f"{', '.join(f'{t:.2f}' for t in th_ms)} (median of timed "
            f"{statistics.median(th_ms[warm:]):.3f}); launches cr {n[4]}, rolled {n[1]}; "
            f"max |cr - thomas| trajectory {gap:.3g}")
        if n != (0, q_steps * q_ticks, 0, 0, q_steps * q_ticks):
            raise SystemExit(f"{label}: unexpected launch counts in the interleaved ticks {n}")

    # -- 4f. the augmented dense path: cart-pole h20, B=256 ---------------
    # cartpole_h20_pallas with the formulation left at its default: QP
    # n = 101, m = 197 (the reference angle joins the QP, pinned by its
    # identity row), then three ticks under the reference-parity preset.
    label = f"phase 4f cart-pole h20 dense augmented B={B_cd}"
    ca_state, aug_launches = drive(ca_pallas, cd_frames, cd_refs, ticks,
                                   f"{label} backend=pallas", cd_launch_rule)
    dense_interleave(label, ca_pallas, BatchedSolver(cd_build("xla", augmented=True)), ticks)
    record(lambda: ca_pallas.solve(cd_frames, cd_refs, ca_state))
    sync()
    ca_steady = list(captured["admm_device_loop"])
    captured["admm_device_loop"].clear()
    if len(ca_steady) < steps_cd:
        raise SystemExit(f"{label}: the recorded tick did not go through the device loop")
    # The parity preset (raw objective Hessian, cold QPs): on this
    # nonconvex cost the local QPs are unbounded and their iterates
    # overflow to NaN in the JAX package too (its flags: none converged,
    # no certificate).  Gates: the kernel runs every step, and the two
    # backends agree on NaN, flags and iteration counts.
    label_p = f"{label} parity preset"
    rp_par, par_launches = dense_interleave(
        label_p, BatchedSolver(cd_build("pallas", augmented=True, parity=True)),
        BatchedSolver(cd_build("xla", augmented=True, parity=True)), 3, nan_ok=True)
    log(f"{label_p}: qp_dual_inf share {float(rp_par.qp_dual_inf.float().mean()):.4f}, "
        f"qp_prim_inf share {float(rp_par.qp_prim_inf.float().mean()):.4f}, mean QP "
        f"iterations {float(rp_par.qp_iters.float().mean()):.1f}")

    # -- 4g. the unicycle h50 banded path, with a live half-space row -------
    # unicycle_h50_banded (bench_models.py:310-333): h50, dt 0.05, alpha
    # 0.3 x 10, method "banded", max_iter 500, check_every 5 (adaptive rho
    # on, so the chunk count follows the data), one half-space
    # ((0, 1), -0.5); then the same with the merit line search.
    B_u = 256
    rng_u = np.random.default_rng(0)
    u_frames = np.zeros((B_u, unicycle.FRAME), np.float32)
    u_frames[:, 2] = rng_u.uniform(-0.5, 0.5, B_u).astype(np.float32)
    u_refs = np.tile(unicycle.reference_line(50, 0.05)[None, :], (B_u, 1)).astype(np.float32)

    uni_kw = dict(halfspaces=(((0.0, 1.0), -0.5),), stagewise=True)

    def uni_config(merit):
        cfg_ = unicycle.make_config(horizon=50, dt=0.05, alpha=0.3, step_num=step_num,
                                    formulation="reduced", ADMM_settings=dict(UNI_ADMM))
        if merit:
            cfg_["solver_settings"]["SQP_settings"]["line_search"] = "merit"
        return cfg_

    def uni_build(merit, device="cuda"):
        return unicycle.build(uni_config(merit), **uni_kw, device=device)

    def uni_rule(n):
        # Adaptive rho: at least one chunk launch per SQP step, one-way only.
        return n[1:] == (0, 0, 0, 0) and n[0] >= step_num * ticks

    uni_launches = {}
    for merit in (False, True):
        label = f"phase 4g unicycle h50 banded B={B_u}" + (" line_search=merit" if merit else "")
        us = BatchedSolver(uni_build(merit))
        if us._solve_batch is not us.solver.solve_batch_banded_fn or abb.chunk_kernel(
                50, 5, B_u)[0] is not bk.banded_admm_chunk:
            raise SystemExit(f"{label}: not routed to the one-way banded chunk")
        u_state, uni_launches[merit] = drive(us, u_frames, u_refs, ticks, label, uni_rule)
        traj_u = u_state.x.reshape(B_u, 50, unicycle.FRAME)
        log(f"{label}: {uni_launches[merit]} one-way launches over {ticks} ticks "
            + (f"(the merit rule evaluated {us.solver.options.ls_num} x {B_u} candidates a "
               f"step, {us.solver.options.ls_num * B_u * step_num * ticks} in all)"
               if merit else "")
            + f"; smallest y of the plans {float(traj_u[..., 1].min()):.4f} (half-space "
            "y >= -0.5)")
        if not merit:
            n_kept = len(captured["banded_admm_chunk"])  # phase 4's tick, for phase 6
            record(lambda: us.solve(u_frames, u_refs, u_state))
            sync()
            uni_calls = captured["banded_admm_chunk"][n_kept:]
            del captured["banded_admm_chunk"][n_kept:]
            if not uni_calls or launch_shapes(uni_calls[0][0]) != (50, 5, 3, 1):
                raise SystemExit(f"{label}: the recorded tick did not go through the one-way "
                                 "chunk at N=50, w=5, r=3, r2=1")

    # -- 4h. the augmented LTI path: double integrator h20, B=4096 ---------
    # The JAX bench's double integrator with the formulation at its default:
    # the shared factorization at n = 160, m = 236.  Three ticks (drive's
    # checks need a second warm tick).
    label = f"phase 4h double integrator h20 augmented B={B_di} backend=pallas"
    dia_state, dia_launches = drive(dia_pallas, di_frames, di_refs, 3, label, lambda n: (
        n[0], n[1], n[3], n[4]) == (0, 0, 0, 0) and n[2] == tab._admm_iterate_fused.chunks
        >= di_steps * 3, pinned=True)
    n_kept = len(captured["shared_admm_chunk"])  # phase 4c's steady tick, for phase 6
    record(lambda: dia_pallas.solve(di_frames, di_refs, dia_state))
    sync()
    dia_calls = captured["shared_admm_chunk"][n_kept:]
    del captured["shared_admm_chunk"][n_kept:]
    if not dia_calls or dia_calls[0][1]["batch_tile"] != sk.pick_shared_tile(B_di, 160, 236):
        raise SystemExit(f"{label}: the recorded tick did not go through the shared chunk "
                         "in JAX's groups")

    # -- 4i. the LTI main path with iter_precision "high" / "mixed" ---------
    # The double integrator B=4096 of 4c through the shared chunk's
    # tensor-core form, each tick beside the "highest" tick from the same
    # state (so a difference stays within one tick).  Held like the JAX
    # test of these variants (tests/test_shared_fused.py: rtol 1e-3, atol
    # 2e-3) on positions and velocities; the accelerations (weighted 1e-3)
    # to phase 4c's 0.1, the gap JAX's own two backends show at eps 1e-3.
    def di_tc_solver(mode):
        cfg_ = double_integrator.make_config(
            horizon=H_di, dt=dt_di, solve_method="TPU_SQP", alpha=0.1, step_num=10,
            ADMM_settings={**DI_ADMM, "backend": "pallas"}, formulation="reduced")
        ocp_ = double_integrator.DoubleIntegratorOCP(cfg_, device="cuda")
        st_ = ocp_.solver_settings
        st_.admm = st_.admm.replace(iter_precision=mode)
        ocp_.gen_solver()
        return BatchedSolver(ocp_, device="cuda")

    tc_rows_data = {}
    for mode in ("high", "mixed"):
        label = f"phase 4i double integrator h20 B={B_di} backend=pallas iter_precision={mode}"
        tc_solver = di_tc_solver(mode)
        _, _ = drive(tc_solver, di_frames, di_refs, ticks, label, lambda n: n == (
            0, 0, 0, 0, 0) and sk.shared_admm_chunk.tc_launches == tab._admm_iterate_fused.chunks
            >= di_steps * ticks, pinned=True)
        tc_launches = sk.shared_admm_chunk.tc_launches
        st_t = tc_solver.init_state(B_di)
        tc_ms, hi_ms, it_t, it_h, gap_pv, gap_acc = [], [], [], [], 0.0, 0.0
        for _ in range(ticks):
            st_in = BatchState(*(a.clone() for a in st_t))
            sync()
            t0 = time.perf_counter()
            tt, _, st_t = tc_solver.solve(di_frames, di_refs, st_t)
            sync()
            tc_ms.append((time.perf_counter() - t0) * 1e3)
            it_t.append(float(tc_solver.last_result.qp_iters.float().mean()))
            t0 = time.perf_counter()
            th, _, _ = di_pallas.solve(di_frames, di_refs, st_in)
            sync()
            hi_ms.append((time.perf_counter() - t0) * 1e3)
            it_h.append(float(di_pallas.last_result.qp_iters.float().mean()))
            d = (tt - th).abs().reshape(B_di, H_di, double_integrator.FRAME)
            ref_pv = th.abs().reshape(B_di, H_di, double_integrator.FRAME)[..., 0:4]
            gap_pv = max(gap_pv, float((d[..., 0:4] - 1e-3 * ref_pv).max()))
            gap_acc = max(gap_acc, float(d[..., 4:6].max()))
        n_tc = len(captured["shared_admm_chunk"])
        record(lambda: tc_solver.solve(di_frames, di_refs, st_t))
        sync()
        tc_calls = captured["shared_admm_chunk"][n_tc:]
        del captured["shared_admm_chunk"][n_tc:]
        log(f"{label}: ms/tick {', '.join(f'{t:.2f}' for t in tc_ms)} (median of timed "
            f"{statistics.median(tc_ms[warm:]):.3f}) beside iter_precision=highest "
            f"{', '.join(f'{t:.2f}' for t in hi_ms)} (median of timed "
            f"{statistics.median(hi_ms[warm:]):.3f}); mean QP iterations per step by tick "
            f"{', '.join(f'{v:.1f}' for v in it_t)} beside {', '.join(f'{v:.1f}' for v in it_h)}"
            f"; max |{mode} - highest| - 1e-3 |highest| on positions and velocities "
            f"{gap_pv:.3g} (limit 2e-3), accelerations {gap_acc:.3g} (limit 0.1)")
        if not (gap_pv <= 2e-3 and gap_acc <= 0.1):
            raise SystemExit(f"{label}: the variant's ticks disagree with iter_precision=highest")
        if not tc_calls or any(k["iter_precision"] != mode for _, k in tc_calls):
            raise SystemExit(f"{label}: the recorded tick did not go through the tensor-core form")
        # Phase 3's converging check on chunks that do converge: the first
        # two of this steady tick, kernel against plain.
        for c_args, c_kw in tc_calls[:2]:
            compare_tc(c_args, c_kw, mode, "converging", "4i steady tick")
        tc_rows_data[mode] = {"launches": tc_launches, "calls": tc_calls,
                              "ms_per_tick": statistics.median(tc_ms[warm:]),
                              "highest_ms_per_tick": statistics.median(hi_ms[warm:]),
                              "qp_iters": it_t[-1], "highest_qp_iters": it_h[-1]}

    # -- 5m, started here: export round trips -------------------------------
    # A toy solve (toy_export_job), then the batched kernel ticks: each
    # solve's trace, reload and ticks run in a worker process on the card
    # (export_job) while phases 5-5l run here: a trace is host work, tens of
    # seconds a solve.  Read after 5l.
    e_dir = os.path.join(HERE, "build")  # git-ignored, inside the checkout
    os.makedirs(e_dir, exist_ok=True)

    def cut_steps(cfg_):
        cfg_ = copy.deepcopy(cfg_)
        cfg_["solver_settings"]["SQP_settings"]["step_num"] = EXPORT_STEPS
        return cfg_

    # label: (model, config, frames, references, phase 4 state, build
    # keywords, kernel counter the loaded tick must raise).
    export_cases = {
        f"B1 cart-pole h20 banded B={Bm}": (
            "cartpole", *export_from["B1"], dict(stagewise=True), "banded_admm_chunk.launches"),
        "B2 quadrotor h100 banded B=64": (
            "quadrotor", *export_from["B2"], dict(stagewise=True),
            "banded_admm_chunk_rolled.launches"),
        "B4 quadrotor h100 banded_solver=cr B=64": (
            "quadrotor", *export_from["B4"], dict(stagewise=True),
            "banded_admm_chunk_cr.launches"),
        f"B3 double integrator h20 B={B_di} iter_precision=highest": (
            "double_integrator", di_config("pallas"), di_frames, di_refs, di_state, {},
            "shared_admm_chunk.launches"),
        f"B3 double integrator h20 B={B_di} iter_precision=high": (
            "double_integrator", di_config("pallas"), di_frames, di_refs, di_state, {},
            "shared_admm_chunk.tc_launches"),
        f"B5 cart-pole h20 dense B={B_cd}": (
            "cartpole", cd_config("pallas"), cd_frames, cd_refs, cd_state,
            dict(stagewise=False), "admm_device_loop.launches"),
    }
    export_jobs = [(export_job, (dict(
        model=model, cfg=cut_steps(cfg_), frames=fr, refs=rf,
        state=tuple(t.cpu().numpy() for t in (st_.x, st_.qp_x, st_.qp_y)), build_kw=kw_,
        path=os.path.join(e_dir, f"chip_smoke_export_{i}.pt2"), reps=3,
        **({"iter_precision": "high"} if counter.endswith("tc_launches") else {})),))
        for i, (model, cfg_, fr, rf, st_, kw_, counter) in enumerate(export_cases.values())]
    toy_job = (toy_export_job, (os.path.join(e_dir, "chip_smoke_solver.pt2"),))
    t_5m = time.perf_counter()
    export_wait = process_map([toy_job] + export_jobs, workers=3, threads=1)

    # -- 5. card vs CPU ---------------------------------------------------
    # The CPU sides (the plain kernels, host-bound: seconds to a minute and
    # a half each) run in worker processes while the card's sides run here;
    # each comparison is then checked and logged in order.
    def card_vs_cpu(label, fr, sides, acc_limit=None, n_ticks=2, nan_ok=False):
        """``n_ticks`` ticks on the card and on the CPU (plain kernels),
        ``sides`` each device's ``ticks_on``: trajectories within 5e-3;
        with ``acc_limit`` the double integrator's weakly weighted
        accelerations (columns 4:6 of each frame) are held to it and the
        rest to 5e-3.  ``nan_ok`` (a diverging preset): NaN in the same
        places, the gap over the finite entries, and equal QP flags and
        iteration counts every tick."""
        trajs, flags = {}, {}
        for d in ("cuda", "cpu"):
            trajs[d], flags[d], secs = sides[d]
            log(f"{label}: {n_ticks} ticks at B={fr.shape[0]} on {d}: {secs:.2f} s")
        if nan_ok:
            same = all(np.array_equal(np.isnan(a), np.isnan(b))
                       for a, b in zip(trajs["cuda"], trajs["cpu"])) and all(
                np.array_equal(x, y) for fa, fb in zip(flags["cuda"], flags["cpu"])
                for x, y in zip(fa, fb))
            log(f"{label}: NaN share of the card's last plans "
                f"{float(np.isnan(trajs['cuda'][-1]).mean()):.4f}; NaN places, QP flags and "
                f"iteration counts equal on card and CPU: {same}")
            if not same:
                raise SystemExit(f"{label}: card and CPU ticks disagree")
            trajs = {d: [np.nan_to_num(a, nan=0.0) for a in v] for d, v in trajs.items()}
        diffs = [np.abs(a - b) for a, b in zip(trajs["cuda"], trajs["cpu"])]
        if acc_limit is not None:
            diffs = [d.reshape(d.shape[0], -1, double_integrator.FRAME) for d in diffs]
            acc_gap = max(float(d[..., 4:6].max()) for d in diffs)
            diffs = [d[..., 0:4] for d in diffs]
            log(f"{label}: max |card - CPU| acceleration gap {acc_gap:.3g} (limit {acc_limit})")
            if not acc_gap <= acc_limit:
                raise SystemExit(f"{label}: card and CPU ticks disagree")
        gap = max(float(d.max()) for d in diffs)
        log(f"{label}: max |card - CPU| trajectory gap {gap:.3g} (limit 5e-3)")
        if not gap <= 5e-3:
            raise SystemExit(f"{label}: card and CPU ticks disagree")

    Bs = 64
    qcfg, qfr, qrf = quad_case(8)
    qcfg_cr, qfr_cr, qrf_cr = quad_case(8, admm=QUAD_CR_ADMM)
    stagewise = dict(stagewise=True)
    # (label, model, config, build keywords, frames, refs, card_vs_cpu's
    # options), in phase order.
    comparisons = [
        ("phase 5 cart-pole h20", "cartpole", cartpole.make_config(
            horizon=20, dt=0.04, alpha=0.3, step_num=step_num, formulation="reduced",
            ADMM_settings=dict(MAIN_ADMM)), stagewise, frames[:Bs], refs[:Bs], {}),
        ("phase 5b quadrotor h100", "quadrotor", qcfg, stagewise, qfr, qrf, {}),
        ("phase 5c double integrator h20", "double_integrator", di_config("pallas"), {},
         di_frames[:Bs], di_refs[:Bs], dict(acc_limit=0.1)),
        ("phase 5d cart-pole h20 dense", "cartpole", cd_config("pallas"),
         dict(stagewise=False), cd_frames[:4], cd_refs[:4], dict(n_ticks=3)),
        ("phase 5e quadrotor h100 banded_solver=cr", "quadrotor", qcfg_cr, stagewise, qfr_cr,
         qrf_cr, {}),
        ("phase 5f cart-pole h20 dense augmented", "cartpole",
         cd_config("pallas", augmented=True), dict(stagewise=False), cd_frames[:4],
         cd_refs[:4], dict(n_ticks=3)),
        ("phase 5f cart-pole h20 dense parity preset", "cartpole",
         cd_config("pallas", augmented=True, parity=True), dict(stagewise=False),
         cd_frames[:4], cd_refs[:4], dict(n_ticks=3, nan_ok=True)),
        *[("phase 5g unicycle h50 banded" + (" line_search=merit" if merit else ""),
           "unicycle", uni_config(merit), uni_kw, u_frames[:4], u_refs[:4], {})
          for merit in (False, True)],
        ("phase 5h double integrator h20 augmented", "double_integrator",
         di_config("pallas", augmented=True), {}, di_frames[:4], di_refs[:4],
         dict(acc_limit=0.1)),
    ]

    def side(c, device):
        label, model, cfg_, kw_, fr, rf, opts = c
        return ticks_on, (model, cfg_, kw_, device, fr, rf, opts.get("n_ticks", 2))

    # 5i. the MPC controller, card vs CPU: tests/test_controller.py's
    # closed loop (``closed_loop``).  The controls are its accelerations
    # (range +-50, weight 1e-3 against 10 on the positions): QPs stopped at
    # eps 1e-3 leave them loose, and on the CPU the port's and JAX's
    # controls differ by up to 0.34 at one step
    # (tests/test_torch_frontend.py).  Held: controls within 1% of the
    # range (0.5), closed-loop positions and velocities within 2e-2, the
    # final state within 1e-3, and on each device the position error below
    # 0.4x its start; whether the controls also agree within 5e-3 is
    # printed.
    cpu_jobs = [side(c, "cpu") for c in comparisons] + [(closed_loop, ("cpu",))]
    # The parity preset's CPU side is the longest (its NaN QPs run to the
    # 10,000-iteration budget): it starts first.
    first = [i for i, c in enumerate(comparisons) if c[6].get("nan_ok")]
    order = first + [i for i in range(len(cpu_jobs)) if i not in first]
    cpu_wait = process_map([cpu_jobs[i] for i in order], workers=4, threads=2)
    card = [fn(*args) for fn, args in (side(c, "cuda") for c in comparisons)]
    e_card, s_card, u_card, t_card = closed_loop("cuda")
    cpu = [None] * len(cpu_jobs)
    for i, r in zip(order, cpu_wait()):
        cpu[i] = r
    for c, on_card, on_cpu in zip(comparisons, card, cpu):
        card_vs_cpu(c[0], c[4], {"cuda": on_card, "cpu": on_cpu}, **c[6])

    e_cpu, s_cpu, u_cpu, t_cpu = cpu[-1]
    for device, errs, secs in (("cuda", e_card, t_card), ("cpu", e_cpu, t_cpu)):
        log(f"phase 5i MPCController double integrator h10: 40 closed-loop steps on {device}: "
            f"{secs:.2f} s, position error {errs[0]:.4f} -> {errs[-1]:.4f}")
    u_gap = float(np.abs(u_card - u_cpu).max())
    s_gap = float(np.abs(s_card - s_cpu).max())
    end_gap = float(np.abs(s_card[-1] - s_cpu[-1]).max())
    log(f"phase 5i: max |card - CPU| controls {u_gap:.3g} (limit 0.5; within 5e-3: "
        f"{u_gap <= 5e-3}), closed-loop states {s_gap:.3g} (limit 2e-2), final state "
        f"{end_gap:.3g} (limit 1e-3)")
    if not (e_card[-1] < 0.4 * e_card[0] and e_cpu[-1] < 0.4 * e_cpu[0]):
        raise SystemExit("phase 5i: the closed loop did not bring the position error below "
                         "0.4x its start")
    if not (u_gap <= 0.5 and s_gap <= 2e-2 and end_gap <= 1e-3):
        raise SystemExit("phase 5i: the card's and the CPU's closed loops disagree")

    # -- 5j. the host side: MIXED, the parity oracle, TpuQP, export ----------
    from optimal_control_problem_tpu_torch.solvers import oracle
    from optimal_control_problem_tpu_torch.solvers.qp_interface import TpuQP

    # MIXED on the dense cart-pole h20 (the JAX bench's cartpole_h20_pallas
    # settings, one scenario): tick 1 on the host backend (scipy over
    # float64 CPU evaluations), ticks 2+ on the card's SQP engine, whose
    # QPs go through the device loop.
    mcfg = cartpole.make_config(horizon=20, dt=0.02, alpha=0.3, step_num=steps_cd,
                                solve_method="MIXED", formulation="reduced",
                                ADMM_settings={**DENSE_ADMM, "backend": "pallas"})
    mocp = cartpole.build(mcfg, stagewise=False, device="cuda")
    m_frame, m_ref = cartpole.initial_state(th=0.3), np.array([np.pi])
    m_launches, m_ms = [], []
    for t_ in range(4):
        ak.admm_device_loop.launches = 0
        t0 = time.perf_counter()
        mocp.compute_optimal_trajectory(m_frame, m_ref)
        sync()
        m_ms.append((time.perf_counter() - t0) * 1e3)
        m_launches.append(ak.admm_device_loop.launches)
        if not bool(torch.isfinite(mocp.get_optimal_trajectory()).all()):
            raise SystemExit(f"phase 5j: MIXED tick {t_ + 1} is not finite")
    log(f"phase 5j MIXED dense cart-pole h20: ms/tick {', '.join(f'{v:.1f}' for v in m_ms)}, "
        f"device-loop launches by tick {m_launches}, objective {mocp._last_f:.4f}")
    if not (m_launches[0] == 0 and all(n_ >= steps_cd for n_ in m_launches[1:])):
        raise SystemExit("phase 5j: MIXED did not take the host on tick 1 and the device loop "
                         "after it")

    # The parity oracle (the reference's loop: float64 derivatives on the
    # host, cold native C++ QPs) against the port's product loop on the
    # card, at JAX's bounds: controls within 1e-4 float64 against float64,
    # within the f32 floor of 5e-3 float32 against float32.  Cart-pole's
    # parity preset diverges to NaN in both (raw nonconvex Hessian; 1 tick,
    # its QPs run the whole budget): NaN places must agree.
    for model, cs, o_ticks in (("double_integrator", slice(4, 6), 3),
                               ("cartpole", slice(4, 5), 1)):
        t0 = time.perf_counter()
        o32 = oracle.oracle_closed_loop(model, o_ticks)["trajectories"]
        o64 = oracle.oracle_closed_loop(model, o_ticks, qp_internal_f64=True)["trajectories"]
        p64 = oracle.product_closed_loop(model, o_ticks, precision="f64", device="cuda")
        p32 = oracle.product_closed_loop(model, o_ticks, precision="f32", device="cuda")
        o_cfg = oracle.build_parity_ocp(model, gen=False).ocp_config
        ctrl = lambda tr: tr.reshape(o_ticks, o_cfg.get_horizon(),  # noqa: E731
                                     o_cfg.get_frame_size())[..., cs]
        nan_same = all(np.array_equal(np.isnan(a), np.isnan(b)) for a, b in ((p64, o64), (p32, o32)))
        sem = np.abs(ctrl(p64) - ctrl(o64))
        f32 = np.abs(ctrl(p32) - ctrl(o32))
        nan_share = float(np.isnan(p32).mean())
        sem_max = float(np.nanmax(sem)) if np.isfinite(sem).any() else 0.0
        f32_max = float(np.nanmax(f32)) if np.isfinite(f32).any() else 0.0
        log(f"phase 5k parity oracle {model} ({o_ticks} tick(s), {time.perf_counter() - t0:.1f} s):"
            f" max control gap float64 product (card) vs float64 oracle {sem_max:.3g} (limit "
            f"1e-4), float32 vs float32 {f32_max:.3g} (limit 5e-3); NaN share {nan_share:.4f}, "
            f"NaN places equal: {nan_same}")
        if not (nan_same and sem_max <= 1e-4 and f32_max <= 5e-3):
            raise SystemExit(f"phase 5k: the product loop on the card and the oracle disagree "
                             f"({model})")

    # TpuQP on the card, through the "xla" loop and through the device loop.
    tqp_x = {}
    for backend in ("xla", "pallas"):
        tqp = TpuQP(device="cuda")
        tqp.set_dimension(3, 2)
        tqp.set_system((np.diag([2.0, 2.0, 2.0]), np.array([-1.0, -2.0, 0.0]),
                        np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 1.0]]), np.zeros(2),
                        np.full(2, 10.0)))
        tqp.set_settings(ADMMSettings(eps_abs=1e-4, eps_rel=1e-4, method="condensed",
                                      backend=backend))
        ak.admm_device_loop.launches = 0
        if not tqp.solve():
            raise SystemExit(f"phase 5l: TpuQP ({backend}) did not converge on the card")
        tqp_x[backend] = tqp.get_solution()
        if (backend == "pallas") != (ak.admm_device_loop.launches > 0):
            raise SystemExit(f"phase 5l: TpuQP ({backend}) took the wrong path")
    tqp_gap = max(float(np.abs(v - np.array([0.5, 1.0, 0.0])).max()) for v in tqp_x.values())
    log(f"phase 5l TpuQP on the card: solution {tqp_x['pallas'].tolist()} (device loop), "
        f"{tqp_x['xla'].tolist()} (xla); max gap to (0.5, 1, 0) {tqp_gap:.3g} (limit 2e-3)")
    if not tqp_gap <= 2e-3:
        raise SystemExit("phase 5l: TpuQP's solution is wrong")

    # The batched kernel ticks, exported and reloaded in the workers started
    # before phase 5: each loaded tick from phase 4's state gives the direct
    # tick's QP iterations exactly and its plan within 1e-5, holds its
    # kernel's op node and raises the kernel's counter as the direct tick
    # does (every counter equal; the banded ones by one launch a step).
    t0 = time.perf_counter()
    toy, *export_results = export_wait()
    t_wait = time.perf_counter() - t0
    log(f"phase 5m export_solver/import_solver on the card: traced in {toy['trace_s']:.1f} s, "
        f"{toy['bytes']} bytes, loaded program on {toy['device']}; max |direct - loaded| "
        f"{toy['gap']:.3g} (limit 1e-6), qp_iters equal: {toy['iters_equal']}")
    if not (toy["gap"] <= 1e-6 and toy["device"].startswith("cuda")):
        raise SystemExit("phase 5m: the exported solve differs from the direct call")
    for (label, case), r in zip(export_cases.items(), export_results):
        counter = case[-1]
        kernel = counter.split(".")[0]
        n_kernel = r["n_loaded"][counter]
        per_step = kernel.startswith("banded")
        counts_ok = r["n_loaded"] == r["n_direct"] and (
            n_kernel == EXPORT_STEPS if per_step else n_kernel >= EXPORT_STEPS)
        held = any(k.endswith(f":{kernel}") for k in r["nodes"])
        log(f"phase 5m {label} ({EXPORT_STEPS} SQP steps): traced in {r['trace_s']:.1f} s, "
            f"{r['bytes']} bytes, loaded in {r['load_s']:.1f} s; op nodes {r['nodes']}; "
            f"loaded tick on {r['device']}: {counter} {n_kernel} (direct tick "
            f"{r['n_direct'][counter]}; all counters equal: {r['n_loaded'] == r['n_direct']}), "
            f"qp_iters equal {r['iters_equal']} (mean {r['qp_iters']:.1f}), max |direct - "
            f"loaded| plan {r['gap']:.3g}, QP primal {r['qp_x_gap']:.3g} (limit 1e-5); "
            f"ms/tick direct {r['direct_ms']:.3f}, loaded {r['loaded_ms']:.3f} (median of 3, "
            f"interleaved; worker beside phase 5); one profiled tick: device kernel time "
            f"direct {r['device_ms']['direct']:.3f} of {r['profiled_ms']['direct']:.3f} ms, "
            f"loaded {r['device_ms']['loaded']:.3f} of {r['profiled_ms']['loaded']:.3f} ms "
            f"(host share {1 - r['device_ms']['loaded'] / r['profiled_ms']['loaded']:.3f}); "
            f"job {r['job_s']:.1f} s")
        if not (held and counts_ok and r["iters_equal"] and r["gap"] <= 1e-5 and r["finite"]
                and r["device"].startswith("cuda")):
            raise SystemExit(f"phase 5m {label}: the loaded program differs from the direct "
                             "tick or did not launch its kernel")
    log(f"phase 5m: the toy and the {len(export_results)} batched exports took "
        f"{time.perf_counter() - t_5m:.1f} s from their start before phase 5 (3 worker "
        f"processes); waited here {t_wait:.1f} s")

    # -- 6. kernel timing at the main paths' inputs ------------------------
    def kernel_row(name, kernel, plain, flops_of, launches_, source, replaces, calls=None):
        calls = captured[name] if calls is None else calls
        n_calls = len(calls)

        def run_all(fn):
            for args, kw in calls:
                fn(*args, **kw)

        ms = time_ms(lambda: run_all(kernel), 7, sync) / n_calls
        plain_ms = time_ms(lambda: run_all(plain), 1, sync) / n_calls  # one run: minutes
        # The same launches with no iterations: state copy, M assembly and
        # factorization only (not part of the record; says where time goes).
        prologue_ms = time_ms(lambda: [
            kernel(*args, **{**kw, "interval": 0}) for args, kw in calls], 7, sync) / n_calls
        nbytes = flops = 0
        iters, largest = [], []
        for args, kw in calls:
            outs = plain(*args, **kw)
            iters.append(float(outs[8].double().mean()))
            largest.append(int(outs[8].max()))
            tensors = [a for a in args if torch.is_tensor(a)]
            tensors += [v for a in args if isinstance(a, dict) for v in a.values()]
            nbytes += sum(t.numel() * t.element_size() for t in tensors)
            nbytes += sum(t.numel() * t.element_size() for t in outs)
            shapes = launch_shapes(args)
            flops += float(sum(
                flops_of(shapes, kw, it, it / kw["check_every"])
                for it in outs[8].double().tolist()
            ))
        mean_it = statistics.fmean(iters)
        bytes_ms = nbytes / n_calls / PEAK_BYTES_PER_S * 1e3
        ops_ms = flops / n_calls / PEAK_F32_FLOPS * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        log(f"phase 6: {name} at its main path's inputs ({n_calls} launches of one tick, "
            f"(N, w, r, r2) = {launch_shapes(calls[0][0])}, B={calls[0][0][6].shape[-1]}): "
            f"{ms:.4f} ms/launch, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms * 1e3:.3f} us ({bound_by}; bytes "
            f"{bytes_ms * 1e3:.3f} us, operations {ops_ms * 1e3:.3f} us); of which the "
            f"prologue (interval 0: assembly + factorization) {prologue_ms:.4f} ms; mean "
            f"iterations per scenario and launch {mean_it:.2f}, largest by launch {largest}")
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches_, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "prologue_ms": prologue_ms, "mean_it_inc": mean_it, "max_it_inc": max(largest),
        }

    row1 = kernel_row(
        "banded_admm_chunk", bk.banded_admm_chunk, bk.banded_admm_chunk_plain,
        lambda sh, kw, it, ch: chunk_flops(*sh, it, ch), launches,
        CHUNK_SOURCE, CHUNK_REPLACES)
    row1["max_abs_err"] = max_abs_err
    # B1 at the unicycle h50 tick's recorded inputs (N=50, w=5, r=3, r2=1,
    # a live half-space row; adaptive rho: several chunks a step).
    uni_row = kernel_row(
        "banded_admm_chunk", bk.banded_admm_chunk, bk.banded_admm_chunk_plain,
        lambda sh, kw, it, ch: chunk_flops(*sh, it, ch), uni_launches[False],
        CHUNK_SOURCE, CHUNK_REPLACES, uni_calls)
    row1["unicycle_h50"] = {k: uni_row[k] for k in (
        "launches", "ms", "plain_ms", "bound_ms", "bound_by", "prologue_ms", "mean_it_inc",
        "max_it_inc")}
    row1["unicycle_h50"].update(launches_per_tick=len(uni_calls),
                                merit_launches=uni_launches[True])
    row2 = kernel_row(
        "banded_admm_chunk_rolled", brk.banded_admm_chunk_rolled,
        brk.banded_admm_chunk_rolled_plain,
        lambda sh, kw, it, ch: rolled_chunk_flops(*sh, it, ch, kw["cr1"]), rolled_launches,
        ROLLED_SOURCE, ROLLED_REPLACES)
    row2["max_abs_err"] = rolled_err
    # The same launches without the CR level (the elimination order the
    # driver takes at B >= 128), for the choice of that rule on this card.
    rcalls = captured["banded_admm_chunk_rolled"]
    no_cr1_ms = time_ms(lambda: [brk.banded_admm_chunk_rolled(*args, **{**kw, "cr1": False})
                                 for args, kw in rcalls], 7, sync) / len(rcalls)
    log(f"phase 6: banded_admm_chunk_rolled on the same inputs without the CR level: "
        f"{no_cr1_ms:.4f} ms/launch (with it: {row2['ms']:.4f})")

    # The shared-operator chunk on the recorded launches of one
    # steady-state B=4096 tick of the double integrator.
    scalls = captured["shared_admm_chunk"]

    def matmul_loop(args, kw, iters, checks):
        """The chunk's products as torch.matmul calls (cuBLAS, true f32)
        with the same elementwise updates, for the given iteration and
        check counts: the "xla" backend's arithmetic on the chunk's inputs.
        Times only; nothing reads its result."""
        _, _, OP, Ab, Pb, rho, lb, ub, qb, Dinv, Einv, cinv, x, z, y = args
        sg, al = kw["sigma"], kw["alpha"]
        AbT = Ab.T
        per_block = iters // checks if checks else 0
        for _ in range(checks):
            for _ in range(per_block):
                xt = (sg * x - qb + (rho * z - y) @ Ab) @ OP
                zt = xt @ AbT
                x = al * xt + (1 - al) * x
                z_rel = al * zt + (1 - al) * z
                z_new = torch.minimum(torch.maximum(z_rel + y / rho, lb), ub)
                y = y + rho * (z_rel - z_new)
                z = z_new
            Ax, Px, Aty = x @ AbT, x @ Pb, y @ Ab
            r_prim = ((Ax - z) * Einv).abs().amax(dim=1)
            r_dual = cinv * ((Px + qb + Aty) * Dinv).abs().amax(dim=1)
            max_prim = torch.maximum((Ax * Einv).abs().amax(dim=1), (z * Einv).abs().amax(dim=1))
            max_dual = cinv * torch.maximum(torch.maximum(
                (Aty * Dinv).abs().amax(dim=1), (Px * Dinv).abs().amax(dim=1)),
                (qb * Dinv).abs().amax(dim=1))
            _ = (r_prim <= kw["eps_abs"] + kw["eps_rel"] * max_prim) & (
                r_dual <= kw["eps_abs"] + kw["eps_rel"] * max_dual)
        return x, z, y

    def shared_stats(calls, mean_its=None):
        """Per launch: the largest iteration count (from the kernel, equal
        to the plain version's, phase 3; the mean per scenario appended to
        ``mean_its``), bytes read and written once, and operations from each
        scenario's own iterations and checks."""
        nbytes = flops = 0
        its = []
        for args, kw in calls:
            outs = sk.shared_admm_chunk(*args, **kw)
            its.append(int(outs[4].max()))
            if mean_its is not None:
                mean_its.append(float(outs[4].double().mean()))
            tensors = [a for a in args if torch.is_tensor(a)]
            nbytes += sum(t_.numel() * t_.element_size() for t_ in tensors)
            nbytes += sum(t_.numel() * t_.element_size() for t_ in outs)
            n_c, m_c = args[12].shape[1], args[13].shape[1]
            flops += sum(shared_chunk_flops(n_c, m_c, it, it // kw["check_every"])
                         for it in outs[4].tolist())
        nc = len(calls)
        return its, nbytes / nc / PEAK_BYTES_PER_S * 1e3, flops / nc / PEAK_F32_FLOPS * 1e3

    def shared_timing(calls, what, reps=7, plain=False, matmul=False):
        """ms/launch of the kernel (the launcher's block shape and each
        forced one), its bound and the -fmad=false ceiling (each term a
        separate multiply and add: twice the operations bound), the mean
        and largest iteration count per launch; optionally the plain
        version and the torch.matmul loop on the same launches."""
        nc = len(calls)
        mean_its = []
        its, bytes_ms, ops_ms = shared_stats(calls, mean_its)
        k_ms = time_ms(lambda: [sk.shared_admm_chunk(*a, **k) for a, k in calls], reps,
                       sync) / nc
        by_rows = {
            rows: time_ms(lambda: [sk.shared_admm_chunk(*a, **k, rows_per_block=rows)
                                   for a, k in calls], reps, sync) / nc
            for rows in sk.ROWS_PER_BLOCK}
        a0, k0 = calls[0]
        B_, n_c, m_c = a0[12].shape[0], a0[12].shape[1], a0[13].shape[1]
        rule = sk.shared_block_rows(B_, k0["batch_tile"], n_c, m_c, sms)
        out = {"ms": k_ms, "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "rows": rule,
               "by_rows_ms": {str(r_): v for r_, v in by_rows.items()},
               "mean_it_inc": statistics.fmean(mean_its), "max_it_inc": max(its)}
        extra = ""
        if plain:
            out["plain_ms"] = time_ms(
                lambda: [sk.shared_admm_chunk_plain(*a, **k) for a, k in calls], 1, sync) / nc
            extra += f", plain {out['plain_ms']:.3f} ms"
        if matmul:
            out["matmul_loop_ms"] = time_ms(lambda: [
                matmul_loop(a, k, it, it // k["check_every"]) for (a, k), it in zip(calls, its)],
                reps, sync) / nc
            extra += (f", the same iterations and checks as torch.matmul products "
                      f"{out['matmul_loop_ms']:.4f} ms")
        log(f"phase 6: shared_admm_chunk, {what} ({nc} launches, B={B_}, n={n_c}, m={m_c}, "
            f"iterations per launch: mean {out['mean_it_inc']:.2f}, largest by launch {its}): "
            f"{k_ms:.4f} ms/launch with {rule} scenarios a block (launcher's rule){extra}; "
            f"bound {out['bound_ms'] * 1e3:.3f} us (bytes {bytes_ms * 1e3:.3f} us, operations "
            f"{ops_ms * 1e3:.3f} us), -fmad=false ceiling {2 * ops_ms * 1e3:.3f} us; with 8 / 16 "
            f"/ 32 scenarios per thread block: "
            + " / ".join(f"{by_rows[r_]:.4f}" for r_ in sk.ROWS_PER_BLOCK) + " ms/launch")
        return out

    s4096 = shared_timing(scalls, "steady-state double integrator tick", plain=True, matmul=True)
    s64 = shared_timing(scalls64, "steady-state double integrator tick at the latency batch")
    # One group of 6,144 scenarios (beyond the grid the card holds resident
    # at once): the random shared QP solve's chunks of phase 3.
    s6144 = shared_timing(big_calls[6144], "one group of 6144, a random shared QP solve",
                          reps=5)
    s160 = shared_timing(dia_calls, "steady-state augmented double integrator tick")
    row3 = {
        "name": "shared_admm_chunk", "route": "cuda", "source": SHARED_SOURCE,
        "replaces": SHARED_REPLACES, "launches": shared_launches, "max_abs_err": shared_err,
        "ms": s4096["ms"], "plain_ms": s4096["plain_ms"], "bound_ms": s4096["bound_ms"],
        "bound_by": s4096["bound_by"],
        # No single PyTorch call computes an ADMM chunk; the loop of
        # torch.matmul products is reported beside it.
        "library_ms": None, "matmul_loop_ms": s4096["matmul_loop_ms"],
        "by_rows_ms": s4096["by_rows_ms"], "mean_it_inc": s4096["mean_it_inc"],
        "max_it_inc": s4096["max_it_inc"],
        "b64": s64, "b6144": s6144,
        "augmented_n160_m236": {**s160, "launches": dia_launches},
    }

    # The tensor-core form on 4i's steady B=4096 tick of each mode, beside
    # its plain version and a loop of torch.matmul bf16_3x products (the
    # same split products, the residuals as f32 products).  Bound: the
    # larger of bytes (each input read once and each output written once)
    # and f32 operations at the f32 peak plus the tensor-core operations at
    # the dense bf16 peak.  Beside it the bytes the kernel's bulk copies
    # brought from L2 (its own count: every block reads each operator
    # slice once an iteration) and the rate they imply.
    def tc_matmul_loop(args, kw, iters, checks, mode):
        _, _, OP, Ab, Pb, rho, lb, ub, qb, Dinv, Einv, cinv, x, z, y = args
        sg, al = kw["sigma"], kw["alpha"]
        AbT = Ab.T
        ws = [sk.split_bf16(w) for w in (Ab, OP, AbT)]
        zt_of = (lambda v: sk.matmul_split(v, ws[2])) if mode == "high" else (lambda v: v @ AbT)
        per_block = iters // checks if checks else 0
        for _ in range(checks):
            for _ in range(per_block):
                xt = sk.matmul_split(sg * x - qb + sk.matmul_split(rho * z - y, ws[0]), ws[1])
                zt = zt_of(xt)
                x = al * xt + (1 - al) * x
                z_rel = al * zt + (1 - al) * z
                z_new = torch.minimum(torch.maximum(z_rel + y / rho, lb), ub)
                y = y + rho * (z_rel - z_new)
                z = z_new
            _ = (x @ AbT, x @ Pb, y @ Ab)
        return x, z, y

    def tc_l2_bytes(args, kw):
        """One call of the tensor-core form with the kernel's byte count."""
        B_, n_, m_, bound_, done_, cinv_ = sk._contract(*args, kw["check_every"],
                                                         kw["batch_tile"])
        counter = torch.zeros(1, dtype=torch.int64, device=dev)
        run_kw = {k: v for k, v in kw.items() if k != "iter_precision"}
        sk._launch_tc(done_, bound_, *args[2:11], cinv_, *args[12:], None, **run_kw,
                      iter_precision=kw["iter_precision"], l2_bytes=counter)
        return int(counter.item())

    tc_rows = []
    for mode, data in tc_rows_data.items():
        calls = data["calls"]
        nc = len(calls)
        its, nbytes, f32_ops, tc_ops, l2 = [], 0, 0, 0, 0
        for args, kw in calls:
            outs = sk.shared_admm_chunk(*args, **kw)
            its.append(int(outs[4].max()))
            n_c, m_c = args[12].shape[1], args[13].shape[1]
            tensors = [a for a in args if torch.is_tensor(a)]
            nbytes += sum(t_.numel() * t_.element_size() for t_ in tensors + list(outs))
            l2 += tc_l2_bytes(args, kw)
            for it in outs[4].tolist():
                f, t_ = shared_tc_flops(n_c, m_c, it, it // kw["check_every"], mode)
                f32_ops += f
                tc_ops += t_
        bytes_ms = nbytes / nc / PEAK_BYTES_PER_S * 1e3
        ops_ms = (f32_ops / PEAK_F32_FLOPS + tc_ops / PEAK_BF16_TC_FLOPS) / nc * 1e3
        k_ms = time_ms(lambda: [sk.shared_admm_chunk(*a, **k) for a, k in calls], 7, sync) / nc
        hi_ms = time_ms(lambda: [sk.shared_admm_chunk(*a, **{**k, "iter_precision": "highest"})
                                 for a, k in calls], 7, sync) / nc
        p_ms = time_ms(lambda: [sk.shared_admm_chunk_plain(*a, **k) for a, k in calls], 1,
                       sync) / nc
        mm_ms = time_ms(lambda: [tc_matmul_loop(a, k, it, it // k["check_every"], mode)
                                 for (a, k), it in zip(calls, its)], 7, sync) / nc
        by_rows = {str(r_): time_ms(lambda: [sk.shared_admm_chunk(*a, **k, rows_per_block=r_)
                                             for a, k in calls], 5, sync) / nc
                   for r_ in sk.ROWS_PER_BLOCK_TC}
        l2_call = l2 / nc
        log(f"phase 6: shared_admm_chunk tensor-core form ({mode}), {SHARED_TC_SOURCE}, steady "
            f"double integrator tick ({nc} launches, B={calls[0][0][12].shape[0]}, iterations per "
            f"launch: largest by launch {its}): {k_ms:.4f} ms/launch (16 / 32 scenarios a block: "
            + " / ".join(f"{v:.4f}" for v in by_rows.values())
            + f"), the FP32 form on the same inputs {hi_ms:.4f}, plain {p_ms:.3f}, torch.matmul "
            f"bf16_3x loop {mm_ms:.4f}; bound {max(bytes_ms, ops_ms) * 1e3:.3f} us (bytes "
            f"{bytes_ms * 1e3:.3f} us, operations {ops_ms * 1e3:.3f} us); operator slices "
            f"brought from L2 by bulk copies {l2_call / 1e6:.3f} MB a call (the kernel's count), "
            f"{l2_call / (k_ms * 1e-3) / 1e12:.3f} TB/s over the call")
        tc_rows.append({
            "name": f"shared_admm_chunk[iter_precision={mode}]", "route": "cuda",
            "source": SHARED_TC_SOURCE, "replaces": SHARED_REPLACES,
            "launches": data["launches"], "max_abs_err": tc_err[mode],
            "max_abs_err_is": "relative to the output's largest magnitude",
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            # No single PyTorch call computes an ADMM chunk; the loop of
            # torch.matmul bf16_3x products is reported beside it.
            "library_ms": None, "matmul_loop_ms": mm_ms, "highest_same_inputs_ms": hi_ms,
            "by_rows_ms": by_rows, "max_it_inc": max(its),
            "l2_bytes_per_call": l2_call, "l2_TB_per_s": l2_call / (k_ms * 1e-3) / 1e12,
            "ms_per_tick": data["ms_per_tick"], "highest_ms_per_tick": data["highest_ms_per_tick"],
            "qp_iters": data["qp_iters"], "highest_qp_iters": data["highest_qp_iters"],
        })

    # The dense device loop on the recorded launches of one cold and one
    # steady-state B=256 tick of the cart-pole dense path.
    def loop_matmul(args, kw, iters):
        """The device loop's products as batched torch.matmul calls (cuBLAS,
        true f32) with the same elementwise updates, ``iters`` iterations in
        blocks of check_every with a check after each: the "xla" loop's
        arithmetic on the kernel's inputs.  Times only."""
        OP, Ab, Pb, qb, lb, ub, rho, Dinv, Einv, cinv, sg, al, ea, er, x, y = args
        ce = kw["check_every"]
        AbT = Ab.transpose(1, 2)

        def mv(M, v):
            return (M @ v.unsqueeze(-1)).squeeze(-1)

        z = torch.minimum(torch.maximum(mv(Ab, x), lb), ub)
        for _ in range(iters // ce):
            for _ in range(ce):
                xt = mv(OP, sg * x - qb + mv(AbT, rho * z - y))
                zt = mv(Ab, xt)
                x = al * xt + (1 - al) * x
                z_rel = al * zt + (1 - al) * z
                z_new = torch.minimum(torch.maximum(z_rel + y / rho, lb), ub)
                y = y + rho * (z_rel - z_new)
                z = z_new
            Ax, Px, Aty = mv(Ab, x), mv(Pb, x), mv(AbT, y)
            r_prim = ((Ax - z) * Einv).abs().amax(dim=1)
            r_dual = cinv * ((Px + qb + Aty) * Dinv).abs().amax(dim=1)
            max_prim = torch.maximum((Ax * Einv).abs().amax(dim=1), (z * Einv).abs().amax(dim=1))
            max_dual = cinv * torch.maximum(torch.maximum(
                (Aty * Dinv).abs().amax(dim=1), (Px * Dinv).abs().amax(dim=1)),
                (qb * Dinv).abs().amax(dim=1))
            _ = (r_prim <= ea + er * max_prim) & (r_dual <= ea + er * max_dual)
        return x, y, z

    def loop_stats(calls):
        """Per launch: the iteration counts (from the plain version's
        contract: equal to the kernel's, phase 3), bytes read and written
        once, and operations from each scenario's own counts."""
        nbytes = flops = 0
        iters = []
        for args, kw in calls:
            it = ak.admm_device_loop(*args, **kw)[3]
            iters.append(it)
            B_, n_, m_ = args[0].shape[0], args[0].shape[1], args[1].shape[1]
            tensors = [a for a in args if torch.is_tensor(a)]
            nbytes += sum(t_.numel() * t_.element_size() for t_ in tensors)
            nbytes += 4 * B_ * (n_ + 2 * m_ + 1)
            flops += sum(device_loop_flops(n_, m_, k, k // kw["check_every"])
                         for k in it.tolist())
        nc = len(calls)
        bytes_ms = nbytes / nc / PEAK_BYTES_PER_S * 1e3
        ops_ms = flops / nc / PEAK_F32_FLOPS * 1e3
        return iters, bytes_ms, ops_ms

    def event_ms(fn, reps):
        """Mean device ms of ``fn`` over ``reps`` calls (CUDA events, after
        one warm call)."""
        fn()
        sync()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        sync()
        return e0.elapsed_time(e1) / reps

    loop_rows = {}
    for which, calls in (("cold", cd_cold), ("steady", cd_steady), ("augmented cold", ca_cold),
                         ("augmented steady", ca_steady)):
        nc = len(calls)
        iters, bytes_ms, ops_ms = loop_stats(calls)
        k_ms = time_ms(lambda: [ak.admm_device_loop(*a, **k) for a, k in calls], 7, sync) / nc
        mm_ms = time_ms(lambda: [loop_matmul(a, k, int(it.max())) for (a, k), it in
                                 zip(calls, iters)], 3 if which.endswith("steady") else 1,
                        sync) / nc
        plain_ms = None
        if which == "steady":  # the plain version at n=100, m=196 only (minutes)
            plain_ms = time_ms(lambda: [ak.admm_device_loop_plain(*a, **k) for a, k in calls],
                               1, sync) / nc
        mean_it = statistics.fmean(float(it.float().mean()) for it in iters)
        max_it = max(int(it.max()) for it in iters)
        B_, n_, m_ = calls[0][0][0].shape[0], calls[0][0][0].shape[1], calls[0][0][1].shape[1]
        loop_rows[which] = dict(ms=k_ms, mm_ms=mm_ms, plain_ms=plain_ms,
                                bound_ms=max(bytes_ms, ops_ms),
                                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                                mean_it=mean_it, max_it=max_it)
        log(f"phase 6: admm_device_loop at the {which} cart-pole dense tick's inputs ({nc} "
            f"launches, B={B_}, n={n_}, m={m_}, tier {ak.kernel_tier(n_, m_)}; iterations "
            f"per scenario and launch: mean {mean_it:.2f}, largest {max_it}, by launch "
            f"(largest) {[int(it.max()) for it in iters]}): {k_ms:.4f} ms/launch, plain "
            + (f"{plain_ms:.3f} ms" if plain_ms is not None else "not measured (minutes)")
            + f", the same iterations and checks as batched torch.matmul products "
            f"{mm_ms:.4f} ms, bound {max(bytes_ms, ops_ms) * 1e3:.3f} us (bytes "
            f"{bytes_ms * 1e3:.3f} us, operations {ops_ms * 1e3:.3f} us)")
        if which == "steady":
            # The slowest scenario of the steady tick alone (B=1): its
            # latency against the B=256 launch's time says whether one
            # scenario's iterations or the waves of blocks set the
            # launch; over its iteration count (checks in the time, not
            # the count), one scenario's us per iteration.
            (sa, sk_), sit = max(zip(calls, iters), key=lambda c: int(c[1].max()))
            bs = int(sit.argmax())
            one_ = tuple(t_[bs:bs + 1] if torch.is_tensor(t_) else t_ for t_ in sa)
            b1_ms = event_ms(lambda: ak.admm_device_loop(*one_, **sk_), 20)
            loop_rows[which].update(b1_slowest_ms=b1_ms, b1_slowest_it=int(sit.max()),
                                    b1_us_per_iter=b1_ms * 1e3 / int(sit.max()))
            log(f"phase 6: admm_device_loop, the steady tick's slowest scenario alone (B=1, "
                f"{int(sit.max())} iterations): {b1_ms:.4f} ms/launch "
                f"({b1_ms * 1e3 / int(sit.max()):.4f} us per iteration)")
    # Tiers 2 and 3: the n=120, m=236 and n=200, m=392 random dense solves'
    # kernel entries of phase 3.
    tier_rows = {}
    for (n_t, m_t), tcalls in dense_tiers.items():
        t_iters, t_bytes_ms, t_ops_ms = loop_stats(tcalls)
        t_ms = time_ms(lambda: [ak.admm_device_loop(*a, **k) for a, k in tcalls], 5,
                       sync) / len(tcalls)
        B_t = tcalls[0][0][0].shape[0]
        tier_t = ak.kernel_tier(n_t, m_t)
        tier_rows[tier_t] = (n_t, m_t, t_ms, max(t_bytes_ms, t_ops_ms))
        log(f"phase 6: admm_device_loop, tier {tier_t} ({len(tcalls)} launches of a random "
            f"dense solve, B={B_t}, n={n_t}, m={m_t}; iterations per scenario and launch: "
            f"mean {statistics.fmean(float(it.float().mean()) for it in t_iters):.2f}, "
            f"largest {max(int(it.max()) for it in t_iters)}): {t_ms:.4f} ms/launch, "
            f"bound {max(t_bytes_ms, t_ops_ms) * 1e3:.3f} us (bytes "
            f"{t_bytes_ms * 1e3:.3f} us, operations {t_ops_ms * 1e3:.3f} us)")
    st_row, cold_row = loop_rows["steady"], loop_rows["cold"]
    row4 = {
        "name": "admm_device_loop", "route": "cuda", "source": DEVLOOP_SOURCE,
        "replaces": DEVLOOP_REPLACES, "launches": dense_launches, "max_abs_err": loop_err,
        "ms": st_row["ms"], "plain_ms": st_row["plain_ms"], "bound_ms": st_row["bound_ms"],
        "bound_by": st_row["bound_by"],
        # No single PyTorch call computes the loop; the batched
        # torch.matmul loop above is reported beside it.
        "library_ms": None, "matmul_loop_ms": st_row["mm_ms"],
        "tier": ak.kernel_tier(100, 196),
        "mean_it": st_row["mean_it"], "max_it": st_row["max_it"],
        "b1_slowest_ms": st_row["b1_slowest_ms"], "b1_slowest_it": st_row["b1_slowest_it"],
        "b1_us_per_iter": st_row["b1_us_per_iter"],
        "cold_ms": cold_row["ms"], "cold_bound_ms": cold_row["bound_ms"],
        "cold_matmul_loop_ms": cold_row["mm_ms"], "cold_mean_it": cold_row["mean_it"],
        "cold_max_it": cold_row["max_it"],
    }
    # B5 at the augmented cart-pole tick's recorded inputs (n=101, m=197).
    ast_row, acold_row = loop_rows["augmented steady"], loop_rows["augmented cold"]
    row4["augmented_n101_m197"] = {
        "launches": aug_launches, "tier": ak.kernel_tier(101, 197), "ms": ast_row["ms"],
        "bound_ms": ast_row["bound_ms"], "bound_by": ast_row["bound_by"],
        "matmul_loop_ms": ast_row["mm_ms"], "mean_it": ast_row["mean_it"],
        "max_it": ast_row["max_it"], "cold_ms": acold_row["ms"],
        "cold_bound_ms": acold_row["bound_ms"], "cold_mean_it": acold_row["mean_it"],
        "cold_max_it": acold_row["max_it"], "parity_launches": par_launches,
    }
    for tier_t, (n_t, m_t, t_ms, t_bound) in sorted(tier_rows.items()):
        row4[f"tier{tier_t}_n{n_t}_m{m_t}_ms"] = t_ms
        row4[f"tier{tier_t}_n{n_t}_m{m_t}_bound_ms"] = t_bound

    # The cyclic-reduction chunk on the recorded launches of one steady
    # B=64 and one B=8 quadrotor tick, and the rolled chunk (with the CR
    # level where the driver's rule puts it) on the very same inputs.
    cr_rows = {}
    for Bq, calls in cr_calls.items():
        row = kernel_row(
            "banded_admm_chunk_cr", bck.banded_admm_chunk_cr, bck.banded_admm_chunk_cr_plain,
            lambda sh, kw, it, ch: cr_chunk_flops(*sh, it, ch), cr_launches, CR_SOURCE,
            CR_REPLACES, calls)
        cr1 = abb.use_cr1(100, Bq)
        row["rolled_same_inputs_ms"] = time_ms(lambda: [
            brk.banded_admm_chunk_rolled(*a, **k, cr1=cr1) for a, k in calls], 7, sync) / len(calls)
        log(f"phase 6: banded_admm_chunk_rolled (cr1={cr1}) on the same B={Bq} inputs: "
            f"{row['rolled_same_inputs_ms']:.4f} ms/launch (banded_admm_chunk_cr "
            f"{row['ms']:.4f})")
        cr_rows[Bq] = row
    row5 = dict(cr_rows[64])
    row5["max_abs_err"] = cr_err
    row5.update({f"b8_{k}": cr_rows[8][k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "rolled_same_inputs_ms", "prologue_ms",
        "mean_it_inc", "max_it_inc")})

    # The custom ops' dispatch: each kernel's op against its direct ctypes
    # launch (the module's kernel path, which the op's CUDA implementation
    # calls) on one recorded main-path call.  The host time of the call,
    # which returns once the launch is enqueued (synchronised before and
    # after, outside the timed span), interleaved, median of 30 each; the
    # difference is the op's per-launch overhead.
    def host_us(calls, reps=30):
        out = {k: [] for k in calls}
        for _ in range(reps):
            for k, fn in calls.items():
                sync()
                t0 = time.perf_counter()
                fn()
                t1 = time.perf_counter()
                sync()
                out[k].append((t1 - t0) * 1e6)
        return {k: statistics.median(v) for k, v in out.items()}

    def banded_pair(name, mod, args, kw):
        ts = bk.chunk_tensors(*args)
        inputs, dims = bk.chunk_contract(name, *ts, kw["check_every"])
        sc = bk.chunk_scalars(*(kw[k] for k in ("interval", "check_every", "max_iter", "sigma",
                                                 "alpha", "eps_abs", "eps_rel")))
        sc += (kw["cr1"],) if "cr1" in kw else ()
        op = getattr(torch.ops.ocp_torch, name)
        return lambda: op(inputs, *sc), lambda: mod._launch(inputs, dims, *sc)

    def shared_pair(args, kw):
        _, _, _, bound_, done_, cinv_ = sk._contract(*args, kw["check_every"], kw["batch_tile"])
        rest = (*args[2:11], cinv_, *args[12:])
        sc = (kw["check_every"], float(kw["sigma"]), float(kw["alpha"]), float(kw["eps_abs"]),
              float(kw["eps_rel"]), kw["batch_tile"])
        launch = sk._launch if kw["iter_precision"] == "highest" else sk._launch_tc
        run_kw = {k: v for k, v in kw.items() if k != "iter_precision"}
        bound_t = torch.tensor(bound_)
        return (lambda: torch.ops.ocp_torch.shared_admm_chunk(
                    done_, bound_t, *rest, *sc, kw["iter_precision"], None),
                lambda: launch(done_, bound_, *rest, None, **run_kw,
                               iter_precision=kw["iter_precision"]))

    def loop_pair(args, kw):
        sc = tuple(float(v) for v in args[10:14])
        return (lambda: torch.ops.ocp_torch.admm_device_loop(
                    *args[:10], *sc, args[14], args[15], kw["max_iter"], kw["check_every"]),
                lambda: ak._launch(*args, kw["max_iter"], kw["check_every"]))

    dispatch_cases = (
        (row1, banded_pair("banded_admm_chunk", bk, *captured["banded_admm_chunk"][0])),
        (row2, banded_pair("banded_admm_chunk_rolled", brk,
                           *captured["banded_admm_chunk_rolled"][0])),
        (row3, shared_pair(*scalls[0])),
        *((r_, shared_pair(*d_["calls"][0])) for r_, d_ in zip(tc_rows, tc_rows_data.values())),
        (row4, loop_pair(*cd_steady[0])),
        (row5, banded_pair("banded_admm_chunk_cr", bck, *cr_calls[64][0])),
    )
    for row, (via_op, direct) in dispatch_cases:
        us = host_us({"op": via_op, "direct": direct})
        row.update(op="ocp_torch::" + row["name"].split("[")[0], op_host_us=us["op"],
                   direct_host_us=us["direct"], dispatch_us=us["op"] - us["direct"])
        log(f"phase 6: {row['name']} through its op {row['op']}: {us['op']:.1f} us of host "
            f"time a launch, the direct ctypes launch {us['direct']:.1f} us: dispatch "
            f"{us['op'] - us['direct']:.1f} us a launch (kernel {row['ms'] * 1e3:.1f} us)")

    # -- 7. the multi-device paths on the card ----------------------------
    t0 = time.perf_counter()
    phase7(dev)
    log(f"phase 7: {time.perf_counter() - t0:.1f} s in all")

    # -- 8. the example twins on the card ---------------------------------
    t0 = time.perf_counter()
    phase8(dev)
    log(f"phase 8: {time.perf_counter() - t0:.1f} s in all")

    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [row1, row2, row3, *tc_rows, row4, row5]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
