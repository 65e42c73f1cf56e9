#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; exits non-zero on any failure
    python3 chip_smoke.py --profile  # also a torch.profiler window of one tick,
                                     # summary written under chiprun_out/

Phases:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel of the main paths from the sources in this
     checkout (one nvcc per source, all started together);
  3. hold each kernel against its plain PyTorch version on the card, on the
     same inputs: random stage-QP batches scaled and padded by the port's
     own driver prepare -- the one-way chunk at cart-pole shapes (N=20, w=5,
     r=4, r2=1, B=1024), the rolled two-way chunk at quadrotor shapes
     (N=100, w=16, r=12, r2=1) at B=64 (CR level on, also with entry
     counts near max_iter and scenarios frozen at entry) and B=128 (off);
  4. the short-horizon main path: the batched cart-pole h20 MPC tick at
     B=1024 through ``BatchedSolver`` (2 warm-up + 5 timed ticks), checking
     the launch counts, finite trajectories, and that each warm tick lowers
     the objective or the constraint violation (see ``drive``);
  4b. the long-horizon main path: the batched quadrotor h100 tick at the
     JAX bench's settings, B=64 and B=128, with the same checks;
  5. the cart-pole tick at B=64 on the card and on the CPU (plain chunk)
     agree; 5b. the quadrotor h100 tick at B=8 likewise;
  6. time each kernel at its main path's own inputs beside its plain
     version and its bound (and the rolled one without its CR level).
The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# NVIDIA H100 SXM data-sheet peaks (dense, no sparsity), used for bounds.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

CHUNK_REPLACES = "optimal_control_problem_tpu/ops/banded_kernel.py:403"
CHUNK_SOURCE = "optimal_control_problem_tpu_torch/csrc/banded_chunk.cu"
ROLLED_REPLACES = "optimal_control_problem_tpu/ops/banded_rolled_kernel.py:666"
ROLLED_SOURCE = "optimal_control_problem_tpu_torch/csrc/banded_rolled_chunk.cu"

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


def log(msg: str) -> None:
    print(msg, flush=True)


def random_stage_qp_batch(seed, B, N, w, r, r2):
    """Batch-last random stage QP (the shape of tests' random_stage_qp)."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(B, N, w, w))
    Hb = L @ np.swapaxes(L, -1, -2) + 2 * np.eye(w)
    J0 = 0.5 * rng.normal(size=(B, N - 1, r, w))
    J1 = 0.5 * rng.normal(size=(B, N - 1, r, w))
    Jc = 0.5 * rng.normal(size=(B, N, r2, w))
    n = N * w
    q = rng.normal(size=(B, n))
    l = np.concatenate(
        [np.full(n, -2.0), np.zeros((N - 1) * r), np.full(N * r2, -1.0)]
    )
    u = np.concatenate(
        [np.full(n, 2.0), np.zeros((N - 1) * r), np.full(N * r2, np.inf)]
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


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from optimal_control_problem_tpu_torch.models import cartpole, quadrotor
    from optimal_control_problem_tpu_torch.ops import banded_kernel as bk
    from optimal_control_problem_tpu_torch.ops import banded_rolled_kernel as brk
    from optimal_control_problem_tpu_torch.ops import build
    from optimal_control_problem_tpu_torch.parallel import BatchedSolver
    from optimal_control_problem_tpu_torch.solvers import admm_banded_batch as abb
    from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings
    from optimal_control_problem_tpu_torch.solvers.admm_banded import BandedQP

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

    def compare(kernel, plain, shapes, st, label, extra=None, it0=None, done0=None):
        """Kernel and plain version on one random batch; ``it0``/``done0``
        (numpy, per scenario) default to 0."""
        N, w, r, r2, B = shapes
        fields, x0, y0 = random_stage_qp_batch(0, B, N, w, r, r2)
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

    def check_forced(out_k, out_p, errs, label):
        if not (torch.equal(out_k[7], out_p[7]) and torch.equal(out_k[8], out_p[8])):
            raise SystemExit(f"phase 3 [{label}]: done/it_inc differ between kernel and plain")
        for i in range(7):
            torch.testing.assert_close(out_k[i], out_p[i], atol=1e-4, rtol=1e-3)
        return max(errs[k] for k in names[:7])

    def check_converging(out_k, out_p, label):
        same_it = float((out_k[8] == out_p[8]).float().mean())
        conv_k = float((out_k[7] == 1).float().mean())
        conv_p = float((out_p[7] == 1).float().mean())
        log(f"phase 3 [{label}]: converged kernel {conv_k:.4f} plain {conv_p:.4f}, "
            f"equal iteration counts {same_it:.4f}")
        if same_it < 0.98 or abs(conv_k - conv_p) > 0.01:
            raise SystemExit(f"phase 3 [{label}]: converging chunk disagrees with the plain version")
        for i in range(7):
            torch.testing.assert_close(out_k[i], out_p[i], atol=5e-3, rtol=1e-2)

    cart_shapes = (20, 5, 4, 1, 1024)
    st_forced = ADMMSettings(method="banded", eps_abs=0.0, eps_rel=0.0, max_iter=100,
                             adaptive_rho=False, check_infeasibility=False, check_every=25)
    out_k, out_p, errs = compare(bk.banded_admm_chunk, bk.banded_admm_chunk_plain,
                                 cart_shapes, st_forced, "forced budget, 100 iterations")
    max_abs_err = check_forced(out_k, out_p, errs, "one-way")
    st_conv = ADMMSettings(method="banded", eps_abs=1e-4, eps_rel=1e-4, max_iter=500,
                           adaptive_rho=False, check_infeasibility=False, check_every=2)
    out_k, out_p, _ = compare(bk.banded_admm_chunk, bk.banded_admm_chunk_plain,
                              cart_shapes, st_conv, "converging, eps 1e-4")
    check_converging(out_k, out_p, "converging")

    rolled_err = 0.0
    st_rforced = ADMMSettings(method="banded", eps_abs=0.0, eps_rel=0.0, max_iter=40,
                              adaptive_rho=False, check_infeasibility=False, check_every=2)
    st_rconv = ADMMSettings(method="banded", eps_abs=1e-3, eps_rel=1e-3, max_iter=250,
                            adaptive_rho=False, check_infeasibility=False, check_every=2)
    for Bq in (64, 128):
        shapes = (100, 16, 12, 1, Bq)
        extra = {"cr1": abb.use_cr1(100, Bq)}
        label = f"rolled N=100 w=16 r=12 B={Bq} cr1={extra['cr1']}"
        out_k, out_p, errs = compare(brk.banded_admm_chunk_rolled,
                                     brk.banded_admm_chunk_rolled_plain, shapes, st_rforced,
                                     f"{label}, forced budget, 40 iterations", extra)
        rolled_err = max(rolled_err, check_forced(out_k, out_p, errs, label))
        if Bq == 64:
            # The kernel's freezing: entry counts near max_iter (some
            # scenarios get one or two check blocks, some none) and every
            # fifth scenario frozen at entry, as the adaptive-rho driver's
            # later chunks see them.
            it0 = np.array([0, 10, 30, 36, 38, 39, 40, 41])[np.arange(Bq) % 8]
            done0 = (np.arange(Bq) % 5 == 0).astype(np.int32)
            out_k, out_p, errs = compare(brk.banded_admm_chunk_rolled,
                                         brk.banded_admm_chunk_rolled_plain, shapes, st_rforced,
                                         f"{label}, forced budget, it0 up to 41, done0 every 5th",
                                         extra, it0, done0)
            rolled_err = max(rolled_err, check_forced(out_k, out_p, errs, f"{label}, frozen"))
            # One check block of 2 runs while it0 + kb < max_iter = 40.
            blocks = (np.clip(40 - it0, 0, None) + 1) // 2
            if not torch.equal(out_k[8].cpu(), torch.as_tensor(
                    np.where(done0 == 1, 0, 2 * blocks).astype(np.int32))):
                raise SystemExit(f"phase 3 [{label}]: iteration counts do not follow it0/done0")
        out_k, out_p, _ = compare(brk.banded_admm_chunk_rolled,
                                  brk.banded_admm_chunk_rolled_plain, shapes, st_rconv,
                                  f"{label}, converging, eps 1e-3", extra)
        check_converging(out_k, out_p, f"{label}, converging")
    log(f"phase 3: largest gap kernel vs plain: one-way {max_abs_err:.3g}, "
        f"rolled {rolled_err:.3g}")

    # Recording wrappers: the driver looks both kernels up on its module at
    # each SQP step (chunk_kernel), so these see whichever it dispatched.
    captured = {"banded_admm_chunk": [], "banded_admm_chunk_rolled": []}
    real = {k: getattr(abb, k) for k in captured}

    def record(solve):
        def recorder(name):
            def fn(*args, **kw):
                captured[name].append((args, kw))
                return real[name](*args, **kw)
            return fn

        for k in captured:
            setattr(abb, k, recorder(k))
        try:
            return solve()
        finally:
            for k, f in real.items():
                setattr(abb, k, f)

    def reset_counts():
        bk.banded_admm_chunk.launches = 0
        brk.banded_admm_chunk_rolled.launches = 0

    def drive(solver, frames, refs, ticks, label, expect_one_way, expect_rolled):
        """Run ``ticks`` ticks of one main path with the launch counts
        reset just before and read just after; check and report.

        The frames are the same every tick, so each tick warm-starts the
        SQP from the last.  The plan's objective alone need not fall: as
        the dynamics defect closes, the cost of the (now feasible) plan can
        rise.  So every tick after the first must lower the objective
        (rtol 1e-3) or the defect, the defect must end below its value at
        the first warm tick, and the objective must not end above the
        first tick's."""
        state = solver.init_state(frames.shape[0])
        refs_t = torch.as_tensor(refs, device=dev)
        lbg, ubg = (torch.as_tensor(b, dtype=torch.float32, device=dev) for b in (
            solver.ocp.get_constraint_lower_bounds(), solver.ocp.get_constraint_upper_bounds()))
        g_batch = torch.func.vmap(solver.solver.g_fn)
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
            viol = torch.clamp(torch.maximum(lbg - g, g - ubg), min=0)
            defect.append(float(viol.sum(dim=1).mean()))  # mean l1 violation
        n1, n2 = bk.banded_admm_chunk.launches, brk.banded_admm_chunk_rolled.launches
        log(f"{label}: {ticks} ticks: one-way launches {n1}, rolled launches {n2}, "
            f"mean f by tick " + ", ".join(f"{v:.4f}" for v in f_mean)
            + "; mean l1 constraint violation by tick " + ", ".join(f"{v:.3e}" for v in defect))
        if (n1, n2) != (expect_one_way, expect_rolled):
            raise SystemExit(f"{label}: expected launches one-way {expect_one_way}, "
                             f"rolled {expect_rolled}; got {n1}, {n2}")
        if f_mean[-1] > f_mean[0] * (1 + 1e-3):
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
        qp_iters = solver.last_result.qp_iters.float().mean(dim=1).tolist()
        log(f"{label}: ms/tick {', '.join(f'{t:.2f}' for t in tick_ms)}; median of "
            f"timed {med:.3f} ms, {B / (med / 1e3):.1f} solves/s; mean QP iterations "
            f"per step at the last tick {', '.join(f'{v:.1f}' for v in qp_iters)}")
        return state, n1 + n2

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
                            step_num * ticks, 0)
    # One more tick records the chunk inputs the main path produces.
    record(lambda: solver.solve(frames, refs, state))
    sync()

    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile

        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sync()
            t0 = time.perf_counter()
            solver.solve(frames, refs, state)
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        os.makedirs(OUT_DIR, exist_ok=True)
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
        with open(os.path.join(OUT_DIR, "profile_tick.txt"), "w") as fh:
            fh.write(f"{smi}\none profiled tick at B={Bm}: {wall:.3f} ms wall\n{table}\n")
        from torch.autograd import DeviceType

        dev_us = sum(
            getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
        )
        log(f"profile: tick wall {wall:.3f} ms, device kernel time {dev_us / 1e3:.3f} ms "
            f"({100 * dev_us / 1e3 / wall:.1f}% busy); table in chiprun_out/profile_tick.txt")

    # -- 4b. the long-horizon main path: quadrotor h100 -------------------
    q_steps, q_ticks = 5, 7

    def quad_case(Bq, H=100):
        rq = np.random.default_rng(0)
        fr = np.tile(quadrotor.initial_state()[None, :], (Bq, 1)).astype(np.float32)
        fr[:, 0:2] += rq.uniform(-0.5, 0.5, (Bq, 2)).astype(np.float32)
        rf = np.tile(quadrotor.reference_hover(H)[None, :], (Bq, 1)).astype(np.float32)
        qcfg = quadrotor.make_config(horizon=H, dt=0.02, alpha=0.3, step_num=q_steps,
                                     formulation="reduced", ADMM_settings=dict(QUAD_ADMM))
        return qcfg, fr, rf

    rolled_launches = 0
    for Bq in (64, 128):
        qcfg, qfr, qrf = quad_case(Bq)
        qsolver = BatchedSolver(quadrotor.build(qcfg, stagewise=True, device="cuda"))
        qstate, n = drive(qsolver, qfr, qrf, q_ticks, f"phase 4b quadrotor h100 B={Bq}",
                          0, q_steps * q_ticks)
        rolled_launches += n
        if Bq == 64:
            record(lambda: qsolver.solve(qfr, qrf, qstate))
            sync()
    if len(captured["banded_admm_chunk_rolled"]) != q_steps or len(
            captured["banded_admm_chunk"]) != step_num:
        raise SystemExit("phase 4/4b: the recorded ticks did not go through the expected kernels")

    # -- 5. card vs CPU ---------------------------------------------------
    def card_vs_cpu(build_fn, fr, rf, label):
        trajs = {}
        for d in ("cuda", "cpu"):
            s_ = BatchedSolver(build_fn(d), device=d)
            st_ = s_.init_state(fr.shape[0])
            t0 = time.perf_counter()
            out = []
            for _ in range(2):
                tr, _, st_ = s_.solve(fr, rf, st_)
                out.append(tr.cpu().numpy())
            trajs[d] = out
            log(f"{label}: 2 ticks at B={fr.shape[0]} on {d}: {time.perf_counter() - t0:.2f} s")
        gap = max(float(np.abs(a - b).max()) for a, b in zip(trajs["cuda"], trajs["cpu"]))
        log(f"{label}: max |card - CPU| trajectory gap {gap:.3g} (limit 5e-3)")
        if not gap <= 5e-3:
            raise SystemExit(f"{label}: card and CPU ticks disagree")

    Bs = 64
    card_vs_cpu(lambda d: cartpole.build(cartpole.make_config(
        horizon=20, dt=0.04, alpha=0.3, step_num=step_num, formulation="reduced",
        ADMM_settings=dict(MAIN_ADMM)), stagewise=True, device=d),
        frames[:Bs], refs[:Bs], "phase 5 cart-pole h20")
    qcfg, qfr, qrf = quad_case(8)
    card_vs_cpu(lambda d: quadrotor.build(qcfg, stagewise=True, device=d), qfr, qrf,
                "phase 5b quadrotor h100")

    # -- 6. kernel timing at the main paths' inputs ------------------------
    def kernel_row(name, kernel, plain, flops_of, launches_, source, replaces):
        calls = captured[name]
        n_calls = len(calls)

        def run_all(fn):
            for args, kw in calls:
                fn(*args, **kw)

        ms = time_ms(lambda: run_all(kernel), 7, sync) / n_calls
        plain_ms = time_ms(lambda: run_all(plain), 3, sync) / n_calls
        # The same launches with no iterations: state copy, M assembly and
        # factorization only (not part of the record; says where time goes).
        prologue_ms = time_ms(lambda: [
            kernel(*args, **{**kw, "interval": 0}) for args, kw in calls], 7, sync) / n_calls
        nbytes = flops = 0
        iters = []
        for args, kw in calls:
            outs = plain(*args, **kw)
            iters.append(float(outs[8].double().mean()))
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
            f"(N, w, r, r2) = {launch_shapes(calls[0][0])}): {ms:.4f} ms/launch, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms * 1e3:.3f} us ({bound_by}; bytes "
            f"{bytes_ms * 1e3:.3f} us, operations {ops_ms * 1e3:.3f} us); of which the "
            f"prologue (interval 0: assembly + factorization) {prologue_ms:.4f} ms; mean "
            f"iterations per scenario and launch {mean_it:.2f}")
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches_, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        }

    row1 = kernel_row(
        "banded_admm_chunk", bk.banded_admm_chunk, bk.banded_admm_chunk_plain,
        lambda sh, kw, it, ch: chunk_flops(*sh, it, ch), launches,
        CHUNK_SOURCE, CHUNK_REPLACES)
    row1["max_abs_err"] = max_abs_err
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

    print(json.dumps({"kernels": [row1, row2]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
