#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; exits non-zero on any failure
    python3 chip_smoke.py --profile  # also a torch.profiler window of one tick,
                                     # summary written under chiprun_out/

Phases:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel of the main path from the sources in this
     checkout (one nvcc per source, all started together);
  3. hold each kernel against its plain PyTorch version on the card, on the
     same inputs: a random stage-QP batch (N=20, w=5, r=4, r2=1, B=1024,
     numpy seed) scaled and padded by the port's own driver prepare;
  4. the main path: the batched cart-pole h20 MPC tick at B=1024 through
     ``BatchedSolver`` (2 warm-up + 5 timed ticks), checking the launch
     count, finite trajectories and a non-rising objective;
  5. the same tick at B=64 on the card and on the CPU (plain chunk) agree;
  6. time each kernel at the main path's own inputs beside its plain
     version and its bound.
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

MAIN_ADMM = {
    "method": "banded",
    "max_iter": 500,
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


def chunk_flops(N, w, r, r2, iters, checks):
    """Arithmetic operations one chunk launch needs for one scenario that
    runs ``iters`` iterations and ``checks`` termination checks (counted
    from the algorithm's shapes, multiply and add each one)."""
    n, nd = N * w, N - 1
    m = n + nd * r + N * r2
    assemble = N * w * w * (4 + 3 * r2) + nd * w * w * 9 * r
    factor = nd * 4 * w**3 + N * (2 * w * w + 4 * w**3)
    a_x = 4 * nd * r * w + 2 * N * r2 * w  # A x
    at_y = 4 * nd * r * w + 2 * N * r2 * w  # A^T y
    per_iter = (
        5 * n + 2 * (m - n) + at_y  # rhs
        + 2 * nd * w * w + 2 * N * w * w + 2 * nd * w * w  # sweeps
        + a_x + 10 * m + 3 * n  # A xt, relaxation, projection, duals
    )
    per_check = a_x + 2 * N * w * w + at_y + 12 * m
    return assemble + factor + iters * per_iter + checks * per_check


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
    from optimal_control_problem_tpu_torch.models import cartpole
    from optimal_control_problem_tpu_torch.ops import banded_kernel as bk
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
    for line in build.ptxas_log("banded_chunk").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # -- 3. kernel vs plain version on the card --------------------------
    N, w, r, r2, B = 20, 5, 4, 1, 1024
    fields, x0, y0 = random_stage_qp_batch(0, B, N, w, r, r2)
    qpT = BandedQP(*(torch.as_tensor(a, device=dev) for a in fields))
    x0T, y0T = torch.as_tensor(x0, device=dev), torch.as_tensor(y0, device=dev)
    names = ("x", "yx", "yd", "yc", "zx", "zd", "zc", "done", "it_inc", "rp", "rd", "mp", "md")

    def compare(st, label):
        prob = abb.prepare_banded_batch_T(qpT, st, x0T, y0T)
        zeros_b = torch.zeros((B,), dtype=torch.int32, device=dev)
        args, kw = abb.chunk_inputs(prob, st, zeros_b, zeros_b, prob.x, prob.y, prob.z, prob.rho)
        out_k = bk.banded_admm_chunk(*args, **kw)
        sync()
        out_p = bk.banded_admm_chunk_plain(*args, **kw)
        sync()
        errs = {}
        for nm, a, b in zip(names, out_k, out_p):
            d = (a.double() - b.double()).abs()
            fin = torch.isfinite(b.double())
            errs[nm] = float(d[fin].max()) if bool(fin.any()) else 0.0
        log(f"phase 3 [{label}]: max |kernel - plain| " + ", ".join(
            f"{k}={v:.3g}" for k, v in errs.items()))
        return out_k, out_p, errs

    st_forced = ADMMSettings(method="banded", eps_abs=0.0, eps_rel=0.0, max_iter=100,
                             adaptive_rho=False, check_infeasibility=False, check_every=25)
    out_k, out_p, errs = compare(st_forced, "forced budget, 100 iterations")
    if not (torch.equal(out_k[7], out_p[7]) and torch.equal(out_k[8], out_p[8])):
        raise SystemExit("phase 3: done/it_inc differ between kernel and plain version")
    for i in range(7):
        torch.testing.assert_close(out_k[i], out_p[i], atol=1e-4, rtol=1e-3)
    max_abs_err = max(errs[k] for k in names[:7])

    st_conv = ADMMSettings(method="banded", eps_abs=1e-4, eps_rel=1e-4, max_iter=500,
                           adaptive_rho=False, check_infeasibility=False, check_every=2)
    out_k, out_p, _ = compare(st_conv, "converging, eps 1e-4")
    same_it = float((out_k[8] == out_p[8]).float().mean())
    conv_k = float((out_k[7] == 1).float().mean())
    conv_p = float((out_p[7] == 1).float().mean())
    log(f"phase 3 [converging]: converged kernel {conv_k:.4f} plain {conv_p:.4f}, "
        f"equal iteration counts {same_it:.4f}")
    if same_it < 0.98 or abs(conv_k - conv_p) > 0.01:
        raise SystemExit("phase 3: converging chunk disagrees with the plain version")
    for i in range(7):
        torch.testing.assert_close(out_k[i], out_p[i], atol=5e-3, rtol=1e-2)

    # -- 4. the main path -------------------------------------------------
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
    state = solver.init_state(Bm)
    tick_ms, f_mean = [], []
    bk.banded_admm_chunk.launches = 0
    for _ in range(ticks):
        sync()
        t0 = time.perf_counter()
        traj, f, state = solver.solve(frames, refs, state)
        sync()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        if not bool(torch.isfinite(traj).all()):
            raise SystemExit("phase 4: non-finite trajectory")
        f_mean.append(float(f.mean()))
    launches = bk.banded_admm_chunk.launches
    log(f"phase 4: {ticks} ticks at B={Bm}: launches {launches}, mean f by tick "
        + ", ".join(f"{v:.4f}" for v in f_mean))
    if launches != step_num * ticks:
        raise SystemExit(f"phase 4: expected {step_num * ticks} chunk launches, got {launches}")
    if f_mean[-1] > f_mean[0] * (1 + 1e-3):
        raise SystemExit("phase 4: the objective rose between tick 1 and tick 7")
    qp_iters = solver.last_result.qp_iters.float().mean(dim=1).tolist()
    med = statistics.median(tick_ms[warm:])
    log(f"phase 4: ms/tick {', '.join(f'{t:.2f}' for t in tick_ms)}; median of "
        f"timed {med:.3f} ms, {Bm / (med / 1e3):.1f} solves/s; mean QP iterations "
        f"per step at the last tick {', '.join(f'{v:.1f}' for v in qp_iters)}")

    # One more tick records the chunk inputs the main path produces.
    captured = []
    real_chunk = abb.banded_admm_chunk

    def recording_chunk(*args, **kw):
        captured.append((args, kw))
        return real_chunk(*args, **kw)

    abb.banded_admm_chunk = recording_chunk
    try:
        traj, f, state = solver.solve(frames, refs, state)
    finally:
        abb.banded_admm_chunk = real_chunk
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

    # -- 5. card vs CPU at B=64 -----------------------------------------
    Bs = 64
    fr_s, rf_s = frames[:Bs], refs[:Bs]
    trajs = {}
    for d in ("cuda", "cpu"):
        o = cartpole.build(cartpole.make_config(
            horizon=20, dt=0.04, alpha=0.3, step_num=step_num, formulation="reduced",
            ADMM_settings=dict(MAIN_ADMM)), stagewise=True, device=d)
        s_ = BatchedSolver(o, device=d)
        st_ = s_.init_state(Bs)
        t0 = time.perf_counter()
        out = []
        for _ in range(2):
            tr, _, st_ = s_.solve(fr_s, rf_s, st_)
            out.append(tr.cpu().numpy())
        trajs[d] = out
        log(f"phase 5: 2 ticks at B={Bs} on {d}: {time.perf_counter() - t0:.2f} s")
    gap = max(float(np.abs(a - b).max()) for a, b in zip(trajs["cuda"], trajs["cpu"]))
    log(f"phase 5: max |card - CPU| trajectory gap {gap:.3g} (limit 5e-3)")
    if not gap <= 5e-3:
        raise SystemExit("phase 5: card and CPU ticks disagree")

    # -- 6. kernel timing at the main path's inputs -----------------------
    def run_all(fn):
        for args, kw in captured:
            fn(*args, **kw)

    n_calls = len(captured)
    ms = time_ms(lambda: run_all(bk.banded_admm_chunk), 7, sync) / n_calls
    plain_ms = time_ms(lambda: run_all(bk.banded_admm_chunk_plain), 3, sync) / n_calls
    nbytes = flops = 0
    for args, kw in captured:
        outs = bk.banded_admm_chunk_plain(*args, **kw)
        tensors = [a for a in args if torch.is_tensor(a)]
        tensors += [v for a in args if isinstance(a, dict) for v in a.values()]
        nbytes += sum(t.numel() * t.element_size() for t in tensors)
        nbytes += sum(t.numel() * t.element_size() for t in outs)
        it_inc = outs[8].double()
        flops += float(sum(
            chunk_flops(N, w, r, r2, it, it / kw["check_every"])
            for it in it_inc.tolist()
        ))
    bytes_ms = nbytes / n_calls / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / n_calls / PEAK_F32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"phase 6: banded_admm_chunk at the main path's inputs ({n_calls} launches "
        f"of one tick): {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms * 1e3:.3f} us ({bound_by}; bytes {bytes_ms * 1e3:.3f} us, "
        f"operations {ops_ms * 1e3:.3f} us)")

    kernels = {"kernels": [{
        "name": "banded_admm_chunk",
        "route": "cuda",
        "source": CHUNK_SOURCE,
        "replaces": CHUNK_REPLACES,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
