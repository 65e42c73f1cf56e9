"""Time two design choices of the CUDA kernels against the shipped kernels,
in one run on one card.

    python3 -m optimal_control_problem_tpu_torch.tools.kernel_ablation

Run from the repository root (it takes its inputs from ``chip_smoke.py``).
Each variant is a copy of a shipped source with one constant changed,
compiled with the shipped flags (``ops/build._FLAGS``) into
``build/kernel_ablation/``:

* ``csrc/banded_cr_chunk.cu`` (the cyclic-reduction chunk): ``kCols``, the
  output columns each thread computes in the assembly and the level's
  block products -- 8 (shipped: half a block row at w = 16), 4, 2 and 1
  (one thread per output element) -- and ``kThreads`` 1024 in place of
  512;
* ``csrc/shared_chunk.cu`` (the shared-operator chunk): ``kWarps`` 16 in
  place of 8, so each SM runs twice the warps at the same scenarios per
  block (one block per SM either way: the panels and slices fill its
  shared memory).

Inputs: the cyclic-reduction chunk on a random quadrotor-shaped stage QP
batch (N=100, w=16, r=12, r2=1; B=64 and B=8) through the batch solver's
prepare, two iterations a launch (the main path's ~2) and the prologue
alone (``interval=0``); the shared chunk on the first chunk of a random
shared QP solve at n=120, m=196 (the double integrator h20's sizes), B=4096
and B=64, 25 iterations a launch.  Every variant is first held bitwise to
the plain version on the same inputs (it fails otherwise); then the
variants are timed with CUDA events, round by round, the order reversed
every other round, and each reports its median ms per launch.  Prints the
card's name and power limit first and a JSON record as the last line.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

ROUNDS = 5
REPS = 20

# (key, source, shipped line, variant line)
VARIANTS = [
    ("cr_cols4", "banded_cr_chunk", "constexpr int kCols = 8;", "constexpr int kCols = 4;"),
    ("cr_cols2", "banded_cr_chunk", "constexpr int kCols = 8;", "constexpr int kCols = 2;"),
    ("cr_cols1", "banded_cr_chunk", "constexpr int kCols = 8;", "constexpr int kCols = 1;"),
    ("cr_threads1024", "banded_cr_chunk", "constexpr int kThreads = 512;",
     "constexpr int kThreads = 1024;"),
    ("sh_warps16", "shared_chunk", "constexpr int kWarps = 8;", "constexpr int kWarps = 16;"),
]


def build_variants(build, out_dir):
    """Compile every variant (one nvcc each, all at once): ``{key: path}``."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for key, name, old, new in VARIANTS:
        src = build.SOURCES[name].read_text()
        if src.count(old) != 1:
            raise SystemExit(f"{key}: {old!r} is not in {build.SOURCES[name]} exactly once")
        path = os.path.join(out_dir, f"{key}.cu")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
        lib = os.path.join(out_dir, f"lib{key}.so")
        procs[key] = (subprocess.Popen([build._nvcc(), *build._FLAGS, "-o", lib, path],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{key}: nvcc exit {proc.returncode}\n{log[-4000:]}")
        libs[key] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_ablation: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from optimal_control_problem_tpu_torch.ops import banded_cr_kernel as bck
    from optimal_control_problem_tpu_torch.ops import banded_kernel as bk
    from optimal_control_problem_tpu_torch.ops import build
    from optimal_control_problem_tpu_torch.ops import shared_kernel as sk
    from optimal_control_problem_tpu_torch.solvers import admm_banded_batch as abb
    from optimal_control_problem_tpu_torch.solvers import admm_batched as tab
    from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings
    from optimal_control_problem_tpu_torch.solvers.admm_banded import BandedQP

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    build.build(["banded_cr_chunk", "shared_chunk"])
    paths = build_variants(build, str(build.BUILD_DIR.parent / "kernel_ablation"))
    print(f"built the shipped kernels and {len(paths)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    libs = {key: ctypes.CDLL(p) for key, p in paths.items()}
    shipped = {name: build.load_library(name) for name in ("banded_cr_chunk", "shared_chunk")}

    def use(name, key):
        build._LIBS[name] = shipped[name] if key == "shipped" else libs[key]
        bk._LIB_FNS.clear()

    def event_ms(fn):
        fn()
        sync()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(REPS):
            fn()
        e1.record()
        sync()
        return e0.elapsed_time(e1) / REPS

    def ablate(name, label, keys, kernel, plain):
        """Bitwise check of each variant, then the interleaved timing."""
        ref = plain()
        sync()
        for key in keys:
            use(name, key)
            out = kernel()
            sync()
            if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                raise SystemExit(f"{label}: {key} disagrees with the plain version")
        times = {key: [] for key in keys}
        for rnd in range(ROUNDS):
            for key in keys if rnd % 2 == 0 else keys[::-1]:
                use(name, key)
                times[key].append(event_ms(kernel))
        use(name, "shipped")
        res = {key: statistics.median(v) for key, v in times.items()}
        print(f"{label}: bitwise equal to the plain version; ms/launch (median of {ROUNDS} "
              f"rounds of {REPS}): " + ", ".join(f"{k} {v:.4f}" for k, v in res.items()),
              flush=True)
        return res

    record = {"card": card, "cr": {}, "shared": {}}
    cr_keys = ["shipped"] + [k for k, n, _, _ in VARIANTS if n == "banded_cr_chunk"]
    st = ADMMSettings(method="banded", eps_abs=0.0, eps_rel=0.0, max_iter=2,
                      adaptive_rho=False, check_infeasibility=False, check_every=2)
    for B in (64, 8):
        fields, x0, y0 = cs.random_stage_qp_batch(0, B, 100, 16, 12, 1)
        qp = BandedQP(*(torch.as_tensor(a, device=dev) for a in fields))
        prob = abb.prepare_banded_batch_T(qp, st, torch.as_tensor(x0, device=dev),
                                          torch.as_tensor(y0, device=dev))
        z = torch.zeros(B, dtype=torch.int32, device=dev)
        args, kw = abb.chunk_inputs(prob, st, z, z, prob.x, prob.y, prob.z, prob.rho)
        for what, kw_ in (("2 iterations", kw), ("prologue", {**kw, "interval": 0})):
            record["cr"][f"B{B} {what}"] = ablate(
                "banded_cr_chunk", f"banded_admm_chunk_cr, quadrotor shapes, B={B}, {what}",
                cr_keys, lambda: bck.banded_admm_chunk_cr(*args, **kw_),
                lambda: bck.banded_admm_chunk_cr_plain(*args, **kw_))

    st_s = ADMMSettings(**cs.DI_ADMM, backend="pallas")
    for B in (4096, 64):
        P, A, q, lo, hi = (torch.as_tensor(a, device=dev) for a in cs.random_shared_qp(0, B, 120, 196))
        fac = tab.prepare_shared(P, A, lo, hi, q, st_s)
        calls = []
        real = tab.shared_admm_chunk
        tab.shared_admm_chunk = lambda *a, **k: calls.append((a, k)) or real(*a, **k)
        try:
            tab.admm_iterate_prepared(fac, q, lo, hi, st_s)
        finally:
            tab.shared_admm_chunk = real
        a, k = calls[0]
        a = (a[0], 25) + a[2:]
        k = {**k, "eps_abs": 0.0, "eps_rel": 0.0}
        for rows in (32, 16):
            record["shared"][f"B{B} rows{rows}"] = ablate(
                "shared_chunk", f"shared_admm_chunk, n=120, m=196, B={B}, {rows} scenarios a "
                "block, 25 iterations", ["shipped", "sh_warps16"],
                lambda: sk.shared_admm_chunk(*a, **k, rows_per_block=rows),
                lambda: sk.shared_admm_chunk_plain(*a, **k))
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
