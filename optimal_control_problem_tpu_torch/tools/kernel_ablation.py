"""Time design choices of the CUDA kernels against the shipped kernels, in
one run on one card.

    python3 -m optimal_control_problem_tpu_torch.tools.kernel_ablation
        [--only cr,shared,dl] [--baseline OLD_admm_device_loop.cu]

Run from the repository root (it takes its inputs from ``chip_smoke.py``).
Each variant is a copy of a shipped source with one piece of text
replaced (a constant, or a function from this file's patch text), compiled
with the shipped flags (``ops/build._FLAGS``) into
``build/kernel_ablation/``:

* ``csrc/banded_cr_chunk.cu`` (the cyclic-reduction chunk): ``kCols``, the
  output columns each thread computes in the assembly and the level's
  block products -- 8 (shipped: half a block row at w = 16), 4, 2 and 1
  (one thread per output element) -- and ``kThreads`` 1024 in place of
  512;
* ``csrc/shared_chunk.cu`` (the shared-operator chunk): ``kWarps`` 16 in
  place of 8, so each SM runs twice the warps at the same scenarios per
  block (one block per SM either way: the panels and slices fill its
  shared memory);
* ``csrc/admm_device_loop.cu`` (the dense device loop): two output rows
  a thread in the row products in place of one (``OUTS2_ROW_PRODUCT``:
  two chains side by side, one float4 of the vector serving both) and
  CUDA's division for ``y / rho`` in place of ``div_rn``; besides, the
  shipped kernel with the next tier forced (tier 2 at n=100, m=196: no
  ``Ab^T`` copy, ``rhs`` and ``y @ Ab`` read columns of ``Ab``) and, with ``--baseline``, an earlier version of the source (for
  example ``git show <rev>:optimal_control_problem_tpu_torch/csrc/
  admm_device_loop.cu``) whose entry point takes the same arguments with
  ``shared`` (1: operators in shared memory, 0: read from global memory)
  in the place of ``tier``: it runs with 1 where the rule's tier is 1, else
  with 0;
* a copy of ``csrc/admm_device_loop.cu`` with ``clock64()`` probes
  (``PHASE_PROBES``): thread 0 of block 0 adds the cycles of each phase of
  the loop -- the prologue, the entry's ``z``, each product and its
  barrier, the check -- into the launch's scratch pointer (unused by tiers
  1 and 2), and thread 0 and thread 128 the cycles of the check's lower
  half (``y @ Ab``, ``x @ Ab^T``) and upper half (``x @ Pb``).

Inputs: the cyclic-reduction chunk on a random quadrotor-shaped stage QP
batch (N=100, w=16, r=12, r2=1; B=64 and B=8) through the batch solver's
prepare, two iterations a launch (the main path's ~2) and the prologue
alone (``interval=0``); the shared chunk on the first chunk of a random
shared QP solve at n=120, m=196 (the double integrator h20's sizes), B=4096
and B=64, 25 iterations a launch; the device loop on the recorded launches
of the first three SQP steps of a cold and of all ten of a steady (fifth)
dense cart-pole h20 tick at B=256 (``chip_smoke.py``'s phase 4d path,
n=100, m=196), and on the first entry of a random dense solve at n=120,
m=236, B=64 (tier 2; tier 3 forced beside it) and at n=200, m=392, B=32
(tier 3), and the steady tick's slowest scenario alone (B=1: one
scenario's latency, also as us per iteration).  The probed copy runs the
first launch of the steady tick at B=1 and B=256 with a forced budget of
100 iterations in tiers 1 and 2.  Every variant is first
held bitwise to the plain version on the same inputs (it fails otherwise);
then the variants are timed with CUDA events, round by round, the order
reversed every other round, and each reports its median ms per launch.
Prints the card's name and power limit first and a JSON record as the last
line.
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

# The device loop's row product with two output rows a thread: rows r and
# r + per (per = rows / 2 rounded up) as two chains side by side, the
# pipelined dot of the shipped source widened to R operands.
_ROW_PRODUCT = """template <class Epi>
__device__ __forceinline__ void row_product(const float* __restrict__ a,
                                            const float* __restrict__ W, int ld, int K, int rows,
                                            Epi epi) {
  for (int r = threadIdx.x; r < rows; r += kThreads) epi(r, dot<kRingS>(a, RowS{W + r * ld}, K));
}
"""
OUTS2_ROW_PRODUCT = """template <int R, int kRing, class W>
__device__ __forceinline__ void chain_r(const float* __restrict__ a, const W (&w)[R], int K,
                                        float (&acc)[R]) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
#pragma unroll
  for (int u = 0; u < R; ++u) acc[u] = 0.0f;
  auto mul4 = [](float4 av, float4 wv) {
    float4 p;
    p.x = av.x * wv.x;
    p.y = av.y * wv.y;
    p.z = av.z * wv.z;
    p.w = av.w * wv.w;
    return p;
  };
  auto add4 = [&](const float4 (&p)[R]) {
#pragma unroll
    for (int u = 0; u < R; ++u) {
      acc[u] = acc[u] + p[u].x;
      acc[u] = acc[u] + p[u].y;
      acc[u] = acc[u] + p[u].z;
      acc[u] = acc[u] + p[u].w;
    }
  };
  const int K4 = K >> 2;
  const int Kr = K4 - K4 % kRing;
  if (Kr > 0) {
    float4 ab[kRing], wb[kRing][R], pr[R];
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
      ab[s] = a4[s];
#pragma unroll
      for (int u = 0; u < R; ++u) wb[s][u] = w[u].quad(s);
    }
#pragma unroll
    for (int u = 0; u < R; ++u) pr[u] = mul4(ab[0], wb[0][u]);
    {
      const int qn = min(kRing, Kr - 1);
      ab[0] = a4[qn];
#pragma unroll
      for (int u = 0; u < R; ++u) wb[0][u] = w[u].quad(qn);
    }
    for (int q = 0; q < Kr; q += kRing) {
#pragma unroll
      for (int s = 0; s < kRing; ++s) {
        const int t = (s + 1) % kRing;
        float4 np[R];
#pragma unroll
        for (int u = 0; u < R; ++u) np[u] = mul4(ab[t], wb[t][u]);
        const int qn = min(q + s + 1 + kRing, Kr - 1);
        ab[t] = a4[qn];
#pragma unroll
        for (int u = 0; u < R; ++u) wb[t][u] = w[u].quad(qn);
        add4(pr);
#pragma unroll
        for (int u = 0; u < R; ++u) pr[u] = np[u];
      }
    }
  }
  for (int q = Kr; q < K4; ++q) {
    float4 p[R];
#pragma unroll
    for (int u = 0; u < R; ++u) p[u] = mul4(a4[q], w[u].quad(q));
    add4(p);
  }
  for (int k = K4 * 4; k < K; ++k) {
#pragma unroll
    for (int u = 0; u < R; ++u) acc[u] = acc[u] + a[k] * w[u].at(k);
  }
}

template <class Epi>
__device__ __forceinline__ void row_product(const float* __restrict__ a,
                                            const float* __restrict__ W, int ld, int K, int rows,
                                            Epi epi) {
  const int per = (rows + 1) / 2;
  for (int r = threadIdx.x; r < per; r += kThreads) {
    RowS w[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) w[u].w = W + min(r + u * per, rows - 1) * ld;
    float acc[2];
    chain_r<2, kRingS>(a, w, K, acc);
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (r + u * per < rows) epi(r + u * per, acc[u]);
  }
}
"""

# (key, source, shipped text, variant text)
VARIANTS = [
    ("cr_cols4", "banded_cr_chunk", "constexpr int kCols = 8;", "constexpr int kCols = 4;"),
    ("cr_cols2", "banded_cr_chunk", "constexpr int kCols = 8;", "constexpr int kCols = 2;"),
    ("cr_cols1", "banded_cr_chunk", "constexpr int kCols = 8;", "constexpr int kCols = 1;"),
    ("cr_threads1024", "banded_cr_chunk", "constexpr int kThreads = 512;",
     "constexpr int kThreads = 1024;"),
    ("sh_warps16", "shared_chunk", "constexpr int kWarps = 8;", "constexpr int kWarps = 16;"),
    ("dl_outs2", "admm_device_loop", _ROW_PRODUCT, OUTS2_ROW_PRODUCT),
    ("dl_plaindiv", "admm_device_loop", "div_rn(yo, rho)", "yo / rho"),
]


# clock64() probes of the device loop: (line of the shipped source, slot)
# -- the slot's cycles since the previous probe are added after that line.
PHASE_NAMES = ["prologue", "entry z", "rhs", "rhs barrier", "xt", "xt barrier", "zt",
               "zt barrier", "check"]
_RHS = "      ab_cols(sw, [&](int j, float acc) { srhs[j] = (sigma * sx[j] - sq[j]) + acc; });\n"
_XT = "        sx[j] = alpha * acc + oma * sx[j];\n      });\n"
_ZT = "        sw[i] = rho * z_n - y_n;\n      });\n"
_SYNC = "      __syncthreads();\n"
PHASE_PROBES = [
    ("  if (kTier != 3) __pipeline_wait_prior(0);\n  __syncthreads();\n", 0),
    ("    sw[i] = srho[i] * zv - sy[i];\n  });\n  __syncthreads();\n", 1),
    (_RHS + _SYNC, 3), (_XT + _SYNC, 5), (_ZT + _SYNC, 7),
    ("    __syncthreads();  // sred, rhs and xt are rewritten next\n", 8),
    (_RHS, 2), (_XT, 4), (_ZT, 6),
]


def phases_source(src):
    """``csrc/admm_device_loop.cu`` with the ``PHASE_PROBES`` and the
    check's two halves timed (slots 16 and 17)."""
    head = "  const int tid = threadIdx.x;\n"
    check0 = "    float mx[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};\n"
    check1 = ("    __syncthreads();\n    for (int j = tid; j < n; j += kThreads) {\n"
              "      const float px")
    for line in [head, check0, check1] + [line for line, _ in PHASE_PROBES]:
        if src.count(line) != 1:
            raise SystemExit(f"phase probes: {line!r} is not in the source exactly once")
    for line, slot in PHASE_PROBES:
        src = src.replace(line, line + f"  PROBE({slot});\n")
    src = src.replace(head, head + (
        "  long long* probe = (blockIdx.x == 0 && threadIdx.x == 0 && kTier != 3)\n"
        "                         ? reinterpret_cast<long long*>(a.vec) : nullptr;\n"
        "  long long t_probe = clock64();\n"
        "#define PROBE(s) do { if (probe) { const long long t2 = clock64(); "
        "probe[s] += t2 - t_probe; t_probe = t2; } } while (0)\n"))
    src = src.replace(check0, check0 + "    const long long t_check = clock64();\n")
    return src.replace(check1, (
        "    if (blockIdx.x == 0 && (tid == 0 || tid == kHalf) && kTier != 3)\n"
        "      reinterpret_cast<long long*>(a.vec)[tid == 0 ? 16 : 17] += clock64() - t_check;\n")
        + check1)


def build_variants(build, out_dir, names, baseline=None):
    """Compile every variant of the kernels ``names`` and the ``baseline``
    source, if any (one nvcc each, all at once): ``{key: path}``."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    extra = [("dl_phases", "admm_device_loop", None, None)] if "admm_device_loop" in names else []
    extra += [("dl_baseline", None, None, None)] if baseline else []
    for key, name, old, new in VARIANTS + extra:
        if name is None:
            with open(baseline) as f:
                text = f.read()
        elif key == "dl_phases":
            text = phases_source(build.SOURCES[name].read_text())
        elif name in names:
            src = build.SOURCES[name].read_text()
            if src.count(old) != 1:
                raise SystemExit(f"{key}: {old!r} is not in {build.SOURCES[name]} exactly once")
            text = src.replace(old, new)
        else:
            continue
        path = os.path.join(out_dir, f"{key}.cu")
        with open(path, "w") as f:
            f.write(text)
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


def dense_tick_launches(cs, cartpole, BatchedSolver, tadmm, B=256, steady_ticks=3):
    """The device loop's launches ``(args, kw)`` of a cold dense cart-pole
    h20 tick at B and of the tick after ``steady_ticks`` more (the path of
    ``chip_smoke.py`` phase 4d)."""
    import numpy as np

    cfg = cartpole.make_config(horizon=20, dt=0.02, alpha=0.3, step_num=10,
                               formulation="reduced",
                               ADMM_settings={**cs.DENSE_ADMM, "backend": "pallas"})
    solver = BatchedSolver(cartpole.build(cfg, stagewise=False, device="cuda"))
    frames = np.zeros((B, cartpole.FRAME), np.float32)
    frames[:, 2] = np.random.default_rng(0).uniform(-0.5, 0.5, B).astype(np.float32)
    refs = np.full((B, 1), np.pi, np.float32)
    real = tadmm.admm_device_loop

    def recorded(state):
        calls = []
        tadmm.admm_device_loop = lambda *a, **k: calls.append((a, k)) or real(*a, **k)
        try:
            _, _, state = solver.solve(frames, refs, state)
        finally:
            tadmm.admm_device_loop = real
        return calls, state

    cold, state = recorded(solver.init_state(B))
    for _ in range(steady_ticks):
        _, _, state = solver.solve(frames, refs, state)
    steady, _ = recorded(state)
    return cold, steady


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="cr,shared,dl",
                    help="comma list of kernels to ablate: cr, shared, dl")
    ap.add_argument("--baseline", default=None,
                    help="an earlier csrc/admm_device_loop.cu to time beside the shipped one")
    opts = ap.parse_args(argv)
    only = set(opts.only.split(","))
    if not torch.cuda.is_available():
        print("kernel_ablation: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from optimal_control_problem_tpu_torch.models import cartpole
    from optimal_control_problem_tpu_torch.ops import admm_kernel as ak
    from optimal_control_problem_tpu_torch.ops import banded_cr_kernel as bck
    from optimal_control_problem_tpu_torch.ops import banded_kernel as bk
    from optimal_control_problem_tpu_torch.ops import build
    from optimal_control_problem_tpu_torch.ops import shared_kernel as sk
    from optimal_control_problem_tpu_torch.parallel import BatchedSolver
    from optimal_control_problem_tpu_torch.solvers import admm as tadmm
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
    names = [n for key, n in (("cr", "banded_cr_chunk"), ("shared", "shared_chunk"),
                              ("dl", "admm_device_loop")) if key in only]
    t0 = time.perf_counter()
    build.build(names)
    paths = build_variants(build, str(build.BUILD_DIR.parent / "kernel_ablation"), names,
                           opts.baseline if "dl" in only else None)
    print(f"built the shipped kernels and {len(paths)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    libs = {key: ctypes.CDLL(p) for key, p in paths.items()}
    shipped = {name: build.load_library(name) for name in names}

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

    def ablate(name, label, keys, kernel, plain, lib_of=lambda key: key):
        """Bitwise check of each variant, then the interleaved timing;
        ``kernel(key)`` runs the variant ``key`` on library ``lib_of(key)``."""
        ref = plain()
        sync()
        for key in keys:
            use(name, lib_of(key))
            out = kernel(key)
            sync()
            if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                raise SystemExit(f"{label}: {key} disagrees with the plain version")
        times = {key: [] for key in keys}
        for rnd in range(ROUNDS):
            for key in keys if rnd % 2 == 0 else keys[::-1]:
                use(name, lib_of(key))
                times[key].append(event_ms(lambda: kernel(key)))
        use(name, "shipped")
        res = {key: statistics.median(v) for key, v in times.items()}
        print(f"{label}: bitwise equal to the plain version; ms/launch (median of {ROUNDS} "
              f"rounds of {REPS}): " + ", ".join(f"{k} {v:.4f}" for k, v in res.items()),
              flush=True)
        return res

    record = {"card": card, "cr": {}, "shared": {}, "dl": {}}
    if "cr" in only:
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
                    cr_keys, lambda key: bck.banded_admm_chunk_cr(*args, **kw_),
                    lambda: bck.banded_admm_chunk_cr_plain(*args, **kw_))

    if "shared" in only:
        st_s = ADMMSettings(**cs.DI_ADMM, backend="pallas")
        for B in (4096, 64):
            P, A, q, lo, hi = (torch.as_tensor(a, device=dev)
                               for a in cs.random_shared_qp(0, B, 120, 196))
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
                    "shared_chunk", f"shared_admm_chunk, n=120, m=196, B={B}, {rows} scenarios "
                    "a block, 25 iterations", ["shipped", "sh_warps16"],
                    lambda key: sk.shared_admm_chunk(*a, **k, rows_per_block=rows),
                    lambda: sk.shared_admm_chunk_plain(*a, **k))

    if "dl" in only:
        # Keys: the shipped kernel in the rule's tier and with another tier
        # forced, the source variants, the baseline.
        dl_keys = ["shipped", "dl_tier2"] + [k for k, n, _, _ in VARIANTS
                                             if n == "admm_device_loop"]
        dl_keys += ["dl_baseline"] if "dl_baseline" in libs else []

        def baseline(a, k, tier):
            """The earlier source's launch: ``shared`` 1 where the rule's
            ``tier`` is 1, else 0 (operators read from global memory,
            vectors in a slab of 5 n + 7 m floats a scenario).  The rule is
            asked before: the earlier library has no layout query."""
            B, n, m = a[14].shape[0], a[14].shape[1], a[15].shape[1]
            if tier == 1:
                return ak._launch(*a, k["max_iter"], k["check_every"], 1)
            outs = (torch.empty((B, n), device=dev), torch.empty((B, m), device=dev),
                    torch.empty((B, m), device=dev),
                    torch.empty((B,), dtype=torch.int32, device=dev))
            slab = torch.empty((B * (5 * n + 7 * m),), device=dev)
            bk.launch_chunk("admm_device_loop", "admm_device_loop", "ocp_admm_device_loop_f32",
                            [*a[:10], a[14], a[15], *outs, slab],
                            (B, n, m, k["max_iter"], k["check_every"], 0), a[10:14], dev)
            return outs

        def dl_cases():
            cold, steady = dense_tick_launches(cs, cartpole, BatchedSolver, tadmm)
            yield "cart-pole h20 dense B=256, cold tick, first 3 SQP steps", cold[:3], None
            yield "cart-pole h20 dense B=256, steady tick", steady, None
            P, q, A, lo, hi = (torch.as_tensor(a, device=dev)
                               for a in cs.random_dense_qp(2, 64, 120, 236))
            st_d = ADMMSettings(method="condensed", eps_abs=1e-3, eps_rel=1e-3, max_iter=500,
                                adaptive_rho=False, backend="pallas")
            calls = []
            real = tadmm.admm_device_loop
            tadmm.admm_device_loop = lambda *a, **k: calls.append((a, k)) or real(*a, **k)
            try:
                tadmm.admm_solve_batch(P, q, A, lo, hi, st_d)
            finally:
                tadmm.admm_device_loop = real
            yield "random dense QPs n=120, m=236, B=64, first entry", calls[:1], None
            P, q, A, lo, hi = (torch.as_tensor(a, device=dev)
                               for a in cs.random_dense_qp(2, 32, 200, 392))
            calls = []
            tadmm.admm_device_loop = lambda *a, **k: calls.append((a, k)) or real(*a, **k)
            try:
                tadmm.admm_solve_batch(P, q, A, lo, hi, st_d)
            finally:
                tadmm.admm_device_loop = real
            yield "random dense QPs n=200, m=392, B=32, first entry", calls[:1], None
            # The steady tick's slowest scenario alone.
            its = [int(ak.admm_device_loop(*a, **k)[3].max()) for a, k in steady]
            a, k = steady[max(range(len(its)), key=its.__getitem__)]
            b = int(ak.admm_device_loop(*a, **k)[3].argmax())
            one = tuple(t[b:b + 1] if torch.is_tensor(t) else t for t in a)
            yield ("the steady tick's slowest scenario alone, B=1", [(one, k)], max(its))

        for label, calls, iters in dl_cases():
            n, m = calls[0][0][0].shape[1], calls[0][0][1].shape[1]
            # Forced beside the rule's tier: the next one (none past 3).
            rule = ak.kernel_tier(n, m)
            forced = {1: "dl_tier2", 2: "dl_tier3", 3: None}[rule]
            keys = [forced if k == "dl_tier2" else k for k in dl_keys]
            keys = [k for k in keys if k is not None]

            def run(key, calls=calls, rule=rule):
                if key == "dl_baseline":
                    return [o for a, k in calls for o in baseline(a, k, rule)]
                tier = {"dl_tier2": 2, "dl_tier3": 3}.get(key)
                return [o for a, k in calls
                        for o in ak._launch(*a, k["max_iter"], k["check_every"], tier)]

            res = ablate("admm_device_loop", f"admm_device_loop, {label} ({len(calls)} "
                         "launches)", keys, run,
                         lambda: [o for a, k in calls
                                  for o in ak.admm_device_loop_plain(*a, **k)],
                         lambda key: "shipped" if key in ("dl_tier2", "dl_tier3") else key)
            record["dl"][label] = {k: v / len(calls) for k, v in res.items()}
            print("  per launch: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                               record["dl"][label].items()), flush=True)
            if iters:
                # One scenario: us per iteration, checks included in the time.
                record["dl"][label]["iterations"] = iters
                print(f"  us per iteration ({iters} iterations): " + ", ".join(
                    f"{k} {v * 1e3 / iters:.4f}" for k, v in res.items()), flush=True)
            if label.endswith("steady tick"):
                steady_call = calls[0]

        # Where an iteration's cycles go: the probed copy on the steady
        # tick's first launch, a forced budget of 100 (check_every 25).
        a, k = steady_call
        a = a[:12] + (0.0, 0.0) + a[14:]
        use("admm_device_loop", "dl_phases")
        record["dl"]["phases"] = {}
        for tier in (1, 2):
            for B in (1, a[0].shape[0]):
                ab = tuple(t[:B] if torch.is_tensor(t) else t for t in a)
                n, m = ab[0].shape[1], ab[1].shape[1]
                outs = [torch.empty((B, n), device=dev), torch.empty((B, m), device=dev),
                        torch.empty((B, m), device=dev),
                        torch.empty((B,), dtype=torch.int32, device=dev)]
                probe = torch.zeros(32, dtype=torch.int64, device=dev)
                bk.launch_chunk("admm_device_loop", "admm_device_loop",
                                "ocp_admm_device_loop_f32",
                                [*ab[:10], ab[14], ab[15], *outs, probe],
                                (B, n, m, 100, 25, tier), ab[10:14], dev)
                sync()
                cyc = probe.tolist()
                per_it = {nm: c / 100 for nm, c in zip(PHASE_NAMES, cyc)}
                per_it["check lower half (a check)"] = cyc[16] / 4
                per_it["check upper half (a check)"] = cyc[17] / 4
                record["dl"]["phases"][f"tier{tier} B{B}"] = per_it
                print(f"admm_device_loop phases, tier {tier}, B={B}, 100 iterations (block 0, "
                      "cycles per iteration; prologue and entry z once, over 100): "
                      + ", ".join(f"{nm} {v:.1f}" for nm, v in per_it.items()), flush=True)
        use("admm_device_loop", "shipped")
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
