"""Time design choices of the CUDA kernels against the shipped kernels, in
one run on one card.

    python3 -m optimal_control_problem_tpu_torch.tools.kernel_ablation
        [--only cr,shared,dl,tc] [--baseline OLD_admm_device_loop.cu]
        [--tc-baseline OLD_shared_chunk.cu]

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
* ``csrc/shared_chunk_tc.cu`` (the shared-operator chunk's tensor-core
  form, ``iter_precision`` "high" and "mixed"): a ring of 4, 3 and 2
  slots in place of 5 (``kRingStages``; the shipped kernel takes fewer
  where 5 do not fit) and 16 epilogue elements loaded at once in place of
  8 (``kEpiChunk``).  No cluster multicast is shipped, so the shipped
  kernel is the cluster-of-1 variant.  With ``--tc-baseline``,
  the tensor-core form of an earlier ``csrc/shared_chunk.cu`` (for example
  ``git show <rev>:optimal_control_problem_tpu_torch/csrc/shared_chunk.cu``
  of the parent of the commit that added ``shared_chunk_tc.cu``), whose
  entry point takes the operators as ``mma.sync`` B fragments
  (``old_mma_fragments``);
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
and B=64, 25 iterations a launch (its tensor-core form likewise, at "high"
and "mixed"); the device loop on the recorded launches
of the first three SQP steps of a cold and of all ten of a steady (fifth)
dense cart-pole h20 tick at B=256 (``chip_smoke.py``'s phase 4d path,
n=100, m=196), and on the first entry of a random dense solve at n=120,
m=236, B=64 (tier 2; tier 3 forced beside it) and at n=200, m=392, B=32
(tier 3), and the steady tick's slowest scenario alone (B=1: one
scenario's latency, also as us per iteration).  The probed copy runs the
first launch of the steady tick at B=1 and B=256 with a forced budget of
100 iterations in tiers 1 and 2.  Every variant is first
held bitwise to the plain version on the same inputs (it fails otherwise;
the tensor-core form's to ``chip_smoke.py`` phase 3's rule: each of x, z,
y within three times the plain version's own gap to its products summed
in float64, iteration counts and verdicts equal);
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
    ("tc_chunk16", "shared_chunk_tc", "constexpr int kEpiChunk = 8;",
     "constexpr int kEpiChunk = 16;"),
    ("tc_stages4", "shared_chunk_tc", "constexpr int kRingStages = 5;",
     "constexpr int kRingStages = 4;"),
    ("tc_stages3", "shared_chunk_tc", "constexpr int kRingStages = 5;",
     "constexpr int kRingStages = 3;"),
    ("tc_stages2", "shared_chunk_tc", "constexpr int kRingStages = 5;",
     "constexpr int kRingStages = 2;"),
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


# clock64() probes of the tensor-core form (thread 0 of block 0, which also
# issues the ring's bulk copies): (text, slot, before) -- the slot's cycles
# since the previous probe are added before or after the text.
TC_PHASE_NAMES = ["prologue", "full waits", "products (issue, wait<1>, release, refill)",
                  "last slice's wait<0>", "barrier before the epilogue", "epilogues and splits",
                  "barrier after the epilogue", "zt FP32 chain (mixed)", "check"]
TC_PHASE_PROBES = [
    ("      mbar_wait(ring.full(st), (g / ring.stages) & 1);\n"
     "      const uint32_t slot = ring.base + st * ring.stage_bytes;\n", 2, True),
    ("      mbar_wait(ring.full(st), (g / ring.stages) & 1);\n"
     "      const uint32_t slot = ring.base + st * ring.stage_bytes;\n", 1, False),
    ("    wgmma_wait<0>();\n", 2, True),
    ("    const bool last = p == P - 1;\n", 3, True),
    ("    if (last) consumer_sync();  // nobody reads the split panel any more\n", 4, False),
    ("  fence_proxy_async();\n  consumer_sync();\n", 5, True),
    ("  fence_proxy_async();\n  consumer_sync();\n", 6, False),
    ("        fence_proxy_async();\n        consumer_sync();\n", 7, False),
    ("    residual_check<TR>(a, d, chk, g, n, m, sx, sz, sy, srhs, fstage, ks, ci, grow, s_conv, s_rp,\n"
     "                       s_rd, s_rpr, s_rdr);\n", 8, False),
    ("  fence_proxy_async();\n  __syncthreads();\n", 0, False),
]


def tc_phases_source(src):
    """``csrc/shared_chunk_tc.cu`` with the ``TC_PHASE_PROBES``: cycles
    into a ``__device__`` array that ``ocp_tc_probe(out, reset)`` reads."""
    start = "  const int tid = threadIdx.x;\n  const int lane = tid & 31;\n  const int warp = tid >> 5;\n"
    inc = '#include "shared_chunk_common.cuh"\n'
    for text in [start, inc] + [t for t, _, _ in TC_PHASE_PROBES]:
        if src.count(text) != 1:
            raise SystemExit(f"tc phase probes: {text!r} is not in the source exactly once")
    src = src.replace(inc, inc + (
        "__device__ long long g_probe[16];\n"
        "#define PROBE(s) do { if (blockIdx.x == 0 && threadIdx.x == 0) { "
        "const long long t2_ = clock64(); g_probe[s] += t2_ - g_probe[15]; g_probe[15] = t2_; } "
        "} while (0)\n"))
    for text, slot, before in TC_PHASE_PROBES:
        probe = f"  PROBE({slot});\n"
        src = src.replace(text, probe + text if before else text + probe)
    src = src.replace(start, start + "  if (blockIdx.x == 0 && threadIdx.x == 0) g_probe[15] = clock64();\n")
    return src + (
        '\nextern "C" int ocp_tc_probe(long long* out, int reset) {\n'
        "  cudaDeviceSynchronize();\n"
        "  cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));\n"
        "  if (reset) {\n    long long z[16] = {};\n"
        "    cudaMemcpyToSymbol(g_probe, z, sizeof(z));\n  }\n"
        "  return static_cast<int>(cudaGetLastError());\n}\n")


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


def old_mma_fragments(w):
    """``w (K, J)`` as the tensor-core form before ``csrc/shared_chunk_tc.cu``
    read it: split into bf16 hi / lo, padded to K a multiple of 16 and J of
    8, in the B-fragment order of ``mma.sync`` m16n8k16 (int32 words
    ``(J / 8, K / 16, 32 lanes, 4)``: hi's two registers, then lo's)."""
    import torch

    K, J = w.shape
    Kp, Jp = -(-K // 16) * 16, -(-J // 8) * 8
    wp = torch.zeros((Kp, Jp), dtype=torch.float32, device=w.device)
    wp[:K, :J] = w
    hi = wp.to(torch.bfloat16)
    lo = (wp - hi.to(torch.float32)).to(torch.bfloat16)
    parts = torch.stack([hi, lo]).reshape(2, Kp // 16, 2, 4, 2, Jp // 8, 8)
    frag = parts.permute(5, 1, 6, 3, 0, 2, 4).contiguous()
    return frag.view(torch.int32).reshape(Jp // 8, Kp // 16, 32, 4)


def build_variants(build, out_dir, names, baseline=None, tc_baseline=None):
    """Compile every variant of the kernels ``names`` and the ``baseline``
    and ``tc_baseline`` sources, if any (one nvcc each, all at once):
    ``{key: path}``."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    extra = [("dl_phases", "admm_device_loop", None, None)] if "admm_device_loop" in names else []
    extra += [("dl_baseline", None, None, None)] if baseline else []
    extra += [("tc_baseline", None, None, None)] if tc_baseline else []
    extra += [("tc_phases", "shared_chunk_tc", None, None)] if "shared_chunk_tc" in names else []
    texts = {}  # every text first, so that a patch that fails starts no compiler
    for key, name, old, new in VARIANTS + extra:
        if name is None:
            with open(baseline if key == "dl_baseline" else tc_baseline) as f:
                text = f.read()
        elif key == "dl_phases":
            text = phases_source(build.SOURCES[name].read_text())
        elif key == "tc_phases":
            text = tc_phases_source(build.SOURCES[name].read_text())
        elif name in names:
            src = build.SOURCES[name].read_text()
            if src.count(old) != 1:
                raise SystemExit(f"{key}: {old!r} is not in {build.SOURCES[name]} exactly once")
            text = src.replace(old, new)
        else:
            continue
        texts[key] = text
    inc = ["-I", str(build.SOURCES["shared_chunk"].parent)]  # csrc/*.cuh
    for key, text in texts.items():
        path = os.path.join(out_dir, f"{key}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{key}.so")
        procs[key] = (subprocess.Popen([build._nvcc(), *build._FLAGS, *inc, "-o", lib, path],
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
    ap.add_argument("--only", default="cr,shared,dl,tc",
                    help="comma list of kernels to ablate: cr, shared, dl, tc")
    ap.add_argument("--baseline", default=None,
                    help="an earlier csrc/admm_device_loop.cu to time beside the shipped one")
    ap.add_argument("--tc-baseline", default=None,
                    help="an earlier csrc/shared_chunk.cu whose tensor-core form to time beside "
                         "csrc/shared_chunk_tc.cu")
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
                              ("dl", "admm_device_loop"), ("tc", "shared_chunk_tc"))
             if key in only]
    t0 = time.perf_counter()
    build.build(names)
    paths = build_variants(build, str(build.BUILD_DIR.parent / "kernel_ablation"), names,
                           opts.baseline if "dl" in only else None,
                           opts.tc_baseline if "tc" in only else None)
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

    def ablate(name, label, keys, kernel, plain, lib_of=lambda key: key, agree=None):
        """Bitwise check of each variant (or ``agree(out, ref)``), then the
        interleaved timing; ``kernel(key)`` runs the variant ``key`` on
        library ``lib_of(key)``."""
        ref = plain()
        sync()
        bad = []
        for key in keys:
            use(name, lib_of(key))
            out = kernel(key)
            sync()
            ok = (agree(out, ref) if agree is not None
                  else all(torch.equal(a, b) for a, b in zip(out, ref)))
            if not ok:
                print(f"{label}: {key} disagrees with the plain version", flush=True)
                bad.append(key)
        if bad:
            use(name, "shipped")
            raise SystemExit(f"{label}: {', '.join(bad)} disagree with the plain version")
        times = {key: [] for key in keys}
        for rnd in range(ROUNDS):
            for key in keys if rnd % 2 == 0 else keys[::-1]:
                use(name, lib_of(key))
                times[key].append(event_ms(lambda: kernel(key)))
        use(name, "shipped")
        res = {key: statistics.median(v) for key, v in times.items()}
        print(f"{label}: {'within the tolerance of' if agree else 'bitwise equal to'} the "
              f"plain version; ms/launch (median of {ROUNDS} "
              f"rounds of {REPS}): " + ", ".join(f"{k} {v:.4f}" for k, v in res.items()),
              flush=True)
        return res

    record = {"card": card, "cr": {}, "shared": {}, "dl": {}, "tc": {}}
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

    if "tc" in only:
        tc_keys = ["shipped"] + [k for k, n, _, _ in VARIANTS if n == "shared_chunk_tc"]
        probe_fn = libs["tc_phases"].ocp_tc_probe
        probe_fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        probe_fn.restype = ctypes.c_int
        tc_keys += ["tc_baseline"] if "tc_baseline" in libs else []
        st_s = ADMMSettings(**cs.DI_ADMM, backend="pallas")

        def split_f64(a, w_split):
            a_hi, a_lo = sk.split_bf16(a)
            d64 = [t.double() for t in (a_hi, a_lo, *w_split)]
            return (d64[0] @ d64[2] + d64[0] @ d64[3] + d64[1] @ d64[2]).float()

        def rel_gap(a, b):
            fin = torch.isfinite(b)
            if not torch.equal(torch.isfinite(a), fin):
                return float("inf")
            return float((a[fin] - b[fin]).abs().max() / b[fin].abs().max().clamp(min=1e-30))

        def tc_agree(a, k):
            """``chip_smoke.py`` phase 3's rule for a forced budget."""
            real = sk.matmul_split
            sk.matmul_split = split_f64
            try:
                ref64 = sk.shared_admm_chunk_plain(*a, **k)
            finally:
                sk.matmul_split = real

            def agree(out, ref):
                lims = [max(3 * rel_gap(r, d), 1e-5) for r, d in zip(ref[:3], ref64[:3])]
                gaps = [rel_gap(o, r) for o, r in zip(out[:3], ref[:3])]
                print("  max |kernel - plain| / max |plain| x, z, y: " + ", ".join(
                    f"{g:.3g} (limit {lim:.3g})" for g, lim in zip(gaps, lims)), flush=True)
                return (all(g <= lim for g, lim in zip(gaps, lims))
                        and torch.equal(out[3], ref[3]) and torch.equal(out[4], ref[4]))
            return agree

        def old_tc(a, k, rows):
            """The earlier source's tensor-core form on the same inputs."""
            B_, n_, m_, bound_, done_, cinv_ = sk._contract(*a, k["check_every"],
                                                             k["batch_tile"])
            OP_, Ab_ = a[2], a[3]
            AbT_ = Ab_.T.contiguous()
            outs = sk._outputs(B_, n_, m_, dev)
            f_ab, f_op = old_mma_fragments(Ab_), old_mma_fragments(OP_)
            f_abt = old_mma_fragments(AbT_) if k["iter_precision"] == "high" else f_op
            n_checks = max(1, -(-bound_ // k["check_every"]))
            votes = torch.zeros((B_ // k["batch_tile"], n_checks), dtype=torch.int32, device=dev)
            bk.launch_chunk("shared_admm_chunk", "shared_chunk_tc", "ocp_shared_admm_chunk_tc_f32",
                            [done_, OP_, Ab_, AbT_, *a[4:11], cinv_, *a[12:], *outs, votes,
                             f_ab, f_op, f_abt],
                            (B_, n_, m_, k["batch_tile"], rows, bound_, k["check_every"], n_checks,
                             sk.ITER_PRECISIONS.index(k["iter_precision"])),
                            (k["sigma"], k["alpha"], k["eps_abs"], k["eps_rel"]), dev)
            return outs[:3] + (outs[3].bool(),) + outs[4:]

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
            rows = sk.shared_block_rows(B, k["batch_tile"], 120, 196,
                                        torch.cuda.get_device_properties(dev).multi_processor_count,
                                        tensor_cores=True)
            for mode in ("high", "mixed"):
                k_m = {**k, "eps_abs": 0.0, "eps_rel": 0.0, "iter_precision": mode}

                def run(key, a=a, k_m=k_m, rows=rows):
                    if key == "tc_baseline":
                        return old_tc(a, k_m, rows)
                    return sk.shared_admm_chunk(*a, **k_m)

                record["tc"][f"B{B} {mode}"] = ablate(
                    "shared_chunk_tc", f"shared_admm_chunk tensor-core form ({mode}), n=120, m=196, "
                    f"B={B}, {rows} scenarios a block, 25 iterations", tc_keys, run,
                    lambda a=a, k_m=k_m: sk.shared_admm_chunk_plain(*a, **k_m),
                    agree=tc_agree(a, k_m))
                # Where a launch's cycles go: the probed copy, block 0's
                # thread 0, one warm launch (the first one read is reset).
                use("shared_chunk_tc", "tc_phases")
                out = (ctypes.c_longlong * 16)()
                run("shipped")
                probe_fn(out, 1)
                run("shipped")
                probe_fn(out, 1)
                use("shared_chunk_tc", "shipped")
                cyc = {nm: out[i] for i, nm in enumerate(TC_PHASE_NAMES)}
                total = sum(cyc.values())
                record["tc"][f"B{B} {mode} phases"] = cyc
                print(f"shared_admm_chunk tensor-core form ({mode}) phases, B={B}, one launch of 25 "
                      f"iterations (block 0, thread 0; cycles, share): " + ", ".join(
                          f"{nm} {c} ({c / max(total, 1):.3f})" for nm, c in cyc.items()),
                      flush=True)

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
