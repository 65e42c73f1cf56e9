"""The port's five CUDA kernels run on the CPU through a thread emulation of
CUDA, each held bitwise to its plain PyTorch version (B3's tensor-core form
at a tolerance: see its test).

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
* ``__syncthreads()`` releases when every thread of the block that has
  not exited waits at it, ``__syncwarp()`` likewise over the warp;
  ``__syncthreads_or/and``, ``__any_sync`` and the shuffles go through
  exchange arrays between two barriers;
* ``mma_bf16_16816`` (the one device function that issues ``mma.sync``
  m16n8k16 bf16) is a warp-collective stand-in: each lane hands its A, B
  and C fragment registers to an exchange array, every lane rebuilds the
  warp's 16x16 A, 16x8 B and C from them by the PTX fragment layout and
  computes its own D elements (the exact dot product of the bf16 values,
  plus C, rounded once to float32), so a fragment-layout error in the
  kernel shows here;
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
"""

from __future__ import annotations

import ctypes
import os
import pickle
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from optimal_control_problem_tpu_torch.ops import admm_kernel as ak
from optimal_control_problem_tpu_torch.ops import banded_cr_kernel as bck
from optimal_control_problem_tpu_torch.ops import banded_kernel as bk
from optimal_control_problem_tpu_torch.ops import banded_rolled_kernel as brk
from optimal_control_problem_tpu_torch.ops import build
from optimal_control_problem_tpu_torch.ops import shared_kernel as sk

EMU_HEADER = r"""
// CUDA runtime stand-in: one fiber per CUDA thread, blocks in turn.
#pragma once
#include <atomic>
#include <cmath>
#include <math.h>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <ucontext.h>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __noinline__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 {
  unsigned x, y, z;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
typedef int cudaError_t;
typedef struct CUstream_st* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr {
  cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97
};

namespace emu {
constexpr long kSmemOptin = 232448;
constexpr long kSmemPerSM = 233472;
constexpr size_t kStack = 256 * 1024;  // bytes of stack per CUDA thread
enum { kRun, kAtBlock, kAtWarp, kDone };
struct Fiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  int state = kRun;
};
// One thread block: its CUDA threads as fibers (user-level threads) that a
// scheduler on the calling OS thread runs in turn, each until it reaches a
// barrier or exits.  A barrier releases once every thread of the block (of
// the warp) that has not exited waits at it.
struct Block {
  int nt = 0, live = 0, at_block = 0;
  std::vector<Fiber> f;
  std::vector<int> warp_live, at_warp;
  std::vector<int> xi;            // per-thread exchange slots (votes)
  std::vector<std::uint32_t> xw;  // per-thread exchange slots (shuffles)
  std::vector<std::uint32_t> xm;  // per-thread exchange slots (mma fragments, 10 words)
  std::vector<unsigned char> dyn;
  std::function<void()> body;
  ucontext_t sched;
};
inline Block* blk = nullptr;
inline uint3 tidx, bidx;
inline dim3 bdim, gdim;
inline int ltid = 0;
inline std::mutex atomic_mu;
inline cudaError_t last_error = cudaSuccess;

inline int nwarp_threads(int w) { return std::min(32, blk->nt - 32 * w); }

// Park the running fiber at the block (kAtBlock) or warp (kAtWarp) barrier.
inline void park(int at) {
  Fiber& me = blk->f[ltid];
  me.state = at;
  if (at == kAtBlock)
    ++blk->at_block;
  else
    ++blk->at_warp[ltid / 32];
  swapcontext(&me.ctx, &blk->sched);
}

inline void release(Block& b) {
  if (b.at_block > 0 && b.at_block == b.live) {
    for (auto& x : b.f)
      if (x.state == kAtBlock) x.state = kRun;
    b.at_block = 0;
  }
  for (size_t w = 0; w < b.at_warp.size(); ++w)
    if (b.at_warp[w] > 0 && b.at_warp[w] == b.warp_live[w]) {
      for (int t = 32 * static_cast<int>(w); t < std::min(b.nt, 32 * static_cast<int>(w) + 32); ++t)
        if (b.f[t].state == kAtWarp) b.f[t].state = kRun;
      b.at_warp[w] = 0;
    }
}

inline void trampoline() {
  blk->body();
  Block& b = *blk;
  b.f[ltid].state = kDone;
  --b.live;
  --b.warp_live[ltid / 32];
  // uc_link returns to the scheduler.
}

template <class T>
T* dyn_smem() {
  return reinterpret_cast<T*>(blk->dyn.data());
}

struct Cfg {
  dim3 grid, block;
  size_t smem;
  cudaStream_t stream;
  Cfg(dim3 g, dim3 b, size_t s = 0, cudaStream_t st = nullptr)
      : grid(g), block(b), smem(s), stream(st) {}
};

template <class K, class... A>
void launch(K kernel, Cfg c, A... args) {
  const long nt = static_cast<long>(c.block.x) * c.block.y * c.block.z;
  if (nt < 1 || nt > 1024 || static_cast<long>(c.smem) > kSmemOptin) {
    last_error = cudaErrorInvalidConfiguration;
    return;
  }
  for (unsigned bz = 0; bz < c.grid.z; ++bz)
    for (unsigned by = 0; by < c.grid.y; ++by)
      for (unsigned bx = 0; bx < c.grid.x; ++bx) {
        Block b;
        b.nt = b.live = static_cast<int>(nt);
        for (int w = 0; 32 * w < nt; ++w) {
          b.warp_live.push_back(static_cast<int>(std::min<long>(32, nt - 32 * w)));
          b.at_warp.push_back(0);
        }
        b.xi.assign(nt, 0);
        b.xw.assign(nt, 0);
        b.xm.assign(10 * nt, 0);
        b.dyn.assign(c.smem + 16, 0);
        b.body = [&] { kernel(args...); };
        b.f.resize(nt);
        blk = &b;
        bidx = uint3{bx, by, bz};
        bdim = c.block;
        gdim = c.grid;
        for (auto& x : b.f) {
          x.stack.reset(new char[kStack]);
          getcontext(&x.ctx);
          x.ctx.uc_stack.ss_sp = x.stack.get();
          x.ctx.uc_stack.ss_size = kStack;
          x.ctx.uc_link = &b.sched;
          makecontext(&x.ctx, trampoline, 0);
        }
        while (b.live > 0) {
          bool ran = false;
          for (int t = 0; t < b.nt; ++t) {
            if (b.f[t].state != kRun) continue;
            ran = true;
            ltid = t;
            tidx = uint3{static_cast<unsigned>(t % c.block.x),
                         static_cast<unsigned>((t / c.block.x) % c.block.y),
                         static_cast<unsigned>(t / (c.block.x * c.block.y))};
            swapcontext(&b.sched, &b.f[t].ctx);
            release(b);
          }
          if (!ran) {
            std::fprintf(stderr, "emulated block deadlocked: no thread can run\n");
            std::abort();
          }
        }
      }
}
}  // namespace emu

#define threadIdx emu::tidx
#define blockIdx emu::bidx
#define blockDim emu::bdim
#define gridDim emu::gdim

inline void __syncthreads() { emu::park(emu::kAtBlock); }
inline int __syncthreads_or(int p) {
  emu::blk->xi[emu::ltid] = p != 0;
  __syncthreads();
  int r = 0;
  for (int i = 0; i < emu::blk->nt; ++i) r |= emu::blk->xi[i];
  __syncthreads();
  return r;
}
inline int __syncthreads_and(int p) {
  emu::blk->xi[emu::ltid] = p != 0;
  __syncthreads();
  int r = 1;
  for (int i = 0; i < emu::blk->nt; ++i) r &= emu::blk->xi[i];
  __syncthreads();
  return r;
}
inline int __syncthreads_count(int p) {
  emu::blk->xi[emu::ltid] = p != 0;
  __syncthreads();
  int r = 0;
  for (int i = 0; i < emu::blk->nt; ++i) r += emu::blk->xi[i];
  __syncthreads();
  return r;
}
inline void __syncwarp(unsigned = 0xffffffffu) { emu::park(emu::kAtWarp); }
template <class T>
T __shfl_xor_sync(unsigned, T v, int o) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  const int base = emu::ltid & ~31, lane = emu::ltid & 31;
  std::memcpy(&emu::blk->xw[emu::ltid], &v, 4);
  __syncwarp();
  const int src = lane ^ o;
  T r = v;
  if (src < emu::nwarp_threads(base / 32)) std::memcpy(&r, &emu::blk->xw[base + src], 4);
  __syncwarp();
  return r;
}
template <class T>
T __shfl_sync(unsigned, T v, int src) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  const int base = emu::ltid & ~31;
  std::memcpy(&emu::blk->xw[emu::ltid], &v, 4);
  __syncwarp();
  T r;
  std::memcpy(&r, &emu::blk->xw[base + (src & 31)], 4);
  __syncwarp();
  return r;
}
inline int __any_sync(unsigned, int p) {
  const int base = emu::ltid & ~31;
  emu::blk->xi[emu::ltid] = p != 0;
  __syncwarp();
  int r = 0;
  for (int i = 0; i < emu::nwarp_threads(base / 32); ++i) r |= emu::blk->xi[base + i];
  __syncwarp();
  return r;
}
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 for the warp, by
// the PTX fragment layout (lane l: g = l / 4, t = l % 4; the lower index in
// the low 16 bits): a[e] holds A row g + 8 (e & 1) at columns
// 2t + 8 (e >> 1) + {0, 1}; b[e] B rows 2t + 8 e + {0, 1} of column g;
// d[e] D row g + 8 (e >> 1), column 2t + (e & 1).
#define OCP_MMA_EMULATED 1
inline float emu_bf16(std::uint32_t h) {
  const std::uint32_t u = (h & 0xffffu) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline void mma_bf16_16816(float d[4], const unsigned a[4], const unsigned b[2]) {
  const int base = emu::ltid & ~31, lane = emu::ltid & 31;
  std::uint32_t* const x = emu::blk->xm.data();
  std::uint32_t* const me = x + 10 * emu::ltid;
  for (int e = 0; e < 4; ++e) me[e] = a[e];
  me[4] = b[0];
  me[5] = b[1];
  std::memcpy(me + 6, d, 16);
  __syncwarp();
  float A[16][16], Bm[16][8], C[16][8];
  for (int l = 0; l < 32; ++l) {
    const std::uint32_t* f = x + 10 * (base + l);
    const int g = l >> 2, t = l & 3;
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e & 1), col = 2 * t + 8 * (e >> 1);
      A[row][col] = emu_bf16(f[e]);
      A[row][col + 1] = emu_bf16(f[e] >> 16);
    }
    for (int e = 0; e < 2; ++e) {
      Bm[2 * t + 8 * e][g] = emu_bf16(f[4 + e]);
      Bm[2 * t + 8 * e + 1][g] = emu_bf16(f[4 + e] >> 16);
    }
    for (int e = 0; e < 4; ++e) std::memcpy(&C[g + 8 * (e >> 1)][2 * t + (e & 1)], f + 6 + e, 4);
  }
  __syncwarp();
  const int g = lane >> 2, t = lane & 3;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    double acc = C[row][col];
    for (int k = 0; k < 16; ++k) acc += static_cast<double>(A[row][k]) * Bm[k][col];
    d[e] = static_cast<float>(acc);
  }
}
inline int __all_sync(unsigned, int p) {
  const int base = emu::ltid & ~31;
  emu::blk->xi[emu::ltid] = p != 0;
  __syncwarp();
  int r = 1;
  for (int i = 0; i < emu::nwarp_threads(base / 32); ++i) r &= emu::blk->xi[base + i];
  __syncwarp();
  return r;
}
template <class T>
T atomicAdd(T* p, T v) {
  std::lock_guard<std::mutex> g(emu::atomic_mu);
  const T o = *p;
  *p = o + v;
  return o;
}
template <class T>
T __ldg(const T* p) {
  return *p;
}
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, 4);
  return i;
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline void __threadfence_block() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline long long clock64() { return 0; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline long long max(long long a, long long b) { return a > b ? a : b; }

// Runtime API stubs with the H100's limits.
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = emu::last_error;
  emu::last_error = cudaSuccess;
  return e;
}
inline cudaError_t cudaPeekAtLastError() { return emu::last_error; }
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : e == cudaErrorInvalidValue ? "invalid argument"
                                                                     : "invalid configuration";
}
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int v) {
  return v <= emu::kSmemOptin ? cudaSuccess : cudaErrorInvalidValue;
}
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? 132 : static_cast<int>(emu::kSmemOptin);
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int threads, size_t smem) {
  int by_threads = 2048 / threads;
  int by_smem = static_cast<int>(emu::kSmemPerSM / (static_cast<long>(smem) + 1024));
  *n = std::min(std::min(by_threads, by_smem), 32);
  return cudaSuccess;
}
"""

PIPELINE_HEADER = r"""
#pragma once
#include "emu_cuda.h"
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n, size_t = 0) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
"""

# The child: load the library, call the entry point on the arrays, hand the
# arrays back.  numpy and ctypes only, so it starts in well under a second.
CHILD = r"""
import ctypes, pickle, sys
import numpy as np
spec = pickle.load(open(sys.argv[1], "rb"))
lib = ctypes.CDLL(spec["lib"])
fn = getattr(lib, spec["symbol"])
arrs = [np.ascontiguousarray(a) for a in spec["arrays"]]
ptrs = (ctypes.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs])
fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int] * len(spec["ints"])
               + [ctypes.c_double] * len(spec["floats"]) + [ctypes.c_void_p])
fn.restype = ctypes.c_int
rc = fn(ctypes.cast(ptrs, ctypes.c_void_p), len(arrs), *spec["ints"], *spec["floats"], None)
pickle.dump({"rc": rc, "arrays": arrs}, open(sys.argv[2], "wb"))
"""

# Seconds a child may take before its case fails (a deadlocked barrier
# would otherwise hang the suite).
CASE_LIMIT = 120


def _source_for_gxx(src: str) -> str:
    """A ``.cu`` source as plain C++: dynamic shared memory as the launch's
    buffer, ``<<<...>>>`` launches as ``emu::launch`` calls."""
    src = re.sub(
        r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?(\w+)\s+(\w+)\[\];",
        r"\1* const \2 = emu::dyn_smem<\1>();",
        src,
    )
    return re.sub(
        r"([\w:]+(?:<[^<>;()]*>)?)\s*<<<(.*?)>>>\(",
        r"emu::launch(\1, emu::Cfg(\2), ",
        src,
    )


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    """``name -> path`` of each kernel built with g++ against the header."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the CUDA emulation needs it")
    root = tmp_path_factory.mktemp("cuda_emu")
    inc = root / "include"
    inc.mkdir(exist_ok=True)
    (inc / "emu_cuda.h").write_text(EMU_HEADER)
    (inc / "cuda_runtime.h").write_text('#pragma once\n#include "emu_cuda.h"\n')
    (inc / "math_constants.h").write_text(
        '#pragma once\n#include "emu_cuda.h"\n#define CUDART_INF_F (__builtin_huge_valf())\n')
    (inc / "cuda_pipeline.h").write_text(PIPELINE_HEADER)
    (root / "child.py").write_text(CHILD)
    built = {}

    def get(name):
        if name not in built:
            src = root / f"{name}.cpp"
            src.write_text(_source_for_gxx(build.SOURCES[name].read_text()))
            out = root / f"lib{name}.so"
            cmd = [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fno-strict-aliasing", "-fPIC", "-shared",
                   "-pthread", "-w", "-I", str(inc), "-o", str(out), str(src)]
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            assert res.returncode == 0, res.stderr[-4000:]
            built[name] = out
        return built[name]

    get.root = root
    return get


def _run_entry(emu_lib, lib_name, symbol, tensors, ints, floats):
    """Run a C entry point in a child process on CPU tensors; the tensors
    get the arrays the kernel left (outputs and scratch)."""
    root = emu_lib.root
    spec_path = root / f"spec_{os.getpid()}.pkl"
    out_path = root / f"out_{os.getpid()}.pkl"
    arrays = [t.detach().numpy() for t in tensors]
    with open(spec_path, "wb") as f:
        pickle.dump({"lib": str(emu_lib(lib_name)), "symbol": symbol, "arrays": arrays,
                     "ints": [int(i) for i in ints], "floats": [float(x) for x in floats]}, f)
    try:
        res = subprocess.run([sys.executable, str(root / "child.py"), str(spec_path),
                              str(out_path)], capture_output=True, text=True,
                             timeout=CASE_LIMIT)
    except subprocess.TimeoutExpired:
        pytest.fail(f"{symbol}: the emulated launch took over {CASE_LIMIT} s (deadlock?)")
    assert res.returncode == 0, res.stderr[-4000:]
    with open(out_path, "rb") as f:
        got = pickle.load(f)
    for t, a in zip(tensors, got["arrays"]):
        t.copy_(torch.from_numpy(a))
    return got["rc"]


@pytest.fixture
def emulate(emu_lib, monkeypatch):
    """Route every wrapper's ``launch_chunk`` to the emulated library, and
    the device loop's layout queries (its tier rule) to its emulated build;
    ``emulate.rcs`` collects the entry points' return codes."""
    rcs = []

    def fake_launch(label, lib_name, symbol, tensors, ints, floats, dev):
        rc = _run_entry(emu_lib, lib_name, symbol, tensors, ints, floats)
        rcs.append(rc)
        if rc != 0:
            raise RuntimeError(f"{label} launch failed: cudaError {rc}")

    for mod in (bk, brk, bck, sk, ak):
        monkeypatch.setattr(mod, "launch_chunk", fake_launch)
    monkeypatch.setattr(ak, "load_library", lambda name: ctypes.CDLL(str(emu_lib(name))))
    fake_launch.rcs = rcs
    return fake_launch


# ---- inputs -----------------------------------------------------------------


def stage_chunk_case(N, w, r, r2, B, eps=0.0, max_iter=40, check_every=2, near_budget=False,
                     seed=0, nan_scenario=None, stage_bounds=(-1.0, np.inf)):
    """Chunk inputs of a random batch-last stage QP batch (the shape of
    ``tests/test_admm_banded.random_stage_qp``) through the port's driver
    prepare; ``near_budget``: entry counts near ``max_iter`` and every
    fifth scenario frozen at entry; ``nan_scenario``: that scenario's
    linear term is NaN (a diverged scenario: its iterates, residuals and
    clipped ``z`` are NaN in the plain version); ``stage_bounds``: the
    stage rows' ``(lower, upper)``."""
    from optimal_control_problem_tpu_torch.solvers import admm_banded_batch as abb
    from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings
    from optimal_control_problem_tpu_torch.solvers.admm_banded import BandedQP

    rng = np.random.default_rng(seed)
    L = rng.normal(size=(B, N, w, w))
    Hb = L @ np.swapaxes(L, -1, -2) + 2 * np.eye(w)
    J0 = 0.5 * rng.normal(size=(B, N - 1, r, w))
    J1 = 0.5 * rng.normal(size=(B, N - 1, r, w))
    Jc = 0.5 * rng.normal(size=(B, N, r2, w))
    n = N * w
    q = rng.normal(size=(B, n))
    lo = np.concatenate([np.full(n, -2.0), np.zeros((N - 1) * r),
                         np.full(N * r2, stage_bounds[0])])
    hi = np.concatenate([np.full(n, 2.0), np.zeros((N - 1) * r),
                         np.full(N * r2, stage_bounds[1])])
    m = lo.shape[0]

    def last(a):
        return torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, 0, -1), np.float32))

    qp = BandedQP(*(last(a) for a in (Hb, J0, J1, Jc, q)),
                  torch.as_tensor(np.repeat(lo[:, None], B, 1), dtype=torch.float32),
                  torch.as_tensor(np.repeat(hi[:, None], B, 1), dtype=torch.float32))
    x0 = torch.as_tensor(0.1 * rng.normal(size=(n, B)), dtype=torch.float32)
    y0 = torch.as_tensor(0.1 * rng.normal(size=(m, B)), dtype=torch.float32)
    st = ADMMSettings(method="banded", eps_abs=eps, eps_rel=eps, max_iter=max_iter,
                      adaptive_rho=False, check_infeasibility=False, check_every=check_every)
    prob = abb.prepare_banded_batch_T(qp, st, x0, y0)
    it0 = np.zeros(B, np.int32)
    done0 = np.zeros(B, np.int32)
    if near_budget:
        it0 = np.array([0, 10, 30, 36, 38, 39, 40, 41])[np.arange(B) % 8].astype(np.int32)
        done0 = (np.arange(B) % 5 == 0).astype(np.int32)
    args, kw = abb.chunk_inputs(prob, st, torch.as_tensor(it0), torch.as_tensor(done0),
                                prob.x, prob.y, prob.z, prob.rho)
    if nan_scenario is not None:
        args[6][..., nan_scenario] = float("nan")
    return args, kw


def assert_bitwise(out_k, out_p):
    """Every output equal bit for bit (NaN where NaN, the sign of a zero
    included), ``done``/``it_inc`` and the other integer outputs too."""
    assert len(out_k) == len(out_p)
    for i, (a, b) in enumerate(zip(out_k, out_p)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        if a.dtype.is_floating_point:
            nan = torch.isnan(a) & torch.isnan(b)
            # +0 and -0 compare equal; the bits must too (a NaN's sign is
            # not specified by IEEE arithmetic, so NaN matches NaN).
            same = nan | ((a == b) & (torch.signbit(a) == torch.signbit(b)))
            assert bool(same.all()), f"output {i}: largest gap {float((a - b).abs().max())}"
        else:
            assert torch.equal(a, b), f"output {i} differs"


def run_banded(module, plain_kw, case):
    """The module's kernel (through its launch path, emulated) and its plain
    version on one case, bitwise; ``plain_kw`` go to both."""
    args, kw = case
    out_p = getattr(module, plain_name(module))(*args, **kw, **plain_kw)
    inputs, dims = bk.chunk_contract("emu", *args, kw["check_every"])
    out_k = module._launch(inputs, dims, kw["interval"], kw["check_every"], kw["max_iter"],
                           kw["sigma"], kw["alpha"], kw["eps_abs"], kw["eps_rel"],
                           *plain_kw.values())
    assert_bitwise(out_k, out_p)
    return out_k


def plain_name(module):
    return {bk: "banded_admm_chunk_plain", brk: "banded_admm_chunk_rolled_plain",
            bck: "banded_admm_chunk_cr_plain"}[module]


# ---- B1, B2: one small case each; B5: every tier ---------------------------------


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


def device_loop_case(B, n, m, diverging=False, seed=0):
    """Device-loop inputs of B random QPs of their own (the positional
    arguments before ``max_iter``).  ``diverging``: the operator is no
    ADMM operator, so a scenario's iterates overflow to NaN."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)

    L = f(B, n, n)
    Pb = L @ L.transpose(1, 2) + 0.5 * torch.eye(n)
    Ab = f(B, m, n)
    lb = -1 - f(B, m).abs()
    ub = 1 + f(B, m).abs()
    lb[:, 0], ub[:, 0] = -np.inf, np.inf
    rho = 0.1 + f(B, m).abs()
    # The condensed operator of a convergent ADMM: (P + sigma I + A^T R A)^-1.
    OP = torch.linalg.inv(Pb + 1e-6 * torch.eye(n) + Ab.transpose(1, 2) @ (rho[:, :, None] * Ab))
    if diverging:
        L2 = f(B, n, n)
        OP = torch.linalg.inv(L2 @ L2.transpose(1, 2) + 4 * torch.eye(n))
    pos = lambda *s: 0.5 + f(*s).abs()  # noqa: E731
    OP, Pb = OP.contiguous(), Pb.contiguous()
    return (OP, Ab, Pb, f(B, n), lb, ub, rho, pos(B, n), pos(B, m), pos(B), 1e-6, 1.6,
            1e-4, 1e-4, 0.1 * f(B, n), 0.1 * f(B, m))


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


# (B, n, m, max_iter, check_every, diverging, eps): n=7, m=13 pad every row
# stride and vector (row_stride 12 and 20, float4 tails of 3 and 1 terms);
# n=9, m=17 odd both, as the augmented cart-pole's n=101, m=197 (every
# chain ends in a tail of one term); B=1; a forced budget (eps 0) that is no multiple of check_every; a
# diverging (NaN) batch; the cart-pole h20 QP's n=100, m=196 at a short
# budget; n=104 and m=300 (more rows than a block has threads).
DEVICE_LOOP_CASES = [
    (4, 7, 13, 200, 5, False, 1e-4),
    (3, 9, 17, 200, 5, False, 1e-4),
    (1, 9, 6, 23, 4, False, 0.0),
    (3, 6, 9, 100, 5, True, 1e-4),
    (1, 100, 196, 3, 2, False, 0.0),
    (2, 104, 20, 6, 3, False, 0.0),
    (2, 8, 300, 6, 3, False, 0.0),
]


@pytest.mark.parametrize("tier", [1, 2, 3])
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


@pytest.fixture
def dl_smem(emu_lib, monkeypatch):
    """The device loop's C ``ocp_admm_device_loop_smem(tier, n, m)``, with
    the wrapper's layout queries routed to the same emulated build."""
    lib = ctypes.CDLL(str(emu_lib("admm_device_loop")))
    monkeypatch.setattr(ak, "load_library", lambda name: lib)
    fn = lib.ocp_admm_device_loop_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return fn


@pytest.mark.parametrize("n,m,tier", [
    (100, 196, 1), (120, 236, 2), (200, 392, 3),
    (91, 258, 1), (91, 259, 2),     # tier 1 at exactly 232,448 bytes, then one row more
    (100, 444, 2), (100, 445, 3),   # the last m of tier 2 at n=100, then one more
    (7, 13, 1), (1, 1, 1), (700, 10, 3),
])
def test_device_loop_tier_rule(dl_smem, n, m, tier):
    """``kernel_tier`` is the first tier whose block (the C entry point's
    count) fits the card's 232,448 bytes: pinned at the dense cart-pole
    QP, at n=120, m=236 and n=200, m=392, and either side of each
    boundary."""
    assert ak.kernel_tier(n, m) == tier
    assert dl_smem(tier, n, m) <= ak.SMEM_LIMIT
    assert all(dl_smem(t, n, m) > ak.SMEM_LIMIT for t in range(1, tier))
    assert dl_smem(1, 91, 258) == ak.SMEM_LIMIT


# (tier, n, m, bytes): every shared row stride is the least multiple of 4
# >= its row's terms whose quotient by 4 is odd (100 and 196 as they are,
# 120 -> 124, 7 -> 12, 13 -> 20), every vector padded to a multiple of 4,
# and 64 floats of reduction rows; -1 for no tier.
@pytest.mark.parametrize("tier,n,m,nbytes", [
    (1, 100, 196, 204_544), (2, 100, 196, 126_144), (1, 120, 236, 299_120),
    (2, 120, 236, 185_840), (2, 200, 392, 498_304), (1, 7, 13, 2_384), (2, 7, 13, 1_824),
    (3, 200, 392, 256), (0, 7, 13, -1), (4, 7, 13, -1),
])
def test_device_loop_smem_of_each_tier(dl_smem, tier, n, m, nbytes):
    assert dl_smem(tier, n, m) == nbytes


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


# ---- B4: the cyclic-reduction chunk, every layout tier ----------------------

# (N, w, r, r2, B, case keywords).  Shared-memory tiers (``cr_layout``): up
# to N=25, w=16 everything is in shared memory; at N=100, w=16 (the
# quadrotor) the operator rows, pivot inverses and couplings are in the
# slab, J0 and J1 in the region; at N=150, w=16 all but the region is in
# the slab; at N=400, w=16 the level's products and J0, J1 are in the slab
# too; at N=600, w=3 the couplings are in the slab, the rest in shared
# memory.
CR_CASES = [
    (2, 3, 2, 1, 2, dict(max_iter=6)),
    (7, 5, 4, 1, 8, dict(max_iter=41, near_budget=True)),
    (10, 5, 3, 2, 3, dict(eps=1e-3, max_iter=200)),
    (25, 16, 12, 1, 2, dict(max_iter=4)),
    (100, 16, 12, 1, 1, dict(max_iter=2)),
    (150, 16, 12, 1, 1, dict(max_iter=2)),
    (600, 3, 2, 1, 1, dict(max_iter=2)),
    (400, 16, 12, 1, 1, dict(max_iter=2)),
    (20, 5, 4, 1, 3, dict(eps=1e-3, max_iter=40, nan_scenario=1)),
]


@pytest.mark.parametrize("N,w,r,r2,B,case_kw", CR_CASES,
                         ids=[f"N{c[0]}-w{c[1]}-B{c[4]}" for c in CR_CASES])
def test_cr_chunk_emulated_matches_plain(emulate, N, w, r, r2, B, case_kw):
    out = run_banded(bck, {}, stage_chunk_case(N, w, r, r2, B, **case_kw))
    assert emulate.rcs == [0] and int(out[8].max()) > 0


@pytest.fixture(scope="module")
def cr_layout(emu_lib):
    """The C entry point's layout, ``ocp_banded_cr_layout``: ``(N, w, r,
    r2) -> dict``, or its error code."""
    import ctypes

    fn = ctypes.CDLL(str(emu_lib("banded_cr_chunk"))).ocp_banded_cr_layout
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    keys = ("per", "smem_bytes", "region", "vec", "st", "ov", "dinvt", "lp", "lpt", "j_region")

    def get(N, w, r, r2):
        out = (ctypes.c_longlong * len(keys))()
        rc = fn(N, w, r, r2, out)
        return dict(zip(keys, out)) if rc == 0 else rc

    return get


@pytest.mark.parametrize("N,w,r,r2", [(2, 3, 2, 1), (7, 5, 4, 1), (25, 16, 12, 1),
                                      (100, 16, 12, 1), (101, 16, 12, 1), (150, 16, 12, 1),
                                      (400, 16, 12, 1), (600, 3, 2, 1), (1500, 3, 2, 1),
                                      (9, 7, 5, 3), (60, 1, 1, 1)])
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


def test_cr_layout_refuses_sizes_the_kernel_does_not_take(cr_layout):
    assert cr_layout(1, 16, 12, 1) != 0
    assert cr_layout(100, 17, 12, 1) != 0
    assert cr_layout(100, 16, 0, 1) != 0


# ---- B3: the shared-operator chunk, every block shape and operator path ------


def shared_chunk_case(B, n, m, seed=0):
    """The first chunk call of the port's fused driver (``backend="pallas"``
    on the CPU, plain version) on a random shared QP batch (the shape of
    ``tests/test_torch_shared.problem``): ``(args, kw)``."""
    from optimal_control_problem_tpu_torch.solvers import admm_batched as tab
    from optimal_control_problem_tpu_torch.solvers.admm import ADMMSettings

    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, n))
    P = L @ L.T + 0.5 * np.eye(n)
    A = rng.normal(size=(m, n))
    qs = rng.normal(size=(B, n))
    centers = rng.normal(size=(B, n)) @ A.T
    ls = centers - rng.uniform(0.2, 1.5, size=(B, m))
    us = centers + rng.uniform(0.2, 1.5, size=(B, m))
    P, A, qs, ls, us = (torch.as_tensor(a, dtype=torch.float32) for a in (P, A, qs, ls, us))
    st = ADMMSettings(eps_abs=1e-4, eps_rel=1e-4, method="condensed", backend="pallas",
                      check_every=5, max_iter=40)
    fac = tab.prepare_shared(P, A, ls, us, qs, st)
    calls = []
    real = tab.shared_admm_chunk

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    tab.shared_admm_chunk = record
    try:
        tab.admm_iterate_prepared(fac, qs, ls, us, st)
    finally:
        tab.shared_admm_chunk = real
    return calls[0]


# (B, n, m, rows, variation).  n=40, m=36: operator slices of 32 rows, the
# last one partial; n=6, m=9: max(n, m) no multiple of 4, operators read
# through L1; n=232, m=12: two column passes.  Variations: a forced budget
# that is no multiple of check_every, converging, four termination groups
# with one done at entry.
SHARED_CASES = [
    (16, 40, 36, 8, "forced"),
    (16, 40, 36, 16, "converging"),
    (64, 40, 36, 32, "groups"),
    (16, 6, 9, 8, "groups"),
    (8, 40, 36, 8, "nan"),
    (8, 232, 12, 8, "forced"),
]


@pytest.mark.parametrize("B,n,m,rows,variation", SHARED_CASES,
                         ids=[f"B{c[0]}-n{c[1]}-m{c[2]}-rows{c[3]}-{c[4]}" for c in SHARED_CASES])
def test_shared_chunk_emulated_matches_plain(emulate, B, n, m, rows, variation):
    args, kw = shared_chunk_case(B, n, m)
    args = list(args)
    if variation == "forced":
        kw = {**kw, "eps_abs": 0.0, "eps_rel": 0.0}
        args[1] = 7
    elif variation == "converging":
        args[1] = 1000
    elif variation == "nan":
        # One scenario diverged: its NaN residual keeps its group open to
        # the budget, as in the plain version.
        args[8] = args[8].clone()
        args[8][1] = float("nan")
        args[1] = 100
    else:
        kw = {**kw, "eps_abs": 0.0, "eps_rel": 0.0, "batch_tile": B // 4}
        args[0] = torch.zeros(B, dtype=torch.bool)
        args[0][B // 2:3 * B // 4] = True
        args[1] = 10
    out_p = sk.shared_admm_chunk_plain(*args, **kw)
    B_, n_, m_, bound, done0, cinv = sk._contract(
        *args[:11], args[11], *args[12:], kw["check_every"], kw["batch_tile"])
    out_k = sk._launch(done0, bound, *args[2:11], cinv, *args[12:], rows, **kw)
    assert_bitwise(out_k, out_p)
    assert emulate.rcs == [0]
    if variation == "forced":
        assert bool((out_k[4] == 10).all())
    elif variation == "converging":
        assert bool(out_k[3].all()) and 0 < int(out_k[4][0]) < 1000
    elif variation == "nan":
        assert not bool(out_k[3][1]) and bool((out_k[4] == 100).all())
    else:
        g = slice(B // 2, 3 * B // 4)
        assert bool((out_k[4][g] == 0).all()) and bool((out_k[4][:B // 2] == 10).all())


@pytest.fixture(scope="module")
def stage_rows(emu_lib):
    """The C entry point's ``ocp_shared_stage_rows``."""
    import ctypes

    fn = ctypes.CDLL(str(emu_lib("shared_chunk"))).ocp_shared_stage_rows
    fn.argtypes = [ctypes.c_int] * 3
    return fn


@pytest.mark.parametrize("rows", sk.ROWS_PER_BLOCK)
@pytest.mark.parametrize("n,m", [(120, 196), (6, 9), (40, 36), (600, 1200), (700, 1000),
                                 (118, 195), (2400, 40)])
def test_stage_rows_are_the_most_that_fit(stage_rows, rows, n, m):
    """Three slices of ``ks`` operator rows fit beside the panels, twice as
    many would not (or ``ks`` is the cap of 32); ``0`` where no slice fits
    or ``max(n, m)`` is no multiple of 4, ``-1`` where the panels alone
    do not fit."""
    J = max(n, m)
    ks = stage_rows(rows, n, m)

    def bytes_(k):
        return (rows * (3 * n + 3 * m) + 3 * k * J + 5 * rows) * 4

    if bytes_(0) > sk.SMEM_LIMIT:
        assert ks == -1
    elif J % 4 or bytes_(4) > sk.SMEM_LIMIT:
        assert ks == 0
    else:
        assert ks in (4, 8, 16, 32) and bytes_(ks) <= sk.SMEM_LIMIT
        assert ks == 32 or bytes_(2 * ks) > sk.SMEM_LIMIT


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


# ---- B3's tensor-core form (iter_precision "high" / "mixed") ----------------


def rel_gap(a, b):
    """Largest |a - b| over the finite entries of ``b``, relative to the
    largest of them (NaN and infinite places must agree)."""
    fin = torch.isfinite(b)
    assert torch.equal(torch.isfinite(a), fin) and torch.equal(torch.isnan(a), torch.isnan(b))
    if not bool(fin.any()):
        return 0.0
    return float((a[fin] - b[fin]).abs().max() / b[fin].abs().max().clamp(min=1e-30))


# (B, n, m, rows, mode, variation).  n=40, m=36: the rhs product's K = m
# pads to 48, the x and z products' to 48; n=232, m=12: fifteen n8 tiles
# for a warp's 29 in the x product, two m16 tiles at 32 rows.  Variations:
# one forced iteration (check_every 1), a forced budget of 10 iterations,
# converging, four termination groups with one done at entry, a NaN
# scenario.
TC_CASES = [
    (16, 40, 36, 16, "high", "one"),
    (32, 40, 36, 32, "mixed", "one"),
    (16, 40, 36, 16, "mixed", "forced"),
    (32, 40, 36, 32, "high", "converging"),
    (64, 40, 36, 16, "high", "groups"),
    (16, 40, 36, 16, "high", "nan"),
    (16, 40, 36, 16, "mixed", "nan"),
    (32, 232, 12, 32, "high", "one"),
]

# Tolerances of the tensor-core form against its plain version, relative to
# each output's largest finite magnitude.  Both split every operand into
# the same bf16 hi/lo bits and sum exact products in float32; they differ
# only in the order of the sums (the tensor core's, here the emulation's
# one rounding per mma, against torch.matmul's).  That is f32 roundoff of
# the products' terms, which exceed their result by the operator's
# cancellation: measured after one iteration 2.7e-6 at n=40 (terms 6x the
# result) and 4.6e-5 at n=232 (158x; FP32 chains and torch.matmul already
# differ by 5.1e-6 there), so 1e-4; over a forced chunk of ten iterations
# up to 7.3e-5 (n=40), so 5e-4.  A converging chunk may stop one check
# block apart (the knife edge of the termination test: 295 against 300
# iterations at eps 1e-4 here); its iterates agree to the tolerance's
# scale, 1e-3.
TC_ONE_ITER = 1e-4
TC_CHUNK = 5e-4
TC_CONVERGED = 1e-3


@pytest.mark.parametrize("B,n,m,rows,mode,variation", TC_CASES,
                         ids=[f"B{c[0]}-n{c[1]}-m{c[2]}-rows{c[3]}-{c[4]}-{c[5]}" for c in TC_CASES])
def test_shared_chunk_tc_emulated_matches_plain(emulate, B, n, m, rows, mode, variation):
    args, kw = shared_chunk_case(B, n, m)
    args = list(args)
    kw = {**kw, "iter_precision": mode}
    if variation == "one":
        kw = {**kw, "eps_abs": 0.0, "eps_rel": 0.0, "check_every": 1}
        args[1] = 1
    elif variation == "forced":
        kw = {**kw, "eps_abs": 0.0, "eps_rel": 0.0}
        args[1] = 7
    elif variation == "converging":
        args[1] = 1000
    elif variation == "nan":
        args[8] = args[8].clone()
        args[8][1] = float("nan")
        args[1] = 10
    else:
        kw = {**kw, "eps_abs": 0.0, "eps_rel": 0.0, "batch_tile": B // 4}
        args[0] = torch.zeros(B, dtype=torch.bool)
        args[0][B // 2:3 * B // 4] = True
        args[1] = 10
    out_p = sk.shared_admm_chunk_plain(*args, **kw)
    run_kw = {k: v for k, v in kw.items() if k != "iter_precision"}
    B_, n_, m_, bound, done0, cinv = sk._contract(
        *args[:11], args[11], *args[12:], kw["check_every"], kw["batch_tile"])
    out_k = sk._launch_tc(done0, bound, *args[2:11], cinv, *args[12:], rows, **run_kw,
                          iter_precision=mode)
    assert emulate.rcs == [0]
    if variation == "converging":
        assert int((out_k[4] - out_p[4]).abs().max()) <= kw["check_every"]
    else:
        assert torch.equal(out_k[4], out_p[4])
    limit = {"one": TC_ONE_ITER, "converging": TC_CONVERGED}.get(variation, TC_CHUNK)
    gaps = {nm: rel_gap(a, b) for nm, a, b in zip(("x", "z", "y"), out_k[:3], out_p[:3])}
    assert max(gaps.values()) <= limit, gaps
    # The residuals are FP32 chains of iterates that differ by the above;
    # a residual is a difference of nearly equal terms, so its gap is held
    # against the magnitude it is relative to (max_prim = rp / rp_rel).
    for i in (5, 6):
        fin = torch.isfinite(out_p[i]) & (out_p[i + 2] > 0)
        assert torch.equal(torch.isfinite(out_k[i]), torch.isfinite(out_p[i]))
        scale = (out_p[i] / out_p[i + 2])[fin]
        assert bool(((out_k[i][fin] - out_p[i][fin]).abs() <= 10 * limit * scale).all())
        assert bool(((out_k[i + 2][fin] - out_p[i + 2][fin]).abs() <= 10 * limit).all())
    if variation == "converging":
        assert bool(out_k[3].all()) and bool(out_p[3].all())
        assert 0 < int(out_k[4][0]) < 1000
    elif variation == "nan":
        assert not bool(out_k[3][1]) and bool((out_k[4] == 10).all())
        assert bool(torch.isnan(out_k[0][1]).all())
    elif variation == "groups":
        g = slice(B // 2, 3 * B // 4)
        assert bool((out_k[4][g] == 0).all()) and bool((out_k[4][:B // 2] == 10).all())
        assert all(torch.equal(out_k[i][g], args[12 + i][g]) for i in range(3))
    else:
        assert torch.equal(out_k[3], out_p[3])


@pytest.fixture(scope="module")
def tc_stage_rows(emu_lib):
    """The C entry point's ``ocp_shared_tc_stage_rows``."""
    fn = ctypes.CDLL(str(emu_lib("shared_chunk"))).ocp_shared_tc_stage_rows
    fn.argtypes = [ctypes.c_int] * 3
    return fn


@pytest.mark.parametrize("n,m", [(120, 196), (160, 236), (40, 36), (232, 12), (600, 1200)])
def test_tc_block_rows_rule_takes_only_shapes_the_entry_point_takes(tc_stage_rows, n, m):
    """The tensor-core form's block-shape rule (its split panel in the
    per-row bytes) agrees with the C entry point: a shape it picks fits
    there, and it raises only where not even 16 rows fit.  At the main
    path's n=120, m=196 (B=4096) it takes 32 rows with slices of 32
    operator rows (224,896 of 232,448 bytes), at the augmented n=160,
    m=236 32 rows with slices of 16."""
    try:
        rows = sk.shared_block_rows(4096, 4096, n, m, 132, tensor_cores=True)
    except ValueError:
        assert tc_stage_rows(16, n, m) == -1
        return
    assert tc_stage_rows(rows, n, m) >= 0
    if (n, m) == (120, 196):
        assert (rows, tc_stage_rows(rows, n, m)) == (32, 32)
    if (n, m) == (160, 236):
        assert (rows, tc_stage_rows(rows, n, m)) == (32, 16)
