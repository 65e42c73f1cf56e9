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
#include <map>
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
constexpr int kNamed = 16;              // named barriers of a block
enum { kRun, kAtBlock, kAtWarp, kAtWarpgroup, kAtNamed, kDone };
struct Fiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  int state = kRun;
  int named = 0;         // the named barrier it waits at
  bool yielded = false;  // it gave way in an mbarrier wait
};
// An mbarrier: arrivals still expected in the current phase, the bytes of
// transactions still pending, and the phases completed.
struct Mbar {
  int expected = 0, pending = 0;
  long long tx = 0;
  unsigned phase = 0;
};
// A bulk copy in flight: it lands when the scheduler's sweep ends.
struct Copy {
  std::uint32_t dst;
  const void* src;
  unsigned bytes;
  std::uint32_t bar;
};
// A wgmma product issued and not yet waited for: d = A B (+ d if acc).
struct WgOp {
  float* d;
  int regs;
  std::uint64_t da, db;
  int acc;
};
// One thread block: its CUDA threads as fibers (user-level threads) that a
// scheduler on the calling OS thread runs in turn, each until it reaches a
// barrier, gives way in an mbarrier wait, or exits.  A barrier releases once
// every thread of the block (of the warp, of the warpgroup) that has not
// exited waits at it; a named barrier once its count of threads waits.
struct Block {
  int nt = 0, live = 0, at_block = 0;
  std::vector<Fiber> f;
  std::vector<int> warp_live, at_warp;
  std::vector<int> wg_live, at_wg;
  int at_named[kNamed] = {}, named_count[kNamed] = {};
  std::vector<int> xi;            // per-thread exchange slots (votes)
  std::vector<std::uint32_t> xw;  // per-thread exchange slots (shuffles)
  std::vector<std::uint64_t> xd;  // per-thread exchange slots (wgmma descriptors, 2 words)
  std::vector<unsigned char> dyn;
  std::map<std::uint32_t, Mbar> mbars;  // by shared address
  std::vector<Copy> copies;
  std::vector<std::vector<std::vector<WgOp>>> wg_groups;  // per thread: committed groups, then the open one
  long progress = 0;  // mbarrier arrivals and completed transactions
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

[[noreturn]] inline void die(const char* what) {
  std::fprintf(stderr, "emulated kernel fault: %s\n", what);
  std::abort();
}

// Park the running fiber at the block (kAtBlock), warp (kAtWarp) or
// warpgroup (kAtWarpgroup) barrier, or at named barrier `id`.
inline void park(int at, int id = 0) {
  Fiber& me = blk->f[ltid];
  me.state = at;
  // bar.sync 0 counts every thread of the block: one that has exited can
  // never arrive (a thread that runs no product still passes them all).
  if (at == kAtBlock && blk->live != blk->nt) die("__syncthreads() after a thread of the block exited");
  if (at == kAtBlock)
    ++blk->at_block;
  else if (at == kAtWarp)
    ++blk->at_warp[ltid / 32];
  else if (at == kAtWarpgroup)
    ++blk->at_wg[ltid / 128];
  else {
    me.named = id;
    ++blk->at_named[id];
  }
  swapcontext(&me.ctx, &blk->sched);
}

// Give way: the fiber stays runnable and the scheduler runs the others.
inline void yield() {
  Fiber& me = blk->f[ltid];
  me.yielded = true;
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
  for (size_t w = 0; w < b.at_wg.size(); ++w)
    if (b.at_wg[w] > 0 && b.at_wg[w] == b.wg_live[w]) {
      for (int t = 128 * static_cast<int>(w); t < std::min(b.nt, 128 * static_cast<int>(w) + 128); ++t)
        if (b.f[t].state == kAtWarpgroup) b.f[t].state = kRun;
      b.at_wg[w] = 0;
    }
  for (int id = 0; id < kNamed; ++id)
    if (b.at_named[id] > 0 && b.at_named[id] == b.named_count[id]) {
      for (auto& x : b.f)
        if (x.state == kAtNamed && x.named == id) x.state = kRun;
      b.at_named[id] = 0;
      b.named_count[id] = 0;
    }
}

inline Mbar& mbar_at(std::uint32_t a) {
  auto it = blk->mbars.find(a);
  if (it == blk->mbars.end()) die("mbarrier used before mbarrier.init");
  return it->second;
}
inline void mbar_settle(Mbar& m) {
  if (m.pending == 0 && m.tx == 0) {
    ++m.phase;
    m.pending = m.expected;
  }
}

// The bulk copies of the sweep land: their bytes, then their transactions.
inline void land_copies(Block& b) {
  for (const Copy& c : b.copies) {
    std::memcpy(b.dyn.data() + c.dst, c.src, c.bytes);
    Mbar& m = mbar_at(c.bar);
    m.tx -= c.bytes;
    mbar_settle(m);
    ++b.progress;
  }
  b.copies.clear();
}

inline void trampoline() {
  blk->body();
  Block& b = *blk;
  if (b.at_block > 0) die("a thread exited while others wait at __syncthreads()");
  b.f[ltid].state = kDone;
  --b.live;
  --b.warp_live[ltid / 32];
  --b.wg_live[ltid / 128];
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
        for (int w = 0; 128 * w < nt; ++w) {
          b.wg_live.push_back(static_cast<int>(std::min<long>(128, nt - 128 * w)));
          b.at_wg.push_back(0);
        }
        b.xi.assign(nt, 0);
        b.xw.assign(nt, 0);
        b.xd.assign(2 * nt, 0);
        b.wg_groups.assign(nt, std::vector<std::vector<WgOp>>(1));
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
          bool ran = false, moved = false;
          const long before = b.progress;
          for (int t = 0; t < b.nt; ++t) {
            if (b.f[t].state != kRun) continue;
            ran = true;
            ltid = t;
            tidx = uint3{static_cast<unsigned>(t % c.block.x),
                         static_cast<unsigned>((t / c.block.x) % c.block.y),
                         static_cast<unsigned>(t / (c.block.x * c.block.y))};
            b.f[t].yielded = false;
            swapcontext(&b.sched, &b.f[t].ctx);
            moved |= !b.f[t].yielded;
            release(b);
          }
          const bool landed = !b.copies.empty();
          land_copies(b);
          if (!ran) {
            std::fprintf(stderr, "emulated block deadlocked: no thread can run\n");
            std::abort();
          }
          if (!moved && !landed && b.progress == before) {
            std::fprintf(stderr, "emulated block deadlocked: every thread waits on an mbarrier\n");
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
// The kernels' device primitives of Hopper are the stand-ins below.
#define OCP_MMA_EMULATED 1
inline float emu_bf16(std::uint32_t h) {
  const std::uint32_t u = (h & 0xffffu) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// Hopper's asynchronous primitives (sm_90a), for csrc/shared_chunk_tc.cu.
// A shared address is the offset into the launch's dynamic shared memory.
inline std::uint32_t smem_addr(const void* p) {
  const unsigned char* b = emu::blk->dyn.data();
  const unsigned char* q = static_cast<const unsigned char*>(p);
  if (q < b || q >= b + emu::blk->dyn.size()) emu::die("shared address outside dynamic shared memory");
  return static_cast<std::uint32_t>(q - b);
}
// mbarrier.init / arrive / arrive.expect_tx / try_wait.parity: the phase
// completes when its arrivals and its transaction bytes are all in; a wait
// on a phase that has not completed gives way to the other threads.
inline void mbar_init(std::uint32_t a, unsigned count) {
  if (a % 8 != 0 || count < 1) emu::die("mbarrier.init: misaligned or no arrivals");
  emu::Mbar& m = emu::blk->mbars[a];
  m = emu::Mbar{static_cast<int>(count), static_cast<int>(count), 0, 0};
}
inline void fence_mbar_init() {}
inline void mbar_arrive(std::uint32_t a) {
  emu::Mbar& m = emu::mbar_at(a);
  --m.pending;
  emu::mbar_settle(m);
  ++emu::blk->progress;
}
inline void mbar_arrive_expect_tx(std::uint32_t a, unsigned bytes) {
  emu::Mbar& m = emu::mbar_at(a);
  m.tx += bytes;
  --m.pending;
  emu::mbar_settle(m);
  ++emu::blk->progress;
}
inline bool mbar_try_wait(std::uint32_t a, unsigned parity) {
  if ((emu::mbar_at(a).phase & 1u) != (parity & 1u)) return true;
  emu::yield();
  return false;
}
// cp.async.bulk global -> shared with complete_tx on the mbarrier: 16-byte
// aligned, a multiple of 16 bytes; lands when the scheduler's sweep ends.
inline void bulk_copy_g2s(std::uint32_t dst, const void* src, unsigned bytes, std::uint32_t bar) {
  if (dst % 16 != 0 || reinterpret_cast<std::uintptr_t>(src) % 16 != 0 || bytes % 16 != 0 || bytes == 0)
    emu::die("cp.async.bulk: address or size not a multiple of 16 bytes");
  if (dst + static_cast<size_t>(bytes) > emu::blk->dyn.size()) emu::die("cp.async.bulk: past shared memory");
  emu::mbar_at(bar);
  emu::blk->copies.push_back(emu::Copy{dst, src, bytes, bar});
}
inline void fence_proxy_async() {}
// bar.sync id, count: releases once `count` threads wait at it.
inline void named_sync(int id, int count) {
  emu::Block& b = *emu::blk;
  if (id < 0 || id >= emu::kNamed || count < 1 || count % 32 != 0) emu::die("bar.sync: bad barrier or count");
  if (b.named_count[id] != 0 && b.named_count[id] != count) emu::die("bar.sync: threads disagree on the count");
  b.named_count[id] = count;
  emu::park(emu::kAtNamed, id);
}
// The warpgroup's 128 threads at one point (wgmma's .sync.aligned).
inline void wg_sync() { emu::park(emu::kAtWarpgroup); }
// Element (row, k) of a K-major shared-memory matrix through a wgmma
// descriptor: start address bits 0-13, leading byte offset (between core
// matrices along k) bits 16-29, stride byte offset (between 8-row groups)
// bits 32-45, all in 16-byte units; base offset bits 49-51 and swizzle
// bits 62-63 must be 0 (no swizzle: core matrices of 8 rows x 16 bytes).
inline float wgmma_operand(std::uint64_t desc, int row, int k) {
  const size_t start = (desc & 0x3FFFu) << 4;
  const size_t lbo = ((desc >> 16) & 0x3FFFu) << 4;
  const size_t sbo = ((desc >> 32) & 0x3FFFu) << 4;
  if (((desc >> 49) & 7u) != 0 || ((desc >> 62) & 3u) != 0)
    emu::die("wgmma: swizzled layouts are not emulated (the kernel uses none)");
  const size_t off = start + (row >> 3) * sbo + (k >> 3) * lbo + (row & 7) * 16 + (k & 7) * 2;
  if (off + 2 > emu::blk->dyn.size()) emu::die("wgmma: operand past shared memory");
  std::uint16_t h;
  std::memcpy(&h, emu::blk->dyn.data() + off, 2);
  return emu_bf16(h);
}
// A waited-for product: this thread's accumulator registers (rows 16 w + g
// (+ 8) of A, columns 8 i + 2 t (+ 1) of B) get each k16 dot product, plus
// the register where the product accumulates (scale-d 1), summed exactly
// and rounded once to float32.
inline void wgmma_run(const emu::WgOp& op) {
  const int w = (emu::ltid >> 5) & 3, lane = emu::ltid & 31, g = lane >> 2, t = lane & 3;
  for (int e = 0; e < op.regs; ++e) {
    const int row = 16 * w + g + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + 2 * t + (e & 1);
    double acc = op.acc ? op.d[e] : 0.0;
    for (int k = 0; k < 16; ++k)
      acc += static_cast<double>(wgmma_operand(op.da, row, k)) * wgmma_operand(op.db, col, k);
    op.d[e] = static_cast<float>(acc);
  }
}
inline void wgmma_fence() { wg_sync(); }
inline void wgmma_commit() {
  wg_sync();
  emu::blk->wg_groups[emu::ltid].emplace_back();
}
// wgmma.wait_group N: the products of all but the N newest committed
// groups are carried out now (reading shared memory as it is now).
template <int N>
inline void wgmma_wait() {
  wg_sync();
  auto& gs = emu::blk->wg_groups[emu::ltid];
  while (static_cast<int>(gs.size()) - 1 > N) {
    for (const emu::WgOp& op : gs.front()) wgmma_run(op);
    gs.erase(gs.begin());
  }
}
// wgmma.mma_async m64nNk16 bf16 -> f32 (N = 2 regs), scale-d `acc`:
// warpgroup-collective, every thread must pass the same descriptors.
template <int L>
inline void wgmma_bf16(float (&d)[L], std::uint64_t da, std::uint64_t db, int acc) {
  static_assert(L == 8 || L == 16, "m64n16k16 or m64n32k16");
  emu::Block& b = *emu::blk;
  const int base = emu::ltid & ~127;
  if (b.wg_live[emu::ltid / 128] != 128) emu::die("wgmma: the warpgroup is not whole");
  b.xd[2 * emu::ltid] = da;
  b.xd[2 * emu::ltid + 1] = db;
  wg_sync();
  for (int i = 0; i < 128; ++i)
    if (b.xd[2 * (base + i)] != da || b.xd[2 * (base + i) + 1] != db)
      emu::die("wgmma: the warpgroup's threads disagree on a descriptor");
  wg_sync();
  b.wg_groups[emu::ltid].back().push_back(emu::WgOp{d, L, da, db, acc != 0});
}
// setmaxnreg.dec / .inc: warpgroup-collective; registers are not modelled.
template <int N>
inline void setmaxnreg_dec() {
  static_assert(N >= 24 && N <= 256 && N % 8 == 0, "setmaxnreg: 24..256, a multiple of 8");
  wg_sync();
}
template <int N>
inline void setmaxnreg_inc() {
  static_assert(N >= 24 && N <= 256 && N % 8 == 0, "setmaxnreg: 24..256, a multiple of 8");
  wg_sync();
}
// cvt.rn.bf16.f32: round to nearest even (a NaN gives a NaN: 0x7fc0 here).
inline unsigned bf16_bits(float v) {
  std::uint32_t u;
  std::memcpy(&u, &v, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
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
arrs = [None if a is None else np.ascontiguousarray(a) for a in spec["arrays"]]
ptrs = (ctypes.c_void_p * len(arrs))(*[None if a is None else a.ctypes.data for a in arrs])
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
    variants = {}  # name -> (source name, shipped text, variant text)

    def get(name):
        if name not in built:
            base, old, new = variants.get(name, (name, None, None))
            text = build.SOURCES[base].read_text()
            if old is not None:
                assert text.count(old) == 1, f"{old!r} is not in {base} exactly once"
                text = text.replace(old, new)
            src = root / f"{name}.cpp"
            src.write_text(_source_for_gxx(text))
            out = root / f"lib{name}.so"
            cmd = [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fno-strict-aliasing", "-fPIC", "-shared",
                   "-pthread", "-w", "-I", str(inc), "-I", str(build.SOURCES[base].parent),
                   "-o", str(out), str(src)]
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            assert res.returncode == 0, res.stderr[-4000:]
            built[name] = out
        return built[name]

    def variant(name, base, old, new):
        """Register ``name``: source ``base`` with ``old`` replaced by ``new``."""
        variants[name] = (base, old, new)
        return name

    get.root = root
    get.variant = variant
    return get


def _run_entry(emu_lib, lib_name, symbol, tensors, ints, floats):
    """Run a C entry point in a child process on CPU tensors; the tensors
    get the arrays the kernel left (outputs and scratch)."""
    root = emu_lib.root
    spec_path = root / f"spec_{os.getpid()}.pkl"
    out_path = root / f"out_{os.getpid()}.pkl"
    # numpy has no bfloat16: such tensors travel as their int16 bits; None
    # as a null pointer.
    bits = [t.view(torch.int16) if t is not None and t.dtype == torch.bfloat16 else t
            for t in tensors]
    arrays = [None if t is None else t.detach().numpy() for t in bits]
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
    for t, a in zip(bits, got["arrays"]):
        if t is not None:
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
# pads to 48, the x and z products' to 48, their output columns to 64 (one
# m64 tile: the second warpgroup idles); n=232, m=12: the x product's 232
# output columns are four m64 tiles (two a warpgroup), zt's K = 232 pads to
# 240; n=120, m=196 (the main path): 128 and 256 output columns, K = 208 and
# 128.  Variations: one forced iteration (check_every 1), a forced budget
# of 10 iterations, converging, four termination groups with one done at
# entry (at B=96 and 16 rows each group is a block of 16 and a ragged block
# of 8), a NaN scenario, a ragged last block (B=40 in blocks of 32).
TC_CASES = [
    (16, 40, 36, 16, "high", "one"),
    (32, 40, 36, 32, "mixed", "one"),
    (16, 40, 36, 16, "mixed", "forced"),
    (32, 40, 36, 32, "high", "converging"),
    (64, 40, 36, 16, "high", "groups"),
    (16, 40, 36, 16, "high", "nan"),
    (16, 40, 36, 16, "mixed", "nan"),
    (32, 232, 12, 32, "high", "one"),
    (40, 40, 36, 32, "high", "ragged"),
    (96, 40, 36, 16, "mixed", "groups"),
    (32, 120, 196, 32, "high", "one"),
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


def tc_case(B, n, m, mode, variation):
    """``(args, kw)`` of a tensor-core case: the fused driver's first chunk
    of a random shared QP batch, varied as ``TC_CASES`` says."""
    args, kw = shared_chunk_case(B, n, m)
    args = list(args)
    kw = {**kw, "iter_precision": mode}
    if variation == "one":
        kw = {**kw, "eps_abs": 0.0, "eps_rel": 0.0, "check_every": 1}
        args[1] = 1
    elif variation in ("forced", "ragged"):
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
    return args, kw


def run_tc(args, kw, rows):
    """The tensor-core form through the wrapper's launch path (emulated)."""
    run_kw = {k: v for k, v in kw.items() if k != "iter_precision"}
    B_, n_, m_, bound, done0, cinv = sk._contract(
        *args[:11], args[11], *args[12:], kw["check_every"], kw["batch_tile"])
    return sk._launch_tc(done0, bound, *args[2:11], cinv, *args[12:], rows, **run_kw,
                         iter_precision=kw["iter_precision"])


@pytest.mark.parametrize("B,n,m,rows,mode,variation", TC_CASES,
                         ids=[f"B{c[0]}-n{c[1]}-m{c[2]}-rows{c[3]}-{c[4]}-{c[5]}" for c in TC_CASES])
def test_shared_chunk_tc_emulated_matches_plain(emulate, B, n, m, rows, mode, variation):
    args, kw = tc_case(B, n, m, mode, variation)
    out_p = sk.shared_admm_chunk_plain(*args, **kw)
    out_k = run_tc(args, kw, rows)
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


def tc_variant_launch(emu_lib, monkeypatch, lib):
    """Route the tensor-core form's launches to the emulated library
    ``lib``; returns the entry points' return codes."""
    rcs = []

    def fake_launch(label, lib_name, symbol, tensors, ints, floats, dev):
        assert lib_name == "shared_chunk_tc"
        rcs.append(_run_entry(emu_lib, lib, symbol, tensors, ints, floats))
        if rcs[-1] != 0:
            raise RuntimeError(f"{label} launch failed: cudaError {rcs[-1]}")

    monkeypatch.setattr(sk, "launch_chunk", fake_launch)
    return rcs


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


@pytest.mark.parametrize("K,J", [(196, 120), (120, 196), (37, 300), (12, 232)])
def test_tc_pack_kernel_matches_tc_operator_slices(emu_lib, K, J):
    """The entry point's packing kernel lays an operator out bit for bit as
    its plain version ``tc_operator_slices`` does: the main path's Ab
    (196 x 120) and Ab^T, an operator of two passes (300 output columns:
    256 and 64), and one whose k pads from 12 to 16."""
    w = torch.as_tensor(np.random.default_rng(K + J).normal(size=(K, J)), dtype=torch.float32)
    w[0, 0] = float("nan")
    want = sk.tc_operator_slices(w)
    out = torch.zeros_like(want)
    rc = _run_entry(emu_lib, "shared_chunk_tc", "ocp_shared_tc_pack_f32", [w, out], (K, J), ())
    assert rc == 0
    # A NaN's bits are not specified (torch's CPU conversion gives 0xffff
    # here, the emulated cvt.rn 0x7fc0): NaN where NaN, every other half
    # bitwise.
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(out), nan) and bool(nan.any())
    assert torch.equal(out.view(torch.int16)[~nan], want.view(torch.int16)[~nan])


@pytest.fixture(scope="module")
def tc_layout(emu_lib):
    """The C entry point's ``ocp_shared_tc_layout``: ``(rows, n, m, mode) ->
    (ring slots, slot bytes, FP32 slice rows, shared memory bytes)`` or
    ``None`` where the block does not fit."""
    fn = ctypes.CDLL(str(emu_lib("shared_chunk_tc"))).ocp_shared_tc_layout
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]

    def get(rows, n, m, mode):
        out = (ctypes.c_longlong * 4)()
        return tuple(out) if fn(rows, n, m, mode, out) == 0 else None

    return get


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
