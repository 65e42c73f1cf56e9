// Shared-operator ADMM chunk for Hopper (sm_90a), tensor-core form:
// iter_precision "high" and "mixed".
//
// Replaces the TPU kernel
//   optimal_control_problem_tpu/ops/shared_kernel.py::shared_admm_chunk
// (the Pallas `_kernel` there) at its iteration precisions "high" and
// "mixed" (:149-150).  Contract: optimal_control_problem_tpu_torch/ops/
// shared_kernel.py::shared_admm_chunk_plain with the same iter_precision.
// The FP32 form ("highest") is csrc/shared_chunk.cu; both include
// csrc/shared_chunk_common.cuh, so the FP32 chains this form keeps (the
// residual products of every check, and zt at "mixed") are that form's.
//
// Arithmetic.  The JAX kernel runs the iteration products at
// Precision.HIGH, the TPU's bf16_3x: each f32 operand split into
// hi = bf16(a) and lo = bf16(a - hi), the product hi hi + (hi lo + lo hi)
// with f32 sums.  Here the three products of an iteration (two at
// "mixed": zt stays an FP32 chain) run on the tensor cores, bf16 in, f32
// accumulated, with two accumulators, hi hi and hi lo + lo hi, added in
// the epilogue.  Tensor cores sum in their own order, so this form agrees
// with its plain version to f32 roundoff of the products, not bitwise.
//
// Bound on this card: operations.  At n=120, m=196, B=4096 and 25
// iterations a call the bf16_3x products are 37.7 GFLOP (38 us at the
// dense bf16 peak) and the FP32 chains of one check 0.76 GFLOP (11 us at
// the f32 peak); the panels are ~7 MB.  The time goes elsewhere: an
// iteration is a chain of three products, each a sequence of small k16
// slices (29 an iteration) and an elementwise epilogue, on two warpgroups
// an SM; per-slice latency and the epilogues' instruction latency take
// most of a launch (PERF.md; the clock64 probes of tools/kernel_ablation.py).
//
// Design.
// * The operators are packed once per call (pack_slices_kernel, whose
//   plain version is ops/shared_kernel.py::tc_operator_slices), by the
//   entry point before the chunk's launches: each 16-deep k-slice of a
//   split operator, across its output columns (at most 256: wider
//   operators are cut into passes of 256), is one contiguous run, hi then
//   lo, in the layout the product instruction reads from shared memory
//   (8 x 16-byte core matrices, K-major, no swizzle).
// * A ring of kRingStages (5) slots in shared memory holds the slices.  A
//   producer warpgroup (one lane issues) brings each slice with one bulk
//   copy (cp.async.bulk, TMA) that completes on the slot's `full`
//   mbarrier; the eight consumer warps wait on `full`, and each releases
//   the slot on its `empty` mbarrier when its products no longer read it.
//   The producer streams every product of the launch's check block back
//   to back, so the next product's slices are in flight while the last
//   one's epilogue runs.  Consumers never wait on a global load of the
//   operator.  The producer is a whole warpgroup because registers are
//   allocated by warpgroup: a ninth warp alone capped every thread at 168
//   registers (65,536 / 384) and spilled the epilogues; as a warpgroup it
//   gives registers back (setmaxnreg, 40) and the consumers run with 232.
//   Thread 0 of a consumer warp as the producer instead stalled its
//   warpgroup's collective products on every refill (PERF.md).
// * Products with the operator as the wide side: out^T = W^T panel^T.
//   wgmma.mma_async m64nNk16 (N = the block's 16 or 32 scenarios): A is a
//   64-column tile of the operator slice, B the block's split panel, both
//   from shared memory through matrix descriptors.  The output columns
//   are padded to 64s (128 at n=120, 256 at m=196) and spread over the two
//   warpgroups, each running a constant number of tiles a pass (a
//   branch between the asynchronous products made ptxas serialise them).
//   (mma.sync m16n8k16 on the same staged slices was slower: PERF.md.)
// * The epilogues load what they read (qb, rho, lb, ub from global
//   memory; x, z, y from shared memory) for eight elements before updating
//   any, so that their loads and arithmetic overlap: with two consumer
//   warps a scheduler, one element's chain after another left the
//   epilogues at 41% of a launch (the clock64 probes of
//   tools/kernel_ablation.py).
// * The split is fused: each product's epilogue writes the bf16 hi / lo
//   copy of the operand the next product reads (rhs -> xt -> rho z - y ->
//   rhs), into the split panel that every product reads.  Two consumer
//   barriers a product: one before its epilogue overwrites the split panel
//   (all reads done), one after (writes visible to the next product).
// * No cluster multicast yet: every block reads each slice from L2 once an
//   iteration.  The producer counts those bytes (Args::l2_bytes).
//
// Termination group, launches and votes: as csrc/shared_chunk.cu (one
// launch per check block, the group's vote through global memory).

#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 8;                      // consumer warps: two warpgroups
constexpr int kThreads = kWarps * 32;          // the threads that run products
constexpr int kBlockThreads = kThreads + 128;  // and the producer warpgroup
constexpr int kProducerRegs = 40;   // setmaxnreg: the producer warpgroup gives registers up
constexpr int kConsumerRegs = 232;  // ... to the consumers (128 x 40 + 256 x 232 <= 65,536)
constexpr int kMaxCols = 7;     // FP32 chains: columns per lane and pass
constexpr int kStages = 3;      // FP32 chains: operator slices in flight
constexpr int kRingStages = 5;  // tensor-core operator slices in flight (the ring)
constexpr int kEpiChunk = 8;    // epilogue elements loaded before any is updated
constexpr int kPassCols = 256;  // output columns a pass: four m64 tiles, two a warpgroup
constexpr unsigned kCoreLbo = 128;  // bytes between the k halves of a core-matrix pair
constexpr long long kSmemLimit = 232448;  // dynamic shared memory a block may opt into
constexpr int kNumPtrs = 29;

}  // namespace

#include "shared_chunk_common.cuh"

namespace {

struct Args {
  const int* done0;   // (B,) 1 = enters converged or certified
  const float* OP;    // (n, n)
  const float* Ab;    // (m, n)
  const float* AbT;   // (n, m)
  const float* Pb;    // (n, n)
  const float* rho;   // (m,)
  const float* lb;    // (B, m)
  const float* ub;    // (B, m)
  const float* qb;    // (B, n)
  const float* dinv;  // (n,)
  const float* einv;  // (m,)
  const float* cinv;  // (1,)
  const float* x0;    // (B, n)
  const float* z0;    // (B, m)
  const float* y0;    // (B, m)
  float* x;
  float* z;
  float* y;
  int* conv;    // (B,)
  int* it_inc;  // (B,)
  float* rp;
  float* rd;
  float* rpr;
  float* rdr;
  int* votes;  // (groups, n_checks): the group's blocks that held an unconverged scenario
  // The operators as tc_operator_slices packs them (bf16 hi / lo).
  const uint8_t* s_ab;   // Ab   (K = m, J = n): the rhs product
  const uint8_t* s_op;   // OP   (K = n, J = n): the x product
  const uint8_t* s_abt;  // Ab^T (K = n, J = m): zt at "high" (not read at "mixed")
  unsigned long long* l2_bytes;  // += the bytes this launch's bulk copies brought
};

struct Dims {
  int B, n, m, tile, bpg, bound, check_every, n_checks, groups;
  int ks;           // FP32 chains' slice rows (0: the operators are read through L1)
  int stages;       // ring slots
  int stage_bytes;  // bytes of a ring slot
  int kpn, kpm;     // n, m padded to 16: the products' contraction
  int jpn, jpm;     // n, m padded to 64: the products' output columns
  int off_ring, off_split, off_panels, off_fstage;  // byte offsets in dynamic shared memory
  float sigma, alpha, one_m_alpha, eps_abs, eps_rel;
};

// The device primitives of Hopper this kernel uses.  (The CPU emulation of
// tests/test_torch_kernel_emulation.py defines OCP_MMA_EMULATED and its own
// stand-ins.)
#ifndef OCP_MMA_EMULATED
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Has the phase of parity `parity` completed?
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, unsigned parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// `bytes` from global memory to shared memory; completes on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src, unsigned bytes,
                                              uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// Orders this thread's shared-memory writes before reads of the async
// proxy (wgmma operands) that follow a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Round to nearest even bf16 bits (cvt.rn; a NaN gives a NaN, whose bits
// need not be torch's).
__device__ __forceinline__ unsigned bf16_bits(float v) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(h) : "f"(v));
  return h;
}
// The warpgroup's registers per thread, lowered or raised (.sync.aligned).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
// Named barrier `id` over `count` threads.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// d = A B + (acc ? d : 0) for the warpgroup: A (64 x 16 bf16) and B
// (16 x N bf16) in shared memory through the descriptors, d the 64 x N f32
// accumulator
// (thread: warp w of the group, lane l, g = l / 4, t = l % 4 holds rows
// 16 w + g (+ 8) at columns 8 i + 2 t (+ 1), register 4 i + 2 (row half)
// + column parity), as mma.sync's D fragments side by side.
__device__ __forceinline__ void wgmma_bf16(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, "
      "1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}
#endif

// Barrier 1 over the kThreads consumer threads (the producer warpgroup is not in it).
__device__ __forceinline__ void consumer_sync() { named_sync(1, kThreads); }

// Keeps the compiler from touching accumulator registers across a wgmma
// wait (the asynchronous product writes them).
template <int L>
__device__ __forceinline__ void fence_regs(float (&d)[L]) {
#ifndef OCP_MMA_EMULATED
#pragma unroll
  for (int i = 0; i < L; ++i) asm volatile("" : "+f"(d[i])::"memory");
#endif
}

// A shared-memory matrix descriptor: no swizzle, K-major core matrices of
// 8 rows x 16 bytes; lbo the bytes between the two k halves of a k16 step,
// sbo those between 8-row groups.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, unsigned lbo, unsigned sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFFu) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFFu) >> 4) << 32);
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// The split panel: row r (scenario), column k of an operand of Kp columns,
// as halves of K-major core matrices (8 rows x 8 columns, 128 bytes; the
// Kp / 8 of a row group side by side).
__device__ __forceinline__ int split_at(int Kp, int r, int k) {
  return ((r >> 3) * (Kp >> 3) + (k >> 3)) * 64 + (r & 7) * 8 + (k & 7);
}
__device__ __forceinline__ void put_split(unsigned short* hi, unsigned short* lo, int Kp, int r,
                                          int k, float v) {
  const int o = split_at(Kp, r, k);
  const unsigned h = bf16_bits(v);
  hi[o] = static_cast<unsigned short>(h);
  lo[o] = static_cast<unsigned short>(bf16_bits(v - __int_as_float(static_cast<int>(h << 16))));
}

// The operator W (K, J), row-major, as tc_operator_slices packs it: bf16
// hi / lo halves, K padded to 16 and J to 64, passes of kPassCols output
// columns, k16 slices of core matrices (A[j, k] = W[k, j]).  One thread a
// half, grid-stride.
__global__ void __launch_bounds__(256) pack_slices_kernel(const float* __restrict__ W, int K,
                                                          int J, uint16_t* __restrict__ out) {
  const int Kp = (K + 15) / 16 * 16, Jp = (J + 63) / 64 * 64, S = Kp / 16;
  const long long total = 2LL * Kp * Jp;
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < total; e += 256LL * gridDim.x) {
    const int p = static_cast<int>(e / (S * 32LL * kPassCols));
    const int Wp = Jp - p * kPassCols < kPassCols ? Jp - p * kPassCols : kPassCols;
    const int rem = static_cast<int>(e - p * (S * 32LL * kPassCols));
    const int s = rem / (32 * Wp), in_slice = rem - s * 32 * Wp;
    const int part = in_slice / (16 * Wp), c = in_slice - part * 16 * Wp;
    const int G = c >> 7, half = (c >> 6) & 1, r = (c >> 3) & 7, kk = c & 7;
    const int j = p * kPassCols + G * 8 + r, k = s * 16 + half * 8 + kk;
    const float v = (k < K && j < J) ? W[static_cast<size_t>(k) * J + j] : 0.0f;
    const unsigned h = bf16_bits(v);
    out[e] = static_cast<uint16_t>(
        part == 0 ? h : bf16_bits(v - __int_as_float(static_cast<int>(h << 16))));
  }
}

cudaError_t pack_slices(const float* W, int K, int J, uint8_t* out, cudaStream_t stream) {
  const long long total = 2LL * ((K + 15) / 16 * 16) * ((J + 63) / 64 * 64);
  const long long blocks = (total + 255) / 256;
  pack_slices_kernel<<<static_cast<int>(blocks < 128 ? blocks : 128), 256, 0, stream>>>(
      W, K, J, reinterpret_cast<uint16_t*>(out));
  return cudaGetLastError();
}

// A product's shape: contraction Kp (a multiple of 16), output columns J
// (Jp: padded to 64), cut into passes of kPassCols columns.
__device__ __forceinline__ int n_passes(int Jp) { return (Jp + kPassCols - 1) / kPassCols; }
__device__ __forceinline__ int pass_cols(int Jp, int p) {
  return Jp - p * kPassCols < kPassCols ? Jp - p * kPassCols : kPassCols;
}

// The ring and the launch's stream of operator slices: every k16 slice of
// the iteration's tensor-core products (the rhs product's Ab, the x
// product's OP, at "high" zt's Ab^T; each pass by pass), check_every
// times.  The consumers walk the stream (`next`); the producer issues it
// (`issued`), one bulk copy a slice.
struct Ring {
  uint32_t base;   // shared address of slot 0
  uint32_t bars;   // full[kRingStages], then empty[kRingStages]
  int stages, stage_bytes;
  int next;        // the next slice to consume
  const uint8_t* src[3];  // the products' packed operators
  int S[3], Jp[3];        // their k16 slices and padded output columns
  int nprod, per_iter, total;
  int issued;             // the producer: slices issued
  unsigned long long bytes;  // the producer: bytes those copies bring
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (kRingStages + s); }
  // The producer: issue every slice before `limit` (at most `total`); a
  // slot is refilled once its last slice was released by every consumer warp.
  __device__ void top_up(int limit) {
    if (limit > total) limit = total;
    for (; issued < limit; ++issued) {
      const int st = issued % stages;
      if (issued >= stages) mbar_wait(empty(st), ((issued / stages) - 1) & 1);
      int q = issued % per_iter, k = 0;
      while (q >= n_passes(Jp[k]) * S[k]) q -= n_passes(Jp[k]) * S[k++];
      const int p = q / S[k], s = q - p * S[k];
      const unsigned nb = 64u * pass_cols(Jp[k], p);
      const uint8_t* from =
          src[k] + static_cast<size_t>(p) * S[k] * (64 * kPassCols) + static_cast<size_t>(s) * nb;
      mbar_arrive_expect_tx(full(st), nb);
      bulk_copy_g2s(base + st * stage_bytes, from, nb, full(st));
      bytes += nb;
    }
  }
};

// out[r, j] = (panel W)[r, j] at bf16_3x for the block's R = 8 TR rows, by
// the kThreads consumer threads: the panel is the split panel (hi, lo; Kp
// columns), W comes through the ring.  A warpgroup runs TW m64 tiles of
// each pass (its tiles wg, wg + 2; a tile past the pass's columns reads
// whatever lies there and is dropped), with two accumulators a tile, hi hi
// and hi lo + lo hi; an element is their sum.  TW is a constant so that no
// branch sits between the asynchronous products and their registers.  The
// epilogue of an element (j < J): load(r, j, t) reads what it needs from
// global and shared memory, for eight elements before any is updated (so
// their loads and arithmetic overlap), then apply(r, j, v, t) writes the
// iterates and returns the next product's operand at (r, j); it is split
// into the split panel (Kn columns, zero for J <= j < Kn) where
// `split_next`.  For passes before the last one (J > kPassCols) apply
// keeps the operand in `next_panel` (R x J) and the split is made after
// the last pass.  Ends with the consumer barrier that makes the split
// panel visible.
template <int TR, int TW, class Load, class Apply>
__device__ __forceinline__ void tc_product(Ring& ring, unsigned short* shi, unsigned short* slo,
                                           int Kp, int J, int Jp, bool split_next, int Kn,
                                           const float* next_panel, Load load, Apply apply) {
  constexpr int R = kWarps * TR;
  constexpr int NA = R / 2;  // accumulator registers of a thread per m64 tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, q = warp & 3, g8 = lane >> 2, t4 = lane & 3;
  const uint32_t hi_b = smem_addr(shi), lo_b = smem_addr(slo);
  const unsigned sbo_b = static_cast<unsigned>(Kp) * 16;  // bytes of a row group of the panel
  const int S = Kp >> 4;
  const int P = n_passes(Jp);
  for (int p = 0; p < P; ++p) {
    const int W = pass_cols(Jp, p);
    float big[TW][NA], small[TW][NA];
    int held = -1;  // the slot whose products may still be reading
    for (int s = 0; s < S; ++s) {
      const int g = ring.next++;
      const int st = g % ring.stages;
      mbar_wait(ring.full(st), (g / ring.stages) & 1);
      const uint32_t slot = ring.base + st * ring.stage_bytes;
#pragma unroll
      for (int u = 0; u < TW; ++u) {
        fence_regs(big[u]);
        fence_regs(small[u]);
      }
      wgmma_fence();
      const uint64_t db_hi = smem_desc(hi_b + s * 256, kCoreLbo, sbo_b);
      const uint64_t db_lo = smem_desc(lo_b + s * 256, kCoreLbo, sbo_b);
      const int acc = s > 0;  // the first slice writes the accumulators
#pragma unroll
      for (int u = 0; u < TW; ++u) {
        const uint32_t a_hi = slot + (wg + 2 * u) * 2048, a_lo = a_hi + W * 32;
        const uint64_t da_hi = smem_desc(a_hi, kCoreLbo, 256);
        const uint64_t da_lo = smem_desc(a_lo, kCoreLbo, 256);
        wgmma_bf16(big[u], da_hi, db_hi, acc);
        wgmma_bf16(small[u], da_hi, db_lo, acc);
        wgmma_bf16(small[u], da_lo, db_hi, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the last slice's products are done
#pragma unroll
      for (int u = 0; u < TW; ++u) {
        fence_regs(big[u]);
        fence_regs(small[u]);
      }
      if (held >= 0 && lane == 0) mbar_arrive(ring.empty(held));
      held = st;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int u = 0; u < TW; ++u) {
      fence_regs(big[u]);
      fence_regs(small[u]);
    }
    if (held >= 0 && lane == 0) mbar_arrive(ring.empty(held));
    const bool last = p == P - 1;
    if (last) consumer_sync();  // nobody reads the split panel any more
#pragma unroll
    for (int u = 0; u < TW; ++u) {
      constexpr int CH = kEpiChunk < NA ? kEpiChunk : NA;
#pragma unroll
      for (int c = 0; c < NA; c += CH) {
        auto col = [&](int e) {
          return p * kPassCols + (wg + 2 * u) * 64 + q * 16 + g8 + 8 * ((e >> 1) & 1);
        };
        auto row = [&](int e) { return 8 * (e >> 2) + 2 * t4 + (e & 1); };
        float t[CH][5];
#pragma unroll
        for (int e = c; e < c + CH; ++e)
          if (col(e) < J) load(row(e), col(e), t[e - c]);
#pragma unroll
        for (int e = c; e < c + CH; ++e) {
          const int j = col(e), r = row(e);
          const float nv = j < J ? apply(r, j, big[u][e] + small[u][e], t[e - c]) : 0.0f;
          if (last && split_next && j < Kn) put_split(shi, slo, Kn, r, j, nv);
        }
      }
    }
  }
  if (split_next && P > 1) {  // the columns of the earlier passes
    const int cols = (P - 1) * kPassCols;
    for (int idx = threadIdx.x; idx < R * cols; idx += kThreads) {
      const int r = idx / cols, j = idx - r * cols;
      put_split(shi, slo, Kn, r, j, next_panel[r * J + j]);
    }
  }
  fence_proxy_async();
  consumer_sync();
}

// tc_product with the tiles a warpgroup runs in a pass of Jp columns: one
// where a pass has two m64 tiles or fewer, else two.
template <int TR, class Load, class Apply>
__device__ __forceinline__ void tc_product_any(Ring& ring, unsigned short* shi,
                                               unsigned short* slo, int Kp, int J, int Jp,
                                               bool split_next, int Kn, const float* next_panel,
                                               Load load, Apply apply) {
  if (Jp <= 128)
    tc_product<TR, 1>(ring, shi, slo, Kp, J, Jp, split_next, Kn, next_panel, load, apply);
  else
    tc_product<TR, 2>(ring, shi, slo, Kp, J, Jp, split_next, Kn, next_panel, load, apply);
}

// kMode: 1 "high" (all three iteration products on the tensor cores), 2
// "mixed" (zt an FP32 chain).
template <int TR, int kMode>
__global__ void __launch_bounds__(kBlockThreads, 1)
    shared_chunk_tc_kernel(Args a, Dims d, int chk) {
  constexpr int R = kWarps * TR;
  static_assert(R == 16 || R == 32, "the products take 16 or 32 scenarios");
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const int n = d.n, m = d.m;
  const int kpmax = d.kpn > d.kpm ? d.kpn : d.kpm;
  unsigned short* const shi = reinterpret_cast<unsigned short*>(smem_raw + d.off_split);
  unsigned short* const slo = shi + R * kpmax;
  float* sx = reinterpret_cast<float*>(smem_raw + d.off_panels);  // (R, n) x
  float* sz = sx + R * n;     // (R, m) z
  float* sy = sz + R * m;     // (R, m) y
  float* sw = sy + R * m;     // (R, m) rho z - y
  float* srhs = sw + R * m;   // (R, n) rhs; Px during a check
  float* sxt = srhs + R * n;  // (R, n) xt
  // The FP32 chains' slices: the ring's slots at "high" (idle by the
  // check), a region of their own at "mixed" (zt runs beside the ring).
  float* fstage = reinterpret_cast<float*>(smem_raw + d.off_fstage);
  const int ks = d.ks;
  __shared__ int s_conv[R];
  __shared__ float s_rp[R], s_rd[R], s_rpr[R], s_rdr[R];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = blockIdx.x / d.bpg;
  const int bi = blockIdx.x % d.bpg;
  const int row_base = g * d.tile + bi * R;
  const int nrows = min(R, d.tile - bi * R);
  // Rows past the block's last scenario repeat it (same arithmetic, same
  // vote) and are never written back.
  auto grow = [&](int r) { return row_base + min(r, nrows - 1); };

  // Is the group open at this check?  As csrc/shared_chunk.cu.
  bool open;
  if (chk == 0) {
    int undone = 0;
    for (int i = tid; i < d.tile; i += kBlockThreads) undone |= (a.done0[g * d.tile + i] != 1);
    open = __syncthreads_or(undone) != 0 && d.bound > 0;
  } else {
    open = *(a.votes + g * d.n_checks + chk - 1) > 0;
  }
  if (!open) {
    if (chk == 0) {
      for (int idx = tid; idx < nrows * n; idx += kBlockThreads) {
        const size_t o = static_cast<size_t>(row_base) * n + idx;
        a.x[o] = a.x0[o];
      }
      for (int idx = tid; idx < nrows * m; idx += kBlockThreads) {
        const size_t o = static_cast<size_t>(row_base) * m + idx;
        a.z[o] = a.z0[o];
        a.y[o] = a.y0[o];
      }
      if (tid < nrows) {
        const int o = row_base + tid;
        a.conv[o] = a.done0[o];
        a.it_inc[o] = 0;
        a.rp[o] = a.rd[o] = a.rpr[o] = a.rdr[o] = CUDART_INF_F;
      }
    }
    return;  // uniform across the block
  }

  Ring ring;
  ring.base = smem_addr(smem_raw + d.off_ring);
  ring.bars = smem_addr(smem_raw);
  ring.stages = d.stages;
  ring.stage_bytes = d.stage_bytes;
  ring.next = 0;
  ring.src[0] = a.s_ab;
  ring.src[1] = a.s_op;
  ring.src[2] = a.s_abt;
  ring.S[0] = d.kpm >> 4;
  ring.S[1] = ring.S[2] = d.kpn >> 4;
  ring.Jp[0] = ring.Jp[1] = d.jpn;
  ring.Jp[2] = d.jpm;
  ring.nprod = kMode == 1 ? 3 : 2;
  ring.per_iter = 0;
  for (int k = 0; k < ring.nprod; ++k) ring.per_iter += n_passes(ring.Jp[k]) * ring.S[k];
  ring.total = d.check_every * ring.per_iter;
  ring.issued = 0;
  ring.bytes = 0;
  if (tid == 0) {
    for (int s = 0; s < d.stages; ++s) {
      mbar_init(ring.full(s), 1);        // the producer's arrive (and the copy's bytes)
      mbar_init(ring.empty(s), kWarps);  // one arrive per consumer warp
    }
    fence_mbar_init();
  }

  // The iterates: the inputs at the first check, the last check's after;
  // the first product's operand rho z - y split into the split panel.
  const float* const xin = chk == 0 ? a.x0 : a.x;
  const float* const zin = chk == 0 ? a.z0 : a.z;
  const float* const yin = chk == 0 ? a.y0 : a.y;
  for (int idx = tid; idx < R * n; idx += kBlockThreads) {
    const int r = idx / n, j = idx - r * n;
    sx[idx] = xin[static_cast<size_t>(grow(r)) * n + j];
  }
  for (int idx = tid; idx < R * d.kpm; idx += kBlockThreads) {
    const int r = idx / d.kpm, j = idx - r * d.kpm;
    float wv = 0.0f;
    if (j < m) {
      const size_t src = static_cast<size_t>(grow(r)) * m + j;
      const float zv = zin[src], yv = yin[src];
      sz[r * m + j] = zv;
      sy[r * m + j] = yv;
      wv = __ldg(a.rho + j) * zv - yv;
      sw[r * m + j] = wv;
    }
    put_split(shi, slo, d.kpm, r, j, wv);
  }
  fence_proxy_async();
  __syncthreads();

  if (warp >= kWarps) {
    // The producer warpgroup: its first lane streams every slice of the
    // check block through the ring; the group then passes the barriers of
    // the FP32 chains and of the vote with the consumers, which it does not
    // run (panel_product_syncs).
    setmaxnreg_dec<kProducerRegs>();
    const bool issuer = tid == kThreads;
    if (kMode == 1) {
      if (issuer) ring.top_up(ring.total);
    } else {
      const int zt_syncs = panel_product_syncs(n, m, ks);
      for (int t = 0; t < d.check_every; ++t) {
        // This iteration's slices and the next one's first, then zt's barriers.
        if (issuer) ring.top_up((t + 1) * ring.per_iter + ring.stages);
        __syncwarp();
        for (int i = 0; i < zt_syncs; ++i) __syncthreads();
      }
    }
    __syncwarp();
    const int check_syncs = panel_product_syncs(n, m, ks) + panel_product_syncs(n, n, ks) +
                            panel_product_syncs(m, n, ks);
    for (int i = 0; i < check_syncs; ++i) __syncthreads();
    (void)__syncthreads_and(1);
    if (issuer && a.l2_bytes != nullptr) atomicAdd(a.l2_bytes, ring.bytes);
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const float sigma = d.sigma, alpha = d.alpha, oma = d.one_m_alpha;
  const float ci = __ldg(a.cinv);
  {
    // Each epilogue: what it reads from global memory (load), then the
    // update (apply), which returns the next product's operand.
    // rhs = sigma x - qb + (rho z - y) @ Ab; returns rhs (the x product's operand)
    auto rhs_load = [&](int r, int j, float (&t)[5]) {
      t[0] = __ldg(a.qb + static_cast<size_t>(grow(r)) * n + j);
      t[1] = sx[r * n + j];
    };
    auto rhs_apply = [&](int r, int j, float v, const float (&t)[5]) {
      const float rv = (sigma * t[1] - t[0]) + v;
      srhs[r * n + j] = rv;
      return rv;
    };
    // xt = rhs @ OP;  x = alpha xt + (1 - alpha) x; returns xt (zt's operand)
    auto x_load = [&](int r, int j, float (&t)[5]) { t[0] = sx[r * n + j]; };
    auto x_apply = [&](int r, int j, float v, const float (&t)[5]) {
      sxt[r * n + j] = v;
      sx[r * n + j] = alpha * v + oma * t[0];
      return v;
    };
    // zt = xt @ Ab^T;  relaxation, projection onto [lb, ub], dual update;
    // returns rho z - y (the next rhs product's operand)
    auto z_load = [&](int r, int j, float (&t)[5]) {
      const size_t gi = static_cast<size_t>(grow(r)) * m + j;
      t[0] = __ldg(a.rho + j);
      t[1] = __ldg(a.lb + gi);
      t[2] = __ldg(a.ub + gi);
      t[3] = sz[r * m + j];
      t[4] = sy[r * m + j];
    };
    auto z_apply = [&](int r, int j, float v, const float (&t)[5]) {
      const float rho = t[0];
      const float zo = t[3], yo = t[4];
      const float z_rel = alpha * v + oma * zo;
      const float z_n = clip_nan(z_rel + div_rn(yo, rho), t[1], t[2]);
      const float y_n = yo + rho * (z_rel - z_n);
      sz[r * m + j] = z_n;
      sy[r * m + j] = y_n;
      const float w = rho * z_n - y_n;
      sw[r * m + j] = w;
      return w;
    };
    for (int t = 0; t < d.check_every; ++t) {
      tc_product_any<TR>(ring, shi, slo, d.kpm, n, d.jpn, true, d.kpn, srhs, rhs_load, rhs_apply);
      tc_product_any<TR>(ring, shi, slo, d.kpn, n, d.jpn, kMode == 1, d.kpn, sxt, x_load,
                         x_apply);
      if constexpr (kMode == 1) {
        tc_product_any<TR>(ring, shi, slo, d.kpn, m, d.jpm, true, d.kpm, sw, z_load, z_apply);
      } else {
        panel_product<TR>(sxt, a.AbT, n, m, fstage, ks, [&](int, int r, int j, float v) {
          float t[5];
          z_load(r, j, t);
          put_split(shi, slo, d.kpm, r, j, z_apply(r, j, v, t));
        });
        for (int idx = tid; idx < R * (d.kpm - m); idx += kThreads) {
          const int r = idx / (d.kpm - m);
          put_split(shi, slo, d.kpm, r, m + idx - r * (d.kpm - m), 0.0f);
        }
        fence_proxy_async();
        consumer_sync();
      }
    }
    residual_check<TR>(a, d, chk, g, n, m, sx, sz, sy, srhs, fstage, ks, ci, grow, s_conv, s_rp,
                       s_rd, s_rpr, s_rdr);
  }

  for (int idx = tid; idx < nrows * n; idx += kThreads) {
    const int r = idx / n, j = idx - r * n;
    a.x[static_cast<size_t>(row_base + r) * n + j] = sx[r * n + j];
  }
  for (int idx = tid; idx < nrows * m; idx += kThreads) {
    const int r = idx / m, j = idx - r * m;
    const size_t dst = static_cast<size_t>(row_base + r) * m + j;
    a.z[dst] = sz[r * m + j];
    a.y[dst] = sy[r * m + j];
  }
  if (tid < nrows) {
    const int o = row_base + tid;
    a.conv[o] = s_conv[tid];
    a.it_inc[o] = (chk + 1) * d.check_every;
    a.rp[o] = s_rp[tid];
    a.rd[o] = s_rd[tid];
    a.rpr[o] = s_rpr[tid];
    a.rdr[o] = s_rdr[tid];
  }
}

constexpr int pad_to(int v, int k) { return (v + k - 1) / k * k; }
constexpr long long kStaticBytes(int R) { return 5LL * R * 4; }  // s_conv, s_rp, ... (static)

// Where everything lives in a block's dynamic shared memory: the ring's
// mbarriers (128 bytes), the ring, the split panel (hi, lo), the six
// panels, at "mixed" the FP32 chains' slices.  The ring takes the most
// slots up to kRingStages (at least 2) that fit beside the panels; then
// the FP32 chains' slice rows ks (32, 16, 8 or 4; 0: through L1) are the
// most that fit in the ring ("high") or beside it ("mixed").
struct Layout {
  int stages, stage_bytes, ks;
  long long off_ring, off_split, off_panels, off_fstage, bytes;
};

bool tc_layout(int R, int n, int m, int mode, Layout& L) {
  if (n < 1 || m < 1 || (mode != 1 && mode != 2) || (R != 16 && R != 32)) return false;
  const int J = n > m ? n : m;
  const int kpmax = pad_to(n, 16) > pad_to(m, 16) ? pad_to(n, 16) : pad_to(m, 16);
  const int jpn = pad_to(n, 64), jpm = pad_to(m, 64);
  const int widest = mode == 1 && jpm > jpn ? jpm : jpn;
  L.stage_bytes = 64 * (widest < kPassCols ? widest : kPassCols);
  const long long split = pad_to(R * kpmax * 4, 128);
  const long long panels = pad_to(R * (3 * n + 3 * m) * 4, 128);
  for (int st = kRingStages; st >= 2; --st) {
    L.off_ring = 128;
    L.off_split = L.off_ring + static_cast<long long>(st) * L.stage_bytes;
    L.off_panels = L.off_split + split;
    const long long end = L.off_panels + panels;
    if (end + kStaticBytes(R) > kSmemLimit) continue;
    L.stages = st;
    L.ks = 0;
    L.off_fstage = mode == 1 ? L.off_ring : end;
    const long long room =
        mode == 1 ? static_cast<long long>(st) * L.stage_bytes : kSmemLimit - kStaticBytes(R) - end;
    if (J % 4 == 0)
      for (int ks = 32; ks >= 4; ks /= 2)
        if (3LL * ks * J * 4 <= room) {
          L.ks = ks;
          break;
        }
    L.bytes = mode == 1 ? end : end + 3LL * L.ks * J * 4;
    return true;
  }
  return false;
}

template <int TR, int kMode>
cudaError_t launch_checks(const Args& a, Dims d, cudaStream_t stream) {
  constexpr int R = kWarps * TR;
  Layout L;
  if (!tc_layout(R, d.n, d.m, kMode, L)) return cudaErrorInvalidValue;
  d.bpg = (d.tile + R - 1) / R;
  d.ks = L.ks;
  d.stages = L.stages;
  d.stage_bytes = L.stage_bytes;
  d.kpn = pad_to(d.n, 16);
  d.kpm = pad_to(d.m, 16);
  d.jpn = pad_to(d.n, 64);
  d.jpm = pad_to(d.m, 64);
  d.off_ring = static_cast<int>(L.off_ring);
  d.off_split = static_cast<int>(L.off_split);
  d.off_panels = static_cast<int>(L.off_panels);
  d.off_fstage = static_cast<int>(L.off_fstage);
  // cp.async copies 16 bytes from 16-byte aligned operators only; bulk
  // copies need 16-byte aligned slices.
  for (const float* op : {a.OP, a.Ab, a.AbT, a.Pb})
    if (reinterpret_cast<size_t>(op) % 16 != 0) d.ks = 0;
  for (const uint8_t* s : {a.s_ab, a.s_op, a.s_abt})
    if (s == nullptr || reinterpret_cast<size_t>(s) % 16 != 0) return cudaErrorInvalidValue;
  const dim3 grid(d.groups * d.bpg);
  const size_t smem = static_cast<size_t>(L.bytes);
  cudaError_t e = cudaFuncSetAttribute(shared_chunk_tc_kernel<TR, kMode>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  for (int c = 0; c < d.n_checks; ++c) {
    shared_chunk_tc_kernel<TR, kMode><<<grid, kBlockThreads, smem, stream>>>(a, d, c);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The layout tc_layout gives a block of `rows` scenarios (16 or 32) at
// (n, m) in `mode` (1 "high", 2 "mixed"): out = {ring slots, bytes of a
// slot, FP32 slice rows, dynamic shared memory bytes}.  Returns 0, or -1
// where the block does not fit.
int ocp_shared_tc_layout(int rows, int n, int m, int mode, long long* out) {
  Layout L;
  if (!tc_layout(rows, n, m, mode, L)) return -1;
  out[0] = L.stages;
  out[1] = L.stage_bytes;
  out[2] = L.ks;
  out[3] = L.bytes;
  return 0;
}

// ptrs: the kNumPtrs device pointers in Args order (the FP32 form's 25,
// then room for the packed Ab, OP and Ab^T slices, 4 Kp Jp bytes each,
// which this fills, and the byte counter, which may be null); `rows` 16
// or 32 scenarios per thread block; `mode` 1 ("high") or 2 ("mixed").
// Enqueues the packing (one small launch per operator) and n_checks
// launches of 288 threads on `stream` and returns their cudaError_t
// (cudaErrorInvalidValue for sizes the kernel does not take); nothing is
// synchronised.
int ocp_shared_admm_chunk_tc_f32(const void* const* ptrs, int nptrs, int B, int n, int m,
                                 int tile, int rows, int bound, int check_every, int n_checks,
                                 int mode, double sigma, double alpha, double eps_abs,
                                 double eps_rel, void* stream) {
  static_assert(sizeof(Args) == kNumPtrs * sizeof(void*), "Args layout");
  if (nptrs != kNumPtrs || B < 1 || n < 1 || m < 1 || tile < 1 || B % tile != 0 ||
      check_every < 1 || n_checks < 1 || static_cast<long long>(n_checks) * check_every < bound ||
      (mode != 1 && mode != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  memcpy(&a, ptrs, sizeof(Args));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The operators' slices, packed on the stream before the launches read
  // them (Ab^T only at "high"; at "mixed" s_abt may alias another).
  if (rows != 16 && rows != 32) return static_cast<int>(cudaErrorInvalidValue);
  for (const uint8_t* p : {a.s_ab, a.s_op, a.s_abt})
    if (p == nullptr || reinterpret_cast<size_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = pack_slices(a.Ab, m, n, const_cast<uint8_t*>(a.s_ab), s);
  if (e == cudaSuccess) e = pack_slices(a.OP, n, n, const_cast<uint8_t*>(a.s_op), s);
  if (e == cudaSuccess && mode == 1) e = pack_slices(a.AbT, n, m, const_cast<uint8_t*>(a.s_abt), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  Dims d;
  memset(&d, 0, sizeof(Dims));
  d.B = B;
  d.n = n;
  d.m = m;
  d.tile = tile;
  d.bound = bound;
  d.check_every = check_every;
  d.n_checks = n_checks;
  d.groups = B / tile;
  d.sigma = static_cast<float>(sigma);
  d.alpha = static_cast<float>(alpha);
  d.one_m_alpha = static_cast<float>(1.0 - alpha);
  d.eps_abs = static_cast<float>(eps_abs);
  d.eps_rel = static_cast<float>(eps_rel);
  e = cudaErrorInvalidValue;
  if (mode == 1)
    e = rows == 4 * kWarps   ? launch_checks<4, 1>(a, d, s)
        : rows == 2 * kWarps ? launch_checks<2, 1>(a, d, s)
                             : cudaErrorInvalidValue;
  else if (mode == 2)
    e = rows == 4 * kWarps   ? launch_checks<4, 2>(a, d, s)
        : rows == 2 * kWarps ? launch_checks<2, 2>(a, d, s)
                             : cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// The packing alone, for its tests: ptrs = {W (K, J) f32, out (4 Kp Jp
// bytes)}.
int ocp_shared_tc_pack_f32(const void* const* ptrs, int nptrs, int K, int J, void* stream) {
  if (nptrs != 2 || K < 1 || J < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(pack_slices(static_cast<const float*>(ptrs[0]), K, J,
                                      static_cast<uint8_t*>(const_cast<void*>(ptrs[1])),
                                      static_cast<cudaStream_t>(stream)));
}

const char* ocp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
