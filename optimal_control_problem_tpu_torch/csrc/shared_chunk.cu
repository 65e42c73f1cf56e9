// Fused shared-operator ADMM chunk for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel
//   optimal_control_problem_tpu/ops/shared_kernel.py::shared_admm_chunk
// (the Pallas `_kernel` there).  Contract and op order are those of
//   optimal_control_problem_tpu_torch/ops/shared_kernel.py::shared_admm_chunk_plain:
// one rho-constant condensed OSQP-ADMM chunk for a batch of QPs that share
// the operators OP (n, n), Ab (m, n), Pb (n, n) and rho (m,).  Panels are
// batch-leading, (B, n) and (B, m), row-major.
//
// Work split.  A thread block owns R = 8, 16 or 32 consecutive scenarios
// (template parameter: TR rows for each of its 8 warps; the wrapper picks
// R, ops/shared_kernel.py::shared_block_rows) and keeps their iterates x,
// z, y and the three intermediates of an iteration in shared memory for
// the whole chunk.  The six panel products (three per iteration, three
// per termination check) are computed here, by hand: a warp owns TR rows,
// a lane owns columns lane, lane + 32, ... of the whole product width (C
// of them, a template parameter: 4 at n=120, 7 at m=196, so a product
// runs in one pass), and every output element is one accumulator in a
// register that runs the contraction index upwards from zero with one
// multiply and one add per term (build with -fmad=false), the plain
// version's order, so the two agree bitwise.  No split-K: the chain of an
// element stays in one thread.  The elementwise relaxation, projection and
// dual update run in the products' epilogues.
//
// Operator staging.  The shared operators (OP, Ab, Ab^T, Pb: 303 KB at
// n=120, m=196) do not fit in shared memory together, and read through
// L1 from L2 they left each k step waiting on a load.  So each product
// streams its operator through shared memory in slices of KS rows
// (KS = 32, 16, 8 or 4, the most that fits beside the panels: 32 at R=32,
// n=120, m=196), three slices in flight: cp.async copies the slice two
// ahead while the block computes on the current one, one barrier a slice.
// Every warp reads the slice's rows, a lane its own columns (no bank
// conflicts).  Where not even 4 rows fit beside the panels the operator is
// read through L1 as before (KS = 0).
//
// Termination group.  `tile` consecutive scenarios vote together: the
// group runs whole check blocks while k < bound and not all of its
// scenarios have converged; nobody freezes.  A group spans several thread
// blocks (up to JAX's tile, 6,536 scenarios at n=120, m=196: 205 blocks of
// 32), so its vote crosses them.  Each launch runs ONE check block for
// every group that is still open, and the launcher enqueues one launch per
// check block of the chunk's budget: a block of launch c reads its group's
// vote of check c - 1 from global memory (`votes`, zeroed by the wrapper:
// per group and check, the number of its thread blocks that still hold an
// unconverged scenario) and either runs the check block or returns at
// once.  The stream orders the launches, so no block waits on another and
// any grid size runs, however many scenarios the card holds resident at
// once (~4,200 at n=120, m=196).  Why launches and not one persistent
// cooperative grid that walks several panels per block between grid-wide
// votes: that grid must also park the panels it is not running in global
// memory, and adds a spin per check and the residency bookkeeping; here a
// block's iterates wait in the output panels between launches (~65 KB for
// 32 scenarios at n=120, m=196, against ~25 iterations of work), and a
// closed group's launches cost one vote read per block.  The per-scenario
// arithmetic is that of one launch per chunk, so the kernel stays bitwise
// equal to the plain version.  Nothing is read on the host.
//
// Bound on this card: operations.  At n=120, m=196 an iteration is 122,880
// float operations per scenario against ~3 KB of panel traffic per chunk.
// With -fmad=false every term is a multiply and an add, two instructions,
// so under the bitwise contract the kernel can reach at most half the
// card's float32 peak (which counts a fused multiply-add as two).
//
// Tensor-core form (iter_precision "high" / "mixed", template kPrec 1 / 2).
// The JAX kernel runs those iteration products at Precision.HIGH, the
// TPU's bf16_3x: each f32 operand split into hi = bf16(a) and lo =
// bf16(a - hi), the product hi hi + hi lo + lo hi with f32 accumulation.
// Here they run on the tensor cores, mma.sync m16n8k16 bf16 -> f32 (one
// device function, mma_bf16_16816).  The operators come split and in
// B-fragment order from the wrapper (ops/shared_kernel.py::mma_fragments,
// once per call: Ab for the rhs product, OP for the x product, Ab^T for zt
// at "high"; one 16-byte load gives a lane its hi and lo registers).  The
// panel operand of each such product is split per iteration into bf16 hi
// and lo copies in shared memory, its width zero-padded to a multiple of
// 16 (n=120 -> 128, m=196 -> 208) and the row stride 8 more, so the eight
// row groups of a fragment load fall on distinct banks.  A block holds 16
// or 32 scenarios (one or two m16 tiles); warp w takes the n8 column tiles
// w, w + 8, ... for every m tile and keeps two accumulators per tile, hi hi
// and hi lo + lo hi, added in the epilogue (the plain version's two sums).
// "mixed" runs zt, and both forms run every residual product, as the FP32
// chains above: a scenario that stops is certified in true f32.  Tensor
// cores sum in their own order, so this form agrees with its plain version
// to f32 roundoff of the products, not bitwise; kPrec 0 is untouched.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

namespace {

// Warps per block.  16 (half the scenario rows a warp, each operator word
// read from shared memory serving half as many) is slower on an H100
// (tools/kernel_ablation.py, PERF.md).
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCols = 7;  // columns per lane and pass: 224 columns per pass
constexpr int kStages = 3;   // operator slices in flight
constexpr long long kSmemLimit = 232448;  // dynamic shared memory a block may opt into
constexpr int kNumPtrs = 25;    // the FP32 form's pointers
constexpr int kNumPtrsTc = 28;  // and the tensor-core form's three fragment arrays

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
  // Tensor-core form only: bf16 hi/lo B fragments (mma_fragments), each
  // (J / 8, K / 16, 32, 4) words.
  const uint4* f_ab;   // Ab  (K = m, J = n): the rhs product
  const uint4* f_op;   // OP  (K = n, J = n): the x product
  const uint4* f_abt;  // Ab^T (K = n, J = m): zt at "high"
};

struct Dims {
  int B, n, m, tile, bpg, bound, check_every, n_checks, groups;
  int ks;  // operator slice rows (0: the operators are read through L1)
  int kpn, kpm, sstride;  // tensor-core form: n and m padded to 16, split row stride
  float sigma, alpha, one_m_alpha, eps_abs, eps_rel;
};

// Round to nearest even bf16 bits, NaN as 0x7fc0: torch's float -> bfloat16.
__device__ __forceinline__ unsigned bf16_rn(float f) {
  const unsigned u = static_cast<unsigned>(__float_as_int(f));
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

// d += a b for one warp: A 16x16 bf16 (row), B 16x8 bf16 (col), f32 D.
// Lane l (g = l / 4, t = l % 4) holds A rows g, g + 8 at columns 2t, 2t + 1
// (a[0], a[1]) and 2t + 8, 2t + 9 (a[2], a[3]); B column g at rows 2t,
// 2t + 1 (b[0]) and 2t + 8, 2t + 9 (b[1]); D rows g (d[0], d[1]) and g + 8
// (d[2], d[3]) at columns 2t, 2t + 1; the lower index in the low half.
#ifndef OCP_MMA_EMULATED
__device__ __forceinline__ void mma_bf16_16816(float d[4], const unsigned a[4],
                                               const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

// The block's R rows of `a` (shared memory, row stride K) as bf16 hi and
// lo (row stride S halves), columns K .. Kp - 1 zero.
template <int R>
__device__ __forceinline__ void split_panel(const float* a, int K, int Kp, int S,
                                            unsigned short* hi, unsigned short* lo) {
  for (int idx = threadIdx.x; idx < R * Kp; idx += kThreads) {
    const int r = idx / Kp, k = idx - r * Kp;
    const float v = k < K ? a[r * K + k] : 0.0f;
    const unsigned h = bf16_rn(v);
    hi[r * S + k] = static_cast<unsigned short>(h);
    lo[r * S + k] = static_cast<unsigned short>(bf16_rn(v - __int_as_float(static_cast<int>(h << 16))));
  }
}

// out[r, j] = (a W)[r, j] at bf16_3x for the block's rows: `hi`/`lo` the
// split panel (row stride S, Kp columns), `frag` W's fragments; calls
// epi(0, r, j, value) once per element with j < J.
template <int TR, class Epi>
__device__ __forceinline__ void tc_product(const unsigned short* hi, const unsigned short* lo,
                                           int S, int Kp, const uint4* __restrict__ frag, int J,
                                           Epi epi) {
  constexpr int MT = kWarps * TR / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Jt = (J + 7) >> 3, Kt = Kp >> 4;
  for (int nt = warp; nt < Jt; nt += kWarps) {
    float big[MT][4], small[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[mt][e] = small[mt][e] = 0.0f;
    const uint4* f = frag + static_cast<size_t>(nt) * Kt * 32 + lane;
    for (int kt = 0; kt < Kt; ++kt) {
      const uint4 w = __ldg(f + kt * 32);
      const unsigned bh[2] = {w.x, w.y}, bl[2] = {w.z, w.w};
      const int c = kt * 16 + 2 * t;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = mt * 16 + g;
        unsigned ah[4], al[4];
        const int o[4] = {r * S + c, (r + 8) * S + c, r * S + c + 8, (r + 8) * S + c + 8};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[e] = *reinterpret_cast<const unsigned*>(hi + o[e]);
          al[e] = *reinterpret_cast<const unsigned*>(lo + o[e]);
        }
        mma_bf16_16816(small[mt], ah, bl);
        mma_bf16_16816(small[mt], al, bh);
        mma_bf16_16816(big[mt], ah, bh);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mt * 16 + g + 8 * (e >> 1), j = nt * 8 + 2 * t + (e & 1);
        if (j < J) epi(0, r, j, big[mt][e] + small[mt][e]);
      }
  }
}

// out[r, j] = sum_k a[r, k] * W[k, j] for the block's rows; `a` in shared
// memory with row stride K, W (K, J) row-major in global memory, streamed
// through `stage` in slices of ks rows (ks = 0: read through L1).  Calls
// epi(i, r, j, value) once per element from the thread that owns it: rows
// r = warp * TR + i, columns lane + 32 c of each (32 C)-column pass.
template <int TR, int C, class Epi>
__device__ __forceinline__ void panel_product_c(const float* __restrict__ a,
                                                const float* __restrict__ W, int K, int J,
                                                float* stage, int ks, Epi epi) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * TR;
  for (int j0 = 0; j0 < J; j0 += 32 * C) {
    int col[C];
    int ld[C];  // clamped: a lane past the edge loads a valid column it drops
#pragma unroll
    for (int c = 0; c < C; ++c) {
      col[c] = j0 + lane + 32 * c;
      ld[c] = col[c] < J ? col[c] : J - 1;
    }
    float acc[TR][C];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;
    // Terms k0 .. k0 + rows - 1 of every chain, the operator's rows read
    // from ws (row stride J, row 0 = operator row k0).
    auto mac = [&](const float* ws, bool global, int k0, int rows) {
#pragma unroll 8
      for (int k = 0; k < rows; ++k) {
        const float* wrow = ws + static_cast<size_t>(k) * J;
        float w[C];
#pragma unroll
        for (int c = 0; c < C; ++c) w[c] = global ? __ldg(wrow + ld[c]) : wrow[ld[c]];
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float av = a[(r0 + i) * K + k0 + k];
#pragma unroll
          for (int c = 0; c < C; ++c) acc[i][c] = acc[i][c] + av * w[c];
        }
      }
    };
    if (ks == 0) {
      mac(W, true, 0, K);
    } else {
      const int S = (K + ks - 1) / ks;
      __syncthreads();  // nobody still reads the slices of the last product
      // Slice s (operator rows [s ks, s ks + ks) clipped to K) into buffer
      // s % kStages, 16 bytes per copy (J % 4 == 0 where ks > 0); one
      // commit group per slice, empty past the last.
      auto issue = [&](int s) {
        if (s < S) {
          const int k0 = s * ks, rows = K - k0 < ks ? K - k0 : ks;
          float* const dst = stage + (s % kStages) * ks * J;
          const float* const src = W + static_cast<size_t>(k0) * J;
          for (int q = threadIdx.x; q < rows * J / 4; q += kThreads)
            __pipeline_memcpy_async(dst + 4 * q, src + 4 * q, 16);
        }
        __pipeline_commit();
      };
      issue(0);
      issue(1);
      for (int s = 0; s < S; ++s) {
        __pipeline_wait_prior(1);  // slice s has landed (s + 1 may be in flight)
        __syncthreads();           // ... for every thread; slice s - 1 is free
        issue(s + 2);
        const int k0 = s * ks, rows = K - k0 < ks ? K - k0 : ks;
        mac(stage + (s % kStages) * ks * J, false, k0, rows);
      }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (col[c] < J) epi(i, r0 + i, col[c], acc[i][c]);
  }
}

// The pass width that covers J in one pass where it can.
template <int TR, class Epi>
__device__ __forceinline__ void panel_product(const float* __restrict__ a,
                                              const float* __restrict__ W, int K, int J,
                                              float* stage, int ks, Epi epi) {
  if (J <= 32)
    panel_product_c<TR, 1>(a, W, K, J, stage, ks, epi);
  else if (J <= 64)
    panel_product_c<TR, 2>(a, W, K, J, stage, ks, epi);
  else if (J <= 128)
    panel_product_c<TR, 4>(a, W, K, J, stage, ks, epi);
  else
    panel_product_c<TR, kMaxCols>(a, W, K, J, stage, ks, epi);
}

// x / y, correctly rounded, bitwise the IEEE quotient.  A zero dividend
// (the Gauss-Jordan rows' eliminated and not yet filled entries, inactive
// duals) sends the division's fast path to its slow fallback; its result is
// a zero whose sign is the XOR of the operands' signs wherever y is neither
// zero nor NaN, so that case is answered directly.
__device__ __forceinline__ float div_rn(float x, float y) {
  if (x == 0.f && y != 0.f && y == y)
    return __int_as_float((__float_as_int(x) ^ __float_as_int(y)) & 0x80000000);
  return x / y;
}

// NaN-propagating max (torch.amax / torch.maximum semantics; fmaxf would
// drop a NaN, and a diverged scenario's residual with it).
__device__ __forceinline__ float nmax(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// min(max(v, lo), hi) as torch.minimum(torch.maximum(...)) computes it: a
// NaN v stays NaN (fmaxf / fminf alone would clip it to a bound).  The
// bounds are never NaN.
__device__ __forceinline__ float clip_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// kPrec: 0 FP32 chains everywhere ("highest"); 1 ("high") and 2 ("mixed")
// the tensor-core form.
template <int TR, int kPrec>
__global__ void __launch_bounds__(kThreads) shared_chunk_kernel(Args a, Dims d, int chk) {
  constexpr int R = kWarps * TR;
  static_assert(kPrec == 0 || R % 16 == 0, "the tensor-core form takes whole m16 tiles");
  extern __shared__ float smem[];
  const int n = d.n, m = d.m;
  float* sx = smem;           // (R, n) x
  float* sz = sx + R * n;     // (R, m) z
  float* sy = sz + R * m;     // (R, m) y
  float* sw = sy + R * m;     // (R, m) rho z - y
  float* srhs = sw + R * m;   // (R, n) rhs; Px during a check
  float* sxt = srhs + R * n;  // (R, n) xt
  // Tensor-core form: the split panel, hi then lo, (R, sstride) halves each.
  unsigned short* const shi = reinterpret_cast<unsigned short*>(sxt + R * n);
  unsigned short* const slo = shi + (kPrec ? R * d.sstride : 0);
  float* stage = sxt + R * n + (kPrec ? R * d.sstride : 0);  // [kStages][ks][max(n, m)] operator slices
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

  // Is the group open at this check?  At the first, unless all of its
  // scenarios enter done (then it returns its inputs); later, if some
  // block of the group held an unconverged scenario at the last check.
  bool open;
  if (chk == 0) {
    int undone = 0;
    for (int i = tid; i < d.tile; i += kThreads) undone |= (a.done0[g * d.tile + i] != 1);
    open = __syncthreads_or(undone) != 0 && d.bound > 0;
  } else {
    open = *(a.votes + g * d.n_checks + chk - 1) > 0;
  }
  if (!open) {
    if (chk == 0) {
      for (int idx = tid; idx < nrows * n; idx += kThreads) {
        const size_t o = static_cast<size_t>(row_base) * n + idx;
        a.x[o] = a.x0[o];
      }
      for (int idx = tid; idx < nrows * m; idx += kThreads) {
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

  // The iterates: the inputs at the first check, the last check's after.
  const float* const xin = chk == 0 ? a.x0 : a.x;
  const float* const zin = chk == 0 ? a.z0 : a.z;
  const float* const yin = chk == 0 ? a.y0 : a.y;
  for (int idx = tid; idx < R * n; idx += kThreads) {
    const int r = idx / n, j = idx - r * n;
    sx[idx] = xin[static_cast<size_t>(grow(r)) * n + j];
  }
  for (int idx = tid; idx < R * m; idx += kThreads) {
    const int r = idx / m, j = idx - r * m;
    const size_t src = static_cast<size_t>(grow(r)) * m + j;
    const float zv = zin[src], yv = yin[src];
    sz[idx] = zv;
    sy[idx] = yv;
    sw[idx] = __ldg(a.rho + j) * zv - yv;
  }
  __syncthreads();

  const float sigma = d.sigma, alpha = d.alpha, oma = d.one_m_alpha;
  const float ci = __ldg(a.cinv);
  {
    // rhs = sigma x - qb + (rho z - y) @ Ab
    auto rhs_epi = [&](int, int r, int j, float v) {
      const float qv = __ldg(a.qb + static_cast<size_t>(grow(r)) * n + j);
      srhs[r * n + j] = (sigma * sx[r * n + j] - qv) + v;
    };
    // xt = rhs @ OP;  x = alpha xt + (1 - alpha) x
    auto x_epi = [&](int, int r, int j, float v) {
      sxt[r * n + j] = v;
      sx[r * n + j] = alpha * v + oma * sx[r * n + j];
    };
    // zt = xt @ Ab^T;  relaxation, projection onto [lb, ub], dual update
    auto z_epi = [&](int, int r, int j, float v) {
      const size_t gi = static_cast<size_t>(grow(r)) * m + j;
      const float rho = __ldg(a.rho + j);
      const float zo = sz[r * m + j], yo = sy[r * m + j];
      const float z_rel = alpha * v + oma * zo;
      const float z_n = clip_nan(z_rel + div_rn(yo, rho), __ldg(a.lb + gi), __ldg(a.ub + gi));
      const float y_n = yo + rho * (z_rel - z_n);
      sz[r * m + j] = z_n;
      sy[r * m + j] = y_n;
      sw[r * m + j] = rho * z_n - y_n;
    };
    for (int t = 0; t < d.check_every; ++t) {
      if constexpr (kPrec == 0) {
        panel_product<TR>(sw, a.Ab, m, n, stage, ks, rhs_epi);
        __syncthreads();
        panel_product<TR>(srhs, a.OP, n, n, stage, ks, x_epi);
        __syncthreads();
        panel_product<TR>(sxt, a.AbT, n, m, stage, ks, z_epi);
      } else {
        const int S = d.sstride;
        split_panel<R>(sw, m, d.kpm, S, shi, slo);
        __syncthreads();
        tc_product<TR>(shi, slo, S, d.kpm, a.f_ab, n, rhs_epi);
        __syncthreads();
        split_panel<R>(srhs, n, d.kpn, S, shi, slo);
        __syncthreads();
        tc_product<TR>(shi, slo, S, d.kpn, a.f_op, n, x_epi);
        __syncthreads();
        if constexpr (kPrec == 1) {
          split_panel<R>(sxt, n, d.kpn, S, shi, slo);
          __syncthreads();
          tc_product<TR>(shi, slo, S, d.kpn, a.f_abt, m, z_epi);
        } else {
          panel_product<TR>(sxt, a.AbT, n, m, stage, ks, z_epi);
        }
      }
      __syncthreads();
    }

    // Unscaled residuals.  A warp owns whole rows, so a row's maxima are
    // the warp's reduction of its lanes' maxima (max is exact: any order).
    float m_rp[TR], m_ax[TR], m_z[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) m_rp[i] = m_ax[i] = m_z[i] = 0.0f;
    panel_product<TR>(sx, a.AbT, n, m, stage, ks, [&](int i, int r, int j, float ax) {
      const float e = __ldg(a.einv + j);
      const float zv = sz[r * m + j];
      m_rp[i] = nmax(m_rp[i], fabsf((ax - zv) * e));
      m_ax[i] = nmax(m_ax[i], fabsf(ax * e));
      m_z[i] = nmax(m_z[i], fabsf(zv * e));
    });
    // Px lands in the slot of srhs that the same thread reads back below
    // (both products are n wide, so the element's owner is the same).
    panel_product<TR>(sx, a.Pb, n, n, stage, ks, [&](int, int r, int j, float px) { srhs[r * n + j] = px; });
    float m_rd[TR], m_aty[TR], m_px[TR], m_q[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) m_rd[i] = m_aty[i] = m_px[i] = m_q[i] = 0.0f;
    panel_product<TR>(sy, a.Ab, m, n, stage, ks, [&](int i, int r, int j, float aty) {
      const float dv = __ldg(a.dinv + j);
      const float px = srhs[r * n + j];
      const float qv = __ldg(a.qb + static_cast<size_t>(grow(r)) * n + j);
      m_rd[i] = nmax(m_rd[i], fabsf(((px + qv) + aty) * dv));
      m_aty[i] = nmax(m_aty[i], fabsf(aty * dv));
      m_px[i] = nmax(m_px[i], fabsf(px * dv));
      m_q[i] = nmax(m_q[i], fabsf(qv * dv));
    });
    int mine = 1;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float r_prim = warp_max(m_rp[i]);
      const float max_prim = nmax(warp_max(m_ax[i]), warp_max(m_z[i]));
      const float r_dual = ci * warp_max(m_rd[i]);
      const float max_dual =
          ci * nmax(nmax(warp_max(m_aty[i]), warp_max(m_px[i])), warp_max(m_q[i]));
      const float eps_pri = d.eps_abs + d.eps_rel * max_prim;
      const float eps_dua = d.eps_abs + d.eps_rel * max_dual;
      const int cv = (r_prim <= eps_pri) && (r_dual <= eps_dua);
      mine &= cv;
      if (lane == 0) {
        const int r = warp * TR + i;
        s_conv[r] = cv;
        s_rp[r] = r_prim;
        s_rd[r] = r_dual;
        // torch.clamp(., min=1e-12) keeps a NaN.
        s_rpr[r] = r_prim / (max_prim != max_prim ? max_prim : fmaxf(max_prim, 1e-12f));
        s_rdr[r] = r_dual / (max_dual != max_dual ? max_dual : fmaxf(max_dual, 1e-12f));
      }
    }
    // The block's vote: every scenario of it converged or not.  (Also the
    // barrier between this check's reads and the write-back below.)
    const int block_all = __syncthreads_and(mine);
    if (tid == 0 && !block_all) atomicAdd(a.votes + g * d.n_checks + chk, 1);
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

constexpr int pad16(int v) { return (v + 15) / 16 * 16; }
// Halves per row of the tensor-core form's split panel (each of hi, lo):
// the widest product operand padded to 16, and 8 more.
int split_stride(int n, int m) { return (pad16(n) > pad16(m) ? pad16(n) : pad16(m)) + 8; }

// Shared memory of a block of R scenarios with ks-row operator slices:
// the six panels, the tensor-core form's split panel (tc), kStages
// slices, the per-row results (static).
long long smem_floats(int R, int n, int m, int ks, bool tc) {
  const int J = n > m ? n : m;
  return static_cast<long long>(R) * (3 * n + 3 * m + (tc ? split_stride(n, m) : 0)) +
         static_cast<long long>(kStages) * ks * J;
}
constexpr int kStaticFloats(int R) { return 5 * R; }

// The most slice rows that fit beside the panels of R scenarios (32, 16, 8
// or 4; 0: read the operators through L1; -1: not even the panels fit).
int stage_rows(int R, int n, int m, bool tc) {
  const int J = n > m ? n : m;
  if ((smem_floats(R, n, m, 0, tc) + kStaticFloats(R)) * 4 > kSmemLimit) return -1;
  if (J % 4 == 0)
    for (int ks = 32; ks >= 4; ks /= 2)
      if ((smem_floats(R, n, m, ks, tc) + kStaticFloats(R)) * 4 <= kSmemLimit) return ks;
  return 0;
}

// One launch per check block of the chunk's budget, on `stream`.
template <int TR, int kPrec>
cudaError_t launch_checks(const Args& a, Dims d, cudaStream_t stream) {
  constexpr int R = kWarps * TR;
  constexpr bool tc = kPrec != 0;
  d.bpg = (d.tile + R - 1) / R;
  d.ks = stage_rows(R, d.n, d.m, tc);
  if (d.ks < 0) return cudaErrorInvalidValue;
  // cp.async copies 16 bytes from 16-byte aligned operators only.
  for (const float* op : {a.OP, a.Ab, a.AbT, a.Pb})
    if (reinterpret_cast<size_t>(op) % 16 != 0) d.ks = 0;
  if (tc) {
    for (const uint4* f : {a.f_ab, a.f_op, a.f_abt})
      if (f == nullptr || reinterpret_cast<size_t>(f) % 16 != 0) return cudaErrorInvalidValue;
    d.kpn = pad16(d.n);
    d.kpm = pad16(d.m);
    d.sstride = split_stride(d.n, d.m);
  }
  const dim3 grid(d.groups * d.bpg);
  const size_t smem = static_cast<size_t>(smem_floats(R, d.n, d.m, d.ks, tc)) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(shared_chunk_kernel<TR, kPrec>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  for (int c = 0; c < d.n_checks; ++c) {
    shared_chunk_kernel<TR, kPrec><<<grid, kThreads, smem, stream>>>(a, d, c);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// The entry points' shared checks and Dims; false for sizes the kernel
// does not take.
bool make_dims(Dims& d, int B, int n, int m, int tile, int bound, int check_every,
               int n_checks, double sigma, double alpha, double eps_abs, double eps_rel) {
  if (B < 1 || n < 1 || m < 1 || tile < 1 || B % tile != 0 || check_every < 1 ||
      n_checks < 1 || static_cast<long long>(n_checks) * check_every < bound)
    return false;
  d.B = B;
  d.n = n;
  d.m = m;
  d.tile = tile;
  d.bound = bound;
  d.check_every = check_every;
  d.n_checks = n_checks;
  d.groups = B / tile;
  d.bpg = 0;
  d.ks = 0;
  d.kpn = d.kpm = d.sstride = 0;
  d.sigma = static_cast<float>(sigma);
  d.alpha = static_cast<float>(alpha);
  d.one_m_alpha = static_cast<float>(1.0 - alpha);
  d.eps_abs = static_cast<float>(eps_abs);
  d.eps_rel = static_cast<float>(eps_rel);
  return true;
}

}  // namespace

extern "C" {

// The slice rows stage_rows gives a block of `rows` scenarios (8, 16 or
// 32) at (n, m): 32, 16, 8, 4, 0 (operators through L1) or -1 (the panels
// do not fit).
int ocp_shared_stage_rows(int rows, int n, int m) { return stage_rows(rows, n, m, false); }

// The same for the tensor-core form (16 or 32 rows), beside its split panel.
int ocp_shared_tc_stage_rows(int rows, int n, int m) { return stage_rows(rows, n, m, true); }

// ptrs: the kNumPtrs device pointers in Args order; `rows` scenarios per
// thread block: 8, 16 or 32 (the wrapper's ops/shared_kernel.py::
// shared_block_rows).  Enqueues n_checks launches.  Returns the
// cudaError_t of the launches (0 on success; cudaErrorInvalidValue for
// sizes the kernel does not take, e.g. panels of `rows` scenarios beyond
// shared memory); the kernels run on `stream` and are not synchronised.
int ocp_shared_admm_chunk_f32(const void* const* ptrs, int nptrs, int B, int n, int m, int tile,
                              int rows, int bound, int check_every, int n_checks, double sigma,
                              double alpha, double eps_abs, double eps_rel, void* stream) {
  Dims d;
  if (nptrs != kNumPtrs || !make_dims(d, B, n, m, tile, bound, check_every, n_checks, sigma,
                                      alpha, eps_abs, eps_rel))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows != 8 && rows != 16 && rows != 32) return static_cast<int>(cudaErrorInvalidValue);
  static_assert(sizeof(Args) == kNumPtrsTc * sizeof(void*), "Args layout");
  Args a;
  memset(&a, 0, sizeof(Args));
  memcpy(&a, ptrs, kNumPtrs * sizeof(void*));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = rows == 4 * kWarps   ? launch_checks<4, 0>(a, d, s)
                        : rows == 2 * kWarps ? launch_checks<2, 0>(a, d, s)
                        : rows == kWarps     ? launch_checks<1, 0>(a, d, s)
                                             : cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// The tensor-core form: ptrs the kNumPtrsTc pointers in Args order (the
// FP32 form's, then the fragments of Ab, OP and Ab^T; the last is not read
// at "mixed"); `rows` 16 or 32; `mode` 1 ("high": all three iteration
// products on the tensor cores) or 2 ("mixed": zt an FP32 chain).  Returns
// as ocp_shared_admm_chunk_f32.
int ocp_shared_admm_chunk_tc_f32(const void* const* ptrs, int nptrs, int B, int n, int m,
                                 int tile, int rows, int bound, int check_every, int n_checks,
                                 int mode, double sigma, double alpha, double eps_abs,
                                 double eps_rel, void* stream) {
  Dims d;
  if (nptrs != kNumPtrsTc || !make_dims(d, B, n, m, tile, bound, check_every, n_checks, sigma,
                                        alpha, eps_abs, eps_rel))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  memcpy(&a, ptrs, sizeof(Args));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (mode == 1)
    e = rows == 4 * kWarps ? launch_checks<4, 1>(a, d, s)
        : rows == 2 * kWarps ? launch_checks<2, 1>(a, d, s) : cudaErrorInvalidValue;
  else if (mode == 2)
    e = rows == 4 * kWarps ? launch_checks<4, 2>(a, d, s)
        : rows == 2 * kWarps ? launch_checks<2, 2>(a, d, s) : cudaErrorInvalidValue;
  return static_cast<int>(e);
}

const char* ocp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
