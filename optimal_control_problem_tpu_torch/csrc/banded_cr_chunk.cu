// Cyclic-reduction block-tridiagonal ADMM chunk for a batch of
// stage-structured QPs, batch-last layout, one scenario per thread block.
// CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel
//   optimal_control_problem_tpu/ops/banded_cr_kernel.py::banded_admm_chunk_cr
// (its `_kernel`) with the same inputs, the same 13 outputs and the same
// per-element op order as the plain PyTorch version
// (ops/banded_cr_kernel.py::banded_admm_chunk_cr_plain): the
// M = P + sigma I + A^T R A assembly with ascending r-chains, the
// level-by-level odd-even cyclic-reduction factorization over the plan of
// cr_level_plan (each level padded to even by one identity stage), then up
// to `interval` over-relaxed OSQP-ADMM iterations -- rhs, CR down-sweep,
// root, CR up-sweep, clip projection, dual update -- with per-scenario
// OSQP termination every `check_every` iterations and freezing at
// check-block granularity.  Built with -fmad=false (ops/build.py) and
// every sum an ascending chain, so it agrees with the plain version
// bitwise.  Any w <= 16, any N >= 2.
//
// What bounds it.  Per launch at quadrotor h100, B=64 the function must
// read and write about 24 MB (the stage blocks, bounds, scalings and
// state): about 7 us at the card's 3.35 TB/s.  Its operations (the
// assembly, the factorization's block products and per iteration the CR
// sweeps and the A / A^T products; about 0.68 G at the main path's ~2
// iterations per launch) take about 10 us at the float32 peak, so
// operations bound it, narrowly.  No design reaches that: a scenario's
// solve is a chain of dependent level phases (per level one round of
// pivot inverses of w steps, and two product phases; per solve four
// phases a level), so the kernel is built for the latency of one
// scenario.
//
// Design (B2's layout, csrc/banded_rolled_chunk.cu, carried further).
//   * A staging launch first (cr_stage_kernel): a tiled transpose, 32
//     elements x 32 scenarios a tile, coalesced on both sides, writes each
//     scenario's operators, bound and scaling rows and carried state from
//     the batch-last inputs into its scenario-major slab.
//   * Then one scenario per thread block of kThreads = 512 threads (faster
//     than 1024, which spills, on an H100: PERF.md).
//   * Every level inverts all of its odd pivots at once, a warp per block:
//     rows in registers, the pivot, pivot column and pivot row passed lane
//     to lane by shuffles, no block barrier a pivot step (faster on an H100
//     than the shared-memory splits with two barriers a pivot step, one
//     thread per block row or per element: PERF.md).  Each division runs
//     once (a zero dividend is answered without the division's slow path,
//     div_rn).
//   * The level's Schur and coupling products: one thread per product,
//     block row and kCols = 8 columns (half a row at w = 16), the row of
//     the left factor loaded once and each row of the right one read as
//     float4s at w = 16, kCols chains side by side in registers.  Phase A
//     forms G_lo = L_lo dinv_lo, Y = LT_odd dinv_odd and
//     G_lo^T = dinv_lo LT_lo; phase B the reduced diagonal and the next
//     level's couplings.  The pivot inverses and the couplings are also
//     written transposed, so each matrix-vector product of the solve reads
//     a row as a column of the transpose: a warp's lanes read consecutive
//     words.
//   * The assembly: one thread per block row and kCols columns, its chains
//     side by side, the row's Jacobian entry and rho loaded once per term.
//   * Shared memory: the residual maxima and a zero block; a region that
//     holds the level's products where they fit (level 0's three at N=100,
//     w=16: 150 KB), and J0 and J1 during the assembly and the iterations
//     where both fit there; then, greedily in this order where each still
//     fits, the solve vectors, the carried state, the bound and scaling
//     rows, the transposed pivot inverses, the couplings and their
//     transposes.  Whatever does not fit lives in the global slab, same
//     code: at quadrotor h100 the level arrays, pivot inverses and
//     couplings (in L2).  The slab is the wrapper's
//     (ops/banded_cr_kernel.py::cr_slab_floats, checked here); every
//     region of it and of shared memory starts on a 16-byte boundary.
//   * Every w-term dot product is unrolled to 16 terms with the ones past
//     w masked, and the kernel is also built with w fixed at 16 (the
//     quadrotor's), where nothing is masked.
//   * The level arrays (working diagonals and transposed couplings) sit in
//     two ping-pong buffers, so a level never overwrites what another
//     thread still reads; LT is the JAX kernel's transposed-L workspace
//     (equal to L^T bitwise at level 0 only, because an f32 Gauss-Jordan
//     inverse is not exactly symmetric).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <string.h>

namespace {

constexpr int kMaxW = 16;                 // widest block
// Output columns per thread in the assembly and the block products (a
// power of two up to kMaxW): 8, half a block row at w = 16.  A thread loads
// the left factor's row once for its kCols outputs; on an H100, 4 is as
// fast, 2 and 1 (a thread per output element) are slower
// (tools/kernel_ablation.py, PERF.md).
constexpr int kCols = 8;
constexpr int kMaxLevels = 32;
constexpr long long kSmemLimit = 232448;  // dynamic shared memory a block may opt into
constexpr int kThreads = 512;  // per block: faster than 1024, which spills, on an H100 (PERF.md)
constexpr int kWarps = kThreads / 32;
// The residual maxima ([kWarps][7], then the scenario's 7) and a zero block.
constexpr int kFixedFloats = kWarps * 7 + 8 + kMaxW * kMaxW;
constexpr unsigned kFull = 0xffffffffu;

struct CRArgs {
  // inputs
  const int* it0;    // (B,)
  const int* done0;  // (B,)
  const float* hb;   // (N, w, w, B)
  const float* j0;   // (Nd, r, w, B)
  const float* j1;   // (Nd, r, w, B)
  const float* jc;   // (N, r2, w, B)
  const float* q;    // (N, w, B)
  const float* lx;
  const float* ux;
  const float* rx;  // (N, w, B)
  const float* ld;
  const float* ud;
  const float* rd;  // (Nd, r, B)
  const float* lc;
  const float* uc;
  const float* rc;  // (N, r2, B)
  const float* ds;  // (N, w, B)
  const float* ex;  // (N, w, B)
  const float* ed;  // (Nd, r, B)
  const float* ec;  // (N, r2, B)
  const float* ci;  // (B,)
  const float* x0;
  const float* yx0;
  const float* yd0;
  const float* yc0;
  const float* zx0;
  const float* zd0;
  const float* zc0;
  // outputs (the carried state is iterated in place here)
  float* x;
  float* yx;
  float* yd;
  float* yc;
  float* zx;
  float* zd;
  float* zc;
  int* done;
  int* it_inc;
  float* rp;
  float* rdual;
  float* mp;
  float* md;
  // scratch: (B, per) scenario-major slab of the layout below
  float* scratch;
};
constexpr int kNumPtrs = 42;

// One level of cr_level_plan: live stages, padded to even, survivors,
// offset into the packed pivot inverses, offset into the packed couplings.
struct Level {
  int n, n_p, half, off_d, off_L;
};
struct Plan {
  int nlev, nd_slots, nl_slots;
  Level lv[kMaxLevels];
};

// cr_level_plan of the Python module.
bool make_plan(int N, Plan* pl) {
  int n = N, off_d = 0, off_L = 0, l = 0;
  while (n > 1) {
    if (l == kMaxLevels) return false;
    const int n_p = n + (n % 2), half = n_p / 2;
    pl->lv[l] = Level{n, n_p, half, off_d, off_L};
    off_d += half;
    off_L += n_p;
    n = half;
    ++l;
  }
  pl->nlev = l;
  pl->nd_slots = off_d;
  pl->nl_slots = off_L;
  return true;
}

// Counts rounded up to a multiple of 4 floats (16 bytes).
__host__ __device__ inline long long r4(long long n) { return (n + 3) & ~3LL; }

// Floats of the operator rows (OV), the carried state (ST) and the solve
// vectors (two ping-pong buffers, a temporary, the down-sweep's odd
// right-hand sides).
__host__ __device__ inline long long ov_floats(int N, int w, int r, int r2) {
  return 6LL * N * w + 4LL * (N - 1) * r + 4LL * N * r2;
}
__host__ __device__ inline long long st_floats(int N, int w, int r, int r2) {
  return 3LL * N * w + 2LL * (N - 1) * r + 2LL * N * r2;
}
__host__ __device__ inline long long vec_floats(int N, int w, int nd_slots) {
  return 3LL * (N + 1) * w + static_cast<long long>(nd_slots) * w;
}

// Offsets (floats) of one scenario's global slab: the operators copied
// from the batch-last inputs once -- Hb, J0, J1, Jc, then the rows q,
// rho_x, lx, ux, ds, ex (6 N w), rho_d, ld, ud, ed (4 (N-1) r), rho_c,
// lc, uc, ec (4 N r2) -- the carried state x, zx, yx, zd, yd, zc, yc; the
// level arrays: working diagonals and transposed couplings, each in two
// ping-pong buffers (N + 1 and N / 2 + 2 blocks); the packed odd-pivot
// inverses and the root, and their transposes; the packed couplings and
// their transposes (the solve reads a block's rows as the columns of its
// transpose, so a warp's lanes read consecutive words); the level's three
// block products (3 ceil(N/2) blocks); the solve vectors.  The regions that sit
// in shared memory keep their slab slot unused.
// ops/banded_cr_kernel.py::cr_slab_floats mirrors it.
struct Layout {
  long long HB, J0, J1, JC, OV, ST, DA, LTA, DB, LTB, DINV, DINVT, LP, LPT, TMP, VEC, total;
};

Layout make_layout(int N, int w, int r, int r2, const Plan& pl) {
  const long long W2 = static_cast<long long>(w) * w, h0 = (N + 1) / 2;
  Layout L;
  long long o = 0;
  auto put = [&](long long* at, long long cnt) {  // every region 16-byte aligned
    *at = o;
    o += r4(cnt);
  };
  put(&L.HB, N * W2);
  put(&L.J0, static_cast<long long>(N - 1) * r * w);
  put(&L.J1, static_cast<long long>(N - 1) * r * w);
  put(&L.JC, static_cast<long long>(N) * r2 * w);
  put(&L.OV, ov_floats(N, w, r, r2));
  put(&L.ST, st_floats(N, w, r, r2));
  put(&L.DA, (N + 1) * W2);
  put(&L.LTA, (N + 1) * W2);
  put(&L.DB, (N / 2 + 2) * W2);
  put(&L.LTB, (N / 2 + 2) * W2);
  put(&L.DINV, (pl.nd_slots + 1) * W2);
  put(&L.DINVT, (pl.nd_slots + 1) * W2);
  put(&L.LP, pl.nl_slots * W2);
  put(&L.LPT, pl.nl_slots * W2);
  put(&L.TMP, 3 * h0 * W2);
  put(&L.VEC, vec_floats(N, w, pl.nd_slots));
  L.total = o;
  return L;
}

// What lives in shared memory (floats, in this order): the residual
// maxima and a zero block; the region of the level's three products where
// they fit; then each tier that still fits: the solve vectors, the carried
// state, the operator rows, and what the solve reads -- the transposed
// pivot inverses, the couplings and their transposes.
struct Tiers {
  long long region;     // floats of the product region (0: the products in the slab)
  int vec_s, st_s, ov_s, dinvt_s, lp_s, lpt_s;
  long long floats;     // total
};

Tiers make_tiers(int N, int w, int r, int r2, const Plan& pl) {
  const long long W2 = static_cast<long long>(w) * w, h0 = (N + 1) / 2;
  Tiers t;
  long long fl = kFixedFloats;
  t.region = (fl + r4(3 * h0 * W2)) * 4 <= kSmemLimit ? r4(3 * h0 * W2) : 0;
  fl += t.region;
  auto tier = [&](long long cnt) -> int {
    if ((fl + r4(cnt)) * 4 > kSmemLimit) return 0;
    fl += r4(cnt);
    return 1;
  };
  t.vec_s = tier(vec_floats(N, w, pl.nd_slots));
  t.st_s = tier(st_floats(N, w, r, r2));
  t.ov_s = tier(ov_floats(N, w, r, r2));
  t.dinvt_s = tier((pl.nd_slots + 1) * W2);
  t.lp_s = tier(pl.nl_slots * W2);
  t.lpt_s = tier(pl.nl_slots * W2);
  t.floats = fl;
  return t;
}

struct Dims {
  int N, w, r, r2, B;
  int interval, check_every, max_iter;
  long long per;
  float sigma, alpha, one_m_alpha, eps_abs, eps_rel;
};

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

// min(max(v, lo), hi) as torch.clip / torch.minimum(torch.maximum(...))
// compute it: a NaN v stays NaN (fmaxf / fminf alone would clip it to a
// bound).  The bounds are never NaN.
__device__ __forceinline__ float clip_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// NaN-propagating max (jnp.max / torch.amax semantics).
__device__ __forceinline__ float nmax(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// sum_j a[j sa] v[j sv], j = 0 .. w-1, as one ascending chain (one multiply
// and one add per term).  Unrolled to kMaxW with the terms past w masked,
// so every load of the chain is issued before its adds wait.
__device__ __forceinline__ float dotw(const float* a, int sa, const float* v, int sv, int w) {
  float acc = a[0] * v[0];
#pragma unroll
  for (int j = 1; j < kMaxW; ++j)
    if (j < w) acc = acc + a[j * sa] * v[j * sv];
  return acc;
}

// out[c] = sum_j a[j] b[j w + c0 + c] for c < kCols (columns past w
// masked): kCols columns of a row of a block product, each output one
// ascending chain, the row a loaded once for all of them.  At W = 16 the
// rows are read as float4s (every block starts on a 16-byte boundary).
template <int W>
__device__ __forceinline__ void rowprod(const float* a, const float* b, int c0, int w,
                                        float* out) {
  if (W == kMaxW) {
    float ar[kMaxW], br[kCols];
#pragma unroll
    for (int q = 0; q < kMaxW / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(a)[q];
      ar[4 * q] = v.x;
      ar[4 * q + 1] = v.y;
      ar[4 * q + 2] = v.z;
      ar[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < kMaxW; ++j) {
      if constexpr (kCols % 4 == 0) {
#pragma unroll
        for (int q = 0; q < kCols / 4; ++q) {
          const float4 v = reinterpret_cast<const float4*>(b + j * kMaxW + c0)[q];
          br[4 * q] = v.x;
          br[4 * q + 1] = v.y;
          br[4 * q + 2] = v.z;
          br[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) br[c] = b[j * kMaxW + c0 + c];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) out[c] = j == 0 ? ar[0] * br[c] : out[c] + ar[j] * br[c];
    }
    return;
  }
  float av = a[0];
#pragma unroll
  for (int c = 0; c < kCols; ++c) out[c] = c0 + c < w ? av * b[c0 + c] : 0.f;
#pragma unroll
  for (int j = 1; j < kMaxW; ++j) {
    if (j < w) {
      av = a[j];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (c0 + c < w) out[c] = out[c] + av * b[j * w + c0 + c];
    }
  }
}

// W > 0 fixes the block width at compile time (the quadrotor's 16); W = 0
// takes it from d.w.
template <int W>
__global__ void __launch_bounds__(kThreads)
cr_chunk_kernel(const CRArgs a, const Dims d, const Plan plan, const Layout L, const Tiers T) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int N = d.N, w = W > 0 ? W : d.w, r = d.r, r2 = d.r2, Nd = N - 1, W2 = w * w;
  const int parts = (w + kCols - 1) / kCols;  // threads a block row in the assembly and products
  const size_t SB = static_cast<size_t>(d.B);
  const float sigma = d.sigma, alpha = d.alpha, oma = d.one_m_alpha;

  // ---- where everything lives ------------------------------------------
  float* const slab = a.scratch + static_cast<size_t>(b) * static_cast<size_t>(d.per);
  float* const red = smem;                  // [kWarps][7] maxima, then the scenario's 7
  float* const zero = smem + kWarps * 7 + 8;  // a zero block (the missing dinv_lo of i = 0)
  float* const region = smem + kFixedFloats;
  float* cur = region + T.region;
  auto take = [&](int in_s, long long off, long long cnt) -> float* {
    if (!in_s) return slab + off;
    float* const p = cur;
    cur += r4(cnt);
    return p;
  };
  float* const VEC = take(T.vec_s, L.VEC, vec_floats(N, w, plan.nd_slots));
  float* const sA = VEC;  // solve vectors: ping-pong pair, temporary, odd rhs
  float* const sB = sA + (N + 1) * w;
  float* const tv = sB + (N + 1) * w;
  float* const s2 = tv + (N + 1) * w;
  float* const X = take(T.st_s, L.ST, st_floats(N, w, r, r2));  // carried state
  float* const ZX = X + N * w;
  float* const YX = ZX + N * w;
  float* const ZD = YX + N * w;
  float* const YD = ZD + Nd * r;
  float* const ZC = YD + Nd * r;
  float* const YC = ZC + N * r2;
  float* const OV = take(T.ov_s, L.OV, ov_floats(N, w, r, r2));
  float* const Qv = OV;  // (N, w) q, rho_x, lx, ux, ds, ex
  float* const RXv = Qv + N * w;
  float* const LXv = RXv + N * w;
  float* const UXv = LXv + N * w;
  float* const DSv = UXv + N * w;
  float* const EXv = DSv + N * w;
  float* const RDv = EXv + N * w;  // (Nd, r) rho_d, ld, ud, ed
  float* const LDv = RDv + Nd * r;
  float* const UDv = LDv + Nd * r;
  float* const EDv = UDv + Nd * r;
  float* const RCv = EDv + Nd * r;  // (N, r2) rho_c, lc, uc, ec
  float* const LCv = RCv + N * r2;
  float* const UCv = LCv + N * r2;
  float* const ECv = UCv + N * r2;
  float* const DINVT = take(T.dinvt_s, L.DINVT, (plan.nd_slots + 1) * static_cast<long long>(W2));
  float* const LP = take(T.lp_s, L.LP, plan.nl_slots * static_cast<long long>(W2));
  float* const LPT = take(T.lpt_s, L.LPT, plan.nl_slots * static_cast<long long>(W2));
  float* const DINV = slab + L.DINV;
  float* const HB = slab + L.HB;  // (N, w, w) scenario-major operator copies
  // J0 and J1, (Nd, r, w): in the region while it is free (the assembly,
  // then the iterations) where both fit there, else in the slab.
  const bool j_region = 2LL * Nd * r * w <= T.region;
  float* const J0 = j_region ? region : slab + L.J0;
  float* const J1 = j_region ? region + Nd * r * w : slab + L.J1;
  auto j_to_region = [&]() {
    if (j_region)
      for (int e = tid; e < 2 * Nd * r * w; e += kThreads)
        region[e] = e < Nd * r * w ? slab[L.J0 + e] : slab[L.J1 + e - Nd * r * w];
  };
  float* const JC = slab + L.JC;  // (N, r2, w)

#define AT(p, i) (p)[static_cast<size_t>(i) * SB + b]
#define BK(p, k) ((p) + static_cast<size_t>(k) * W2)

  // ---- the operator rows and the carried state into shared memory where
  // their tiers are (cr_stage_kernel left them scenario-major in the slab)
  {
    auto copy = [&](float* dst, long long off, long long cnt) {
      if (dst == slab + off) return;
      for (int e = tid; e < cnt; e += kThreads) dst[e] = slab[off + e];
    };
    copy(OV, L.OV, ov_floats(N, w, r, r2));
    copy(X, L.ST, st_floats(N, w, r, r2));
    j_to_region();
    for (int e = tid; e < kMaxW * kMaxW; e += kThreads) zero[e] = 0.f;
  }
  __syncthreads();

  float* const DA = slab + L.DA;
  float* const LTA = slab + L.LTA;

  // ---- M assembly: Hb, + (sigma + rho_x) on the diagonal, then the J0,
  // J1 and stage-row terms, each an ascending r-chain, into DA; level 0's
  // couplings L[k] (L[0] = 0) into LP and their transposes into LTA (the
  // JAX kernel's workspace) and LPT.  One thread per block row and kCols
  // columns (`parts` threads a row): the row's Jacobian entry and rho are
  // loaded once per term for its columns, whose chains run side by side in
  // registers. ------------------------------------------------------------
  for (int it = tid; it < N * w * parts; it += kThreads) {
    const int k = it / (parts * w), f = it - k * parts * w, i = f / parts;
    const int c0 = (f - i * parts) * kCols;
    float v[kCols], lo[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      v[c] = c0 + c < w ? HB[(k * w + i) * w + c0 + c] : 0.f;
      if (c0 + c == i) v[c] = v[c] + (sigma + RXv[k * w + i]);
      lo[c] = 0.f;
    }
    if (k < Nd) {
      float acc[kCols];
#pragma unroll 2
      for (int t = 0; t < r; ++t) {
        const int kt = k * r + t;
        const float rj = RDv[kt] * J0[kt * w + i];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float p = c0 + c < w ? rj * J0[kt * w + c0 + c] : 0.f;
          acc[c] = (t == 0) ? p : acc[c] + p;
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[c] = v[c] + acc[c];
    }
    if (k > 0) {
      float acc[kCols];
#pragma unroll 2
      for (int t = 0; t < r; ++t) {
        const int kt = (k - 1) * r + t;
        const float rj = RDv[kt] * J1[kt * w + i];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float p = c0 + c < w ? rj * J1[kt * w + c0 + c] : 0.f;
          const float pl = c0 + c < w ? rj * J0[kt * w + c0 + c] : 0.f;
          acc[c] = (t == 0) ? p : acc[c] + p;
          lo[c] = (t == 0) ? pl : lo[c] + pl;
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[c] = v[c] + acc[c];
    }
    {
      float acc[kCols];
      for (int t = 0; t < r2; ++t) {
        const int kt = k * r2 + t;
        const float rj = RCv[kt] * JC[kt * w + i];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float p = c0 + c < w ? rj * JC[kt * w + c0 + c] : 0.f;
          acc[c] = (t == 0) ? p : acc[c] + p;
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[c] = v[c] + acc[c];
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int cc = c0 + c;
      if (cc < w) {
        BK(DA, k)[i * w + cc] = v[c];
        BK(LP, k)[i * w + cc] = lo[c];
        BK(LTA, k)[cc * w + i] = lo[c];
        BK(LPT, k)[cc * w + i] = lo[c];
      }
    }
  }
  if (N & 1) {  // level 0's pad stage: identity diagonal, zero coupling
    for (int e = tid; e < W2; e += kThreads) {
      BK(DA, N)[e] = (e / w == e % w) ? 1.f : 0.f;
      BK(LP, N)[e] = 0.f;
      BK(LPT, N)[e] = 0.f;
      BK(LTA, N)[e] = 0.f;
    }
  }
  __syncthreads();

  // Gauss-Jordan inverses with diagonal pivots (op order of
  // ops/block_tridiag.small_spd_inv) of the blocks src[s0 + sstep i] into
  // dst[d0 + i] (and transposed into dstT[d0 + i]), i < cnt, a warp a
  // block: no block barrier until all are done.
  auto gj = [&](const float* src, int s0, int sstep, float* dst, float* dstT, int d0, int cnt) {
    // One warp per block: lane l holds row l & 15 of the matrix (l < 16)
    // or of its inverse (l >= 16) in registers; the pivot, the pivot
    // column and the pivot row go lane to lane by shuffles, each lane
    // divides one element of the pivot row.
    const int lane = tid & 31, row = lane & 15, half16 = lane & 16;
    const bool inv = half16 != 0, live = row < w;
    for (int k = tid >> 5; k < cnt; k += kWarps) {
      const float* const m = BK(src, s0 + sstep * k);
      float x[kMaxW];
#pragma unroll
      for (int j = 0; j < kMaxW; ++j)
        x[j] = !live || j >= w ? 0.f : inv ? (j == row ? 1.f : 0.f) : m[row * w + j];
#pragma unroll
      for (int p = 0; p < kMaxW; ++p) {
        if (p < w) {
          const float piv = __shfl_sync(kFull, x[p], p);
          const float col = __shfl_sync(kFull, x[p], row);  // M[row][p] before the update
          float own = 0.f;  // element `row` of this half's pivot row
#pragma unroll
          for (int j = 0; j < kMaxW; ++j) {
            const float v = __shfl_sync(kFull, x[j], half16 | p);
            if (j == row) own = v;
          }
          const float q = div_rn(own, piv);
#pragma unroll
          for (int j = 0; j < kMaxW; ++j) {
            if (j < w) {
              const float qj = __shfl_sync(kFull, q, half16 | j);
              x[j] = row == p ? qj : x[j] - col * qj;
            }
          }
        }
      }
      if (inv && live) {
#pragma unroll
        for (int j = 0; j < kMaxW; ++j)
          if (j < w) {
            BK(dst, d0 + k)[row * w + j] = x[j];
            BK(dstT, d0 + k)[j * w + row] = x[j];
          }
      }
    }
    __syncthreads();
  };

  // ---- CR factorization, level by level ------------------------------
  {
    float* dC = DA;
    float* dN = slab + L.DB;
    float* LTC = LTA;
    float* LTN = slab + L.LTB;
    for (int l = 0; l < plan.nlev; ++l) {
      const Level lv = plan.lv[l];
      const int half = lv.half, off_d = lv.off_d, off_L = lv.off_L;
      const int off_L2 = off_L + lv.n_p;
      const int hw = half * W2;
      // The odd pivots' inverses, all at once.
      gj(dC, 1, 2, DINV, DINVT, off_d, half);
      // The level's products: in the region where all three fit.
      float* const Gt = 3LL * hw <= T.region ? region : slab + L.TMP;
      float* const Yt = Gt + hw;
      float* const GTt = Yt + hw;
      const int nA = half > 1 ? 3 : 2;
      // Phase A: G_lo = L_lo dinv_lo, Y = LT_odd dinv_odd, G_lo^T = dinv_lo LT_lo
      // (dinv_lo: the inverse of the odd stage below, zero for i = 0).  One
      // thread per product, block row and kCols columns.
      const int hr = half * w * parts;
      for (int it = tid; it < nA * hr; it += kThreads) {
        const int q = it / hr, f = it - q * hr, i = f / (parts * w), rr = (f / parts) % w;
        const int c0 = (f % parts) * kCols;
        const float* const dlo = i > 0 ? BK(DINV, off_d + i - 1) : zero;
        float v[kCols];
        if (q == 0)
          rowprod<W>(BK(LP, off_L + 2 * i) + rr * w, dlo, c0, w, v);
        else if (q == 1)
          rowprod<W>(BK(LTC, 2 * i + 1) + rr * w, BK(DINV, off_d + i), c0, w, v);
        else
          rowprod<W>(dlo + rr * w, BK(LTC, 2 * i), c0, w, v);
        float* const out = (q == 0 ? Gt : q == 1 ? Yt : GTt) + i * W2 + rr * w;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (c0 + c < w) out[c0 + c] = v[c];
      }
      __syncthreads();
      // Phase B: new_d = (d_even - G_lo LT_lo) - Y L_odd; the next level's
      // L'[i] = -G_lo L_odd[i-1] (and its transpose) and
      // LT'[i] = -LT_odd[i-1] G_lo^T[i] (L'[0] = LT'[0] = 0).
      const int nB = half > 1 ? 3 : 1;
      for (int it = tid; it < nB * hr; it += kThreads) {
        const int q = it / hr, f = it - q * hr, i = f / (parts * w), rr = (f / parts) % w;
        const int c0 = (f % parts) * kCols;
        float v[kCols];
        if (q == 0) {
          float t[kCols];
          rowprod<W>(Gt + i * W2 + rr * w, BK(LTC, 2 * i), c0, w, v);
          rowprod<W>(Yt + i * W2 + rr * w, BK(LP, off_L + 2 * i + 1), c0, w, t);
          const float* const de = BK(dC, 2 * i) + rr * w;
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            if (c0 + c < w) BK(dN, i)[rr * w + c0 + c] = (de[c0 + c] - v[c]) - t[c];
        } else if (q == 1) {
          if (i > 0) rowprod<W>(Gt + i * W2 + rr * w, BK(LP, off_L + 2 * i - 1), c0, w, v);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int cc = c0 + c;
            if (cc < w) {
              const float lv = i == 0 ? 0.f : -v[c];
              BK(LP, off_L2 + i)[rr * w + cc] = lv;
              BK(LPT, off_L2 + i)[cc * w + rr] = lv;
            }
          }
        } else {
          if (i > 0) rowprod<W>(BK(LTC, 2 * i - 1) + rr * w, GTt + i * W2, c0, w, v);
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            if (c0 + c < w) BK(LTN, i)[rr * w + c0 + c] = i == 0 ? 0.f : -v[c];
        }
      }
      if (half > 1 && (half & 1)) {  // the next level's pad stage
        for (int e = tid; e < W2; e += kThreads) {
          BK(dN, half)[e] = (e / w == e % w) ? 1.f : 0.f;
          BK(LP, off_L2 + half)[e] = 0.f;
          BK(LPT, off_L2 + half)[e] = 0.f;
          BK(LTN, half)[e] = 0.f;
        }
      }
      __syncthreads();
      float* t = dC;
      dC = dN;
      dN = t;
      t = LTC;
      LTC = LTN;
      LTN = t;
    }
    gj(dC, 0, 1, DINV, DINVT, plan.nd_slots, 1);  // the root
  }
  j_to_region();  // the region is free again: J0 and J1 back for the iterations
  __syncthreads();
  const float* const rootT = BK(DINVT, plan.nd_slots);

  // ---- the CR solve: rhs in sA[0, N) (a zero pad stage when N is odd);
  // returns the buffer that holds the solution. --------------------------
  auto cr_solve = [&]() -> const float* {
    float* cur_v = sA;
    float* nxt = sB;
    for (int l = 0; l < plan.nlev; ++l) {
      const Level lv = plan.lv[l];
      const int half = lv.half, off_d = lv.off_d, off_L = lv.off_L;
      // t_odd = dinv_odd b_odd (into tv); b_odd kept for the up-sweep.
      for (int e = tid; e < half * w; e += kThreads) {
        const int i = e / w, c = e - i * w;
        const float* const bo = cur_v + (2 * i + 1) * w;
        tv[e] = dotw(BK(DINVT, off_d + i) + c, w, bo, 1, w);
        s2[off_d * w + e] = bo[c];
      }
      __syncthreads();
      // Fold: (b_even - L_lo t_lo) - L_odd^T t_odd (t_lo: t_odd of the
      // survivor below, zero for i = 0).
      for (int e = tid; e < half * w; e += kThreads) {
        const int i = e / w, c = e - i * w;
        const float s = dotw(BK(LPT, off_L + 2 * i) + c, w, i > 0 ? tv + (i - 1) * w : zero,
                             1, w);
        const float t = dotw(BK(LP, off_L + 2 * i + 1) + c, w, tv + i * w, 1, w);
        nxt[e] = (cur_v[2 * i * w + c] - s) - t;
      }
      if (l + 1 < plan.nlev && (half & 1))
        for (int e = tid; e < w; e += kThreads) nxt[half * w + e] = 0.f;
      __syncthreads();
      float* t = cur_v;
      cur_v = nxt;
      nxt = t;
    }
    for (int e = tid; e < w; e += kThreads) nxt[e] = dotw(rootT + e, w, cur_v, 1, w);
    __syncthreads();
    {
      float* t = cur_v;
      cur_v = nxt;
      nxt = t;
    }
    for (int l = plan.nlev - 1; l >= 0; --l) {
      const Level lv = plan.lv[l];
      const int half = lv.half, off_d = lv.off_d, off_L = lv.off_L;
      // rhs_o = (b_odd - L_odd x_even) - L_next^T x_hi (zero for the top).
      for (int e = tid; e < half * w; e += kThreads) {
        const int i = e / w, c = e - i * w;
        const float s = dotw(BK(LPT, off_L + 2 * i + 1) + c, w, cur_v + i * w, 1, w);
        const float t =
            i + 1 < half ? dotw(BK(LP, off_L + 2 * i + 2) + c, w, cur_v + (i + 1) * w, 1, w) : 0.f;
        tv[e] = (s2[off_d * w + e] - s) - t;
      }
      __syncthreads();
      // x_odd = dinv_odd rhs_o, interleaved with the survivors.
      for (int e = tid; e < half * w; e += kThreads) {
        const int i = e / w, c = e - i * w;
        nxt[(2 * i + 1) * w + c] = dotw(BK(DINVT, off_d + i) + c, w, tv + i * w, 1, w);
        nxt[2 * i * w + c] = cur_v[e];
      }
      __syncthreads();
      float* t = cur_v;
      cur_v = nxt;
      nxt = t;
    }
    return cur_v;
  };

  // (A^T t)[k, j] for t = rho z - y (rz) or y: the J0 term (k < Nd), the J1
  // term (k > 0), then the stage-row term, each an ascending r-chain.
  auto at_sum = [&](int k, int j, float out, bool rz) -> float {
    if (k < Nd) {
      float acc = 0.f;
#pragma unroll 4
      for (int t = 0; t < r; ++t) {
        const int kt = k * r + t;
        const float td = rz ? RDv[kt] * ZD[kt] - YD[kt] : YD[kt];
        const float p = J0[kt * w + j] * td;
        acc = (t == 0) ? p : acc + p;
      }
      out = out + acc;
    }
    if (k > 0) {
      float acc = 0.f;
#pragma unroll 4
      for (int t = 0; t < r; ++t) {
        const int kt = (k - 1) * r + t;
        const float td = rz ? RDv[kt] * ZD[kt] - YD[kt] : YD[kt];
        const float p = J1[kt * w + j] * td;
        acc = (t == 0) ? p : acc + p;
      }
      out = out + acc;
    }
    float acc = 0.f;
#pragma unroll 4
    for (int t = 0; t < r2; ++t) {
      const int kt = k * r2 + t;
      const float tc = rz ? RCv[kt] * ZC[kt] - YC[kt] : YC[kt];
      const float p = JC[kt * w + j] * tc;
      acc = (t == 0) ? p : acc + p;
    }
    return out + acc;
  };

  // Dynamics and stage rows of A x, x a vector.
  auto a_dyn = [&](const float* xv, int k, int i) -> float {
    const int kt = k * r + i;
    const float s0 = dotw(J0 + kt * w, 1, xv + k * w, 1, w);
    const float s1 = dotw(J1 + kt * w, 1, xv + (k + 1) * w, 1, w);
    return s0 + s1;
  };
  auto a_stage = [&](const float* xv, int k, int i) -> float {
    return dotw(JC + (k * r2 + i) * w, 1, xv + k * w, 1, w);
  };
  auto relax = [&](float zt, float* z, float* y, const float* rho, const float* lo,
                   const float* hi, int i) {
    const float rh = rho[i];
    const float z_rel = alpha * zt + oma * z[i];
    const float y0 = y[i];
    const float z_new = clip_nan(z_rel + div_rn(y0, rh), lo[i], hi[i]);
    y[i] = y0 + rh * (z_rel - z_new);
    z[i] = z_new;
  };

  auto one_iter = [&]() {
    // rhs = sigma x - q + A^T (rho z - y) into sA.
    for (int e = tid; e < N * w; e += kThreads) {
      const float txv = RXv[e] * ZX[e] - YX[e];
      const float at = at_sum(e / w, e % w, txv, true);
      sA[e] = (sigma * X[e] - Qv[e]) + at;
    }
    if (N & 1)
      for (int e = tid; e < w; e += kThreads) sA[N * w + e] = 0.f;
    __syncthreads();
    const float* const xt = cr_solve();
    // z/y updates from A xt, then the relaxed x.
    for (int e = tid; e < Nd * r; e += kThreads) relax(a_dyn(xt, e / r, e % r), ZD, YD, RDv, LDv, UDv, e);
    for (int e = tid; e < N * r2; e += kThreads)
      relax(a_stage(xt, e / r2, e % r2), ZC, YC, RCv, LCv, UCv, e);
    for (int e = tid; e < N * w; e += kThreads) {
      const float xv = xt[e];
      relax(xv, ZX, YX, RXv, LXv, UXv, e);
      X[e] = alpha * xv + oma * X[e];
    }
    __syncthreads();
  };

  const int it0 = a.it0[b];
  int done = a.done0[b];
  int it_inc = 0;
  const float ci = a.ci[b];
  float rp = INFINITY, rdu = INFINITY, mp = INFINITY, md = INFINITY;
  const int lane = tid & 31;

  for (int kb = 0; kb < d.interval; kb += d.check_every) {
    // Uniform across the block: one scenario per block.
    if (!(done == 0 && it0 + kb < d.max_iter)) break;
    for (int t = 0; t < d.check_every; ++t) one_iter();

    // Unscaled residuals (OSQP termination): this thread's entries, then
    // the scenario's maxima over warps and over the block.
    float p[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int e = tid; e < N * w; e += kThreads) {
      const float ev = EXv[e], xv = X[e], zv = ZX[e];
      p[0] = nmax(p[0], fabsf((xv - zv) * ev));
      p[1] = nmax(p[1], fabsf(xv * ev));
      p[2] = nmax(p[2], fabsf(zv * ev));
    }
    for (int e = tid; e < Nd * r; e += kThreads) {
      const float ev = EDv[e], av = a_dyn(X, e / r, e % r), zv = ZD[e];
      p[0] = nmax(p[0], fabsf((av - zv) * ev));
      p[1] = nmax(p[1], fabsf(av * ev));
      p[2] = nmax(p[2], fabsf(zv * ev));
    }
    for (int e = tid; e < N * r2; e += kThreads) {
      const float ev = ECv[e], av = a_stage(X, e / r2, e % r2), zv = ZC[e];
      p[0] = nmax(p[0], fabsf((av - zv) * ev));
      p[1] = nmax(p[1], fabsf(av * ev));
      p[2] = nmax(p[2], fabsf(zv * ev));
    }
    for (int e = tid; e < N * w; e += kThreads) {
      const int k = e / w, j = e % w;
      const float px = dotw(HB + e * w, 1, X + k * w, 1, w);
      const float aty = at_sum(k, j, YX[e], false);
      const float dsv = DSv[e], qv = Qv[e];
      p[3] = nmax(p[3], fabsf((px + qv + aty) * dsv));
      p[4] = nmax(p[4], fabsf(aty * dsv));
      p[5] = nmax(p[5], fabsf(px * dsv));
      p[6] = nmax(p[6], fabsf(qv * dsv));
    }
#pragma unroll
    for (int t = 0; t < 7; ++t) {
      float v = p[t];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v = nmax(v, __shfl_xor_sync(0xffffffffu, v, o));
      if (lane == 0) red[(tid >> 5) * 7 + t] = v;
    }
    __syncthreads();
    if (tid < 7) {
      float m = red[tid];
      for (int i = 1; i < kWarps; ++i) m = nmax(m, red[i * 7 + tid]);
      red[kWarps * 7 + tid] = m;
    }
    __syncthreads();
    const float* const res = red + kWarps * 7;
    const float r_prim = res[0];
    const float r_dual = ci * res[3];
    const float max_prim = nmax(res[1], res[2]);
    const float max_dual = ci * nmax(nmax(res[4], res[5]), res[6]);
    const float eps_pri = d.eps_abs + d.eps_rel * max_prim;
    const float eps_dua = d.eps_abs + d.eps_rel * max_dual;
    it_inc += d.check_every;
    rp = r_prim;
    rdu = r_dual;
    mp = max_prim;
    md = max_dual;
    if (r_prim <= eps_pri && r_dual <= eps_dua) done = 1;
    // (red is rewritten only after the next check's first barrier.)
  }
  // ---- carried state out (batch-last) -----------------------------------
  for (int e = tid; e < N * w; e += kThreads) {
    AT(a.x, e) = X[e];
    AT(a.zx, e) = ZX[e];
    AT(a.yx, e) = YX[e];
  }
  for (int e = tid; e < Nd * r; e += kThreads) {
    AT(a.zd, e) = ZD[e];
    AT(a.yd, e) = YD[e];
  }
  for (int e = tid; e < N * r2; e += kThreads) {
    AT(a.zc, e) = ZC[e];
    AT(a.yc, e) = YC[e];
  }
  if (tid == 0) {
    a.done[b] = done;
    a.it_inc[b] = it_inc;
    a.rp[b] = rp;
    a.rdual[b] = rdu;
    a.mp[b] = mp;
    a.md[b] = md;
  }
#undef BK
#undef AT
}

// The batch's operators, bound and scaling rows and carried state,
// batch-last -> each scenario's slab (the regions HB, J0, J1, JC, OV, ST of
// the layout), as a tiled transpose: 32 elements x 32 scenarios a tile,
// read and written a row of the tile at a time, so both sides are
// coalesced.  Its own launch before the chunk's.
constexpr int kSegs = 25;
struct Staging {
  const float* src[kSegs];  // batch-last (count, B)
  long long off[kSegs];     // offset in the slab
  int count[kSegs];
  int tile0[kSegs + 1];     // first tile of each segment
};

Staging make_staging(const CRArgs& a, const Layout& L, int N, int w, int r, int r2) {
  const int Nd = N - 1, nw = N * w, nr = Nd * r, nr2 = N * r2;
  const struct {
    const float* p;
    long long off;
    int cnt;
  } seg[kSegs] = {
      {a.hb, L.HB, N * w * w},   {a.j0, L.J0, nr * w},   {a.j1, L.J1, nr * w},
      {a.jc, L.JC, nr2 * w},     {a.q, L.OV, nw},         {a.rx, L.OV + nw, nw},
      {a.lx, L.OV + 2 * nw, nw}, {a.ux, L.OV + 3 * nw, nw}, {a.ds, L.OV + 4 * nw, nw},
      {a.ex, L.OV + 5 * nw, nw}, {a.rd, L.OV + 6 * nw, nr}, {a.ld, L.OV + 6 * nw + nr, nr},
      {a.ud, L.OV + 6 * nw + 2 * nr, nr}, {a.ed, L.OV + 6 * nw + 3 * nr, nr},
      {a.rc, L.OV + 6 * nw + 4 * nr, nr2}, {a.lc, L.OV + 6 * nw + 4 * nr + nr2, nr2},
      {a.uc, L.OV + 6 * nw + 4 * nr + 2 * nr2, nr2},
      {a.ec, L.OV + 6 * nw + 4 * nr + 3 * nr2, nr2},
      {a.x0, L.ST, nw},          {a.zx0, L.ST + nw, nw},  {a.yx0, L.ST + 2 * nw, nw},
      {a.zd0, L.ST + 3 * nw, nr}, {a.yd0, L.ST + 3 * nw + nr, nr},
      {a.zc0, L.ST + 3 * nw + 2 * nr, nr2}, {a.yc0, L.ST + 3 * nw + 2 * nr + nr2, nr2},
  };
  Staging s;
  s.tile0[0] = 0;
  for (int g = 0; g < kSegs; ++g) {
    s.src[g] = seg[g].p;
    s.off[g] = seg[g].off;
    s.count[g] = seg[g].cnt;
    s.tile0[g + 1] = s.tile0[g] + (seg[g].cnt + 31) / 32;
  }
  return s;
}

constexpr int kStageBlocks = 264;  // two per SM of an H100; each walks its share of the tiles

__global__ void __launch_bounds__(256)
cr_stage_kernel(const Staging s, float* slab, long long per, int B) {
  __shared__ float tile[32][33];
  const int b0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  int g = 0;
  for (int t = blockIdx.x; t < s.tile0[kSegs]; t += gridDim.x) {
    while (s.tile0[g + 1] <= t) ++g;
    const int e0 = (t - s.tile0[g]) * 32, cnt = s.count[g];
    for (int q = ty; q < 32; q += 8) {
      const int e = e0 + q, b = b0 + tx;
      if (e < cnt && b < B) tile[q][tx] = __ldg(s.src[g] + static_cast<size_t>(e) * B + b);
    }
    __syncthreads();
    for (int q = ty; q < 32; q += 8) {
      const int b = b0 + q, e = e0 + tx;
      if (e < cnt && b < B) slab[static_cast<size_t>(b) * per + s.off[g] + e] = tile[tx][q];
    }
    __syncthreads();  // the tile is read before the next one lands
  }
}

template <int W>
cudaError_t launch(const CRArgs& a, const Dims& d, const Plan& plan, const Layout& L,
                   const Tiers& T, cudaStream_t st) {
  const Staging sg = make_staging(a, L, d.N, d.w, d.r, d.r2);
  const int gx = sg.tile0[kSegs] < kStageBlocks ? sg.tile0[kSegs] : kStageBlocks;
  cr_stage_kernel<<<dim3(gx, (d.B + 31) / 32), 256, 0, st>>>(sg, a.scratch, d.per, d.B);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(T.floats) * sizeof(float);
  err = cudaFuncSetAttribute(cr_chunk_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cr_chunk_kernel<W><<<d.B, kThreads, smem, st>>>(a, d, plan, L, T);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The layout the entry point derives for (N, w, r, r2): out[0] the slab
// floats per scenario, out[1] the shared-memory bytes, out[2] the product
// region's floats, out[3..8] the tiers (vectors, state, operator rows,
// transposed pivot inverses, couplings, transposed couplings; 1 = shared
// memory), out[9] whether J0 and J1 go to the region outside the
// factorization.  Returns 0, or cudaErrorInvalidValue for sizes the kernel
// does not take.
int ocp_banded_cr_layout(int N, int w, int r, int r2, long long* out) {
  Plan plan;
  if (N < 2 || w < 1 || w > kMaxW || r < 1 || r2 < 1 || !make_plan(N, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = make_layout(N, w, r, r2, plan);
  const Tiers T = make_tiers(N, w, r, r2, plan);
  const long long v[10] = {L.total, T.floats * 4, T.region, T.vec_s,  T.st_s,
                           T.ov_s,  T.dinvt_s,    T.lp_s,   T.lpt_s, 2LL * (N - 1) * r * w <= T.region};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// ptrs: the kNumPtrs device pointers in CRArgs order; `per` the floats of
// the slab per scenario (checked against this file's layout).  Returns the
// cudaError_t of the launch (0 on success); the kernel runs on `stream`
// and is not synchronised.
int ocp_banded_admm_chunk_cr_f32(const void* const* ptrs, int nptrs, int N, int w, int r,
                                 int r2, int B, int interval, int check_every, int max_iter,
                                 int per, double sigma, double alpha, double eps_abs,
                                 double eps_rel, void* stream) {
  Plan plan;
  if (nptrs != kNumPtrs || N < 2 || w < 1 || w > kMaxW || r < 1 || r2 < 1 || B < 1 ||
      check_every < 1 || !make_plan(N, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = make_layout(N, w, r, r2, plan);
  if (per != L.total) return static_cast<int>(cudaErrorInvalidValue);
  const Tiers T = make_tiers(N, w, r, r2, plan);
  static_assert(sizeof(CRArgs) == kNumPtrs * sizeof(void*), "CRArgs layout");
  CRArgs a;
  memcpy(&a, ptrs, sizeof(CRArgs));
  Dims d;
  d.N = N;
  d.w = w;
  d.r = r;
  d.r2 = r2;
  d.B = B;
  d.interval = interval;
  d.check_every = check_every;
  d.max_iter = max_iter;
  d.per = per;
  d.sigma = static_cast<float>(sigma);
  d.alpha = static_cast<float>(alpha);
  d.one_m_alpha = static_cast<float>(1.0 - alpha);
  d.eps_abs = static_cast<float>(eps_abs);
  d.eps_rel = static_cast<float>(eps_rel);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = w == kMaxW ? launch<kMaxW>(a, d, plan, L, T, st)
                                     : launch<0>(a, d, plan, L, T, st);
  return static_cast<int>(err);
}

const char* ocp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
