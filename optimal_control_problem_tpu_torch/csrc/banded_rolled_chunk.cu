// Rolled two-way block-tridiagonal ADMM chunk for a batch of
// stage-structured QPs, batch-last layout, one scenario per thread block.
// CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel
//   optimal_control_problem_tpu/ops/banded_rolled_kernel.py::banded_admm_chunk_rolled
// (its `_kernel`) with the same inputs, the same 13 outputs and the same
// per-element op order as the plain PyTorch version
// (ops/banded_rolled_kernel.py::banded_admm_chunk_rolled_plain): the
// M = P + sigma I + A^T R A assembly with ascending r-chains, the optional
// depth-1 cyclic-reduction level (odd stages eliminated first; reduced
// diagonal D' = d_even - Lb^T dinv_o Lb - La dinv_o La^T, reduced couplings
// -Ya Lb), the two-way ("twisted") block factorization meeting at
// m = n_sys / 2 (top multipliers g[k] = L[k+1] dinv[k], bottom transposed
// multipliers W[k] = dinv[k+1] L[k+1]), then up to `interval` over-relaxed
// OSQP-ADMM iterations -- fold, two-way sweeps, u = dinv s, outward
// back-substitution, odd recovery, clip projection, dual update -- with
// per-scenario OSQP termination every `check_every` iterations and
// freezing at check-block granularity.  Built with -fmad=false
// (ops/build.py) and every sum an ascending chain, so it agrees with the
// plain version bitwise.  Any w <= 16, any N >= 2.
//
// What bounds it.  Per launch at quadrotor h100, B=64 the function must
// read and write about 24 MB (Hb 6.6 MB, J0/J1 9.7 MB, the bound, scale and
// state vectors about 8 MB): about 7 us at the card's 3.35 TB/s; the
// operations (about 0.5 G per launch at the main path's ~2 iterations, most
// of them in the factorization) take a little less at the float32 peak.
// No design reaches it: a scenario's solve is a chain of dependent steps
// (n_sys / 2 factorization steps of w pivot rounds each, 2 x n_sys / 2
// sweep steps per iteration), so the kernel is built for the latency of
// one scenario.
//
// Design (the layout of the cyclic-reduction chunk, banded_cr_chunk.cu).
//   * One scenario per thread block of 512 threads, so the batch's blocks
//     spread over the SMs (64 of 132 at B=64).  The scenario's operators
//     are copied from the batch-last inputs once into a scenario-major
//     slab (their one uncoalesced read).  Stage-parallel phases -- the
//     assembly, the cyclic-reduction level's products, the rhs, fold,
//     u = dinv s, recovery, A / A^T products, relaxation and residual
//     maxima -- run one element or row per thread over all stages.
//   * Element-parallel Gauss-Jordan: each pivot round updates every
//     element of the block and of its inverse in one thread each, reading
//     one copy and writing the other of a ping-pong pair: one barrier per
//     pivot.  The factorization's top and bottom chains run concurrently,
//     one block each (threads [0, w^2) and [w^2, 2 w^2)); the level's odd
//     pivots are inverted as many at once as shared memory holds.
//   * Both sweep directions of the solve run concurrently in warp 0: lanes
//     0-15 walk the top chain, lanes 16-31 the bottom one, one block row a
//     lane, the same instructions on each half's own pointers, exchanging
//     the stage vector through shared memory with one __syncwarp() per
//     step; the step where both chains fold into the middle stage runs top
//     first, as the plain version does.
//   * Shared memory, placed greedily in this order where it fits: the
//     workspace and the rhs/sweep/u vectors, the carried state, the
//     reduced system's multipliers (read by both serial sweeps), its pivot
//     inverses, the bound and scaling rows.  With the CR level (n_sys = 50
//     at w=16) all of it fits (220 KB); without it (n_sys = 100) the pivot
//     inverses (100 KB, read only by the stage-parallel u = dinv s) stay in
//     the global slab, in L2.  Whatever does not fit lives in the slab,
//     same code; so do M's blocks, the level's odd inverses and couplings,
//     Hb and the Jacobians.  The slab is the wrapper's
//     (ops/banded_rolled_kernel.py::rolled_slab_floats).
//   * Every w-term dot product is unrolled to 16 terms with the ones past w
//     masked, and the kernel is also built with w fixed at 16 (the
//     quadrotor's), where nothing is masked and every index division is a
//     shift.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <string.h>

namespace {

constexpr int kMaxW = 16;          // widest block
constexpr int kThreads = 512;      // two blocks of kMaxW^2 elements
constexpr int kWarps = kThreads / 32;
constexpr int kRedFloats = kWarps * 7 + 9;
constexpr long long kSmemLimit = 232448;  // dynamic shared memory a block may opt into

struct RolledArgs {
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
  float* slab;
};
constexpr int kNumPtrs = 42;

// Offsets (floats) of one scenario's global slab: M's diagonal blocks D
// (odd slots -> dinv_o under the CR level; else -> dinv) and subdiagonal
// blocks G (Lb/La under the level; else -> g / W); under the level the
// reduced system DR (-> dinv), GR (-> g / W), the temporaries Vb, Ya and
// the workspace of the level's batched inverses; the Gauss-Jordan / Schur
// workspace WS of the two chains (products and ping-pong pairs); the rhs
// R, sweep S and u U vectors; the scenario's operators, copied from the batch-last inputs
// once: Hb, J0, J1, Jc, then the rows q, rho_x, lx, ux, ds, ex (OV: 6 N
// w), rho_d, ld, ud, ed (4 (N-1) r), rho_c, lc, uc, ec (4 N r2); the
// carried state x, zx, yx, zd, yd, zc, yc (ST).
// ops/banded_rolled_kernel.py::rolled_slab_floats mirrors it.
struct Layout {
  long long D, G, DR, GR, VB, YA, GWS, WS, R, S, U, HB, J0, J1, JC, OV, ST, total;
};

// Floats of the operator rows (OV) and of the state (ST).
__host__ __device__ inline long long ov_floats(int N, int w, int r, int r2) {
  return 6LL * N * w + 4LL * (N - 1) * r + 4LL * N * r2;
}
__host__ __device__ inline long long st_floats(int N, int w, int r, int r2) {
  return 3LL * N * w + 2LL * (N - 1) * r + 2LL * N * r2;
}

Layout make_layout(int N, int w, int r, int r2, int cr1) {
  const long long W2 = static_cast<long long>(w) * w, H = N / 2;
  Layout L;
  long long o = 0;
  L.D = o;
  o += N * W2;
  L.G = o;
  o += (N - 1) * W2;
  L.DR = L.GR = L.VB = L.YA = L.GWS = o;
  if (cr1) {
    L.DR = o;
    o += H * W2;
    L.GR = o;
    o += (H - 1) * W2;
    L.VB = o;
    o += H * W2;
    L.YA = o;
    o += (H - 1) * W2;
    L.GWS = o;
    o += 4 * H * W2;
  }
  L.WS = o;
  o += 10 * W2;
  L.R = o;
  o += static_cast<long long>(N) * w;
  L.S = o;
  o += static_cast<long long>(N) * w;
  L.U = o;
  o += static_cast<long long>(N) * w;
  L.HB = o;
  o += N * W2;
  L.J0 = o;
  o += static_cast<long long>(N - 1) * r * w;
  L.J1 = o;
  o += static_cast<long long>(N - 1) * r * w;
  L.JC = o;
  o += static_cast<long long>(N) * r2 * w;
  L.OV = o;
  o += ov_floats(N, w, r, r2);
  L.ST = o;
  o += st_floats(N, w, r, r2);
  L.total = o;
  return L;
}

struct Dims {
  int N, w, r, r2, B;
  int interval, check_every, max_iter, cr1;
  // in shared memory: the workspace and vectors; the state; F2; F1; the
  // operator rows (each where it still fits, in that order)
  int vec_s, st_s, f2_s, f1_s, ov_s;
  long long per;
  float sigma, alpha, one_m_alpha, eps_abs, eps_rel;
};

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

// Gauss-Jordan pivot rounds with diagonal pivots (op order of
// ops/block_tridiag.small_spd_inv), element-parallel over `nblk` w x w
// blocks whose matrices and identity start in m0 / i0 ([nblk][w^2] each);
// the other halves of the ping-pong pair are m1 / i1.  Block `k` is
// inverted when act(k); its inverse lands in dst(k).  One barrier per
// pivot.
template <class Act, class Dst>
__device__ __forceinline__ void gj_rounds(int w, int nblk, float* m0, float* i0, float* m1,
                                          float* i1, Act act, Dst dst) {
  const int W2 = w * w;
  for (int p = 0; p < w; ++p) {
    const float* const cm = (p & 1) ? m1 : m0;
    const float* const cv = (p & 1) ? i1 : i0;
    float* const nm = (p & 1) ? m0 : m1;
    float* const nv = (p & 1) ? i0 : i1;
    for (int e = threadIdx.x; e < nblk * W2; e += kThreads) {
      const int k = e / W2, rem = e - k * W2, i = rem / w, j = rem % w;
      if (!act(k)) continue;
      const float* const M = cm + k * W2;
      const float* const V = cv + k * W2;
      const float piv = M[p * w + p];
      const float mrow = M[p * w + j] / piv;
      const float irow = V[p * w + j] / piv;
      float vm, vi;
      if (i == p) {
        vm = mrow;
        vi = irow;
      } else {
        const float col = M[i * w + p];
        vm = M[rem] - col * mrow;
        vi = V[rem] - col * irow;
      }
      if (p == w - 1) {
        dst(k)[rem] = vi;
      } else {
        nm[e] = vm;
        nv[e] = vi;
      }
    }
    __syncthreads();
  }
}

// W > 0 fixes the block width at compile time (the quadrotor's 16: every
// w-chain unrolls whole and every index division is a shift); W = 0 takes
// it from d.w.
template <int W>
__global__ void __launch_bounds__(kThreads)
rolled_chunk_kernel(const RolledArgs a, const Dims d, const Layout L) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int N = d.N, w = W > 0 ? W : d.w, r = d.r, r2 = d.r2, Nd = N - 1, W2 = w * w;
  const bool cr1 = d.cr1 != 0;
  const int H = N / 2;
  const int n_sys = cr1 ? H : N, mid = n_sys / 2;
  const size_t SB = static_cast<size_t>(d.B);
  const float sigma = d.sigma, alpha = d.alpha, oma = d.one_m_alpha;

  // ---- where everything lives ------------------------------------------
  float* const slab = a.slab + static_cast<size_t>(b) * static_cast<size_t>(d.per);
  float* const red = smem;  // [kWarps][7] maxima, then the scenario's 7
  float* cur = smem + kRedFloats;
  // A region in shared memory (in order) when its tier fits, else in the slab.
  auto take = [&](bool in_s, long long off, int cnt) -> float* {
    if (!in_s) return slab + off;
    float* const p = cur;
    cur += cnt;
    return p;
  };
  float* const WS = take(d.vec_s, L.WS, 10 * W2);
  float* const Rv = take(d.vec_s, L.R, N * w);
  float* const Sv = take(d.vec_s, L.S, N * w);
  float* const Uv = take(d.vec_s, L.U, N * w);
  float* const X = take(d.st_s, L.ST, N * w);  // carried state
  float* const ZX = take(d.st_s, L.ST + N * w, N * w);
  float* const YX = take(d.st_s, L.ST + 2 * N * w, N * w);
  float* const ZD = take(d.st_s, L.ST + 3 * N * w, Nd * r);
  float* const YD = take(d.st_s, L.ST + 3 * N * w + Nd * r, Nd * r);
  float* const ZC = take(d.st_s, L.ST + 3 * N * w + 2 * Nd * r, N * r2);
  float* const YC = take(d.st_s, L.ST + 3 * N * w + 2 * Nd * r + N * r2, N * r2);
  float* const Dg = slab + L.D;
  float* const Gg = slab + L.G;
  // The system the two-way factorization runs on: F1 (diagonal -> dinv)
  // and F2 (couplings -> g / W).
  float* const F2 = take(d.f2_s, cr1 ? L.GR : L.G, (n_sys - 1) * W2);
  float* const F1 = take(d.f1_s, cr1 ? L.DR : L.D, n_sys * W2);
  float* const OV = take(d.ov_s, L.OV, static_cast<int>(ov_floats(N, w, r, r2)));
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
  float* const HB = slab + L.HB;  // (N, w, w) scenario-major operator copies
  float* const J0 = slab + L.J0;  // (Nd, r, w)
  float* const J1 = slab + L.J1;
  float* const JC = slab + L.JC;  // (N, r2, w)
  float* const Tw = WS;           // [2][W2] the chains' block products
  float* const Am = WS + 2 * W2;  // Gauss-Jordan ping-pong: [2][W2] each
  float* const Ai = Am + 2 * W2;
  float* const Bm = Ai + 2 * W2;
  float* const Bi = Bm + 2 * W2;

#define AT(p, i) (p)[static_cast<size_t>(i) * SB + b]
#define SL(p, i) (p)[i]
#define BK(p, k) ((p) + static_cast<size_t>(k) * W2)

  // ---- the scenario's operators and carried state, batch-last -> slab
  // and shared memory (the inputs' one uncoalesced read) ----------------
  {
    // Eight loads in flight per thread before their stores.
    auto copy = [&](float* dst, const float* src, int cnt) {
      for (int e0 = tid; e0 < cnt; e0 += 8 * kThreads) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = e0 + u * kThreads;
          v[u] = e < cnt ? __ldg(src + static_cast<size_t>(e) * SB + b) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (e0 + u * kThreads < cnt) dst[e0 + u * kThreads] = v[u];
      }
    };
    copy(HB, a.hb, N * W2);
    copy(J0, a.j0, Nd * r * w);
    copy(J1, a.j1, Nd * r * w);
    copy(JC, a.jc, N * r2 * w);
    copy(Qv, a.q, N * w);
    copy(RXv, a.rx, N * w);
    copy(LXv, a.lx, N * w);
    copy(UXv, a.ux, N * w);
    copy(DSv, a.ds, N * w);
    copy(EXv, a.ex, N * w);
    copy(RDv, a.rd, Nd * r);
    copy(LDv, a.ld, Nd * r);
    copy(UDv, a.ud, Nd * r);
    copy(EDv, a.ed, Nd * r);
    copy(RCv, a.rc, N * r2);
    copy(LCv, a.lc, N * r2);
    copy(UCv, a.uc, N * r2);
    copy(ECv, a.ec, N * r2);
    copy(X, a.x0, N * w);
    copy(ZX, a.zx0, N * w);
    copy(YX, a.yx0, N * w);
    copy(ZD, a.zd0, Nd * r);
    copy(YD, a.yd0, Nd * r);
    copy(ZC, a.zc0, N * r2);
    copy(YC, a.yc0, N * r2);
  }
  __syncthreads();

  // ---- M assembly, element-parallel over every stage: Hb, + (sigma +
  // rho_x) on the diagonal, then the J0, J1 and stage-row terms, each an
  // ascending r-chain; the subdiagonal blocks G[k] = L[k+1]. ------------
  {
    float* const Dt = cr1 ? Dg : F1;
    float* const Gt = cr1 ? Gg : F2;
    for (int e = tid; e < N * W2; e += kThreads) {
      const int k = e / W2, i = (e / w) % w, c = e % w;
      float v = SL(HB, e);
      if (i == c) v = v + (sigma + SL(RXv, k * w + i));
      if (k < Nd) {
        float acc = 0.f;
#pragma unroll 4
        for (int t = 0; t < r; ++t) {
          const int kt = k * r + t;
          const float p = (SL(RDv, kt) * SL(J0, kt * w + i)) * SL(J0, kt * w + c);
          acc = (t == 0) ? p : acc + p;
        }
        v = v + acc;
      }
      if (k > 0) {
        float acc = 0.f;
#pragma unroll 4
        for (int t = 0; t < r; ++t) {
          const int kt = (k - 1) * r + t;
          const float p = (SL(RDv, kt) * SL(J1, kt * w + i)) * SL(J1, kt * w + c);
          acc = (t == 0) ? p : acc + p;
        }
        v = v + acc;
      }
      {
        float acc = 0.f;
#pragma unroll 4
        for (int t = 0; t < r2; ++t) {
          const int kt = k * r2 + t;
          const float p = (SL(RCv, kt) * SL(JC, kt * w + i)) * SL(JC, kt * w + c);
          acc = (t == 0) ? p : acc + p;
        }
        v = v + acc;
      }
      Dt[e] = v;
      if (k < Nd) {
        float acc = 0.f;
#pragma unroll 4
        for (int t = 0; t < r; ++t) {
          const int kt = k * r + t;
          const float p = (SL(RDv, kt) * SL(J1, kt * w + i)) * SL(J0, kt * w + c);
          acc = (t == 0) ? p : acc + p;
        }
        Gt[e] = acc;
      }
    }
  }
  __syncthreads();


  auto ident = [&](int rem) -> float { return (rem / w == rem % w) ? 1.f : 0.f; };
  auto always = [](int) { return true; };

  // ---- depth-1 cyclic-reduction level: dinv_o = inv(D[2i+1]) in place
  // (all H at once); Vb = dinv_o Lb, Ya = La dinv_o; the reduced system
  // D' = (d_even - Lb^T Vb) - Ya[i-1] La[i-1]^T into F1 and L' = -Ya Lb
  // into F2.  Lb[i] = G[2i], La[i] = G[2i+1]. ---------------------------
  if (cr1) {
    // The odd pivots' inverses, as many at once as the workspace holds: the
    // reduced system's shared-memory home (F2 then F1, written only after
    // this) when both are there, else the slab's workspace (all at once).
    const bool in_s = d.f2_s && d.f1_s && 2 * H - 1 >= 4;
    float* const gws = in_s ? F2 : slab + L.GWS;
    const int G = in_s ? (2 * H - 1) / 4 : H;
    for (int g0 = 0; g0 < H; g0 += G) {
      const int nb = H - g0 < G ? H - g0 : G;
      float* const m0 = gws;
      float* const i0 = m0 + nb * W2;
      float* const m1 = i0 + nb * W2;
      float* const i1 = m1 + nb * W2;
      for (int e = tid; e < nb * W2; e += kThreads) {
        const int k = e / W2, rem = e - k * W2;
        m0[e] = BK(Dg, 2 * (g0 + k) + 1)[rem];
        i0[e] = ident(rem);
      }
      __syncthreads();
      gj_rounds(w, nb, m0, i0, m1, i1, always, [&](int k) { return BK(Dg, 2 * (g0 + k) + 1); });
    }
    float* const VB = slab + L.VB;
    float* const YA = slab + L.YA;
    for (int e = tid; e < (2 * H - 1) * W2; e += kThreads) {
      const int k = e / W2, rem = e - k * W2, i = rem / w, c = rem % w;
      if (k < H) {  // Vb[k] = dinv_o[k] Lb[k]
        const float* const A = BK(Dg, 2 * k + 1) + i * w;
        const float* const Bm_ = BK(Gg, 2 * k) + c;
        float acc = dotw(A, 1, Bm_, w, w);
        VB[e] = acc;
      } else {  // Ya[k'] = La[k'] dinv_o[k']
        const int kk = k - H;
        const float* const A = BK(Gg, 2 * kk + 1) + i * w;
        const float* const Bm_ = BK(Dg, 2 * kk + 1) + c;
        float acc = dotw(A, 1, Bm_, w, w);
        YA[kk * W2 + rem] = acc;
      }
    }
    __syncthreads();
    for (int e = tid; e < (2 * H - 1) * W2; e += kThreads) {
      const int k = e / W2, rem = e - k * W2, i = rem / w, c = rem % w;
      if (k < H) {
        // (d_even - Lb^T Vb) - Ya[k-1] La[k-1]^T
        const float* const Lb = BK(Gg, 2 * k) + i;
        const float* const V = BK(VB, k) + c;
        float s = dotw(Lb, w, V, w, w);
        float v = BK(Dg, 2 * k)[rem] - s;
        if (k > 0) {
          const float* const Y = BK(YA, k - 1) + i * w;
          const float* const La = BK(Gg, 2 * k - 1) + c * w;
          float t = dotw(Y, 1, La, 1, w);
          v = v - t;
        }
        BK(F1, k)[rem] = v;
      } else {  // L'[k'] = -(Ya[k'] Lb[k'])
        const int kk = k - H;
        const float* const Y = BK(YA, kk) + i * w;
        const float* const Lb = BK(Gg, 2 * kk) + c;
        float acc = dotw(Y, 1, Lb, w, w);
        BK(F2, kk)[rem] = -acc;
      }
    }
    __syncthreads();
  }

  // ---- two-way factorization of the n_sys-stage system (F1, F2): the top
  // chain (block 0 of the workspace) and the bottom chain (block 1) run
  // concurrently, round by round. ----------------------------------------
  {
    const bool has_bot = mid < n_sys - 1;
    // Round 0: the end pivots.
    for (int e = tid; e < 2 * W2; e += kThreads) {
      const int k = e / W2, rem = e - k * W2;
      if (k == 1 && !has_bot) continue;
      Am[e] = BK(F1, k == 0 ? 0 : n_sys - 1)[rem];
      Ai[e] = ident(rem);
    }
    __syncthreads();
    gj_rounds(w, 2, Am, Ai, Bm, Bi, [&](int k) { return k == 0 || has_bot; },
              [&](int k) { return BK(F1, k == 0 ? 0 : n_sys - 1); });
    const int rounds = (mid - 1 > n_sys - 2 - mid) ? mid - 1 : n_sys - 2 - mid;
    for (int j = 1; j <= rounds; ++j) {
      const bool top = j <= mid - 1, bot = j <= n_sys - 2 - mid;
      const int kt = j, kb = n_sys - 1 - j;
      // g_k = L[k] dinv[k-1] (top); W_k = dinv[k+1] L[k+1] (bottom).
      for (int e = tid; e < 2 * W2; e += kThreads) {
        const int h = e / W2, rem = e - h * W2, i = rem / w, c = rem % w;
        if (h == 0 ? !top : !bot) continue;
        const float* const A = h == 0 ? BK(F2, kt - 1) + i * w : BK(F1, kb + 1) + i * w;
        const float* const Bv = h == 0 ? BK(F1, kt - 1) + c : BK(F2, kb) + c;
        Tw[e] = dotw(A, 1, Bv, w, w);
      }
      __syncthreads();
      // D[k] - g_k L[k]^T (top); D[k] - L[k+1]^T W_k (bottom).
      for (int e = tid; e < 2 * W2; e += kThreads) {
        const int h = e / W2, rem = e - h * W2, i = rem / w, c = rem % w;
        if (h == 0 ? !top : !bot) continue;
        const float acc = h == 0 ? dotw(Tw + i * w, 1, BK(F2, kt - 1) + c * w, 1, w)
                                 : dotw(BK(F2, kb) + i, w, Tw + W2 + c, w, w);
        Am[e] = BK(F1, h == 0 ? kt : kb)[rem] - acc;
        Ai[e] = ident(rem);
      }
      __syncthreads();
      // The multipliers replace the couplings (nothing reads those now).
      for (int e = tid; e < 2 * W2; e += kThreads) {
        const int h = e / W2, rem = e - h * W2;
        if (h == 0 ? top : bot) BK(F2, h == 0 ? kt - 1 : kb)[rem] = Tw[e];
      }
      gj_rounds(w, 2, Am, Ai, Bm, Bi, [&](int k) { return k == 0 ? top : bot; },
                [&](int k) { return BK(F1, k == 0 ? kt : kb); });
    }
    // The middle stage: the top Schur term, then the bottom one.
    for (int e = tid; e < 2 * W2; e += kThreads) {
      const int h = e / W2, rem = e - h * W2, i = rem / w, c = rem % w;
      if (h == 1 && !has_bot) continue;
      const float* const A = h == 0 ? BK(F2, mid - 1) + i * w : BK(F1, mid + 1) + i * w;
      const float* const Bv = h == 0 ? BK(F1, mid - 1) + c : BK(F2, mid) + c;
      Tw[e] = dotw(A, 1, Bv, w, w);
    }
    __syncthreads();
    for (int e = tid; e < W2; e += kThreads) {
      const int i = e / w, c = e % w;
      float v = BK(F1, mid)[e] - dotw(Tw + i * w, 1, BK(F2, mid - 1) + c * w, 1, w);
      if (has_bot) v = v - dotw(BK(F2, mid) + i, w, Tw + W2 + c, w, w);
      Am[e] = v;
      Ai[e] = ident(e);
    }
    __syncthreads();
    for (int e = tid; e < 2 * W2; e += kThreads) {
      const int h = e / W2, rem = e - h * W2;
      if (h == 0 || has_bot) BK(F2, h == 0 ? mid - 1 : mid)[rem] = Tw[e];
    }
    gj_rounds(w, 1, Am, Ai, Bm, Bi, always, [&](int) { return BK(F1, mid); });
  }

  // ---- the solve: Sv[0, n_sys) holds the rhs; the solution ends there.
  // Warp 0 runs both directions at once: lanes 0-15 the top chain, lanes
  // 16-31 the bottom chain, lane & 15 the block row. ---------------------
  const int lane = tid & 31, sh = lane >> 4, sr = lane & 15;
  const bool srow = sr < w;
  auto two_way_solve = [&]() {
    const int nt = mid, nb = n_sys - 1 - mid;
    const int steps = nt > nb ? nt : nb;
    if (tid < 32) {
      // Forward: top s[k] -= g[k-1] s[k-1] (row sr of g, k = i + 1);
      // bottom s[k] -= W[k]^T s[k+1] (column sr of W, k = n_sys - 2 - i).
      // Both halves run the same instructions on their own pointers.
      for (int i = 0; i < steps; ++i) {
        const bool my = srow && i < (sh == 0 ? nt : nb);
        const int k = sh == 0 ? i + 1 : n_sys - 2 - i;
        const float* const M = sh == 0 ? BK(F2, k - 1) + sr * w : BK(F2, k) + sr;
        const int ms = sh == 0 ? 1 : w;
        const float* const v = Sv + (sh == 0 ? k - 1 : k + 1) * w;
        const float acc = my ? dotw(M, ms, v, 1, w) : 0.f;
        if (nt == nb && i == nt - 1) {  // both fold into s[mid]: top first
          if (my && sh == 0) Sv[k * w + sr] = Sv[k * w + sr] - acc;
          __syncwarp();
          if (my && sh == 1) Sv[k * w + sr] = Sv[k * w + sr] - acc;
        } else if (my) {
          Sv[k * w + sr] = Sv[k * w + sr] - acc;
        }
        __syncwarp();
      }
    }
    __syncthreads();
    for (int e = tid; e < n_sys * w; e += kThreads) {  // u = dinv s
      const int k = e / w, c = e % w;
      Uv[e] = dotw(BK(F1, k) + c * w, 1, Sv + k * w, 1, w);
    }
    __syncthreads();
    if (tid < 32) {
      if (sh == 0 && srow) Sv[mid * w + sr] = Uv[mid * w + sr];
      __syncwarp();
      // Backward, outward from the middle: top x[k] = u[k] - g[k]^T x[k+1]
      // (k = mid - 1 - i); bottom x[k] = u[k] - W[k-1] x[k-1] (k = mid + 1 + i).
      for (int i = 0; i < steps; ++i) {
        const bool my = srow && i < (sh == 0 ? nt : nb);
        const int k = sh == 0 ? mid - 1 - i : mid + 1 + i;
        const float* const M = sh == 0 ? BK(F2, k) + sr : BK(F2, k - 1) + sr * w;
        const int ms = sh == 0 ? w : 1;
        const float* const v = Sv + (sh == 0 ? k + 1 : k - 1) * w;
        if (my) Sv[k * w + sr] = Uv[k * w + sr] - dotw(M, ms, v, 1, w);
        __syncwarp();
      }
    }
    __syncthreads();
  };

  // (A^T t)[k, j] for t = rho z - y (rz) or y: the J0 term (k < Nd), the J1
  // term (k > 0), then the stage-row term, each an ascending r-chain.
  auto at_sum = [&](int k, int j, float out, bool rz) -> float {
    if (k < Nd) {
      float acc = 0.f;
#pragma unroll 4
      for (int t = 0; t < r; ++t) {
        const int kt = k * r + t;
        const float td = rz ? SL(RDv, kt) * SL(ZD, kt) - SL(YD, kt) : SL(YD, kt);
        const float p = SL(J0, kt * w + j) * td;
        acc = (t == 0) ? p : acc + p;
      }
      out = out + acc;
    }
    if (k > 0) {
      float acc = 0.f;
#pragma unroll 4
      for (int t = 0; t < r; ++t) {
        const int kt = (k - 1) * r + t;
        const float td = rz ? SL(RDv, kt) * SL(ZD, kt) - SL(YD, kt) : SL(YD, kt);
        const float p = SL(J1, kt * w + j) * td;
        acc = (t == 0) ? p : acc + p;
      }
      out = out + acc;
    }
    float acc = 0.f;
#pragma unroll 4
    for (int t = 0; t < r2; ++t) {
      const int kt = k * r2 + t;
      const float tc = rz ? SL(RCv, kt) * SL(ZC, kt) - SL(YC, kt) : SL(YC, kt);
      const float p = SL(JC, kt * w + j) * tc;
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
    const float z_new = clip_nan(z_rel + y0 / rh, lo[i], hi[i]);
    y[i] = y0 + rh * (z_rel - z_new);
    z[i] = z_new;
  };

  float* const xt = cr1 ? Rv : Sv;  // where each solve leaves its result
  auto one_iter = [&]() {
    // rhs = sigma x - q + A^T (rho z - y): into R (cr1) or S.
    for (int e = tid; e < N * w; e += kThreads) {
      const float txv = SL(RXv, e) * SL(ZX, e) - SL(YX, e);
      const float at = at_sum(e / w, e % w, txv, true);
      xt[e] = (sigma * SL(X, e) - SL(Qv, e)) + at;
    }
    __syncthreads();
    if (cr1) {
      // t_o = dinv_o b_odd (into U), then the fold into S:
      // b'_even[i] = (b_even[i] - Lb[i]^T t_o[i]) - [i>0] La[i-1] t_o[i-1].
      for (int e = tid; e < H * w; e += kThreads) {
        const int i = e / w, c = e % w;
        const float* const M = BK(Dg, 2 * i + 1) + c * w;
        const float* const v = Rv + (2 * i + 1) * w;
        float acc = dotw(M, 1, v, 1, w);
        Uv[e] = acc;
      }
      __syncthreads();
      for (int e = tid; e < H * w; e += kThreads) {
        const int i = e / w, c = e % w;
        const float* const Lb = BK(Gg, 2 * i) + c;
        const float* const t0 = Uv + i * w;
        float s = dotw(Lb, w, t0, 1, w);
        float f = Rv[2 * i * w + c] - s;
        if (i > 0) {
          const float* const La = BK(Gg, 2 * i - 1) + c * w;
          const float* const t1 = Uv + (i - 1) * w;
          float t = dotw(La, 1, t1, 1, w);
          f = f - t;
        }
        Sv[e] = f;
      }
      __syncthreads();
    }
    two_way_solve();
    if (cr1) {
      // rhs_o = (b_odd - Lb x_even) - [i<H-1] La^T x_even[i+1] (into U),
      // then x_odd = dinv_o rhs_o; the interleaved solution goes to R.
      for (int e = tid; e < H * w; e += kThreads) {
        const int i = e / w, c = e % w;
        const float* const Lb = BK(Gg, 2 * i) + c * w;
        const float* const x0_ = Sv + i * w;
        float s = dotw(Lb, 1, x0_, 1, w);
        float v = Rv[(2 * i + 1) * w + c] - s;
        if (i < H - 1) {
          const float* const La = BK(Gg, 2 * i + 1) + c;
          const float* const x1 = Sv + (i + 1) * w;
          float t = dotw(La, w, x1, 1, w);
          v = v - t;
        }
        Uv[e] = v;
      }
      __syncthreads();
      for (int e = tid; e < H * w; e += kThreads) {
        const int i = e / w, c = e % w;
        const float* const M = BK(Dg, 2 * i + 1) + c * w;
        const float* const v = Uv + i * w;
        float acc = dotw(M, 1, v, 1, w);
        Rv[(2 * i + 1) * w + c] = acc;
        Rv[2 * i * w + c] = Sv[e];
      }
      __syncthreads();
    }
    // z/y updates from A xt, then the relaxed x.
    for (int e = tid; e < Nd * r; e += kThreads)
      relax(a_dyn(xt, e / r, e % r), ZD, YD, RDv, LDv, UDv, e);
    for (int e = tid; e < N * r2; e += kThreads)
      relax(a_stage(xt, e / r2, e % r2), ZC, YC, RCv, LCv, UCv, e);
    for (int e = tid; e < N * w; e += kThreads) {
      const float xv = xt[e];
      relax(xv, ZX, YX, RXv, LXv, UXv, e);
      SL(X, e) = alpha * xv + oma * SL(X, e);
    }
    __syncthreads();
  };

  const int it0 = a.it0[b];
  int done = a.done0[b];
  int it_inc = 0;
  const float ci = a.ci[b];
  float rp = INFINITY, rdu = INFINITY, mp = INFINITY, md = INFINITY;

  for (int kb = 0; kb < d.interval; kb += d.check_every) {
    // Uniform across the block: one scenario per block.
    if (!(done == 0 && it0 + kb < d.max_iter)) break;
    for (int t = 0; t < d.check_every; ++t) one_iter();

    // Unscaled residuals (OSQP termination): this thread's entries, then
    // the scenario's maxima over warps and over the block.
    float p[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int e = tid; e < N * w; e += kThreads) {
      const float ev = SL(EXv, e), xv = SL(X, e), zv = SL(ZX, e);
      p[0] = nmax(p[0], fabsf((xv - zv) * ev));
      p[1] = nmax(p[1], fabsf(xv * ev));
      p[2] = nmax(p[2], fabsf(zv * ev));
    }
    for (int e = tid; e < Nd * r; e += kThreads) {
      const float ev = SL(EDv, e), av = a_dyn(X, e / r, e % r), zv = SL(ZD, e);
      p[0] = nmax(p[0], fabsf((av - zv) * ev));
      p[1] = nmax(p[1], fabsf(av * ev));
      p[2] = nmax(p[2], fabsf(zv * ev));
    }
    for (int e = tid; e < N * r2; e += kThreads) {
      const float ev = SL(ECv, e), av = a_stage(X, e / r2, e % r2), zv = SL(ZC, e);
      p[0] = nmax(p[0], fabsf((av - zv) * ev));
      p[1] = nmax(p[1], fabsf(av * ev));
      p[2] = nmax(p[2], fabsf(zv * ev));
    }
    for (int e = tid; e < N * w; e += kThreads) {
      const int k = e / w, j = e % w;
      const float px = dotw(HB + e * w, 1, X + k * w, 1, w);
      const float aty = at_sum(k, j, SL(YX, e), false);
      const float dsv = SL(DSv, e), qv = SL(Qv, e);
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
#undef SL
#undef AT
}

}  // namespace

extern "C" {

// ptrs: the kNumPtrs device pointers in RolledArgs order; `per` the floats
// of the slab per scenario (checked against this file's layout).  Returns
// the cudaError_t of the launch (0 on success); the kernel runs on
// `stream` and is not synchronised.
int ocp_banded_admm_chunk_rolled_f32(const void* const* ptrs, int nptrs, int N, int w,
                                     int r, int r2, int B, int interval, int check_every,
                                     int max_iter, int cr1, int per, double sigma,
                                     double alpha, double eps_abs, double eps_rel,
                                     void* stream) {
  if (nptrs != kNumPtrs || N < 2 || w < 1 || w > kMaxW || r < 1 || r2 < 1 || B < 1 ||
      check_every < 1 || (cr1 && (N % 2 != 0 || N < 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = make_layout(N, w, r, r2, cr1);
  if (per != L.total) return static_cast<int>(cudaErrorInvalidValue);
  static_assert(sizeof(RolledArgs) == kNumPtrs * sizeof(void*), "RolledArgs layout");
  RolledArgs a;
  memcpy(&a, ptrs, sizeof(RolledArgs));
  Dims d;
  d.N = N;
  d.w = w;
  d.r = r;
  d.r2 = r2;
  d.B = B;
  d.interval = interval;
  d.check_every = check_every;
  d.max_iter = max_iter;
  d.cr1 = cr1 ? 1 : 0;
  d.per = per;
  d.sigma = static_cast<float>(sigma);
  d.alpha = static_cast<float>(alpha);
  d.one_m_alpha = static_cast<float>(1.0 - alpha);
  d.eps_abs = static_cast<float>(eps_abs);
  d.eps_rel = static_cast<float>(eps_rel);
  // Shared memory, greedily in order of preference: the workspace and
  // vectors; the carried state; the couplings F2 (read by both serial
  // sweeps); the pivot inverses F1 (read by the stage-parallel u = dinv s);
  // the operator rows.
  const long long W2 = static_cast<long long>(w) * w;
  const long long n_sys = cr1 ? N / 2 : N;
  long long fl = kRedFloats;
  auto tier = [&](long long cnt) -> int {
    if ((fl + cnt) * 4 > kSmemLimit) return 0;
    fl += cnt;
    return 1;
  };
  d.vec_s = tier(10 * W2 + 3LL * N * w);
  d.st_s = tier(st_floats(N, w, r, r2));
  d.f2_s = tier((n_sys - 1) * W2);
  d.f1_s = tier(n_sys * W2);
  d.ov_s = tier(ov_floats(N, w, r, r2));
  const size_t smem = static_cast<size_t>(fl) * sizeof(float);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (w == kMaxW) {
    err = cudaFuncSetAttribute(rolled_chunk_kernel<kMaxW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    rolled_chunk_kernel<kMaxW><<<B, kThreads, smem, st>>>(a, d, L);
  } else {
    err = cudaFuncSetAttribute(rolled_chunk_kernel<0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    rolled_chunk_kernel<0><<<B, kThreads, smem, st>>>(a, d, L);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ocp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
