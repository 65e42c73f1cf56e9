// Fused block-tridiagonal ADMM chunk for a batch of stage-structured QPs,
// batch-last layout, one warp per scenario.  CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel
//   optimal_control_problem_tpu/ops/banded_kernel.py::banded_admm_chunk
// (its `_kernel`) with the same inputs, the same 13 outputs and the same
// per-element op order: the M = P + sigma I + A^T R A assembly with
// ascending r-chains, the block-Thomas factorization with sequential
// j-chain block products and the Gauss-Jordan pivot inverses, then up to
// `interval` over-relaxed OSQP-ADMM iterations with the forward/backward
// block sweeps, the clip projection and the dual update, and per-scenario
// OSQP termination on unscaled residuals every `check_every` iterations.
// Scenarios enter with their own iteration counts (it0) and frozen flags
// (done0); a scenario stops at check-block granularity, which is exactly
// what the TPU kernel's tile-wide while loop computes for it.  Built with
// -fmad=false (ops/build.py): every multiply and add rounds on its own, in
// the op order of the plain PyTorch version
// (ops/banded_kernel.py::banded_admm_chunk_plain, whose sums are the same
// ascending chains), so the two agree bitwise.
//
// What bounds it.  The operator and state bytes read and written once per
// launch are about 14 KB a scenario at cart-pole h20 (N=20, w=5, r=4,
// r2=1): about 14 MB at B=1024, 4 us at the card's 3.35 TB/s; the
// operations (~10 k per iteration and scenario) are far below that at the
// float32 peak.  No design reaches it: a launch lasts as long as its
// slowest scenario (on the main path the scenarios average ~6 iterations
// a launch, but the slowest one runs 12 to ~400), and that scenario's
// iterations are chains of dependent steps -- 2N block sweep steps per
// iteration, N block inverses per factorization.  So the kernel is built
// for the latency of one scenario's iteration.
//
// Design.  One warp (a thread block of 32 threads) per scenario: 1024
// warps at B=1024, about eight on each of the card's 132 SMs.
//   * The scenario's factors (dinv, g: (2N-1) w^2 floats), its carried
//     state, the sweep vectors and a copy of its operators (Hb, J0, J1,
//     Jc, bound and scaling rows) live in the block's shared memory, about
//     16 KB at cart-pole h20, copied from the batch-last inputs once.  When
//     they do not fit (large N), a global scratch slab per scenario holds
//     them instead (the wrapper allocates it), same code.
//   * The sweeps run on a team of w lanes, one block row each, each row dot
//     one lane's ascending chain (the plain version's order); a step's new
//     stage vector goes through shared memory with one __syncwarp().  No
//     block-wide barrier exists.
//   * The stage-parallel phases (the assembly, the A and A^T products, the
//     relaxation and projection, the residual maxima) spread over all 32
//     lanes, one element or row each; the maxima reduce with shuffles.
//   * The factorization's products and Gauss-Jordan pivot rounds run
//     element-parallel on w^2 <= 25 lanes, the block and its inverse in a
//     ping-pong pair in shared memory: one __syncwarp() per pivot.
// Why not floor(32 / w) scenarios per warp, a team of w lanes each: one
// lane then walks all N stages of every stage-parallel phase, with few
// warps per scheduler to hide its dependent loads and adds, and on the
// card those phases, not the sweeps, set the iteration's time.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <string.h>

namespace {

constexpr int kWarp = 32;  // threads per block: one warp

struct ChunkArgs {
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
  const float* rx;   // (N, w, B)
  const float* ld;
  const float* ud;
  const float* rd;   // (Nd, r, B)
  const float* lc;
  const float* uc;
  const float* rc;   // (N, r2, B)
  const float* ds;   // (N, w, B)
  const float* ex;   // (N, w, B)
  const float* ed;   // (Nd, r, B)
  const float* ec;   // (N, r2, B)
  const float* ci;   // (B,)
  const float* x0;
  const float* yx0;
  const float* yd0;
  const float* yc0;
  const float* zx0;
  const float* zd0;
  const float* zc0;
  // outputs
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
  // scratch: (B, per) scenario slabs when one does not fit in shared
  // memory (unused otherwise)
  float* slab;
};
constexpr int kNumPtrs = 42;

struct Dims {
  int N, r, r2, B;
  int interval, check_every, max_iter;
  int per;      // floats of one scenario's slab
  int in_smem;  // 1: the slab lives in dynamic shared memory
  float sigma, alpha, one_m_alpha, eps_abs, eps_rel;
};

// Floats of one scenario's slab: dinv (N w^2), g ((N-1) w^2), the sweep and
// solution vectors and x, zx, yx (5 N w), zd, yd (2 (N-1) r), zc, yc
// (2 N r2), the factorization's product and Gauss-Jordan ping-pong pair
// (5 w^2); then the copy of the operators: Hb (N w^2), J0, J1
// (2 (N-1) r w), Jc (N r2 w), q, rho_x, lx, ux, ds, ex (6 N w), rho_d, ld,
// ud, ed (4 (N-1) r), rho_c, lc, uc, ec (4 N r2).
// ops/banded_kernel.py::slab_floats mirrors it.
int slab_floats(int N, int w, int r, int r2) {
  return (2 * N - 1) * w * w + 5 * N * w + 2 * (N - 1) * r + 2 * N * r2 + 5 * w * w +
         N * w * w + 2 * (N - 1) * r * w + N * r2 * w + 6 * N * w + 4 * (N - 1) * r +
         4 * N * r2;
}

// min(max(v, lo), hi) as torch.clip / torch.minimum(torch.maximum(...))
// compute it: a NaN v stays NaN (fmaxf / fminf alone would clip it to a
// bound).  The bounds are never NaN.
__device__ __forceinline__ float clip_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// NaN-propagating max (jnp.max semantics; fmaxf would drop a NaN).
__device__ __forceinline__ float nmax(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// kSmem: the slab is this block's shared memory (every pointer into it is
// a shared-memory address, so its loads and stores are shared-memory
// instructions); else the scenario's part of the global scratch.
template <int W, bool kSmem>
__global__ void __launch_bounds__(kWarp)
banded_chunk_kernel(const ChunkArgs a, const Dims d) {
  extern __shared__ float smem[];
  constexpr int WW = W * W;
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const bool row = lane < W;            // a lane of the sweeps' row team
  const int t = row ? lane : 0;         // its block row (others read row 0)
  const bool el = lane < WW;            // a lane of the element-parallel steps
  const int ei = el ? lane / W : 0, ej = el ? lane % W : 0;
  const int N = d.N, r = d.r, r2 = d.r2, Nd = d.N - 1;
  const size_t SB = static_cast<size_t>(d.B);
#define AT(p, i) (p)[static_cast<size_t>(i) * SB + b]

  float* const sl = kSmem ? smem : a.slab + static_cast<size_t>(b) * d.per;
  float* const Dv = sl;                  // (N, W, W) diagonal blocks -> pivot inverses
  float* const Gv = Dv + N * WW;         // (Nd, W, W) subdiagonal blocks -> multipliers
  float* const sv = Gv + Nd * WW;        // (N, W) rhs -> forward sweep
  float* const xv = sv + N * W;          // (N, W) the solve's result
  float* const X = xv + N * W;           // carried state
  float* const ZX = X + N * W;
  float* const YX = ZX + N * W;
  float* const ZD = YX + N * W;          // (Nd, r)
  float* const YD = ZD + Nd * r;
  float* const ZC = YD + Nd * r;         // (N, r2)
  float* const YC = ZC + N * r2;
  float* const T = YC + N * r2;          // (W, W) a factorization product
  float* const Am = T + WW;              // Gauss-Jordan ping-pong pair
  float* const Ai = Am + WW;
  float* const Bm = Ai + WW;
  float* const Bi = Bm + WW;
  // The scenario's operators, copied from the batch-last inputs once.
  float* const HB = Bi + WW;             // (N, W, W)
  float* const J0 = HB + N * WW;         // (Nd, r, W)
  float* const J1 = J0 + Nd * r * W;
  float* const JC = J1 + Nd * r * W;     // (N, r2, W)
  float* const Qv = JC + N * r2 * W;     // (N, W) q, rho_x, lx, ux, ds, ex
  float* const RXv = Qv + N * W;
  float* const LXv = RXv + N * W;
  float* const UXv = LXv + N * W;
  float* const DSv = UXv + N * W;
  float* const EXv = DSv + N * W;
  float* const RDv = EXv + N * W;        // (Nd, r) rho_d, ld, ud, ed
  float* const LDv = RDv + Nd * r;
  float* const UDv = LDv + Nd * r;
  float* const EDv = UDv + Nd * r;
  float* const RCv = EDv + Nd * r;       // (N, r2) rho_c, lc, uc, ec
  float* const LCv = RCv + N * r2;
  float* const UCv = LCv + N * r2;
  float* const ECv = UCv + N * r2;

  // ---- the scenario's operators and carried state into the slab -------
  {
    auto copy = [&](float* dst, const float* src, int cnt) {
#pragma unroll 4
      for (int i = lane; i < cnt; i += kWarp) dst[i] = __ldg(src + static_cast<size_t>(i) * SB + b);
    };
    copy(HB, a.hb, N * WW);
    copy(J0, a.j0, Nd * r * W);
    copy(J1, a.j1, Nd * r * W);
    copy(JC, a.jc, N * r2 * W);
    copy(Qv, a.q, N * W);
    copy(RXv, a.rx, N * W);
    copy(LXv, a.lx, N * W);
    copy(UXv, a.ux, N * W);
    copy(DSv, a.ds, N * W);
    copy(EXv, a.ex, N * W);
    copy(RDv, a.rd, Nd * r);
    copy(LDv, a.ld, Nd * r);
    copy(UDv, a.ud, Nd * r);
    copy(EDv, a.ed, Nd * r);
    copy(RCv, a.rc, N * r2);
    copy(LCv, a.lc, N * r2);
    copy(UCv, a.uc, N * r2);
    copy(ECv, a.ec, N * r2);
    copy(X, a.x0, N * W);
    copy(YX, a.yx0, N * W);
    copy(ZX, a.zx0, N * W);
    copy(YD, a.yd0, Nd * r);
    copy(ZD, a.zd0, Nd * r);
    copy(YC, a.yc0, N * r2);
    copy(ZC, a.zc0, N * r2);
  }
  __syncwarp();

  // ---- M assembly, element-parallel over every stage: base, then the J0,
  // J1 and stage-row terms, each an ascending r-chain; the subdiagonal
  // blocks into Gv.
  for (int e = lane; e < N * WW; e += kWarp) {
    const int k = e / WW, i = (e / W) % W, j = e % W;
    const float one = (i == j) ? 1.f : 0.f;
    float v = HB[e] + d.sigma * one;
    v = v + one * RXv[k * W + i];
    if (k < Nd) {
      float acc = 0.f;
#pragma unroll 4
      for (int q = 0; q < r; ++q) {
        const int kt = k * r + q;
        const float p = (RDv[kt] * J0[kt * W + i]) * J0[kt * W + j];
        acc = (q == 0) ? p : acc + p;
      }
      v = v + acc;
    }
    if (k > 0) {
      float acc = 0.f;
#pragma unroll 4
      for (int q = 0; q < r; ++q) {
        const int kt = (k - 1) * r + q;
        const float p = (RDv[kt] * J1[kt * W + i]) * J1[kt * W + j];
        acc = (q == 0) ? p : acc + p;
      }
      v = v + acc;
    }
    {
      float acc = 0.f;
#pragma unroll 4
      for (int q = 0; q < r2; ++q) {
        const int kt = k * r2 + q;
        const float p = (RCv[kt] * JC[kt * W + i]) * JC[kt * W + j];
        acc = (q == 0) ? p : acc + p;
      }
      v = v + acc;
    }
    Dv[e] = v;
    if (k < Nd) {
      float acc = 0.f;
#pragma unroll 4
      for (int q = 0; q < r; ++q) {
        const int kt = k * r + q;
        const float p = (RDv[kt] * J1[kt * W + i]) * J0[kt * W + j];
        acc = (q == 0) ? p : acc + p;
      }
      Gv[e] = acc;
    }
  }
  __syncwarp();

  // Gauss-Jordan pivot rounds with diagonal pivots (op order of
  // ops/block_tridiag.small_spd_inv), element-parallel: the block in Am and
  // the identity in Ai at entry; one __syncwarp() per pivot; the inverse
  // lands in dst.
  auto gj = [&](float* dst) {
#pragma unroll
    for (int p = 0; p < W; ++p) {
      const float* const cm = (p & 1) ? Bm : Am;
      const float* const cv = (p & 1) ? Bi : Ai;
      float* const nm = (p & 1) ? Am : Bm;
      float* const nv = (p & 1) ? Ai : Bi;
      if (el) {
        const float piv = cm[p * W + p];
        const float mrow = cm[p * W + ej] / piv;
        const float irow = cv[p * W + ej] / piv;
        float vm, vi;
        if (ei == p) {
          vm = mrow;
          vi = irow;
        } else {
          const float col = cm[ei * W + p];
          vm = cm[lane] - col * mrow;
          vi = cv[lane] - col * irow;
        }
        if (p == W - 1) {
          dst[lane] = vi;
        } else {
          nm[lane] = vm;
          nv[lane] = vi;
        }
      }
      __syncwarp();
    }
  };

  // ---- block-Thomas factorization: Dv <- pivot inverses, Gv <- the
  // multipliers g_k = low_{k-1} dinv_{k-1}. -----------------------------
  if (el) {
    Am[lane] = Dv[lane];
    Ai[lane] = (ei == ej) ? 1.f : 0.f;
  }
  __syncwarp();
  gj(Dv);
  for (int k = 1; k < N; ++k) {
    const float* const prev = Dv + (k - 1) * WW;
    float* const low = Gv + (k - 1) * WW;
    if (el) {  // g_k = low_{k-1} dinv_{k-1}
      float acc = low[ei * W] * prev[ej];
#pragma unroll
      for (int j = 1; j < W; ++j) acc = acc + low[ei * W + j] * prev[j * W + ej];
      T[lane] = acc;
    }
    __syncwarp();
    if (el) {  // D_k - g_k low_{k-1}^T
      float acc = T[ei * W] * low[ej * W];
#pragma unroll
      for (int j = 1; j < W; ++j) acc = acc + T[ei * W + j] * low[ej * W + j];
      Am[lane] = Dv[k * WW + lane] - acc;
      Ai[lane] = (ei == ej) ? 1.f : 0.f;
    }
    __syncwarp();
    if (el) low[lane] = T[lane];  // nothing reads low_{k-1} any more
    gj(Dv + k * WW);
  }

  // (A^T t)[k, j] for t = (tx, td, tc) given as rho*z - y (rz) or as y:
  // the J0 term (stage k < Nd), then the J1 term (k > 0), then the
  // stage-row term, each an ascending r-chain.
  auto at_sum = [&](int k, int j, float out, bool rz) -> float {
    if (k < Nd) {
      float acc = 0.f;
#pragma unroll 4
      for (int q = 0; q < r; ++q) {
        const int kt = k * r + q;
        const float td = rz ? RDv[kt] * ZD[kt] - YD[kt] : YD[kt];
        const float p = J0[kt * W + j] * td;
        acc = (q == 0) ? p : acc + p;
      }
      out = out + acc;
    }
    if (k > 0) {
      float acc = 0.f;
#pragma unroll 4
      for (int q = 0; q < r; ++q) {
        const int kt = (k - 1) * r + q;
        const float td = rz ? RDv[kt] * ZD[kt] - YD[kt] : YD[kt];
        const float p = J1[kt * W + j] * td;
        acc = (q == 0) ? p : acc + p;
      }
      out = out + acc;
    }
    float acc = 0.f;
#pragma unroll 4
    for (int q = 0; q < r2; ++q) {
      const int kt = k * r2 + q;
      const float tc = rz ? RCv[kt] * ZC[kt] - YC[kt] : YC[kt];
      const float p = JC[kt * W + j] * tc;
      acc = (q == 0) ? p : acc + p;
    }
    return out + acc;
  };

  // Dynamics row (k, i) and stage row (k, i) of A x, x a slab vector.
  auto a_dyn = [&](const float* xs, int k, int i) -> float {
    const int kt = k * r + i;
    float s0 = J0[kt * W] * xs[k * W];
#pragma unroll
    for (int j = 1; j < W; ++j) s0 = s0 + J0[kt * W + j] * xs[k * W + j];
    float s1 = J1[kt * W] * xs[(k + 1) * W];
#pragma unroll
    for (int j = 1; j < W; ++j) s1 = s1 + J1[kt * W + j] * xs[(k + 1) * W + j];
    return s0 + s1;
  };
  auto a_stage = [&](const float* xs, int k, int i) -> float {
    const int kt = k * r2 + i;
    float s0 = JC[kt * W] * xs[k * W];
#pragma unroll
    for (int j = 1; j < W; ++j) s0 = s0 + JC[kt * W + j] * xs[k * W + j];
    return s0;
  };

  const float alpha = d.alpha, oma = d.one_m_alpha, sigma = d.sigma;
  auto relax = [&](float zt, float* z, float* y, const float* rho, const float* lo,
                   const float* hi, int i) {
    const float rh = rho[i];
    const float z_rel = alpha * zt + oma * z[i];
    const float y0 = y[i];
    const float z_new = clip_nan(z_rel + y0 / rh, lo[i], hi[i]);
    y[i] = y0 + rh * (z_rel - z_new);
    z[i] = z_new;
  };

  auto one_iter = [&]() {
    // rhs = sigma x - q + A^T (rho z - y), a row per lane.
    for (int e = lane; e < N * W; e += kWarp) {
      const float tx = RXv[e] * ZX[e] - YX[e];
      const float at = at_sum(e / W, e % W, tx, true);
      sv[e] = (sigma * X[e] - Qv[e]) + at;
    }
    __syncwarp();
    // Forward sweep on the row team: s_k -= g_{k-1} s_{k-1}.
    float v[W];
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = sv[j];
    for (int k = 1; k < N; ++k) {
      const float* const g = Gv + ((k - 1) * W + t) * W;
      float acc = g[0] * v[0];
#pragma unroll
      for (int j = 1; j < W; ++j) acc = acc + g[j] * v[j];
      const float nx = sv[k * W + t] - acc;
      if (row) sv[k * W + t] = nx;
      __syncwarp();
#pragma unroll
      for (int j = 0; j < W; ++j) v[j] = sv[k * W + j];
    }
    // u_k = dinv_k s_k for every stage, a row per lane: no dependency
    // between stages, so it leaves the backward sweep's serial chain.
    for (int e = lane; e < N * W; e += kWarp) {
      const float* const dk = Dv + e * W;
      const float* const sk = sv + (e / W) * W;
      float acc = dk[0] * sk[0];
#pragma unroll
      for (int j = 1; j < W; ++j) acc = acc + dk[j] * sk[j];
      xv[e] = acc;
    }
    __syncwarp();
    // Backward sweep: x_{N-1} = u_{N-1}; x_k = u_k - g_k^T x_{k+1}.
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = xv[(N - 1) * W + j];
    for (int k = N - 2; k >= 0; --k) {
      const float* const gk = Gv + k * WW + t;
      float t2 = gk[0] * v[0];
#pragma unroll
      for (int i = 1; i < W; ++i) t2 = t2 + gk[i * W] * v[i];
      // Row t of u_k is read by its own lane only (the others' t = 0 reads
      // are never stored), so x_k replaces it in place.
      const float xk = xv[k * W + t] - t2;
      if (row) xv[k * W + t] = xk;
      __syncwarp();
#pragma unroll
      for (int j = 0; j < W; ++j) v[j] = xv[k * W + j];
    }
    // z/y updates from A xt, then the relaxed x, a row per lane.
    for (int e = lane; e < Nd * r; e += kWarp)
      relax(a_dyn(xv, e / r, e % r), ZD, YD, RDv, LDv, UDv, e);
    for (int e = lane; e < N * r2; e += kWarp)
      relax(a_stage(xv, e / r2, e % r2), ZC, YC, RCv, LCv, UCv, e);
    for (int e = lane; e < N * W; e += kWarp) {
      const float xtv = xv[e];
      relax(xtv, ZX, YX, RXv, LXv, UXv, e);
      X[e] = alpha * xtv + oma * X[e];
    }
    __syncwarp();
  };

  const int it0 = a.it0[b];
  int done = a.done0[b];
  int it_inc = 0;
  const float ci = a.ci[b];
  float rp = INFINITY, rdu = INFINITY, mp = INFINITY, md = INFINITY;

  for (int kb = 0; kb < d.interval; kb += d.check_every) {
    // Uniform across the warp: one scenario per warp.
    if (done != 0 || it0 + kb >= d.max_iter) break;
    for (int it = 0; it < d.check_every; ++it) one_iter();

    // Unscaled residuals (OSQP termination): this lane's rows, then the
    // scenario's maxima over the warp.
    float p[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = lane; i < N * W; i += kWarp) {
      const float e = EXv[i], xx = X[i], zv = ZX[i];
      p[0] = nmax(p[0], fabsf((xx - zv) * e));
      p[1] = nmax(p[1], fabsf(xx * e));
      p[2] = nmax(p[2], fabsf(zv * e));
    }
    for (int ki = lane; ki < Nd * r; ki += kWarp) {
      const float e = EDv[ki], av = a_dyn(X, ki / r, ki % r), zv = ZD[ki];
      p[0] = nmax(p[0], fabsf((av - zv) * e));
      p[1] = nmax(p[1], fabsf(av * e));
      p[2] = nmax(p[2], fabsf(zv * e));
    }
    for (int ki = lane; ki < N * r2; ki += kWarp) {
      const float e = ECv[ki], av = a_stage(X, ki / r2, ki % r2), zv = ZC[ki];
      p[0] = nmax(p[0], fabsf((av - zv) * e));
      p[1] = nmax(p[1], fabsf(av * e));
      p[2] = nmax(p[2], fabsf(zv * e));
    }
    for (int kc = lane; kc < N * W; kc += kWarp) {
      const int k = kc / W;
      float px = HB[kc * W] * X[k * W];
#pragma unroll
      for (int j = 1; j < W; ++j) px = px + HB[kc * W + j] * X[k * W + j];
      const float aty = at_sum(k, kc % W, YX[kc], false);
      const float dsv = DSv[kc], qv = Qv[kc];
      p[3] = nmax(p[3], fabsf((px + qv + aty) * dsv));
      p[4] = nmax(p[4], fabsf(aty * dsv));
      p[5] = nmax(p[5], fabsf(px * dsv));
      p[6] = nmax(p[6], fabsf(qv * dsv));
    }
#pragma unroll
    for (int q = 0; q < 7; ++q)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) p[q] = nmax(p[q], __shfl_xor_sync(0xffffffffu, p[q], o));
    const float r_prim = p[0];
    const float r_dual = ci * p[3];
    const float max_prim = nmax(p[1], p[2]);
    const float max_dual = ci * nmax(nmax(p[4], p[5]), p[6]);
    const float eps_pri = d.eps_abs + d.eps_rel * max_prim;
    const float eps_dua = d.eps_abs + d.eps_rel * max_dual;
    it_inc += d.check_every;
    rp = r_prim;
    rdu = r_dual;
    mp = max_prim;
    md = max_dual;
    if (r_prim <= eps_pri && r_dual <= eps_dua) done = 1;
  }

  // ---- carried state and per-scenario results out ---------------------
  for (int i = lane; i < N * W; i += kWarp) {
    AT(a.x, i) = X[i];
    AT(a.yx, i) = YX[i];
    AT(a.zx, i) = ZX[i];
  }
  for (int i = lane; i < Nd * r; i += kWarp) {
    AT(a.yd, i) = YD[i];
    AT(a.zd, i) = ZD[i];
  }
  for (int i = lane; i < N * r2; i += kWarp) {
    AT(a.yc, i) = YC[i];
    AT(a.zc, i) = ZC[i];
  }
  if (lane == 0) {
    a.done[b] = done;
    a.it_inc[b] = it_inc;
    a.rp[b] = rp;
    a.rdual[b] = rdu;
    a.mp[b] = mp;
    a.md[b] = md;
  }
#undef AT
}

template <int W, bool kSmem>
cudaError_t launch_as(const ChunkArgs& a, const Dims& d, cudaStream_t stream) {
  const size_t smem = kSmem ? static_cast<size_t>(d.per) * sizeof(float) : 0;
  cudaError_t err = cudaFuncSetAttribute(banded_chunk_kernel<W, kSmem>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  banded_chunk_kernel<W, kSmem><<<d.B, kWarp, smem, stream>>>(a, d);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch(const ChunkArgs& a, const Dims& d, cudaStream_t stream) {
  return d.in_smem ? launch_as<W, true>(a, d, stream) : launch_as<W, false>(a, d, stream);
}

}  // namespace

extern "C" {

// ptrs: the kNumPtrs device pointers in ChunkArgs order.  `per` is the
// floats of one scenario's slab (checked against this file's layout) and
// `in_smem` says where the slabs live (the wrapper's choice).  Returns the cudaError_t of the launch (0 on
// success); the kernel runs on `stream` and is not synchronised.
int ocp_banded_admm_chunk_f32(const void* const* ptrs, int nptrs, int N, int w, int r,
                              int r2, int B, int interval, int check_every,
                              int max_iter, int per, int in_smem, double sigma,
                              double alpha, double eps_abs, double eps_rel, void* stream) {
  if (nptrs != kNumPtrs || N < 2 || w < 3 || w > 5 || r < 1 || r2 < 1 || B < 1 ||
      check_every < 1 || per != slab_floats(N, w, r, r2))
    return static_cast<int>(cudaErrorInvalidValue);
  static_assert(sizeof(ChunkArgs) == kNumPtrs * sizeof(void*), "ChunkArgs layout");
  ChunkArgs a;
  memcpy(&a, ptrs, sizeof(ChunkArgs));
  Dims d;
  d.N = N;
  d.r = r;
  d.r2 = r2;
  d.B = B;
  d.interval = interval;
  d.check_every = check_every;
  d.max_iter = max_iter;
  d.per = per;
  d.in_smem = in_smem ? 1 : 0;
  d.sigma = static_cast<float>(sigma);
  d.alpha = static_cast<float>(alpha);
  d.one_m_alpha = static_cast<float>(1.0 - alpha);
  d.eps_abs = static_cast<float>(eps_abs);
  d.eps_rel = static_cast<float>(eps_rel);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (w) {
    case 3: err = launch<3>(a, d, s); break;
    case 4: err = launch<4>(a, d, s); break;
    default: err = launch<5>(a, d, s); break;
  }
  return static_cast<int>(err);
}

const char* ocp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
