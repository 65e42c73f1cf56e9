// Rolled two-way block-tridiagonal ADMM chunk for a batch of
// stage-structured QPs, batch-last layout.  CUDA C++ for sm_90a.
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
// (ops/build.py) and every sum an ascending chain, so it can agree with
// the plain version bitwise.
//
// Design.  The one-way kernel (banded_chunk.cu) keeps whole blocks in one
// thread's registers; a 16x16 block is 256 floats, more than a thread's
// 255 registers, so that design stops at w = 5.  Here a block of threads
// covers kTB neighbouring scenarios (threadIdx.x, so batch-last loads stay
// coalesced) times the w block rows (threadIdx.y, one thread per row `a`
// of every w-vector and w x w block).  Each row-dot runs in one thread in
// the plain version's ascending order.  Factors (dinv, g), the reduced
// system and the sweep vectors live in global scratch allocated by the
// wrapper (about 17 MB at quadrotor h100, B=64: N=100, w=16, r=12), so the
// working set stays in the 50 MB L2.  Rows computed by one thread and
// needed by the others -- the Gauss-Jordan pivot row, the W and Vb blocks
// of the Schur products, the previous stage vector of each sweep step --
// are exchanged through shared memory or global scratch with one barrier
// per dependent step.  Each thread's working rows (the block row being
// inverted, its inverse, product rows) sit in shared memory, laid out so a
// warp touches consecutive words; the loops are not unrolled, which keeps
// the build to seconds (fully unrolled register rows took ptxas minutes).
// Any w <= kMaxW = 16, any N >= 2.
//
// What bounds it.  Per launch at quadrotor h100, B=64 the function must
// read and write about 24 MB (Hb 6.6 MB, J0/J1 9.7 MB, the bound, scale and
// state vectors about 8 MB): about 7 us at the card's 3.35 TB/s; the
// operations (about 0.5 G per launch at the main path's ~2 iterations, most
// of them in the assembly and factorization) take a little less at the
// float32 peak.  This first design is far from either bound: it is latency-bound
// on the 2 x (n_sys / 2) dependent sweep steps per iteration (about 60
// barriers, each after a w-long dependent add chain on L1/L2 loads), on
// the sequential factorization chains, and on few blocks (B / kTB = 8 at
// B=64).  Interleaving the factorization's two chains, keeping the
// factors in shared memory and more scenarios in flight is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <string.h>

namespace {

constexpr int kTB = 8;     // scenarios per thread block (threadIdx.x)
constexpr int kMaxW = 16;  // widest block (threadIdx.y, one thread per row)

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
  // scratch
  float* dM;  // (N, w, w, B) M diagonal; odd slots -> dinv_o under cr1; else -> dinv
  float* gM;  // (N-1, w, w, B) M subdiagonal (Lb/La under cr1); else -> g / W
  float* dR;  // (N/2, w, w, B) reduced diagonal -> dinv (cr1 only)
  float* gR;  // (N/2-1, w, w, B) reduced couplings -> g / W (cr1 only)
  float* R;   // (N, w, B) rhs (cr1), then the solution xt
  float* S;   // (N, w, B) sweep vector; the solution xt without cr1
  float* U;   // (N, w, B) u = dinv s; fold/recovery temporaries
};
constexpr int kNumPtrs = 48;

struct Dims {
  int N, w, r, r2, B;
  int interval, check_every, max_iter, cr1;
  float sigma, alpha, one_m_alpha, eps_abs, eps_rel;
};

// NaN-propagating max (jnp.max / torch.amax semantics).
__device__ __forceinline__ float nmax(float m, float v) {
  return (v > m || v != v) ? v : m;
}

__global__ void __launch_bounds__(kTB * kMaxW)
rolled_chunk_kernel(const RolledArgs a, const Dims d) {
  // Per-thread row buffers, [buffer][column][thread] so that a warp's 32
  // threads touch 32 consecutive words (no bank conflicts).
  __shared__ float s_row[4][kMaxW][kTB * kMaxW];
  __shared__ float s_mrow[kTB][kMaxW];
  __shared__ float s_irow[kTB][kMaxW];
  __shared__ float s_blk[kTB][kMaxW][kMaxW];
  __shared__ float s_red[kTB][kMaxW][7];

  const int tx = threadIdx.x, ar = threadIdx.y;
  const int tid = ar * kTB + tx;
  const int b = blockIdx.x * kTB + tx;
  const bool valid = b < d.B;
  // Threads past the batch load scenario B-1's data (never store) so that
  // every thread reaches every barrier with finite work.
  const int bl = valid ? b : d.B - 1;
  const int N = d.N, w = d.w, r = d.r, r2 = d.r2, Nd = N - 1;
  const bool cr1 = d.cr1 != 0;
  const int H = N / 2;
  const int n_sys = cr1 ? H : N, mid = n_sys / 2;
  const size_t SB = static_cast<size_t>(d.B);
  const float sigma = d.sigma, alpha = d.alpha, oma = d.one_m_alpha;
  float* const dS = cr1 ? a.dR : a.dM;
  float* const gS = cr1 ? a.gR : a.gM;
  float* const xt = cr1 ? a.R : a.S;  // where each solve leaves its result

#define AT(p, i) (p)[static_cast<size_t>(i) * SB + bl]
#define PUT(p, i, v)           \
  do {                         \
    if (valid) AT(p, i) = (v); \
  } while (0)
#define BLK(p, k, i, j) AT(p, ((k) * w + (i)) * w + (j))
#define VEC(p, k, i) AT(p, (k) * w + (i))
#define ROW(buf, j) s_row[buf][j][tid]
  // Row buffers: the block being inverted (RM) and its inverse (RI), a
  // product row (RA), a second product row (RY).
  constexpr int RM = 0, RI = 1, RA = 2, RY = 3;

  float* const mrow = s_mrow[tx];
  float* const irow = s_irow[tx];

  auto load_row = [&](const float* p, int k, int buf) {
    for (int j = 0; j < w; ++j) ROW(buf, j) = BLK(p, k, ar, j);
  };
  auto store_row = [&](float* p, int k, int buf) {
    for (int j = 0; j < w; ++j) PUT(p, (k * w + ar) * w + j, ROW(buf, j));
  };

  // Gauss-Jordan inverse with diagonal pivots of the block whose row `ar`
  // this thread holds in RM; row `ar` of the inverse ends in RI.  Op
  // order of ops/block_tridiag.small_spd_inv.  Pivot rows go through
  // shared memory, two barriers per pivot.
  auto gj_inv = [&]() {
    for (int j = 0; j < w; ++j) ROW(RI, j) = (j == ar) ? 1.f : 0.f;
    for (int k = 0; k < w; ++k) {
      if (ar == k) {
        const float piv = ROW(RM, k);
        for (int j = 0; j < w; ++j) {
          mrow[j] = ROW(RM, j) / piv;
          irow[j] = ROW(RI, j) / piv;
        }
      }
      __syncthreads();
      const float col = ROW(RM, k);
      for (int j = 0; j < w; ++j) {
        if (ar == k) {
          ROW(RM, j) = mrow[j];
          ROW(RI, j) = irow[j];
        } else {
          ROW(RM, j) = ROW(RM, j) - col * mrow[j];
          ROW(RI, j) = ROW(RI, j) - col * irow[j];
        }
      }
      __syncthreads();
    }
  };

  // Invert block k of p in place; RM holds row `ar` of the block to invert.
  auto invert_into = [&](float* p, int k) {
    gj_inv();
    store_row(p, k, RI);
    __syncthreads();
  };

  // ROW(out)[c] = sum_j A[ka][ar][j] * Bm[kb][j][c]: row `ar` of A_ka @ B_kb.
  auto row_mm = [&](const float* A, int ka, const float* Bm, int kb, int out) {
    for (int c = 0; c < w; ++c) {
      float acc = BLK(A, ka, ar, 0) * BLK(Bm, kb, 0, c);
      for (int j = 1; j < w; ++j) acc = acc + BLK(A, ka, ar, j) * BLK(Bm, kb, j, c);
      ROW(out, c) = acc;
    }
  };
  // ROW(m)[c] -= sum_j ROW(y)[j] * L[k][c][j]   (row `ar` of Y L_k^T)
  auto sub_mmt = [&](int m, int y, const float* L, int k) {
    for (int c = 0; c < w; ++c) {
      float acc = ROW(y, 0) * BLK(L, k, c, 0);
      for (int j = 1; j < w; ++j) acc = acc + ROW(y, j) * BLK(L, k, c, j);
      ROW(m, c) = ROW(m, c) - acc;
    }
  };
  // ROW(m)[c] -= sum_j L[k][j][ar] * s_blk[j][c]   (row `ar` of L_k^T V)
  auto sub_mtm_shared = [&](int m, const float* L, int k) {
    for (int c = 0; c < w; ++c) {
      float acc = BLK(L, k, 0, ar) * s_blk[tx][0][c];
      for (int j = 1; j < w; ++j) acc = acc + BLK(L, k, j, ar) * s_blk[tx][j][c];
      ROW(m, c) = ROW(m, c) - acc;
    }
  };
  auto to_shared = [&](int buf) {
    for (int c = 0; c < w; ++c) s_blk[tx][ar][c] = ROW(buf, c);
  };

  // sum_j A[k][ar][j] * v[kv][j] and sum_j A[k][j][ar] * v[kv][j]
  auto dot_row = [&](const float* A, int k, const float* v, int kv) -> float {
    float acc = BLK(A, k, ar, 0) * VEC(v, kv, 0);
    for (int j = 1; j < w; ++j) acc = acc + BLK(A, k, ar, j) * VEC(v, kv, j);
    return acc;
  };
  auto dot_col = [&](const float* A, int k, const float* v, int kv) -> float {
    float acc = BLK(A, k, 0, ar) * VEC(v, kv, 0);
    for (int j = 1; j < w; ++j) acc = acc + BLK(A, k, j, ar) * VEC(v, kv, j);
    return acc;
  };

  // ---- carried state: inputs -> outputs, iterated in place ------------
  for (int k = 0; k < N; ++k) {
    const int i = k * w + ar;
    PUT(a.x, i, AT(a.x0, i));
    PUT(a.yx, i, AT(a.yx0, i));
    PUT(a.zx, i, AT(a.zx0, i));
    for (int t = ar; t < r2; t += w) {
      PUT(a.yc, k * r2 + t, AT(a.yc0, k * r2 + t));
      PUT(a.zc, k * r2 + t, AT(a.zc0, k * r2 + t));
    }
    if (k < Nd) {
      for (int t = ar; t < r; t += w) {
        PUT(a.yd, k * r + t, AT(a.yd0, k * r + t));
        PUT(a.zd, k * r + t, AT(a.zd0, k * r + t));
      }
    }
  }

  // ---- M assembly, row `ar` of every block: Hb, + (sigma + rho_x) on the
  // diagonal, then the J0, J1 and stage-row terms, each an ascending
  // r-chain; subdiagonal blocks into gM. -------------------------------
  for (int k = 0; k < N; ++k) {
    for (int c = 0; c < w; ++c) {
      float v = BLK(a.hb, k, ar, c);
      if (ar == c) v = v + (sigma + VEC(a.rx, k, ar));
      if (k < Nd) {
        float acc = 0.f;
        for (int t = 0; t < r; ++t) {
          const int kt = k * r + t;
          const float p = (AT(a.rd, kt) * AT(a.j0, kt * w + ar)) * AT(a.j0, kt * w + c);
          acc = (t == 0) ? p : acc + p;
        }
        v = v + acc;
      }
      if (k > 0) {
        float acc = 0.f;
        for (int t = 0; t < r; ++t) {
          const int kt = (k - 1) * r + t;
          const float p = (AT(a.rd, kt) * AT(a.j1, kt * w + ar)) * AT(a.j1, kt * w + c);
          acc = (t == 0) ? p : acc + p;
        }
        v = v + acc;
      }
      {
        float acc = 0.f;
        for (int t = 0; t < r2; ++t) {
          const int kt = k * r2 + t;
          const float p = (AT(a.rc, kt) * AT(a.jc, kt * w + ar)) * AT(a.jc, kt * w + c);
          acc = (t == 0) ? p : acc + p;
        }
        v = v + acc;
      }
      PUT(a.dM, (k * w + ar) * w + c, v);
      if (k < Nd) {
        float acc = 0.f;
        for (int t = 0; t < r; ++t) {
          const int kt = k * r + t;
          const float p = (AT(a.rd, kt) * AT(a.j1, kt * w + ar)) * AT(a.j0, kt * w + c);
          acc = (t == 0) ? p : acc + p;
        }
        PUT(a.gM, (k * w + ar) * w + c, acc);
      }
    }
  }
  __syncthreads();

  // ---- depth-1 cyclic-reduction level: dinv_o = inv(D[2i+1]) in place;
  // Lb[i] = L[2i+1] = gM[2i], La[i] = L[2i+2] = gM[2i+1] stay in gM; the
  // reduced system goes to dR / gR.  Row `ar` of Ya[i] = La[i] dinv_o[i]
  // is formed once, at step i, and stays in RY for step i + 1. ---------
  if (cr1) {
    for (int i = 0; i < H; ++i) {
      load_row(a.dM, 2 * i + 1, RM);
      invert_into(a.dM, 2 * i + 1);
    }
    for (int i = 0; i < H; ++i) {
      row_mm(a.dM, 2 * i + 1, a.gM, 2 * i, RA);  // Vb = dinv_o Lb
      to_shared(RA);
      __syncthreads();
      load_row(a.dM, 2 * i, RM);
      sub_mtm_shared(RM, a.gM, 2 * i);  // - Lb^T Vb
      if (i > 0) sub_mmt(RM, RY, a.gM, 2 * i - 1);  // - Ya[i-1] La[i-1]^T
      store_row(a.dR, i, RM);
      if (i < H - 1) {
        row_mm(a.gM, 2 * i + 1, a.dM, 2 * i + 1, RY);  // Ya[i]
        for (int c = 0; c < w; ++c) {
          float acc = ROW(RY, 0) * BLK(a.gM, 2 * i, 0, c);
          for (int j = 1; j < w; ++j) acc = acc + ROW(RY, j) * BLK(a.gM, 2 * i, j, c);
          PUT(a.gR, (i * w + ar) * w + c, -acc);  // L' = -Ya Lb
        }
      }
      __syncthreads();
    }
  }

  // ---- two-way factorization of the n_sys-stage system (dS, gS) --------
  load_row(dS, 0, RM);
  invert_into(dS, 0);
  if (mid < n_sys - 1) {
    load_row(dS, n_sys - 1, RM);
    invert_into(dS, n_sys - 1);
  }
  for (int k = 1; k < mid; ++k) {  // top chain
    row_mm(gS, k - 1, dS, k - 1, RA);  // g_k = L[k] dinv[k-1]
    load_row(dS, k, RM);
    sub_mmt(RM, RA, gS, k - 1);  // D[k] - g_k L[k]^T
    __syncthreads();
    store_row(gS, k - 1, RA);
    invert_into(dS, k);
  }
  for (int k = n_sys - 2; k > mid; --k) {  // bottom chain
    row_mm(dS, k + 1, gS, k, RA);  // W[k] = dinv[k+1] L[k+1]
    to_shared(RA);
    __syncthreads();
    load_row(dS, k, RM);
    sub_mtm_shared(RM, gS, k);  // D[k] - L[k+1]^T W[k]
    __syncthreads();
    store_row(gS, k, RA);
    invert_into(dS, k);
  }
  {  // middle stage: Schur terms from both sides, top first
    const bool bot = mid < n_sys - 1;
    row_mm(gS, mid - 1, dS, mid - 1, RY);
    load_row(dS, mid, RM);
    sub_mmt(RM, RY, gS, mid - 1);
    if (bot) {
      row_mm(dS, mid + 1, gS, mid, RA);
      to_shared(RA);
      __syncthreads();
      sub_mtm_shared(RM, gS, mid);
    }
    __syncthreads();
    if (bot) store_row(gS, mid, RA);
    store_row(gS, mid - 1, RY);
    invert_into(dS, mid);
  }

  // ---- the solve: S[0:n_sys] holds the rhs, the solution ends there ----
  auto two_way_solve = [&](bool act) {
    const int nt = mid, nb = n_sys - 1 - mid;
    const int common = nt < nb ? nt : nb;
    auto fwd_top = [&](int i) {  // s[k] -= g[k-1] s[k-1]
      const int k = i + 1;
      PUT(a.S, k * w + ar, VEC(a.S, k, ar) - dot_row(gS, k - 1, a.S, k - 1));
    };
    auto fwd_bot = [&](int i) {  // s[k] -= W[k]^T s[k+1]
      const int k = n_sys - 2 - i;
      PUT(a.S, k * w + ar, VEC(a.S, k, ar) - dot_col(gS, k, a.S, k + 1));
    };
    for (int i = 0; i < common; ++i) {
      if (act) {
        fwd_top(i);
        fwd_bot(i);
      }
      __syncthreads();
    }
    for (int i = common; i < nt; ++i) {
      if (act) fwd_top(i);
      __syncthreads();
    }
    for (int i = common; i < nb; ++i) {
      if (act) fwd_bot(i);
      __syncthreads();
    }
    if (act)
      for (int k = 0; k < n_sys; ++k) PUT(a.U, k * w + ar, dot_row(dS, k, a.S, k));
    __syncthreads();
    if (act) PUT(a.S, mid * w + ar, VEC(a.U, mid, ar));
    __syncthreads();
    auto bwd_top = [&](int i) {  // x[k] = u[k] - g[k]^T x[k+1]
      const int k = mid - 1 - i;
      PUT(a.S, k * w + ar, VEC(a.U, k, ar) - dot_col(gS, k, a.S, k + 1));
    };
    auto bwd_bot = [&](int i) {  // x[k] = u[k] - W[k-1] x[k-1]
      const int k = mid + 1 + i;
      PUT(a.S, k * w + ar, VEC(a.U, k, ar) - dot_row(gS, k - 1, a.S, k - 1));
    };
    for (int i = 0; i < common; ++i) {
      if (act) {
        bwd_top(i);
        bwd_bot(i);
      }
      __syncthreads();
    }
    for (int i = common; i < nt; ++i) {
      if (act) bwd_top(i);
      __syncthreads();
    }
    for (int i = common; i < nb; ++i) {
      if (act) bwd_bot(i);
      __syncthreads();
    }
  };

  // (A^T t)[k, j] for t = rho z - y (rz) or y: the J0 term (k < Nd), the J1
  // term (k > 0), then the stage-row term, each an ascending r-chain.
  auto at_sum = [&](int k, int j, float out, bool rz) -> float {
    if (k < Nd) {
      float acc = 0.f;
      for (int t = 0; t < r; ++t) {
        const int kt = k * r + t;
        const float td = rz ? AT(a.rd, kt) * AT(a.zd, kt) - AT(a.yd, kt) : AT(a.yd, kt);
        const float p = AT(a.j0, kt * w + j) * td;
        acc = (t == 0) ? p : acc + p;
      }
      out = out + acc;
    }
    if (k > 0) {
      float acc = 0.f;
      for (int t = 0; t < r; ++t) {
        const int kt = (k - 1) * r + t;
        const float td = rz ? AT(a.rd, kt) * AT(a.zd, kt) - AT(a.yd, kt) : AT(a.yd, kt);
        const float p = AT(a.j1, kt * w + j) * td;
        acc = (t == 0) ? p : acc + p;
      }
      out = out + acc;
    }
    float acc = 0.f;
    for (int t = 0; t < r2; ++t) {
      const int kt = k * r2 + t;
      const float tc = rz ? AT(a.rc, kt) * AT(a.zc, kt) - AT(a.yc, kt) : AT(a.yc, kt);
      const float p = AT(a.jc, kt * w + j) * tc;
      acc = (t == 0) ? p : acc + p;
    }
    return out + acc;
  };
  auto a_dyn = [&](const float* xv, int k, int i) -> float {
    const int kt = k * r + i;
    float s0 = AT(a.j0, kt * w) * AT(xv, k * w);
    for (int j = 1; j < w; ++j) s0 = s0 + AT(a.j0, kt * w + j) * AT(xv, k * w + j);
    float s1 = AT(a.j1, kt * w) * AT(xv, (k + 1) * w);
    for (int j = 1; j < w; ++j) s1 = s1 + AT(a.j1, kt * w + j) * AT(xv, (k + 1) * w + j);
    return s0 + s1;
  };
  auto a_stage = [&](const float* xv, int k, int i) -> float {
    const int kt = k * r2 + i;
    float s0 = AT(a.jc, kt * w) * AT(xv, k * w);
    for (int j = 1; j < w; ++j) s0 = s0 + AT(a.jc, kt * w + j) * AT(xv, k * w + j);
    return s0;
  };
  auto relax = [&](float zt, float* z, float* y, const float* rho, const float* lo,
                   const float* hi, int i) {
    const float rh = AT(rho, i);
    const float z_rel = alpha * zt + oma * AT(z, i);
    const float y0 = AT(y, i);
    const float z_new = fminf(fmaxf(z_rel + y0 / rh, AT(lo, i)), AT(hi, i));
    PUT(y, i, y0 + rh * (z_rel - z_new));
    PUT(z, i, z_new);
  };

  auto one_iter = [&](bool act) {
    // rhs = sigma x - q + A^T (rho z - y): into R (cr1) or S.
    if (act) {
      for (int k = 0; k < N; ++k) {
        const int kj = k * w + ar;
        const float txv = AT(a.rx, kj) * AT(a.zx, kj) - AT(a.yx, kj);
        const float at = at_sum(k, ar, txv, true);
        PUT(xt, kj, (sigma * AT(a.x, kj) - AT(a.q, kj)) + at);
      }
    }
    __syncthreads();
    if (cr1) {
      // t_o = dinv_o b_odd (into U), then the fold into S:
      // b'_even[i] = b_even[i] - Lb[i]^T t_o[i] - [i>0] La[i-1] t_o[i-1].
      if (act)
        for (int i = 0; i < H; ++i) PUT(a.U, i * w + ar, dot_row(a.dM, 2 * i + 1, a.R, 2 * i + 1));
      __syncthreads();
      if (act) {
        for (int i = 0; i < H; ++i) {
          float f = VEC(a.R, 2 * i, ar) - dot_col(a.gM, 2 * i, a.U, i);
          if (i > 0) f = f - dot_row(a.gM, 2 * i - 1, a.U, i - 1);
          PUT(a.S, i * w + ar, f);
        }
      }
      __syncthreads();
    }
    two_way_solve(act);
    if (cr1) {
      // rhs_o = b_odd - Lb x_even - [i<H-1] La^T x_even[i+1] (into U), then
      // x_odd = dinv_o rhs_o; the interleaved solution goes to R.
      if (act) {
        for (int i = 0; i < H; ++i) {
          float v = VEC(a.R, 2 * i + 1, ar) - dot_row(a.gM, 2 * i, a.S, i);
          if (i < H - 1) v = v - dot_col(a.gM, 2 * i + 1, a.S, i + 1);
          PUT(a.U, i * w + ar, v);
        }
      }
      __syncthreads();
      if (act) {
        for (int i = 0; i < H; ++i) {
          PUT(a.R, (2 * i + 1) * w + ar, dot_row(a.dM, 2 * i + 1, a.U, i));
          PUT(a.R, (2 * i) * w + ar, VEC(a.S, i, ar));
        }
      }
      __syncthreads();
    }
    // z/y updates from A xt, then the relaxed x.
    if (act) {
      for (int k = 0; k < Nd; ++k)
        for (int i = ar; i < r; i += w)
          relax(a_dyn(xt, k, i), a.zd, a.yd, a.rd, a.ld, a.ud, k * r + i);
      for (int k = 0; k < N; ++k)
        for (int i = ar; i < r2; i += w)
          relax(a_stage(xt, k, i), a.zc, a.yc, a.rc, a.lc, a.uc, k * r2 + i);
      for (int k = 0; k < N; ++k) {
        const int i = k * w + ar;
        const float xv = AT(xt, i);
        relax(xv, a.zx, a.yx, a.rx, a.lx, a.ux, i);
        PUT(a.x, i, alpha * xv + oma * AT(a.x, i));
      }
    }
    __syncthreads();
  };

  const int it0 = a.it0[bl];
  int done = valid ? a.done0[bl] : 1;
  int it_inc = 0;
  const float ci = a.ci[bl];
  float rp = INFINITY, rdu = INFINITY, mp = INFINITY, md = INFINITY;

  for (int kb = 0; kb < d.interval; kb += d.check_every) {
    const bool act = valid && done == 0 && it0 + kb < d.max_iter;
    if (!__syncthreads_or(act)) break;
    for (int t = 0; t < d.check_every; ++t) one_iter(act);

    // Unscaled residuals (OSQP termination): this thread's rows, then the
    // scenario's maxima through shared memory.
    float p[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (act) {
      for (int k = 0; k < N; ++k) {
        const int i = k * w + ar;
        const float e = AT(a.ex, i), xv = AT(a.x, i), zv = AT(a.zx, i);
        p[0] = nmax(p[0], fabsf((xv - zv) * e));
        p[1] = nmax(p[1], fabsf(xv * e));
        p[2] = nmax(p[2], fabsf(zv * e));
      }
      for (int k = 0; k < Nd; ++k)
        for (int i = ar; i < r; i += w) {
          const int ki = k * r + i;
          const float e = AT(a.ed, ki), av = a_dyn(a.x, k, i), zv = AT(a.zd, ki);
          p[0] = nmax(p[0], fabsf((av - zv) * e));
          p[1] = nmax(p[1], fabsf(av * e));
          p[2] = nmax(p[2], fabsf(zv * e));
        }
      for (int k = 0; k < N; ++k)
        for (int i = ar; i < r2; i += w) {
          const int ki = k * r2 + i;
          const float e = AT(a.ec, ki), av = a_stage(a.x, k, i), zv = AT(a.zc, ki);
          p[0] = nmax(p[0], fabsf((av - zv) * e));
          p[1] = nmax(p[1], fabsf(av * e));
          p[2] = nmax(p[2], fabsf(zv * e));
        }
      for (int k = 0; k < N; ++k) {
        const int kc = k * w + ar;
        const float px = dot_row(a.hb, k, a.x, k);
        const float aty = at_sum(k, ar, AT(a.yx, kc), false);
        const float dsv = AT(a.ds, kc), qv = AT(a.q, kc);
        p[3] = nmax(p[3], fabsf((px + qv + aty) * dsv));
        p[4] = nmax(p[4], fabsf(aty * dsv));
        p[5] = nmax(p[5], fabsf(px * dsv));
        p[6] = nmax(p[6], fabsf(qv * dsv));
      }
    }
#pragma unroll
    for (int t = 0; t < 7; ++t) s_red[tx][ar][t] = p[t];
    __syncthreads();
    float m7[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < w; ++i)
#pragma unroll
      for (int t = 0; t < 7; ++t) m7[t] = nmax(m7[t], s_red[tx][i][t]);
    __syncthreads();
    if (act) {
      const float r_prim = m7[0];
      const float r_dual = ci * m7[3];
      const float max_prim = nmax(m7[1], m7[2]);
      const float max_dual = ci * nmax(nmax(m7[4], m7[5]), m7[6]);
      const float eps_pri = d.eps_abs + d.eps_rel * max_prim;
      const float eps_dua = d.eps_abs + d.eps_rel * max_dual;
      it_inc += d.check_every;
      rp = r_prim;
      rdu = r_dual;
      mp = max_prim;
      md = max_dual;
      if (r_prim <= eps_pri && r_dual <= eps_dua) done = 1;
    }
  }
  if (valid && ar == 0) {
    a.done[b] = done;
    a.it_inc[b] = it_inc;
    a.rp[b] = rp;
    a.rdual[b] = rdu;
    a.mp[b] = mp;
    a.md[b] = md;
  }
#undef ROW
#undef VEC
#undef BLK
#undef PUT
#undef AT
}

cudaError_t launch(const RolledArgs& a, const Dims& d, cudaStream_t stream) {
  const dim3 grid((d.B + kTB - 1) / kTB);
  const dim3 block(kTB, d.w);
  rolled_chunk_kernel<<<grid, block, 0, stream>>>(a, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs: the kNumPtrs device pointers in RolledArgs order.  Returns the
// cudaError_t of the launch (0 on success); the kernel runs on `stream`
// and is not synchronised.  The wrapper checks w <= kMaxW; a wider block
// would also be refused by the launch itself (kTB * w threads exceed the
// kernel's __launch_bounds__).
int ocp_banded_admm_chunk_rolled_f32(const void* const* ptrs, int nptrs, int N, int w,
                                     int r, int r2, int B, int interval, int check_every,
                                     int max_iter, int cr1, double sigma, double alpha,
                                     double eps_abs, double eps_rel, void* stream) {
  if (nptrs != kNumPtrs || N < 2 || w < 1 || r < 1 || r2 < 1 || B < 1 ||
      check_every < 1 || (cr1 && (N % 2 != 0 || N < 4)))
    return static_cast<int>(cudaErrorInvalidValue);
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
  d.sigma = static_cast<float>(sigma);
  d.alpha = static_cast<float>(alpha);
  d.one_m_alpha = static_cast<float>(1.0 - alpha);
  d.eps_abs = static_cast<float>(eps_abs);
  d.eps_rel = static_cast<float>(eps_rel);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch(a, d, s));
}

const char* ocp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
