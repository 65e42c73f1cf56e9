// Cyclic-reduction block-tridiagonal ADMM chunk for a batch of
// stage-structured QPs, batch-last layout.  CUDA C++ for sm_90a.
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
// every sum an ascending chain, so it can agree with the plain version
// bitwise.
//
// Design.  One thread block per scenario (a plain launch: termination is
// per scenario, so nothing crosses blocks).  Its threads are P stage lanes
// x w block rows (threadIdx.x = lane * w + row, P = min(256 / w, ceil(N/2))):
// inside a level every odd pivot's Gauss-Jordan inverse, every survivor's
// Schur update and next-level couplings, and every fold and recovery of
// the solves are independent, so a level runs P stages at a time, one
// thread per block row, with __syncthreads() between a level's dependent
// phases (one barrier per pivot of an inverse, the pivot rows
// double-buffered in shared memory).  Each thread's working rows (the
// block being inverted and its inverse, the G_lo and LT_odd dinv_odd rows of
// the Schur products) live in shared memory laid out so a warp touches
// consecutive words; the G_lo^T block that the next level's transposed
// coupling needs whole is exchanged through shared memory.  The level
// arrays (working diagonals and transposed couplings, each in two
// ping-pong buffers, so a level never overwrites what another thread still
// reads -- the JAX kernel's high-to-low group order has no counterpart
// here -- the packed odd-pivot inverses and couplings) and the solve
// vectors sit in a scenario-major global scratch slab allocated by the
// wrapper (about 650 KB per scenario at quadrotor h100: 42 MB at B=64,
// within the 50 MB L2).  The carried state is iterated in place in the
// outputs (batch-last); the JAX kernel's transposed-L workspace keeps its
// orientation (LT equals L^T only at level 0).  Any w <= 16, any N >= 2.
//
// What bounds it.  Per launch at quadrotor h100, B=64 the function must
// read and write about 24 MB (the stage blocks, bounds, scalings and
// state): about 7 us at the card's 3.35 TB/s.  Its operations (the
// assembly, the factorization's block products -- about 1.4x the two-way
// Thomas chunk's -- and per iteration the CR sweeps and the A / A^T
// products; about 0.68 G at the main path's ~2 iterations per launch)
// take about 10 us at the float32 peak, so operations bound it, narrowly.
// This first design is latency-bound far above either: ~4 log2 N
// dependent level phases per solve and w barriers per round of pivot
// inverses, each after a w-long dependent add chain on L1/L2 loads;
// batch-last input loads are one scalar per 32-byte sector (one scenario
// per block).  Keeping the level arrays in shared memory where they fit,
// several scenarios per block at small w and tensor-core products are
// later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <string.h>

namespace {

constexpr int kMaxW = 16;          // widest block
constexpr int kMaxThreads = 256;   // threads per block (lanes x rows)
constexpr int kMaxLevels = 32;

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
  // scratch: (B, per) scenario-major, per = cr_scratch_floats(N, w)
  float* scratch;
};
constexpr int kNumPtrs = 42;

struct Dims {
  int N, w, r, r2, B;
  int interval, check_every, max_iter;
  int P;  // stage lanes per block
  long long per;
  float sigma, alpha, one_m_alpha, eps_abs, eps_rel;
};

// One level of cr_level_plan: live stages, padded to even, survivors,
// offset into the packed pivot inverses, offset into the packed couplings.
struct Level {
  int n, n_p, half, off_d, off_L;
};
struct Plan {
  int nlev, nd_slots, nl_slots;
  Level lv[kMaxLevels];
};

// NaN-propagating max (jnp.max / torch.amax semantics).
__device__ __forceinline__ float nmax(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// A read-only vector with a stride: batch-last arrays (stride B) and
// scenario-major scratch (stride 1) through one accessor.
struct Vec {
  const float* p;
  size_t s;
  __device__ __forceinline__ float operator[](int i) const { return p[static_cast<size_t>(i) * s]; }
};

__global__ void __launch_bounds__(kMaxThreads)
cr_chunk_kernel(const CRArgs a, const Dims d, const Plan plan) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.x;
  const int N = d.N, w = d.w, r = d.r, r2 = d.r2, Nd = N - 1, ww = w * w;
  const int P = d.P;
  const int lp = tid / w, ar = tid % w;  // stage lane, block row
  const bool lane = lp < P;
  const size_t SB = static_cast<size_t>(d.B);
  const float sigma = d.sigma, alpha = d.alpha, oma = d.one_m_alpha;

  // Shared memory: per-thread row buffers [2][w][nt]; pivot rows of the
  // inverses, double-buffered [2][P][w] (matrix and inverse halves); one
  // w x w block per lane; the residual maxima [7][nt] and their result.
  float* const rowbuf = smem;
  float* const mrow = rowbuf + 2 * w * nt;
  float* const irow = mrow + 2 * P * w;
  float* const blk = irow + 2 * P * w;
  float* const red = blk + P * ww;
  float* const res = red + 7 * nt;

  // This scenario's scratch slab (layout of cr_scratch_floats).
  float* const dA = a.scratch + static_cast<size_t>(b) * static_cast<size_t>(d.per);
  float* const LTA = dA + static_cast<size_t>(N + 1) * ww;
  float* const dB = LTA + static_cast<size_t>(N + 1) * ww;
  float* const LTB = dB + static_cast<size_t>(N / 2 + 2) * ww;
  float* const dinv = LTB + static_cast<size_t>(N / 2 + 2) * ww;
  float* const Lp = dinv + static_cast<size_t>(plan.nd_slots + 1) * ww;
  float* const sA = Lp + static_cast<size_t>(plan.nl_slots) * ww;
  float* const sB = sA + static_cast<size_t>(N + 1) * w;
  float* const tv = sB + static_cast<size_t>(N + 1) * w;
  float* const s2 = tv + static_cast<size_t>(N + 1) * w;

#define AT(p, i) (p)[static_cast<size_t>(i) * SB + b]
#define BK(p, k) ((p) + static_cast<size_t>(k) * ww)
#define ROW(buf, j) rowbuf[((buf) * w + (j)) * nt + tid]

  // ---- carried state: inputs -> outputs, iterated in place ------------
  for (int e = tid; e < N * w; e += nt) {
    AT(a.x, e) = AT(a.x0, e);
    AT(a.yx, e) = AT(a.yx0, e);
    AT(a.zx, e) = AT(a.zx0, e);
  }
  for (int e = tid; e < Nd * r; e += nt) {
    AT(a.yd, e) = AT(a.yd0, e);
    AT(a.zd, e) = AT(a.zd0, e);
  }
  for (int e = tid; e < N * r2; e += nt) {
    AT(a.yc, e) = AT(a.yc0, e);
    AT(a.zc, e) = AT(a.zc0, e);
  }

  // ---- M assembly: Hb, + (sigma + rho_x) on the diagonal, then the J0,
  // J1 and stage-row terms, each an ascending r-chain, into dA; level 0's
  // couplings L[k] (L[0] = 0) into Lp and their transposes into LTA. ----
  for (int e = tid; e < N * ww; e += nt) {
    const int k = e / ww, i = (e / w) % w, c = e % w;
    float v = AT(a.hb, e);
    if (i == c) v = v + (sigma + AT(a.rx, k * w + i));
    if (k < Nd) {
      float acc = 0.f;
      for (int t = 0; t < r; ++t) {
        const int kt = k * r + t;
        const float p = (AT(a.rd, kt) * AT(a.j0, kt * w + i)) * AT(a.j0, kt * w + c);
        acc = (t == 0) ? p : acc + p;
      }
      v = v + acc;
    }
    if (k > 0) {
      float acc = 0.f;
      for (int t = 0; t < r; ++t) {
        const int kt = (k - 1) * r + t;
        const float p = (AT(a.rd, kt) * AT(a.j1, kt * w + i)) * AT(a.j1, kt * w + c);
        acc = (t == 0) ? p : acc + p;
      }
      v = v + acc;
    }
    {
      float acc = 0.f;
      for (int t = 0; t < r2; ++t) {
        const int kt = k * r2 + t;
        const float p = (AT(a.rc, kt) * AT(a.jc, kt * w + i)) * AT(a.jc, kt * w + c);
        acc = (t == 0) ? p : acc + p;
      }
      v = v + acc;
    }
    dA[e] = v;
    float lo = 0.f;
    if (k > 0) {
      for (int t = 0; t < r; ++t) {
        const int kt = (k - 1) * r + t;
        const float p = (AT(a.rd, kt) * AT(a.j1, kt * w + i)) * AT(a.j0, kt * w + c);
        lo = (t == 0) ? p : lo + p;
      }
    }
    Lp[e] = lo;
    BK(LTA, k)[c * w + i] = lo;
  }
  if (N & 1) {  // level 0's pad stage: identity diagonal, zero coupling
    for (int e = tid; e < ww; e += nt) {
      BK(dA, N)[e] = (e / w == e % w) ? 1.f : 0.f;
      BK(Lp, N)[e] = 0.f;
      BK(LTA, N)[e] = 0.f;
    }
  }
  __syncthreads();

  // Gauss-Jordan inverses with diagonal pivots (op order of
  // ops/block_tridiag.small_spd_inv) of blocks src[s0 + 2*i*odd... ]:
  // block src_k = s0 + sstep * i into dst[d0 + i], i < cnt, P at a time.
  // Thread (lane, row) holds row `ar` of its block in ROW(0) and of the
  // inverse in ROW(1); pivot rows go through shared memory.
  auto gj_inverses = [&](const float* src, int s0, int sstep, float* dst, int d0, int cnt) {
    for (int i0 = 0; i0 < cnt; i0 += P) {
      const int i = i0 + lp;
      const bool act = lane && i < cnt;
      if (act) {
        const float* m = BK(src, s0 + sstep * i);
        for (int j = 0; j < w; ++j) {
          ROW(0, j) = m[ar * w + j];
          ROW(1, j) = (j == ar) ? 1.f : 0.f;
        }
      }
      for (int k = 0; k < w; ++k) {
        float* const mr = mrow + ((k & 1) * P + (act ? lp : 0)) * w;
        float* const ir = irow + ((k & 1) * P + (act ? lp : 0)) * w;
        if (act && ar == k) {
          const float piv = ROW(0, k);
          for (int j = 0; j < w; ++j) {
            mr[j] = ROW(0, j) / piv;
            ir[j] = ROW(1, j) / piv;
          }
        }
        // One barrier per pivot: the next pivot writes the other buffer.
        __syncthreads();
        if (act) {
          const float col = ROW(0, k);
          for (int j = 0; j < w; ++j) {
            if (ar == k) {
              ROW(0, j) = mr[j];
              ROW(1, j) = ir[j];
            } else {
              ROW(0, j) = ROW(0, j) - col * mr[j];
              ROW(1, j) = ROW(1, j) - col * ir[j];
            }
          }
        }
      }
      if (act) {
        float* const out = BK(dst, d0 + i);
        for (int j = 0; j < w; ++j) out[ar * w + j] = ROW(1, j);
      }
      __syncthreads();
    }
  };

  // ---- CR factorization, level by level ------------------------------
  {
    float* dC = dA;
    float* dN = dB;
    float* LTC = LTA;
    float* LTN = LTB;
    for (int l = 0; l < plan.nlev; ++l) {
      const Level lv = plan.lv[l];
      const int half = lv.half, off_d = lv.off_d, off_L = lv.off_L;
      const int off_L2 = off_L + lv.n_p;
      // The odd pivots' inverses.
      gj_inverses(dC, 1, 2, dinv, off_d, half);
      for (int i0 = 0; i0 < half; i0 += P) {
        const int i = i0 + lp;
        const bool act = lane && i < half;
        if (act) {
          const float* Llo = BK(Lp, off_L + 2 * i);
          const float* Lod = BK(Lp, off_L + 2 * i + 1);
          const float* dlo = i > 0 ? BK(dinv, off_d + i - 1) : nullptr;  // zero at i = 0
          const float* dod = BK(dinv, off_d + i);
          const float* LTlo = BK(LTC, 2 * i);
          const float* LTod = BK(LTC, 2 * i + 1);
          const float* dev = BK(dC, 2 * i);
          // Row `ar` of G_lo = L_lo dinv_lo (ROW 0) and of LT_odd dinv_odd (ROW 1).
          for (int c = 0; c < w; ++c) {
            float g = Llo[ar * w] * (dlo ? dlo[c] : 0.f);
            float y = LTod[ar * w] * dod[c];
            for (int j = 1; j < w; ++j) {
              g = g + Llo[ar * w + j] * (dlo ? dlo[j * w + c] : 0.f);
              y = y + LTod[ar * w + j] * dod[j * w + c];
            }
            ROW(0, c) = g;
            ROW(1, c) = y;
          }
          // new_d = d_even - G_lo LT_lo - (LT_odd dinv_odd) L_odd
          float* const nd = BK(dN, i);
          for (int c = 0; c < w; ++c) {
            float s = ROW(0, 0) * LTlo[c];
            float t = ROW(1, 0) * Lod[c];
            for (int j = 1; j < w; ++j) {
              s = s + ROW(0, j) * LTlo[j * w + c];
              t = t + ROW(1, j) * Lod[j * w + c];
            }
            nd[ar * w + c] = (dev[ar * w + c] - s) - t;
          }
          if (half > 1) {
            // Row `ar` of G_lo^T = dinv_lo LT_lo, shared with the lane.
            for (int c = 0; c < w; ++c) {
              float g = (dlo ? dlo[ar * w] : 0.f) * LTlo[c];
              for (int j = 1; j < w; ++j) g = g + (dlo ? dlo[ar * w + j] : 0.f) * LTlo[j * w + c];
              blk[(lp * w + ar) * w + c] = g;
            }
            // L'[i] = -G_lo L_odd[i-1] (L'[0] = 0).
            float* const Ln = BK(Lp, off_L2 + i);
            if (i == 0) {
              for (int c = 0; c < w; ++c) Ln[ar * w + c] = 0.f;
            } else {
              const float* Lsh = BK(Lp, off_L + 2 * i - 1);
              for (int c = 0; c < w; ++c) {
                float s = ROW(0, 0) * Lsh[c];
                for (int j = 1; j < w; ++j) s = s + ROW(0, j) * Lsh[j * w + c];
                Ln[ar * w + c] = -s;
              }
            }
          }
        }
        if (half > 1) {
          __syncthreads();
          if (act) {
            // LT'[i] = -LT_odd[i-1] G_lo^T (LT'[0] = 0).
            float* const LTn = BK(LTN, i);
            if (i == 0) {
              for (int c = 0; c < w; ++c) LTn[ar * w + c] = 0.f;
            } else {
              const float* LTsh = BK(LTC, 2 * i - 1);
              const float* G = blk + lp * ww;
              for (int c = 0; c < w; ++c) {
                float s = LTsh[ar * w] * G[c];
                for (int j = 1; j < w; ++j) s = s + LTsh[ar * w + j] * G[j * w + c];
                LTn[ar * w + c] = -s;
              }
            }
          }
          __syncthreads();
        }
      }
      if (half > 1 && (half & 1)) {  // the next level's pad stage
        for (int e = tid; e < ww; e += nt) {
          BK(dN, half)[e] = (e / w == e % w) ? 1.f : 0.f;
          BK(Lp, off_L2 + half)[e] = 0.f;
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
    gj_inverses(dC, 0, 1, dinv, plan.nd_slots, 1);  // the root
  }
  const float* const root = BK(dinv, plan.nd_slots);

  // ---- the CR solve: rhs in sA[0, N) (a zero pad stage when N is odd);
  // returns the buffer that holds the solution. --------------------------
  auto cr_solve = [&]() -> const float* {
    float* cur = sA;
    float* nxt = sB;
    for (int l = 0; l < plan.nlev; ++l) {
      const Level lv = plan.lv[l];
      const int half = lv.half, off_d = lv.off_d, off_L = lv.off_L;
      // t_odd = dinv_odd b_odd (into tv); b_odd kept for the up-sweep.
      for (int e = tid; e < half * w; e += nt) {
        const int i = e / w, c = e % w;
        const float* dd = BK(dinv, off_d + i) + c * w;
        const float* bo = cur + (2 * i + 1) * w;
        float acc = dd[0] * bo[0];
        for (int j = 1; j < w; ++j) acc = acc + dd[j] * bo[j];
        tv[e] = acc;
        s2[off_d * w + e] = bo[c];
      }
      __syncthreads();
      // Fold: b_even - L_lo t_lo - L_odd^T t_odd (t_lo: t_odd of the
      // survivor below, zero for i = 0).
      for (int e = tid; e < half * w; e += nt) {
        const int i = e / w, c = e % w;
        const float* Llo = BK(Lp, off_L + 2 * i) + c * w;
        const float* Lod = BK(Lp, off_L + 2 * i + 1) + c;
        const float* tlo = tv + (i - 1) * w;
        const float* tod = tv + i * w;
        float s = Llo[0] * (i > 0 ? tlo[0] : 0.f);
        float t = Lod[0] * tod[0];
        for (int j = 1; j < w; ++j) {
          s = s + Llo[j] * (i > 0 ? tlo[j] : 0.f);
          t = t + Lod[j * w] * tod[j];
        }
        nxt[e] = (cur[2 * i * w + c] - s) - t;
      }
      if (l + 1 < plan.nlev && (half & 1))
        for (int e = tid; e < w; e += nt) nxt[half * w + e] = 0.f;
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    for (int e = tid; e < w; e += nt) {
      float acc = root[e * w] * cur[0];
      for (int j = 1; j < w; ++j) acc = acc + root[e * w + j] * cur[j];
      nxt[e] = acc;
    }
    __syncthreads();
    {
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    for (int l = plan.nlev - 1; l >= 0; --l) {
      const Level lv = plan.lv[l];
      const int half = lv.half, off_d = lv.off_d, off_L = lv.off_L;
      // rhs_o = b_odd - L_odd x_even - L_next^T x_hi (zero for the top).
      for (int e = tid; e < half * w; e += nt) {
        const int i = e / w, c = e % w;
        const float* Lod = BK(Lp, off_L + 2 * i + 1) + c * w;
        const float* xe = cur + i * w;
        float s = Lod[0] * xe[0];
        for (int j = 1; j < w; ++j) s = s + Lod[j] * xe[j];
        float t = 0.f;
        if (i + 1 < half) {
          const float* Lnx = BK(Lp, off_L + 2 * i + 2) + c;
          const float* xh = cur + (i + 1) * w;
          t = Lnx[0] * xh[0];
          for (int j = 1; j < w; ++j) t = t + Lnx[j * w] * xh[j];
        }
        tv[e] = (s2[off_d * w + e] - s) - t;
      }
      __syncthreads();
      // x_odd = dinv_odd rhs_o, interleaved with the survivors.
      for (int e = tid; e < half * w; e += nt) {
        const int i = e / w, c = e % w;
        const float* dd = BK(dinv, off_d + i) + c * w;
        const float* ro = tv + i * w;
        float acc = dd[0] * ro[0];
        for (int j = 1; j < w; ++j) acc = acc + dd[j] * ro[j];
        nxt[(2 * i + 1) * w + c] = acc;
        nxt[2 * i * w + c] = cur[e];
      }
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    return cur;
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
  auto a_dyn = [&](Vec xv, int k, int i) -> float {
    const int kt = k * r + i;
    float s0 = AT(a.j0, kt * w) * xv[k * w];
    for (int j = 1; j < w; ++j) s0 = s0 + AT(a.j0, kt * w + j) * xv[k * w + j];
    float s1 = AT(a.j1, kt * w) * xv[(k + 1) * w];
    for (int j = 1; j < w; ++j) s1 = s1 + AT(a.j1, kt * w + j) * xv[(k + 1) * w + j];
    return s0 + s1;
  };
  auto a_stage = [&](Vec xv, int k, int i) -> float {
    const int kt = k * r2 + i;
    float s0 = AT(a.jc, kt * w) * xv[k * w];
    for (int j = 1; j < w; ++j) s0 = s0 + AT(a.jc, kt * w + j) * xv[k * w + j];
    return s0;
  };
  auto relax = [&](float zt, float* z, float* y, const float* rho, const float* lo,
                   const float* hi, int i) {
    const float rh = AT(rho, i);
    const float z_rel = alpha * zt + oma * AT(z, i);
    const float y0 = AT(y, i);
    const float z_new = fminf(fmaxf(z_rel + y0 / rh, AT(lo, i)), AT(hi, i));
    AT(y, i) = y0 + rh * (z_rel - z_new);
    AT(z, i) = z_new;
  };

  auto one_iter = [&]() {
    // rhs = sigma x - q + A^T (rho z - y) into sA.
    for (int e = tid; e < N * w; e += nt) {
      const int k = e / w, j = e % w;
      const float txv = AT(a.rx, e) * AT(a.zx, e) - AT(a.yx, e);
      const float at = at_sum(k, j, txv, true);
      sA[e] = (sigma * AT(a.x, e) - AT(a.q, e)) + at;
    }
    if (N & 1)
      for (int e = tid; e < w; e += nt) sA[N * w + e] = 0.f;
    __syncthreads();
    const Vec xt{cr_solve(), 1};
    // z/y updates from A xt, then the relaxed x.
    for (int e = tid; e < Nd * r; e += nt)
      relax(a_dyn(xt, e / r, e % r), a.zd, a.yd, a.rd, a.ld, a.ud, e);
    for (int e = tid; e < N * r2; e += nt)
      relax(a_stage(xt, e / r2, e % r2), a.zc, a.yc, a.rc, a.lc, a.uc, e);
    for (int e = tid; e < N * w; e += nt) {
      const float xv = xt[e];
      relax(xv, a.zx, a.yx, a.rx, a.lx, a.ux, e);
      AT(a.x, e) = alpha * xv + oma * AT(a.x, e);
    }
    __syncthreads();
  };

  const int it0 = a.it0[b];
  int done = a.done0[b];
  int it_inc = 0;
  const float ci = a.ci[b];
  float rp = INFINITY, rdu = INFINITY, mp = INFINITY, md = INFINITY;
  const Vec xs{a.x + b, SB};

  for (int kb = 0; kb < d.interval; kb += d.check_every) {
    // Uniform across the block: one scenario per block.
    if (!(done == 0 && it0 + kb < d.max_iter)) break;
    for (int t = 0; t < d.check_every; ++t) one_iter();

    // Unscaled residuals (OSQP termination): this thread's entries, then
    // the scenario's maxima through shared memory.
    float p[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int e = tid; e < N * w; e += nt) {
      const float ev = AT(a.ex, e), xv = AT(a.x, e), zv = AT(a.zx, e);
      p[0] = nmax(p[0], fabsf((xv - zv) * ev));
      p[1] = nmax(p[1], fabsf(xv * ev));
      p[2] = nmax(p[2], fabsf(zv * ev));
    }
    for (int e = tid; e < Nd * r; e += nt) {
      const float ev = AT(a.ed, e), av = a_dyn(xs, e / r, e % r), zv = AT(a.zd, e);
      p[0] = nmax(p[0], fabsf((av - zv) * ev));
      p[1] = nmax(p[1], fabsf(av * ev));
      p[2] = nmax(p[2], fabsf(zv * ev));
    }
    for (int e = tid; e < N * r2; e += nt) {
      const float ev = AT(a.ec, e), av = a_stage(xs, e / r2, e % r2), zv = AT(a.zc, e);
      p[0] = nmax(p[0], fabsf((av - zv) * ev));
      p[1] = nmax(p[1], fabsf(av * ev));
      p[2] = nmax(p[2], fabsf(zv * ev));
    }
    for (int e = tid; e < N * w; e += nt) {
      const int k = e / w, j = e % w;
      float px = AT(a.hb, (k * w + j) * w) * xs[k * w];
      for (int t = 1; t < w; ++t) px = px + AT(a.hb, (k * w + j) * w + t) * xs[k * w + t];
      const float aty = at_sum(k, j, AT(a.yx, e), false);
      const float dsv = AT(a.ds, e), qv = AT(a.q, e);
      p[3] = nmax(p[3], fabsf((px + qv + aty) * dsv));
      p[4] = nmax(p[4], fabsf(aty * dsv));
      p[5] = nmax(p[5], fabsf(px * dsv));
      p[6] = nmax(p[6], fabsf(qv * dsv));
    }
#pragma unroll
    for (int t = 0; t < 7; ++t) red[t * nt + tid] = p[t];
    __syncthreads();
    for (int t = tid; t < 7; t += nt) {  // (a block may have fewer than 7 threads)
      float m = red[t * nt];
      for (int i = 1; i < nt; ++i) m = nmax(m, red[t * nt + i]);
      res[t] = m;
    }
    __syncthreads();
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
    // (res is rewritten only after the next check's first barrier.)
  }
  if (tid == 0) {
    a.done[b] = done;
    a.it_inc[b] = it_inc;
    a.rp[b] = rp;
    a.rdual[b] = rdu;
    a.mp[b] = mp;
    a.md[b] = md;
  }
#undef ROW
#undef BK
#undef AT
}

// Floats of scratch per scenario; the wrapper's cr_scratch_floats.
long long scratch_floats(int N, int w, const Plan& pl) {
  const long long ww = static_cast<long long>(w) * w;
  return 2LL * (N + 1) * ww + 2LL * (N / 2 + 2) * ww + (pl.nd_slots + 1LL) * ww +
         static_cast<long long>(pl.nl_slots) * ww + 3LL * (N + 1) * w +
         static_cast<long long>(pl.nd_slots) * w;
}

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

}  // namespace

extern "C" {

// ptrs: the kNumPtrs device pointers in CRArgs order; `per` the floats of
// scratch per scenario (checked against this file's layout).  Returns the
// cudaError_t of the launch (0 on success); the kernel runs on `stream`
// and is not synchronised.
int ocp_banded_admm_chunk_cr_f32(const void* const* ptrs, int nptrs, int N, int w, int r,
                                 int r2, int B, int interval, int check_every, int max_iter,
                                 int per, double sigma, double alpha, double eps_abs,
                                 double eps_rel, void* stream) {
  Plan plan;
  if (nptrs != kNumPtrs || N < 2 || w < 1 || w > kMaxW || r < 1 || r2 < 1 || B < 1 ||
      check_every < 1 || !make_plan(N, &plan) || per != scratch_floats(N, w, plan))
    return static_cast<int>(cudaErrorInvalidValue);
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
  int P = kMaxThreads / w;
  if (P > (N + 1) / 2) P = (N + 1) / 2;
  if (P < 1) P = 1;
  d.P = P;
  d.per = per;
  d.sigma = static_cast<float>(sigma);
  d.alpha = static_cast<float>(alpha);
  d.one_m_alpha = static_cast<float>(1.0 - alpha);
  d.eps_abs = static_cast<float>(eps_abs);
  d.eps_rel = static_cast<float>(eps_rel);
  const int nt = P * w;
  const size_t smem =
      static_cast<size_t>(2 * w * nt + 4 * P * w + P * w * w + 7 * nt + 8) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cr_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cr_chunk_kernel<<<B, nt, smem, static_cast<cudaStream_t>(stream)>>>(a, d, plan);
  return static_cast<int>(cudaGetLastError());
}

const char* ocp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
