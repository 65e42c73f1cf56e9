// Fused block-tridiagonal ADMM chunk for a batch of stage-structured QPs,
// batch-last layout, one thread per scenario.  CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel
//   optimal_control_problem_tpu/ops/banded_kernel.py::banded_admm_chunk
// (its `_kernel`) with the same inputs, the same 13 outputs and the same
// per-element op order: the M = P + sigma I + A^T R A assembly with
// ascending r-chains, the block-Thomas factorization with sequential
// j-chain block products and the unrolled Gauss-Jordan pivot inverses,
// then up to `interval` over-relaxed OSQP-ADMM iterations with the
// forward/backward block sweeps, the clip projection and the dual update,
// and per-scenario OSQP termination on unscaled residuals every
// `check_every` iterations.  Scenarios enter with their own iteration
// counts (it0) and frozen flags (done0); a scenario stops at check-block
// granularity, which is exactly what the TPU kernel's tile-wide while
// loop computes for it (inactive scenarios are frozen there by `sel`).
// It is compiled with -fmad=false (ops/build.py): every multiply and add
// rounds on its own, in the op order of the plain PyTorch version
// (ops/banded_kernel.py::banded_admm_chunk_plain, whose sums are the same
// ascending chains), so the two agree to f32 roundoff at worst.
//
// Layout: every array is batch-last, element (i0, ..., ik, b) at
// ((i0 * d1 + i1) ... ) * B + b, so the 32 threads of a warp, which own
// 32 neighbouring scenarios, read 32 neighbouring floats: every load and
// store is coalesced.
//
// What bounds it.  The operator and state bytes read once per launch are
// about 14 KB a scenario at cart-pole h20 (N=20, w=5, r=4, r2=1), about
// 14 MB at B=1024 -- 4 us at the card's 3.35 TB/s; the flops (~10 k per
// iteration per scenario) are negligible next to that at the card's
// float32 rate.  This first design does not approach either bound: it is
// latency-bound.  Each thread walks long sequential dependency chains
// (2N block sweeps per iteration, N block inverses per factorization),
// with its x/y/z state and factors in global memory (L1/L2-resident, not
// registers), and B=1024 scenarios at 64 threads a block give only 16
// blocks -- two warps on each of 16 of the card's 132 SMs -- so almost
// nothing hides the load latency.  Spreading one scenario's stages over a
// warp, keeping the factors in shared memory and the state in registers
// is the redesign a later change makes.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <string.h>

namespace {

constexpr int kThreads = 64;

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
  float* s;     // (N, w, B) block-sweep workspace
  float* dinv;  // (N, w, w, B) M diagonal blocks -> pivot inverses
  float* g;     // (Nd, w, w, B) M subdiagonal blocks -> multipliers
};
constexpr int kNumPtrs = 44;

struct Dims {
  int N, r, r2, B;
  int interval, check_every, max_iter;
  float sigma, alpha, one_m_alpha, eps_abs, eps_rel;
};

// NaN-propagating max (jnp.max semantics; fmaxf would drop a NaN).
__device__ __forceinline__ float nmax(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// Unrolled Gauss-Jordan inverse of one SPD block with diagonal pivots,
// op order of ops/block_tridiag.small_spd_inv.  Overwrites m.
template <int W>
__device__ __forceinline__ void spd_inv(float (&m)[W][W], float (&inv)[W][W]) {
#pragma unroll
  for (int i = 0; i < W; ++i)
#pragma unroll
    for (int j = 0; j < W; ++j) inv[i][j] = (i == j) ? 1.f : 0.f;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float piv = m[k][k];
    float mrow[W], irow[W], col[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      mrow[j] = m[k][j] / piv;
      irow[j] = inv[k][j] / piv;
    }
#pragma unroll
    for (int i = 0; i < W; ++i) col[i] = (i == k) ? 0.f : m[i][k];
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int j = 0; j < W; ++j) {
        m[i][j] = m[i][j] - col[i] * mrow[j];
        inv[i][j] = inv[i][j] - col[i] * irow[j];
      }
#pragma unroll
    for (int j = 0; j < W; ++j) {
      m[k][j] = mrow[j];
      inv[k][j] = irow[j];
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
banded_chunk_kernel(const ChunkArgs a, const Dims d) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= d.B) return;
  const int N = d.N, r = d.r, r2 = d.r2, Nd = d.N - 1;
  const size_t SB = static_cast<size_t>(d.B);
#define AT(p, i) (p)[static_cast<size_t>(i) * SB + b]

  // ---- carried state: inputs -> outputs, iterated in place ------------
  for (int i = 0; i < N * W; ++i) {
    AT(a.x, i) = AT(a.x0, i);
    AT(a.yx, i) = AT(a.yx0, i);
    AT(a.zx, i) = AT(a.zx0, i);
  }
  for (int i = 0; i < Nd * r; ++i) {
    AT(a.yd, i) = AT(a.yd0, i);
    AT(a.zd, i) = AT(a.zd0, i);
  }
  for (int i = 0; i < N * r2; ++i) {
    AT(a.yc, i) = AT(a.yc0, i);
    AT(a.zc, i) = AT(a.zc0, i);
  }

  // ---- M assembly: base, then the J0, J1 and stage-row terms, each an
  // ascending r-chain; subdiagonal blocks into g. ------------------------
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const float e = (i == j) ? 1.f : 0.f;
        float v = AT(a.hb, (k * W + i) * W + j) + d.sigma * e;
        v = v + e * AT(a.rx, k * W + i);
        if (k < Nd) {
          float acc = 0.f;
          for (int t = 0; t < r; ++t) {
            const float p = (AT(a.rd, k * r + t) * AT(a.j0, (k * r + t) * W + i)) *
                            AT(a.j0, (k * r + t) * W + j);
            acc = (t == 0) ? p : acc + p;
          }
          v = v + acc;
        }
        if (k > 0) {
          float acc = 0.f;
          for (int t = 0; t < r; ++t) {
            const int kt = (k - 1) * r + t;
            const float p = (AT(a.rd, kt) * AT(a.j1, kt * W + i)) * AT(a.j1, kt * W + j);
            acc = (t == 0) ? p : acc + p;
          }
          v = v + acc;
        }
        {
          float acc = 0.f;
          for (int t = 0; t < r2; ++t) {
            const int kt = k * r2 + t;
            const float p = (AT(a.rc, kt) * AT(a.jc, kt * W + i)) * AT(a.jc, kt * W + j);
            acc = (t == 0) ? p : acc + p;
          }
          v = v + acc;
        }
        AT(a.dinv, (k * W + i) * W + j) = v;
        if (k < Nd) {
          float acc = 0.f;
          for (int t = 0; t < r; ++t) {
            const int kt = k * r + t;
            const float p = (AT(a.rd, kt) * AT(a.j1, kt * W + i)) * AT(a.j0, kt * W + j);
            acc = (t == 0) ? p : acc + p;
          }
          AT(a.g, (k * W + i) * W + j) = acc;
        }
      }
    }
  }

  // ---- block-Thomas factorization: dinv <- pivot inverses,
  // g <- multipliers g_k = low_{k-1} dinv_{k-1}.  The transposed
  // subdiagonal block of the Schur product is read from registers. ------
  {
    float prev[W][W], m[W][W], inv[W][W];
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int j = 0; j < W; ++j) m[i][j] = AT(a.dinv, i * W + j);
    spd_inv<W>(m, prev);
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int j = 0; j < W; ++j) AT(a.dinv, i * W + j) = prev[i][j];
    for (int k = 1; k < N; ++k) {
      float low[W][W], gk[W][W];
#pragma unroll
      for (int i = 0; i < W; ++i)
#pragma unroll
        for (int j = 0; j < W; ++j) low[i][j] = AT(a.g, ((k - 1) * W + i) * W + j);
#pragma unroll
      for (int i = 0; i < W; ++i)
#pragma unroll
        for (int l = 0; l < W; ++l) {
          float acc = low[i][0] * prev[0][l];
#pragma unroll
          for (int j = 1; j < W; ++j) acc = acc + low[i][j] * prev[j][l];
          gk[i][l] = acc;
        }
#pragma unroll
      for (int i = 0; i < W; ++i)
#pragma unroll
        for (int l = 0; l < W; ++l) {
          float acc = gk[i][0] * low[l][0];
#pragma unroll
          for (int j = 1; j < W; ++j) acc = acc + gk[i][j] * low[l][j];
          m[i][l] = AT(a.dinv, (k * W + i) * W + l) - acc;
        }
      spd_inv<W>(m, inv);
#pragma unroll
      for (int i = 0; i < W; ++i)
#pragma unroll
        for (int j = 0; j < W; ++j) {
          prev[i][j] = inv[i][j];
          AT(a.dinv, (k * W + i) * W + j) = inv[i][j];
          AT(a.g, ((k - 1) * W + i) * W + j) = gk[i][j];
        }
    }
  }

  // (A^T t)[k, j] for t = (tx, td, tc) given as rho*z - y or as y.
  // Adds the J0 term (stage k < Nd), then the J1 term (k > 0), then the
  // stage-row term, each an ascending r-chain.
  auto at_sum = [&](int k, int j, float tx, const float* rdv, const float* zdv,
                    const float* ydv, const float* rcv, const float* zcv,
                    const float* ycv) -> float {
    float out = tx;
    if (k < Nd) {
      float acc = 0.f;
      for (int t = 0; t < r; ++t) {
        const int kt = k * r + t;
        const float td = rdv ? AT(rdv, kt) * AT(zdv, kt) - AT(ydv, kt) : AT(ydv, kt);
        const float p = AT(a.j0, kt * W + j) * td;
        acc = (t == 0) ? p : acc + p;
      }
      out = out + acc;
    }
    if (k > 0) {
      float acc = 0.f;
      for (int t = 0; t < r; ++t) {
        const int kt = (k - 1) * r + t;
        const float td = rdv ? AT(rdv, kt) * AT(zdv, kt) - AT(ydv, kt) : AT(ydv, kt);
        const float p = AT(a.j1, kt * W + j) * td;
        acc = (t == 0) ? p : acc + p;
      }
      out = out + acc;
    }
    float acc = 0.f;
    for (int t = 0; t < r2; ++t) {
      const int kt = k * r2 + t;
      const float tc = rcv ? AT(rcv, kt) * AT(zcv, kt) - AT(ycv, kt) : AT(ycv, kt);
      const float p = AT(a.jc, kt * W + j) * tc;
      acc = (t == 0) ? p : acc + p;
    }
    return out + acc;
  };

  // Dynamics row (k, i) of A x and stage row (k, i) of A x, for x given
  // as a (N, w, B) array.
  auto a_dyn = [&](const float* xv, int k, int i) -> float {
    const int kt = k * r + i;
    float s0 = AT(a.j0, kt * W) * AT(xv, k * W);
#pragma unroll
    for (int j = 1; j < W; ++j) s0 = s0 + AT(a.j0, kt * W + j) * AT(xv, k * W + j);
    float s1 = AT(a.j1, kt * W) * AT(xv, (k + 1) * W);
#pragma unroll
    for (int j = 1; j < W; ++j) s1 = s1 + AT(a.j1, kt * W + j) * AT(xv, (k + 1) * W + j);
    return s0 + s1;
  };
  auto a_stage = [&](const float* xv, int k, int i) -> float {
    const int kt = k * r2 + i;
    float s0 = AT(a.jc, kt * W) * AT(xv, k * W);
#pragma unroll
    for (int j = 1; j < W; ++j) s0 = s0 + AT(a.jc, kt * W + j) * AT(xv, k * W + j);
    return s0;
  };

  const float alpha = d.alpha, oma = d.one_m_alpha, sigma = d.sigma;
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
    // rhs = sigma x - q + A^T (rho z - y), into the sweep workspace.
    for (int k = 0; k < N; ++k) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int kj = k * W + j;
        const float tx = AT(a.rx, kj) * AT(a.zx, kj) - AT(a.yx, kj);
        const float at = at_sum(k, j, tx, a.rd, a.zd, a.yd, a.rc, a.zc, a.yc);
        AT(a.s, kj) = (sigma * AT(a.x, kj) - AT(a.q, kj)) + at;
      }
    }
    // Forward sweep: s_k -= g_{k-1} s_{k-1}.
    float v[W], nx[W];
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = AT(a.s, j);
    for (int k = 1; k < N; ++k) {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        float acc = AT(a.g, ((k - 1) * W + i) * W) * v[0];
#pragma unroll
        for (int j = 1; j < W; ++j) acc = acc + AT(a.g, ((k - 1) * W + i) * W + j) * v[j];
        nx[i] = AT(a.s, k * W + i) - acc;
      }
#pragma unroll
      for (int i = 0; i < W; ++i) {
        v[i] = nx[i];
        AT(a.s, k * W + i) = nx[i];
      }
    }
    // Backward sweep: x_{N-1} = dinv s; x_k = dinv_k s_k - g_k^T x_{k+1}.
#pragma unroll
    for (int i = 0; i < W; ++i) {
      float acc = AT(a.dinv, ((N - 1) * W + i) * W) * v[0];
#pragma unroll
      for (int j = 1; j < W; ++j) acc = acc + AT(a.dinv, ((N - 1) * W + i) * W + j) * v[j];
      nx[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
      v[i] = nx[i];
      AT(a.s, (N - 1) * W + i) = nx[i];
    }
    for (int k = N - 2; k >= 0; --k) {
      float sk[W];
#pragma unroll
      for (int j = 0; j < W; ++j) sk[j] = AT(a.s, k * W + j);
#pragma unroll
      for (int c = 0; c < W; ++c) {
        float t1 = AT(a.dinv, (k * W + c) * W) * sk[0];
#pragma unroll
        for (int j = 1; j < W; ++j) t1 = t1 + AT(a.dinv, (k * W + c) * W + j) * sk[j];
        float t2 = AT(a.g, (k * W) * W + c) * v[0];
#pragma unroll
        for (int i = 1; i < W; ++i) t2 = t2 + AT(a.g, (k * W + i) * W + c) * v[i];
        nx[c] = t1 - t2;
      }
#pragma unroll
      for (int c = 0; c < W; ++c) {
        v[c] = nx[c];
        AT(a.s, k * W + c) = nx[c];
      }
    }
    // z/y updates from A xt (xt in s), then the relaxed x.
    for (int k = 0; k < Nd; ++k)
      for (int i = 0; i < r; ++i)
        relax(a_dyn(a.s, k, i), a.zd, a.yd, a.rd, a.ld, a.ud, k * r + i);
    for (int k = 0; k < N; ++k)
      for (int i = 0; i < r2; ++i)
        relax(a_stage(a.s, k, i), a.zc, a.yc, a.rc, a.lc, a.uc, k * r2 + i);
    for (int i = 0; i < N * W; ++i) {
      const float xt = AT(a.s, i);
      relax(xt, a.zx, a.yx, a.rx, a.lx, a.ux, i);
      AT(a.x, i) = alpha * xt + oma * AT(a.x, i);
    }
  };

  const int it0 = a.it0[b];
  int done = a.done0[b];
  int it_inc = 0;
  const float ci = a.ci[b];
  float rp = INFINITY, rdu = INFINITY, mp = INFINITY, md = INFINITY;

  for (int kb = 0; kb < d.interval; kb += d.check_every) {
    if (done != 0 || it0 + kb >= d.max_iter) break;
    for (int t = 0; t < d.check_every; ++t) one_iter();

    // Unscaled residuals of the new iterate (OSQP termination).
    float r_prim = 0.f, max_ax = 0.f, max_z = 0.f;
    for (int i = 0; i < N * W; ++i) {
      const float e = AT(a.ex, i), xv = AT(a.x, i), zv = AT(a.zx, i);
      r_prim = nmax(r_prim, fabsf((xv - zv) * e));
      max_ax = nmax(max_ax, fabsf(xv * e));
      max_z = nmax(max_z, fabsf(zv * e));
    }
    for (int k = 0; k < Nd; ++k)
      for (int i = 0; i < r; ++i) {
        const int ki = k * r + i;
        const float e = AT(a.ed, ki), av = a_dyn(a.x, k, i), zv = AT(a.zd, ki);
        r_prim = nmax(r_prim, fabsf((av - zv) * e));
        max_ax = nmax(max_ax, fabsf(av * e));
        max_z = nmax(max_z, fabsf(zv * e));
      }
    for (int k = 0; k < N; ++k)
      for (int i = 0; i < r2; ++i) {
        const int ki = k * r2 + i;
        const float e = AT(a.ec, ki), av = a_stage(a.x, k, i), zv = AT(a.zc, ki);
        r_prim = nmax(r_prim, fabsf((av - zv) * e));
        max_ax = nmax(max_ax, fabsf(av * e));
        max_z = nmax(max_z, fabsf(zv * e));
      }
    float r_dual = 0.f, max_aty = 0.f, max_px = 0.f, max_q = 0.f;
    for (int k = 0; k < N; ++k) {
#pragma unroll
      for (int c = 0; c < W; ++c) {
        const int kc = k * W + c;
        float px = AT(a.hb, kc * W) * AT(a.x, k * W);
#pragma unroll
        for (int j = 1; j < W; ++j) px = px + AT(a.hb, kc * W + j) * AT(a.x, k * W + j);
        const float aty = at_sum(k, c, AT(a.yx, kc), nullptr, nullptr, a.yd, nullptr,
                                 nullptr, a.yc);
        const float dsv = AT(a.ds, kc), qv = AT(a.q, kc);
        r_dual = nmax(r_dual, fabsf((px + qv + aty) * dsv));
        max_aty = nmax(max_aty, fabsf(aty * dsv));
        max_px = nmax(max_px, fabsf(px * dsv));
        max_q = nmax(max_q, fabsf(qv * dsv));
      }
    }
    r_dual = ci * r_dual;
    const float max_prim = nmax(max_ax, max_z);
    const float max_dual = ci * nmax(nmax(max_aty, max_px), max_q);
    const float eps_pri = d.eps_abs + d.eps_rel * max_prim;
    const float eps_dua = d.eps_abs + d.eps_rel * max_dual;
    it_inc += d.check_every;
    rp = r_prim;
    rdu = r_dual;
    mp = max_prim;
    md = max_dual;
    if (r_prim <= eps_pri && r_dual <= eps_dua) done = 1;
  }
  a.done[b] = done;
  a.it_inc[b] = it_inc;
  a.rp[b] = rp;
  a.rdual[b] = rdu;
  a.mp[b] = mp;
  a.md[b] = md;
#undef AT
}

template <int W>
cudaError_t launch(const ChunkArgs& a, const Dims& d, cudaStream_t stream) {
  const dim3 grid((d.B + kThreads - 1) / kThreads);
  banded_chunk_kernel<W><<<grid, kThreads, 0, stream>>>(a, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs: the kNumPtrs device pointers in ChunkArgs order.  Returns the
// cudaError_t of the launch (0 on success); the kernel runs on `stream`
// and is not synchronised.
int ocp_banded_admm_chunk_f32(const void* const* ptrs, int nptrs, int N, int w, int r,
                              int r2, int B, int interval, int check_every,
                              int max_iter, double sigma, double alpha,
                              double eps_abs, double eps_rel, void* stream) {
  if (nptrs != kNumPtrs || N < 2 || r < 1 || r2 < 1 || B < 1 || check_every < 1)
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
    case 5: err = launch<5>(a, d, s); break;
    default: err = cudaErrorInvalidValue; break;
  }
  return static_cast<int>(err);
}

const char* ocp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
