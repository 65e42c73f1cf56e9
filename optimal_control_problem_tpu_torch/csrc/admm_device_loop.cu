// Dense per-scenario ADMM device loop for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel
//   optimal_control_problem_tpu/ops/admm_kernel.py::admm_device_loop (:149)
// (the Pallas `_kernel` there).  Contract and op order are those of
//   optimal_control_problem_tpu_torch/ops/admm_kernel.py::admm_device_loop_plain:
// for each of B independent QPs a whole rho-constant condensed OSQP-ADMM
// solve in the scaled space, with its own operators OP (n, n), Ab (m, n),
// Pb (n, n) and per-row rho (m,).  All arrays are batch-leading and
// row-major.  Each iteration runs three dependent products,
//   rhs = sigma x - qb + (rho z - y) @ Ab,  xt = rhs @ OP,  zt = xt @ Ab^T,
// then the relaxation, the projection and the dual update; every
// check_every iterations three more (x @ Ab^T, x @ Pb, y @ Ab) and seven
// maxima give the OSQP test.
//
// Work split.  One thread block per scenario (grid = B): termination is per
// scenario, so no vote crosses blocks and a plain launch suffices.
//
// Bound on this card.  An iteration costs 2 (2 m n + n^2) = 98,400
// operations per scenario at n = 100, m = 196, and so does a check, against
// one read of the operators per launch: operations bound it (about 0.2 ms
// for 500 iterations at B = 256, 67 TFLOP/s).  What holds a scenario back
// is each iteration's latency: the three products are dependent chains of
// m + 2 n = 396 adds (no split of a sum is allowed: it would round
// otherwise), and each reads its operator from shared memory, n^2 + 2 m n
// words an iteration (197 KB at the cart-pole h20 QP, ~1,540 cycles at the
// SM's 128 bytes a clock).  At 227 KB of shared memory a block, one
// scenario fills an SM, so B = 256 runs in two waves and a launch lasts as
// long as its slowest scenario's iterations.
//
// What the design does about it.  Every product is a row read: a thread
// owns an output (one row), reads its operator row in 16-byte loads along the contraction index and the vector as a broadcast
// float4, so four terms cost two shared-memory instructions (eight in the
// plain column read), and the chain keeps its ascending order.  Each chain
// is software-pipelined (dot): a quad's operands load ahead into
// registers and its products form one quad ahead of its adds, so that
// loads and multiplies overlap the add chain.  For that
// the block stages transposed copies in its prologue (cp.async, coalesced
// from global memory), in tiers placed greedily (ops/admm_kernel.py::
// kernel_tier picks one and passes it here):
//   tier 1: OP^T, Ab and Ab^T in shared memory (204,544 bytes at n = 100,
//           m = 196): all five products are row reads;
//   tier 2: OP^T and Ab (185,840 bytes at n = 120, m = 236); rhs and y @ Ab
//           read columns of Ab, a word a thread and term;
//   tier 3: the operators stay where the caller holds them, read through
//           L1 from L2 (the operators of 132 resident scenarios at n = 200,
//           m = 392 are 66 MB, so the later ones come from device memory),
//           and the vectors live in a global scratch slab per scenario, so
//           no n or m is refused below the JAX package's 40 MiB guard.
// Every shared row stride is a multiple of 4 whose quotient by 4 is odd
// (row_stride), so the eight lanes of a quarter-warp that read 16 bytes
// from eight consecutive rows hit disjoint banks.  Pb, read only by the
// check, stays in global memory (L2, __ldg; lanes take consecutive columns,
// so each term is one coalesced line), and x @ Pb runs on the upper half
// of the block while the lower half runs the check's other two products.
// y / rho goes through div_rn: an inactive constraint's dual is zero, and
// a zero dividend sends CUDA's division to its slow path.  Each output is
// one accumulator that runs the contraction index upwards from zero with
// one multiply and one add per term (build with -fmad=false), the plain
// version's order, so every tier agrees with it bitwise.  A check's seven maxima are a block-wide
// reduction (max is exact in any order; nmax keeps a NaN).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNumPtrs = 17;
constexpr int kRed = 8;              // reduction slots per warp (7 used)
constexpr int kHalf = kThreads / 2;  // a check's x @ Pb runs on the upper half
constexpr int kRingS = 1;            // quads of a chain loaded ahead from shared memory
constexpr int kRingG = 8;            // the same from global memory (x @ Pb, tier 3)

struct Args {
  const float* OP;    // (B, n, n)
  const float* Ab;    // (B, m, n)
  const float* Pb;    // (B, n, n)
  const float* qb;    // (B, n)
  const float* lb;    // (B, m)
  const float* ub;    // (B, m)
  const float* rho;   // (B, m)
  const float* dinv;  // (B, n)
  const float* einv;  // (B, m)
  const float* cinv;  // (B,)
  const float* x0;    // (B, n)
  const float* y0;    // (B, m)
  float* x;           // (B, n)
  float* y;           // (B, m)
  float* z;           // (B, m)
  int* it;            // (B,)
  float* vec;         // (B, vec_floats): the vectors of tier 3
};

struct Dims {
  int n, m, ldn, ldm, max_iter, check_every;  // ldn, ldm: row strides over n and m terms
  float sigma, alpha, one_m_alpha, eps_abs, eps_rel;
};

__host__ __device__ inline int round4(int k) { return (k + 3) & ~3; }

// Row stride of a shared copy whose rows hold k terms: the least multiple
// of 4 >= k whose quotient by 4 is odd.
__host__ __device__ inline int row_stride(int k) { return round4(k) | 4; }

// Floats of one scenario's vectors, each padded to a multiple of 4 (a
// float4 read of a chain's last terms stays inside): x, rhs, xt, qb, 1/D
// (n each) and z, y, rho z - y, lb, ub, rho, 1/E (m each).
__host__ __device__ inline size_t vec_floats(int n, int m) {
  return 5 * static_cast<size_t>(round4(n)) + 7 * static_cast<size_t>(round4(m));
}

// Shared floats of one block in tier 1 (OP^T, Ab, Ab^T, vectors, reduction
// rows), 2 (OP^T, Ab, vectors, reduction rows) or 3 (reduction rows).
__host__ __device__ inline size_t smem_floats(int tier, int n, int m) {
  const size_t red = kRed * kWarps;
  if (tier == 3) return red;
  const size_t ldn = row_stride(n);
  size_t f = (static_cast<size_t>(n) + m) * ldn + vec_floats(n, m) + red;
  if (tier == 1) f += static_cast<size_t>(n) * row_stride(m);
  return f;
}

// Where an operator's four terms q (k = 4q .. 4q+3) come from: a float4
// of a row in shared memory (16-byte aligned, readable up to round4(K)),
// four words of a column in shared memory (stride ld), or the same from
// global memory through the read-only path (a row of tier 3 is not 16-byte
// aligned in general).  `at(k)` is one term, for a chain's last K % 4.
struct RowS {
  const float* w;
  __device__ __forceinline__ float4 quad(int q) const {
    return reinterpret_cast<const float4*>(w)[q];
  }
  __device__ __forceinline__ float at(int k) const { return w[k]; }
};
struct ColS {
  const float* w;
  int ld;
  __device__ __forceinline__ float4 quad(int q) const {
    const float* p = w + 4 * q * ld;
    float4 v;
    v.x = p[0];
    v.y = p[ld];
    v.z = p[2 * ld];
    v.w = p[3 * ld];
    return v;
  }
  __device__ __forceinline__ float at(int k) const { return w[k * ld]; }
};
struct G {  // global memory, stride ld (1: a row)
  const float* w;
  int ld;
  __device__ __forceinline__ float4 quad(int q) const {
    const float* p = w + 4 * q * ld;
    float4 v;
    v.x = __ldg(p);
    v.y = __ldg(p + ld);
    v.z = __ldg(p + 2 * ld);
    v.w = __ldg(p + 3 * ld);
    return v;
  }
  __device__ __forceinline__ float at(int k) const { return __ldg(w + k * ld); }
};

// a . w = sum_k a[k] * w(k), k = 0 .. K-1: one ascending chain, one
// multiply and one add per term, the plain version's order.  The terms
// come four at a time (a as a broadcast float4, 16-byte aligned and
// readable up to round4(K)).  Software-pipelined, so that loads and
// multiplies overlap the add chain: the operands of a quad load kRing
// quads ahead into a ring of registers, its products form one quad ahead
// (issued before the current quad's adds, which in-order issue would
// otherwise hold them behind), and the loop has no bound checks (a reload
// past the last whole ring re-reads its last quad).  The last K4 % kRing
// quads and K % 4 terms follow one at a time.
template <int kRing, class W>
__device__ __forceinline__ float dot(const float* __restrict__ a, W w, int K) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  float acc = 0.0f;
  auto mul4 = [](float4 av, float4 wv) {
    float4 p;
    p.x = av.x * wv.x;
    p.y = av.y * wv.y;
    p.z = av.z * wv.z;
    p.w = av.w * wv.w;
    return p;
  };
  auto add4 = [&](float4 p) {
    acc = acc + p.x;
    acc = acc + p.y;
    acc = acc + p.z;
    acc = acc + p.w;
  };
  const int K4 = K >> 2;
  const int Kr = K4 - K4 % kRing;  // quads of the pipelined loop
  if (Kr > 0) {
    float4 ab[kRing], wb[kRing];
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
      ab[s] = a4[s];
      wb[s] = w.quad(s);
    }
    float4 pr = mul4(ab[0], wb[0]);
    {
      const int qn = min(kRing, Kr - 1);
      ab[0] = a4[qn];
      wb[0] = w.quad(qn);
    }
    for (int q = 0; q < Kr; q += kRing) {
#pragma unroll
      for (int s = 0; s < kRing; ++s) {
        // Quad q + s: its products are pr; slot t holds quad q + s + 1.
        const int t = (s + 1) % kRing;
        const float4 np = mul4(ab[t], wb[t]);
        const int qn = min(q + s + 1 + kRing, Kr - 1);
        ab[t] = a4[qn];
        wb[t] = w.quad(qn);
        add4(pr);
        pr = np;
      }
    }
  }
  for (int q = Kr; q < K4; ++q) add4(mul4(a4[q], w.quad(q)));
  for (int k = K4 * 4; k < K; ++k) acc = acc + a[k] * w.at(k);
  return acc;
}

// epi(r, a . W[r]) for the rows r < rows of W (shared memory, stride ld, K
// terms), a row a thread, so a quarter-warp's lanes read consecutive rows.
template <class Epi>
__device__ __forceinline__ void row_product(const float* __restrict__ a,
                                            const float* __restrict__ W, int ld, int K, int rows,
                                            Epi epi) {
  for (int r = threadIdx.x; r < rows; r += kThreads) epi(r, dot<kRingS>(a, RowS{W + r * ld}, K));
}

// x / y, correctly rounded, bitwise the IEEE quotient.  A zero dividend
// (an inactive constraint's dual) sends the division's fast path to its
// slow fallback; its result is a zero whose sign is the XOR of the
// operands' signs wherever y is neither zero nor NaN, so that case is
// answered directly.
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

template <int kTier>
__global__ void __launch_bounds__(kThreads, 1) admm_device_loop_kernel(Args a, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int n = d.n, m = d.m, ldn = d.ldn, ldm = d.ldm;
  const int n4 = round4(n), m4 = round4(m);
  const size_t b = blockIdx.x;
  const float* gOP = a.OP + b * n * n;
  const float* gPb = a.Pb + b * n * n;
  const float* gAb = a.Ab + b * m * n;
  // Tiers 1 and 2: OP^T (n, ldn), Ab (m, ldn), in tier 1 Ab^T (n, ldm),
  // then the vectors and the reduction rows, all in shared memory.  Tier
  // 3: the operators where the caller holds them, the vectors in this
  // scenario's scratch slab, the reduction rows in shared memory.
  float* const sOPT = smem;
  float* const sAb = sOPT + static_cast<size_t>(n) * ldn;
  float* const sAbT = sAb + static_cast<size_t>(m) * ldn;
  float* const vbase = kTier == 3   ? a.vec + b * vec_floats(n, m)
                       : kTier == 1 ? sAbT + static_cast<size_t>(n) * ldm
                                    : sAbT;
  float* sx = vbase;        // x
  float* srhs = sx + n4;    // rhs (and x @ Pb in a check)
  float* sxt = srhs + n4;   // xt (and y @ Ab in a check)
  float* sq = sxt + n4;     // qb
  float* sdinv = sq + n4;   // 1/D
  float* sz = sdinv + n4;   // z
  float* sy = sz + m4;      // y
  float* sw = sy + m4;      // rho z - y
  float* slb = sw + m4;
  float* sub = slb + m4;
  float* srho = sub + m4;
  float* seinv = srho + m4;  // 1/E
  float* sred = kTier == 3 ? smem : seinv + m4;  // (kWarps, kRed)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (kTier != 3) {
    // Coalesced 4-byte copies from the row-major operators into their
    // shared rows: a warp a source row, lanes on consecutive columns.
    for (int k = warp; k < n; k += kWarps)
      for (int j = lane; j < n; j += 32)
        __pipeline_memcpy_async(sOPT + j * ldn + k, gOP + k * n + j, 4);
    for (int i = warp; i < m; i += kWarps)
      for (int k = lane; k < n; k += 32) {
        __pipeline_memcpy_async(sAb + i * ldn + k, gAb + i * n + k, 4);
        if (kTier == 1) __pipeline_memcpy_async(sAbT + k * ldm + i, gAb + i * n + k, 4);
      }
    __pipeline_commit();
  }
  for (int j = tid; j < n; j += kThreads) {
    sx[j] = a.x0[b * n + j];
    sq[j] = a.qb[b * n + j];
    sdinv[j] = a.dinv[b * n + j];
  }
  for (int i = tid; i < m; i += kThreads) {
    sy[i] = a.y0[b * m + i];
    slb[i] = a.lb[b * m + i];
    sub[i] = a.ub[b * m + i];
    srho[i] = a.rho[b * m + i];
    seinv[i] = a.einv[b * m + i];
  }
  if (kTier != 3) __pipeline_wait_prior(0);
  __syncthreads();

  // The products by tier: Ab's rows (zt, x @ Ab^T), Ab's columns (rhs,
  // y @ Ab) and OP's columns (xt).
  auto ab_rows = [&](const float* v, auto epi) {
    if constexpr (kTier == 3)
      for (int i = tid; i < m; i += kThreads) epi(i, dot<kRingG>(v, G{gAb + i * n, 1}, n));
    else
      row_product(v, sAb, ldn, n, m, epi);
  };
  auto ab_col = [&](const float* v, int j) {  // (v @ Ab)[j]
    if constexpr (kTier == 1)
      return dot<kRingS>(v, RowS{sAbT + j * ldm}, m);
    else if constexpr (kTier == 2)
      return dot<kRingS>(v, ColS{sAb + j, ldn}, m);
    else
      return dot<kRingG>(v, G{gAb + j, n}, m);
  };
  auto ab_cols = [&](const float* v, auto epi) {
    if constexpr (kTier == 1)
      row_product(v, sAbT, ldm, m, n, epi);
    else
      for (int j = tid; j < n; j += kThreads) epi(j, ab_col(v, j));
  };
  auto op_cols = [&](const float* v, auto epi) {
    if constexpr (kTier == 3)
      for (int j = tid; j < n; j += kThreads) epi(j, dot<kRingG>(v, G{gOP + j, n}, n));
    else
      row_product(v, sOPT, ldn, n, n, epi);
  };

  // z = clip(x @ Ab^T, lb, ub), recomputed at every entry as the TPU kernel
  // does; w = rho z - y feeds the first iteration.
  ab_rows(sx, [&](int i, float acc) {
    const float zv = clip_nan(acc, slb[i], sub[i]);
    sz[i] = zv;
    sw[i] = srho[i] * zv - sy[i];
  });
  __syncthreads();

  const float sigma = d.sigma, alpha = d.alpha, oma = d.one_m_alpha;
  const float ci = a.cinv[b];
  int it = 0;
  bool done = false;
  while (it < d.max_iter && !done) {
    for (int t = 0; t < d.check_every; ++t) {
      // rhs = sigma x - qb + (rho z - y) @ Ab
      ab_cols(sw, [&](int j, float acc) { srhs[j] = (sigma * sx[j] - sq[j]) + acc; });
      __syncthreads();
      // xt = rhs @ OP;  x = alpha xt + (1 - alpha) x
      op_cols(srhs, [&](int j, float acc) {
        sxt[j] = acc;
        sx[j] = alpha * acc + oma * sx[j];
      });
      __syncthreads();
      // zt = xt @ Ab^T;  relaxation, projection onto [lb, ub], dual update
      ab_rows(sxt, [&](int i, float acc) {
        const float rho = srho[i], zo = sz[i], yo = sy[i];
        const float z_rel = alpha * acc + oma * zo;
        const float z_n = clip_nan(z_rel + div_rn(yo, rho), slb[i], sub[i]);
        const float y_n = yo + rho * (z_rel - z_n);
        sz[i] = z_n;
        sy[i] = y_n;
        sw[i] = rho * z_n - y_n;
      });
      __syncthreads();
    }

    // Unscaled residuals: x @ Pb (into rhs's row) on the upper half of the
    // block, its L2 reads in flight while the lower half runs y @ Ab (into
    // xt's) and x @ Ab^T; then seven maxima.
    float mx[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    auto prim = [&](int i, float ax) {
      const float e = seinv[i], zv = sz[i];
      mx[0] = nmax(mx[0], fabsf((ax - zv) * e));
      mx[1] = nmax(mx[1], fabsf(ax * e));
      mx[2] = nmax(mx[2], fabsf(zv * e));
    };
    if (tid >= kHalf) {
      for (int j = tid - kHalf; j < n; j += kHalf) srhs[j] = dot<kRingG>(sx, G{gPb + j, n}, n);
    } else {
      for (int u = tid; u < n + m; u += kHalf) {
        if (u < n) {
          sxt[u] = ab_col(sy, u);
        } else {
          const int i = u - n;
          if constexpr (kTier == 3)
            prim(i, dot<kRingG>(sx, G{gAb + i * n, 1}, n));
          else
            prim(i, dot<kRingS>(sx, RowS{sAb + i * ldn}, n));
        }
      }
    }
    __syncthreads();
    for (int j = tid; j < n; j += kThreads) {
      const float px = srhs[j], aty = sxt[j];
      const float dv = sdinv[j], qv = sq[j];
      mx[3] = nmax(mx[3], fabsf(((px + qv) + aty) * dv));
      mx[4] = nmax(mx[4], fabsf(aty * dv));
      mx[5] = nmax(mx[5], fabsf(px * dv));
      mx[6] = nmax(mx[6], fabsf(qv * dv));
    }
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      const float v = warp_max(mx[q]);
      if (lane == 0) sred[warp * kRed + q] = v;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      float v = sred[q];
      for (int w = 1; w < kWarps; ++w) v = nmax(v, sred[w * kRed + q]);
      mx[q] = v;
    }
    __syncthreads();  // sred, rhs and xt are rewritten next
    const float r_prim = mx[0];
    const float max_prim = nmax(mx[1], mx[2]);
    const float r_dual = ci * mx[3];
    const float max_dual = ci * nmax(nmax(mx[4], mx[5]), mx[6]);
    done = (r_prim <= d.eps_abs + d.eps_rel * max_prim) &&
           (r_dual <= d.eps_abs + d.eps_rel * max_dual);
    it += d.check_every;
  }

  for (int j = tid; j < n; j += kThreads) a.x[b * n + j] = sx[j];
  for (int i = tid; i < m; i += kThreads) {
    a.y[b * m + i] = sy[i];
    a.z[b * m + i] = sz[i];
  }
  if (tid == 0) a.it[b] = it;
}

template <int kTier>
cudaError_t launch(const Args& a, const Dims& d, int B, size_t smem, cudaStream_t st) {
  if (kTier != 3) {
    const cudaError_t e = cudaFuncSetAttribute(admm_device_loop_kernel<kTier>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  admm_device_loop_kernel<kTier><<<B, kThreads, smem, st>>>(a, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block in `tier` (1, 2 or 3) at n, m; -1 for
// another tier.  The launch refuses a tier whose bytes exceed the card's
// opt-in limit; the wrapper's rule (ops/admm_kernel.py::kernel_tier) takes
// the first tier that fits.
long long ocp_admm_device_loop_smem(int tier, int n, int m) {
  if (tier < 1 || tier > 3 || n < 1 || m < 1) return -1;
  return static_cast<long long>(smem_floats(tier, n, m) * sizeof(float));
}

// Floats of one scenario's row of tier 3's vector slab (`vec`); -1 for a
// size the kernel does not take.
long long ocp_admm_device_loop_slab_floats(int n, int m) {
  if (n < 1 || m < 1) return -1;
  return static_cast<long long>(vec_floats(n, m));
}

// ptrs: the kNumPtrs device pointers in Args order (`vec`, tier 3's
// (B, ocp_admm_device_loop_slab_floats) vector slab, may be any pointer
// for tiers 1 and 2).
// `tier` picks where the operators live (the wrapper's rule,
// ops/admm_kernel.py::kernel_tier).  Returns the cudaError_t of the launch
// (0 on success; cudaErrorInvalidValue for a tier other than 1-3 or one
// whose shared memory exceeds what a block may opt into); the kernel runs
// on `stream` and is not synchronised.
int ocp_admm_device_loop_f32(const void* const* ptrs, int nptrs, int B, int n, int m,
                             int max_iter, int check_every, int tier, double sigma,
                             double alpha, double eps_abs, double eps_rel, void* stream) {
  if (nptrs != kNumPtrs || B < 1 || n < 1 || m < 1 || check_every < 1 || tier < 1 || tier > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  static_assert(sizeof(Args) == kNumPtrs * sizeof(void*), "Args layout");
  Args a;
  memcpy(&a, ptrs, sizeof(Args));
  Dims d;
  d.n = n;
  d.m = m;
  d.ldn = row_stride(n);
  d.ldm = row_stride(m);
  d.max_iter = max_iter;
  d.check_every = check_every;
  d.sigma = static_cast<float>(sigma);
  d.alpha = static_cast<float>(alpha);
  d.one_m_alpha = static_cast<float>(1.0 - alpha);
  d.eps_abs = static_cast<float>(eps_abs);
  d.eps_rel = static_cast<float>(eps_rel);
  const size_t smem = smem_floats(tier, n, m) * sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = tier == 1 ? launch<1>(a, d, B, smem, st)
      : tier == 2 ? launch<2>(a, d, B, smem, st)
                  : launch<3>(a, d, B, smem, st);
  return static_cast<int>(e);
}

const char* ocp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
