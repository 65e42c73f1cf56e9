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
// (template parameter: TR rows for each of its 8 warps) and keeps their
// iterates x, z, y and the three intermediates of an iteration in shared
// memory for the whole chunk.  The six panel products (three per
// iteration, three per termination check) are computed here, by hand: a
// warp owns TR rows, a lane owns columns lane, lane + 32, ... of them, and
// every output element is one accumulator that runs the contraction index
// upwards from zero with one multiply and one add per term (build with
// -fmad=false), the plain version's order, so the two agree bitwise.  The
// elementwise relaxation, projection and dual update run in the products'
// epilogues.  The shared operators are read through the read-only cache
// from L2 (they total ~210 KB at n=120, m=196; keeping them in shared
// memory, and the tensor cores, are later work).
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

#include <cuda_runtime.h>
#include <math_constants.h>
#include <string.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 4;  // columns per lane and pass: 128 columns per pass
constexpr int kNumPtrs = 25;

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
};

struct Dims {
  int B, n, m, tile, bpg, bound, check_every, n_checks, groups;
  float sigma, alpha, one_m_alpha, eps_abs, eps_rel;
};

// out[r, j] = sum_k a[r, k] * W[k, j] for the block's rows; `a` in shared
// memory with row stride K, W (K, J) row-major in global memory.  Calls
// epi(i, r, j, value) once per element from the thread that owns it: rows
// r = warp * TR + i, columns lane + 32 c of each 128-column pass.
template <int TR, class Epi>
__device__ __forceinline__ void panel_product(const float* __restrict__ a,
                                              const float* __restrict__ W, int K, int J,
                                              Epi epi) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * TR;
  for (int j0 = 0; j0 < J; j0 += 32 * kCols) {
    int col[kCols];
    int ld[kCols];  // clamped: a lane past the edge loads a valid column it drops
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      col[c] = j0 + lane + 32 * c;
      ld[c] = col[c] < J ? col[c] : J - 1;
    }
    float acc[TR][kCols];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float* wrow = W + static_cast<size_t>(k) * J;
      float w[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) w[c] = __ldg(wrow + ld[c]);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float av = a[(r0 + i) * K + k];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = acc[i][c] + av * w[c];
      }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (col[c] < J) epi(i, r0 + i, col[c], acc[i][c]);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int TR>
__global__ void __launch_bounds__(kThreads) shared_chunk_kernel(Args a, Dims d, int chk) {
  constexpr int R = kWarps * TR;
  extern __shared__ float smem[];
  const int n = d.n, m = d.m;
  float* sx = smem;           // (R, n) x
  float* sz = sx + R * n;     // (R, m) z
  float* sy = sz + R * m;     // (R, m) y
  float* sw = sy + R * m;     // (R, m) rho z - y
  float* srhs = sw + R * m;   // (R, n) rhs; Px during a check
  float* sxt = srhs + R * n;  // (R, n) xt
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
    for (int t = 0; t < d.check_every; ++t) {
      // rhs = sigma x - qb + (rho z - y) @ Ab
      panel_product<TR>(sw, a.Ab, m, n, [&](int, int r, int j, float v) {
        const float qv = __ldg(a.qb + static_cast<size_t>(grow(r)) * n + j);
        srhs[r * n + j] = (sigma * sx[r * n + j] - qv) + v;
      });
      __syncthreads();
      // xt = rhs @ OP;  x = alpha xt + (1 - alpha) x
      panel_product<TR>(srhs, a.OP, n, n, [&](int, int r, int j, float v) {
        sxt[r * n + j] = v;
        sx[r * n + j] = alpha * v + oma * sx[r * n + j];
      });
      __syncthreads();
      // zt = xt @ Ab^T;  relaxation, projection onto [lb, ub], dual update
      panel_product<TR>(sxt, a.AbT, n, m, [&](int, int r, int j, float v) {
        const size_t gi = static_cast<size_t>(grow(r)) * m + j;
        const float rho = __ldg(a.rho + j);
        const float zo = sz[r * m + j], yo = sy[r * m + j];
        const float z_rel = alpha * v + oma * zo;
        const float z_n = fminf(fmaxf(z_rel + yo / rho, __ldg(a.lb + gi)), __ldg(a.ub + gi));
        const float y_n = yo + rho * (z_rel - z_n);
        sz[r * m + j] = z_n;
        sy[r * m + j] = y_n;
        sw[r * m + j] = rho * z_n - y_n;
      });
      __syncthreads();
    }

    // Unscaled residuals.  A warp owns whole rows, so a row's maxima are
    // the warp's reduction of its lanes' maxima (max is exact: any order).
    float m_rp[TR], m_ax[TR], m_z[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) m_rp[i] = m_ax[i] = m_z[i] = 0.0f;
    panel_product<TR>(sx, a.AbT, n, m, [&](int i, int r, int j, float ax) {
      const float e = __ldg(a.einv + j);
      const float zv = sz[r * m + j];
      m_rp[i] = fmaxf(m_rp[i], fabsf((ax - zv) * e));
      m_ax[i] = fmaxf(m_ax[i], fabsf(ax * e));
      m_z[i] = fmaxf(m_z[i], fabsf(zv * e));
    });
    // Px lands in the slot of srhs that the same thread reads back below
    // (both products are n wide, so the element's owner is the same).
    panel_product<TR>(sx, a.Pb, n, n, [&](int, int r, int j, float px) { srhs[r * n + j] = px; });
    float m_rd[TR], m_aty[TR], m_px[TR], m_q[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) m_rd[i] = m_aty[i] = m_px[i] = m_q[i] = 0.0f;
    panel_product<TR>(sy, a.Ab, m, n, [&](int i, int r, int j, float aty) {
      const float dv = __ldg(a.dinv + j);
      const float px = srhs[r * n + j];
      const float qv = __ldg(a.qb + static_cast<size_t>(grow(r)) * n + j);
      m_rd[i] = fmaxf(m_rd[i], fabsf(((px + qv) + aty) * dv));
      m_aty[i] = fmaxf(m_aty[i], fabsf(aty * dv));
      m_px[i] = fmaxf(m_px[i], fabsf(px * dv));
      m_q[i] = fmaxf(m_q[i], fabsf(qv * dv));
    });
    int mine = 1;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float r_prim = warp_max(m_rp[i]);
      const float max_prim = fmaxf(warp_max(m_ax[i]), warp_max(m_z[i]));
      const float r_dual = ci * warp_max(m_rd[i]);
      const float max_dual =
          ci * fmaxf(fmaxf(warp_max(m_aty[i]), warp_max(m_px[i])), warp_max(m_q[i]));
      const float eps_pri = d.eps_abs + d.eps_rel * max_prim;
      const float eps_dua = d.eps_abs + d.eps_rel * max_dual;
      const int cv = (r_prim <= eps_pri) && (r_dual <= eps_dua);
      mine &= cv;
      if (lane == 0) {
        const int r = warp * TR + i;
        s_conv[r] = cv;
        s_rp[r] = r_prim;
        s_rd[r] = r_dual;
        s_rpr[r] = r_prim / fmaxf(max_prim, 1e-12f);
        s_rdr[r] = r_dual / fmaxf(max_dual, 1e-12f);
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

template <int TR>
size_t smem_bytes(const Dims& d) {
  return static_cast<size_t>(kWarps * TR) * (3 * d.n + 3 * d.m) * sizeof(float);
}

// Waves of a grid of `rows`-scenario blocks over the card (0 when the
// panels of `rows` scenarios do not fit in shared memory).
template <int TR>
cudaError_t waves(const Dims& d, int* out) {
  constexpr int R = kWarps * TR;
  *out = 0;
  auto kern = shared_chunk_kernel<TR>;
  const size_t smem = smem_bytes<TR>(d);
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess) {
    cudaGetLastError();  // a refused size leaves no sticky error behind
    return cudaSuccess;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaSuccess;
  const long long grid = static_cast<long long>(d.groups) * ((d.tile + R - 1) / R);
  const long long slots = static_cast<long long>(per_sm) * sms;
  *out = static_cast<int>((grid + slots - 1) / slots);
  return cudaSuccess;
}

// One launch per check block of the chunk's budget, on `stream`.
template <int TR>
cudaError_t launch_checks(const Args& a, Dims d, cudaStream_t stream) {
  constexpr int R = kWarps * TR;
  d.bpg = (d.tile + R - 1) / R;
  const dim3 grid(d.groups * d.bpg);
  const size_t smem = smem_bytes<TR>(d);
  for (int c = 0; c < d.n_checks; ++c) {
    shared_chunk_kernel<TR><<<grid, kThreads, smem, stream>>>(a, d, c);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// ptrs: the kNumPtrs device pointers in Args order.  `rows` scenarios per
// thread block: 8, 16 or 32, or 0 for the candidate whose grid runs in the
// fewest waves over the card, then the most rows (measured on an H100 at
// n=120, m=196: the more rows, the faster, at B=64 as at B=4096, since a
// block's time is set by its chain of operator loads, whatever their
// reuse).  Enqueues n_checks launches.  Returns the cudaError_t of the
// launches (0 on success; cudaErrorInvalidValue when no candidate's
// panels fit in shared memory); the kernels run on `stream` and are not
// synchronised.
int ocp_shared_admm_chunk_f32(const void* const* ptrs, int nptrs, int B, int n, int m, int tile,
                              int rows, int bound, int check_every, int n_checks, double sigma,
                              double alpha, double eps_abs, double eps_rel, void* stream) {
  if (nptrs != kNumPtrs || B < 1 || n < 1 || m < 1 || tile < 1 || B % tile != 0 ||
      check_every < 1 || n_checks < 1 ||
      static_cast<long long>(n_checks) * check_every < bound)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows != 0 && rows != 8 && rows != 16 && rows != 32)
    return static_cast<int>(cudaErrorInvalidValue);
  static_assert(sizeof(Args) == kNumPtrs * sizeof(void*), "Args layout");
  Args a;
  memcpy(&a, ptrs, sizeof(Args));
  Dims d;
  d.B = B;
  d.n = n;
  d.m = m;
  d.tile = tile;
  d.bound = bound;
  d.check_every = check_every;
  d.n_checks = n_checks;
  d.groups = B / tile;
  d.bpg = 0;
  d.sigma = static_cast<float>(sigma);
  d.alpha = static_cast<float>(alpha);
  d.one_m_alpha = static_cast<float>(1.0 - alpha);
  d.eps_abs = static_cast<float>(eps_abs);
  d.eps_rel = static_cast<float>(eps_rel);
  int wv[3];  // rows 32, 16, 8
  cudaError_t e;
  if ((e = waves<4>(d, &wv[0])) != cudaSuccess || (e = waves<2>(d, &wv[1])) != cudaSuccess ||
      (e = waves<1>(d, &wv[2])) != cudaSuccess)
    return static_cast<int>(e);
  int best = -1;
  for (int i = 0; i < 3; ++i) {
    if (wv[i] == 0 || (rows != 0 && rows != (32 >> i))) continue;
    if (best < 0 || wv[i] < wv[best]) best = i;
  }
  if (best < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = best == 0 ? launch_checks<4>(a, d, s) : best == 1 ? launch_checks<2>(a, d, s)
                                                         : launch_checks<1>(a, d, s);
  return static_cast<int>(e);
}

const char* ocp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
