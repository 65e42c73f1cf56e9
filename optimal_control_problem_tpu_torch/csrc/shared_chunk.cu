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
// The tensor-core form (iter_precision "high" / "mixed") is a kernel of
// its own, csrc/shared_chunk_tc.cu; both include csrc/shared_chunk_common.cuh
// (the FP32 panel product, the helpers and the termination check).

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
constexpr int kNumPtrs = 25;

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
};

struct Dims {
  int B, n, m, tile, bpg, bound, check_every, n_checks, groups;
  int ks;  // operator slice rows (0: the operators are read through L1)
  float sigma, alpha, one_m_alpha, eps_abs, eps_rel;
};

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
  float* stage = sxt + R * n;  // [kStages][ks][max(n, m)] operator slices
  const int ks = d.ks;
  __shared__ int s_conv[R];
  __shared__ float s_rp[R], s_rd[R], s_rpr[R], s_rdr[R];

  const int tid = threadIdx.x;
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
      panel_product<TR>(sw, a.Ab, m, n, stage, ks, rhs_epi);
      __syncthreads();
      panel_product<TR>(srhs, a.OP, n, n, stage, ks, x_epi);
      __syncthreads();
      panel_product<TR>(sxt, a.AbT, n, m, stage, ks, z_epi);
      __syncthreads();
    }

    residual_check<TR>(a, d, chk, g, n, m, sx, sz, sy, srhs, stage, ks, ci, grow, s_conv, s_rp,
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

// Shared memory of a block of R scenarios with ks-row operator slices:
// the six panels, kStages slices, the per-row results (static).
long long smem_floats(int R, int n, int m, int ks) {
  const int J = n > m ? n : m;
  return static_cast<long long>(R) * (3 * n + 3 * m) + static_cast<long long>(kStages) * ks * J;
}
constexpr int kStaticFloats(int R) { return 5 * R; }

// The most slice rows that fit beside the panels of R scenarios (32, 16, 8
// or 4; 0: read the operators through L1; -1: not even the panels fit).
int stage_rows(int R, int n, int m) {
  const int J = n > m ? n : m;
  if ((smem_floats(R, n, m, 0) + kStaticFloats(R)) * 4 > kSmemLimit) return -1;
  if (J % 4 == 0)
    for (int ks = 32; ks >= 4; ks /= 2)
      if ((smem_floats(R, n, m, ks) + kStaticFloats(R)) * 4 <= kSmemLimit) return ks;
  return 0;
}

// One launch per check block of the chunk's budget, on `stream`.
template <int TR>
cudaError_t launch_checks(const Args& a, Dims d, cudaStream_t stream) {
  constexpr int R = kWarps * TR;
  d.bpg = (d.tile + R - 1) / R;
  d.ks = stage_rows(R, d.n, d.m);
  if (d.ks < 0) return cudaErrorInvalidValue;
  // cp.async copies 16 bytes from 16-byte aligned operators only.
  for (const float* op : {a.OP, a.Ab, a.AbT, a.Pb})
    if (reinterpret_cast<size_t>(op) % 16 != 0) d.ks = 0;
  const dim3 grid(d.groups * d.bpg);
  const size_t smem = static_cast<size_t>(smem_floats(R, d.n, d.m, d.ks)) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(shared_chunk_kernel<TR>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  for (int c = 0; c < d.n_checks; ++c) {
    shared_chunk_kernel<TR><<<grid, kThreads, smem, stream>>>(a, d, c);
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
int ocp_shared_stage_rows(int rows, int n, int m) { return stage_rows(rows, n, m); }

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
  static_assert(sizeof(Args) == kNumPtrs * sizeof(void*), "Args layout");
  Args a;
  memcpy(&a, ptrs, sizeof(Args));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = rows == 4 * kWarps   ? launch_checks<4>(a, d, s)
                        : rows == 2 * kWarps ? launch_checks<2>(a, d, s)
                        : rows == kWarps     ? launch_checks<1>(a, d, s)
                                             : cudaErrorInvalidValue;
  return static_cast<int>(e);
}

const char* ocp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
