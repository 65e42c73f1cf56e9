// Dense per-scenario ADMM device loop for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel
//   optimal_control_problem_tpu/ops/admm_kernel.py::admm_device_loop (:149)
// (the Pallas `_kernel` there).  Contract and op order are those of
//   optimal_control_problem_tpu_torch/ops/admm_kernel.py::admm_device_loop_plain:
// for each of B independent QPs a whole rho-constant condensed OSQP-ADMM
// solve in the scaled space, with its own operators OP (n, n), Ab (m, n),
// Pb (n, n) and per-row rho (m,).  All arrays are batch-leading and
// row-major.
//
// Work split.  One thread block per scenario (grid = B): termination is per
// scenario, so no vote crosses blocks and a plain launch suffices.  The TPU
// kernel pins the operators in VMEM; here, where they fit (the kShared
// variant), the block copies OP, Ab and Pb into dynamic shared memory once
// (4 (2 n^2 + m n) bytes: 158,400 at the cart-pole h20 QP, n = 100,
// m = 196) and runs the whole loop from there.  Ab is stored with an odd
// row stride, so that both of its orientations (t @ Ab: a thread per
// column, and x @ Ab^T: a thread per row) read without bank conflicts.  A
// QP whose operators exceed the 232,448 bytes a block may opt into (from
// n=120, m=236) takes the global variant (kShared = false): the same code
// reads OP, Ab and Pb where the caller holds them, through L1 from L2 (the
// operators of 132 resident scenarios at n=200, m=392 are 66 MB, so the
// later ones come from device memory), and keeps its vectors in a global
// scratch slab per scenario (so no n or m is refused below the JAX
// package's 40 MiB guard); only the reduction rows stay in shared memory.
// A thread owns output elements tid, tid + 256, ...; each is one
// accumulator that runs the contraction index upwards from zero with one
// multiply and one add per term (build with -fmad=false), the plain
// version's order, so both variants agree with it bitwise.  The
// elementwise relaxation, projection and dual update run in the products'
// epilogues; a check's seven maxima are a block-wide reduction (max is
// exact in any order).
//
// Bound on this card.  An iteration costs 2 (2 m n + n^2) = 98,400
// operations per scenario at n = 100, m = 196, and so does a check, against
// one read of the operators per launch: operations bound it (about 0.2 ms
// for 500 iterations at B = 256, 67 TFLOP/s).  What holds the kernel back
// is the chain of shared-memory work per iteration: three dependent
// products, ~400 dependent multiply-add steps (m + 2 n) with three
// barriers, each step two shared-memory loads per warp, ~3,800 warp loads
// per iteration and block, and one block of 8 warps fills an SM's shared
// memory.  The design keeps every operand on chip so that no step waits on
// device memory, and loads kStage terms of a chain ahead of their adds.
// Fewer, wider loads (four columns per thread, 16-byte loads), wgmma/TF32,
// clusters and several scenarios per block are later work.  The global
// variant re-reads its operators at every product, 8 (n^2 + m n) bytes an
// iteration (341 KB at n = 120, m = 236), so there the bytes of its L2
// and device-memory traffic, not shared-memory loads, set the pace.

#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNumPtrs = 17;
constexpr int kRed = 8;  // reduction slots per warp (7 used)
constexpr int kStage = 4;  // terms of a chain whose operands load ahead of its adds

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
  float* vec;         // (B, vec_floats): the vectors of the global variant
};

struct Dims {
  int n, m, ld, max_iter, check_every;  // ld: Ab's row stride (n | 1 in shared memory)
  float sigma, alpha, one_m_alpha, eps_abs, eps_rel;
};

// Floats of one scenario's vectors: x, rhs, xt, qb, 1/D (n each) and z, y,
// rho z - y, lb, ub, rho, 1/E (m each).
__host__ __device__ inline size_t vec_floats(int n, int m) { return 5 * n + 7 * m; }

// Shared floats of one block of the kShared variant (operators, vectors,
// reduction rows); ops/admm_kernel.py::smem_bytes mirrors it.
__host__ __device__ inline size_t smem_floats(int n, int m, int ld) {
  return 2 * static_cast<size_t>(n) * n + static_cast<size_t>(m) * ld + vec_floats(n, m) +
         kRed * kWarps;
}

// sum_k a[k] * w[k * ldw], k = 0 .. K-1, as one ascending chain (one
// multiply and one add per term).  The operands and products of kStage
// terms are formed before their adds, so the loads overlap and only the
// adds wait on each other; the sum's order is the plain version's.
__device__ __forceinline__ float chain(const float* __restrict__ a,
                                       const float* __restrict__ w, int ldw, int K) {
  float acc = 0.0f;
  int k = 0;
  for (; k + kStage <= K; k += kStage) {
    float p[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) p[u] = a[k + u] * w[(k + u) * ldw];
#pragma unroll
    for (int u = 0; u < kStage; ++u) acc = acc + p[u];
  }
  for (; k < K; ++k) acc = acc + a[k] * w[k * ldw];
  return acc;
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

template <bool kShared>
__global__ void __launch_bounds__(kThreads) admm_device_loop_kernel(Args a, Dims d) {
  extern __shared__ float smem[];
  const int n = d.n, m = d.m, ld = d.ld;
  const size_t b = blockIdx.x;
  const float* gOP = a.OP + b * n * n;
  const float* gPb = a.Pb + b * n * n;
  const float* gAb = a.Ab + b * m * n;
  // kShared: operators, vectors and reduction rows in shared memory; else
  // the operators where the caller holds them (ld = n), the vectors in this
  // scenario's scratch slab and the reduction rows in shared memory.
  float* const vbase = kShared ? smem + 2 * n * n + m * ld : a.vec + b * vec_floats(n, m);
  const float* sOP = kShared ? smem : gOP;               // (n, n)
  const float* sPb = kShared ? smem + n * n : gPb;       // (n, n)
  const float* sAb = kShared ? smem + 2 * n * n : gAb;   // (m, ld)
  float* sx = vbase;             // x
  float* srhs = sx + n;          // rhs
  float* sxt = srhs + n;         // xt
  float* sq = sxt + n;           // qb
  float* sdinv = sq + n;         // 1/D
  float* sz = sdinv + n;         // z
  float* sy = sz + m;            // y
  float* sw = sy + m;            // rho z - y
  float* slb = sw + m;
  float* sub = slb + m;
  float* srho = sub + m;
  float* seinv = srho + m;       // 1/E
  float* sred = kShared ? seinv + m : smem;  // (kWarps, kRed)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (kShared) {
    float* const wOP = smem;
    float* const wPb = wOP + n * n;
    float* const wAb = wPb + n * n;
    for (int idx = tid; idx < n * n; idx += kThreads) {
      wOP[idx] = gOP[idx];
      wPb[idx] = gPb[idx];
    }
    for (int idx = tid; idx < m * n; idx += kThreads) {
      const int r = idx / n;
      wAb[r * ld + (idx - r * n)] = gAb[idx];
    }
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
  __syncthreads();

  // z = clip(x @ Ab^T, lb, ub), recomputed at every entry as the TPU kernel
  // does; w = rho z - y feeds the first iteration.
  for (int i = tid; i < m; i += kThreads) {
    const float zv = clip_nan(chain(sx, sAb + i * ld, 1, n), slb[i], sub[i]);
    sz[i] = zv;
    sw[i] = srho[i] * zv - sy[i];
  }
  __syncthreads();

  const float sigma = d.sigma, alpha = d.alpha, oma = d.one_m_alpha;
  const float ci = a.cinv[b];
  int it = 0;
  bool done = false;
  while (it < d.max_iter && !done) {
    for (int t = 0; t < d.check_every; ++t) {
      // rhs = sigma x - qb + (rho z - y) @ Ab
      for (int j = tid; j < n; j += kThreads)
        srhs[j] = (sigma * sx[j] - sq[j]) + chain(sw, sAb + j, ld, m);
      __syncthreads();
      // xt = rhs @ OP;  x = alpha xt + (1 - alpha) x
      for (int j = tid; j < n; j += kThreads) {
        const float acc = chain(srhs, sOP + j, n, n);
        sxt[j] = acc;
        sx[j] = alpha * acc + oma * sx[j];
      }
      __syncthreads();
      // zt = xt @ Ab^T;  relaxation, projection onto [lb, ub], dual update
      for (int i = tid; i < m; i += kThreads) {
        const float acc = chain(sxt, sAb + i * ld, 1, n);
        const float rho = srho[i], zo = sz[i], yo = sy[i];
        const float z_rel = alpha * acc + oma * zo;
        const float z_n = clip_nan(z_rel + yo / rho, slb[i], sub[i]);
        const float y_n = yo + rho * (z_rel - z_n);
        sz[i] = z_n;
        sy[i] = y_n;
        sw[i] = rho * z_n - y_n;
      }
      __syncthreads();
    }

    // Unscaled residuals: x @ Ab^T, x @ Pb, y @ Ab and seven maxima.
    float mx[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = tid; i < m; i += kThreads) {
      const float ax = chain(sx, sAb + i * ld, 1, n);
      const float e = seinv[i], zv = sz[i];
      mx[0] = nmax(mx[0], fabsf((ax - zv) * e));
      mx[1] = nmax(mx[1], fabsf(ax * e));
      mx[2] = nmax(mx[2], fabsf(zv * e));
    }
    for (int j = tid; j < n; j += kThreads) {
      const float px = chain(sx, sPb + j, n, n);
      const float aty = chain(sy, sAb + j, ld, m);
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
    __syncthreads();  // sred is rewritten at the next check
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

}  // namespace

extern "C" {

// ptrs: the kNumPtrs device pointers in Args order (`vec`, the global
// variant's (B, 5 n + 7 m) vector slab, may be any pointer for the shared
// one).  `shared` picks the variant (the wrapper's rule,
// ops/admm_kernel.py::kernel_variant).  Returns the cudaError_t of the
// launch (0 on success; cudaErrorInvalidValue when the shared variant's
// operators exceed the shared memory a block may opt into); the kernel
// runs on `stream` and is not synchronised.
int ocp_admm_device_loop_f32(const void* const* ptrs, int nptrs, int B, int n, int m,
                             int max_iter, int check_every, int shared, double sigma,
                             double alpha, double eps_abs, double eps_rel, void* stream) {
  if (nptrs != kNumPtrs || B < 1 || n < 1 || m < 1 || check_every < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  static_assert(sizeof(Args) == kNumPtrs * sizeof(void*), "Args layout");
  Args a;
  memcpy(&a, ptrs, sizeof(Args));
  Dims d;
  d.n = n;
  d.m = m;
  d.ld = shared ? (n | 1) : n;
  d.max_iter = max_iter;
  d.check_every = check_every;
  d.sigma = static_cast<float>(sigma);
  d.alpha = static_cast<float>(alpha);
  d.one_m_alpha = static_cast<float>(1.0 - alpha);
  d.eps_abs = static_cast<float>(eps_abs);
  d.eps_rel = static_cast<float>(eps_rel);
  const size_t smem =
      (shared ? smem_floats(n, m, d.ld) : static_cast<size_t>(kRed * kWarps)) * sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shared) {
    e = cudaFuncSetAttribute(admm_device_loop_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    admm_device_loop_kernel<true><<<B, kThreads, smem, st>>>(a, d);
  } else {
    admm_device_loop_kernel<false><<<B, kThreads, smem, st>>>(a, d);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ocp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
