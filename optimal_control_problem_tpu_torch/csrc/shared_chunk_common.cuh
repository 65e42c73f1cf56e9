// What both forms of the shared-operator chunk need: the FP32 panel
// product (an ascending chain per output element, operators streamed
// through shared memory in slices), the NaN-keeping helpers and the
// termination check with its vote.  Included by csrc/shared_chunk.cu (the
// FP32 form, iter_precision "highest") and csrc/shared_chunk_tc.cu (the
// tensor-core form, "high" / "mixed"), so both run the same text and the
// FP32 chains of the two forms are the same instructions.
//
// The includer defines, before the #include: kThreads (the threads that
// run a product: warp w owns rows w * TR .. w * TR + TR - 1), kStages
// (operator slices in flight) and kMaxCols (columns per lane and pass).

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// out[r, j] = sum_k a[r, k] * W[k, j] for the block's rows; `a` in shared
// memory with row stride K, W (K, J) row-major in global memory, streamed
// through `stage` in slices of ks rows (ks = 0: read through L1).  Calls
// epi(i, r, j, value) once per element from the thread that owns it: rows
// r = warp * TR + i, columns lane + 32 c of each (32 C)-column pass.
template <int TR, int C, class Epi>
__device__ __forceinline__ void panel_product_c(const float* __restrict__ a,
                                                const float* __restrict__ W, int K, int J,
                                                float* stage, int ks, Epi epi) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * TR;
  for (int j0 = 0; j0 < J; j0 += 32 * C) {
    int col[C];
    int ld[C];  // clamped: a lane past the edge loads a valid column it drops
#pragma unroll
    for (int c = 0; c < C; ++c) {
      col[c] = j0 + lane + 32 * c;
      ld[c] = col[c] < J ? col[c] : J - 1;
    }
    float acc[TR][C];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;
    // Terms k0 .. k0 + rows - 1 of every chain, the operator's rows read
    // from ws (row stride J, row 0 = operator row k0).
    auto mac = [&](const float* ws, bool global, int k0, int rows) {
#pragma unroll 8
      for (int k = 0; k < rows; ++k) {
        const float* wrow = ws + static_cast<size_t>(k) * J;
        float w[C];
#pragma unroll
        for (int c = 0; c < C; ++c) w[c] = global ? __ldg(wrow + ld[c]) : wrow[ld[c]];
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float av = a[(r0 + i) * K + k0 + k];
#pragma unroll
          for (int c = 0; c < C; ++c) acc[i][c] = acc[i][c] + av * w[c];
        }
      }
    };
    if (ks == 0) {
      mac(W, true, 0, K);
    } else {
      const int S = (K + ks - 1) / ks;
      __syncthreads();  // nobody still reads the slices of the last product
      // Slice s (operator rows [s ks, s ks + ks) clipped to K) into buffer
      // s % kStages, 16 bytes per copy (J % 4 == 0 where ks > 0); one
      // commit group per slice, empty past the last.
      auto issue = [&](int s) {
        if (s < S) {
          const int k0 = s * ks, rows = K - k0 < ks ? K - k0 : ks;
          float* const dst = stage + (s % kStages) * ks * J;
          const float* const src = W + static_cast<size_t>(k0) * J;
          for (int q = threadIdx.x; q < rows * J / 4; q += kThreads)
            __pipeline_memcpy_async(dst + 4 * q, src + 4 * q, 16);
        }
        __pipeline_commit();
      };
      issue(0);
      issue(1);
      for (int s = 0; s < S; ++s) {
        __pipeline_wait_prior(1);  // slice s has landed (s + 1 may be in flight)
        __syncthreads();           // ... for every thread; slice s - 1 is free
        issue(s + 2);
        const int k0 = s * ks, rows = K - k0 < ks ? K - k0 : ks;
        mac(stage + (s % kStages) * ks * J, false, k0, rows);
      }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (col[c] < J) epi(i, r0 + i, col[c], acc[i][c]);
  }
}

// The pass width that covers J in one pass where it can.
template <int TR, class Epi>
__device__ __forceinline__ void panel_product(const float* __restrict__ a,
                                              const float* __restrict__ W, int K, int J,
                                              float* stage, int ks, Epi epi) {
  if (J <= 32)
    panel_product_c<TR, 1>(a, W, K, J, stage, ks, epi);
  else if (J <= 64)
    panel_product_c<TR, 2>(a, W, K, J, stage, ks, epi);
  else if (J <= 128)
    panel_product_c<TR, 4>(a, W, K, J, stage, ks, epi);
  else
    panel_product_c<TR, kMaxCols>(a, W, K, J, stage, ks, epi);
}

// How many __syncthreads() panel_product(a, W, K, J, stage, ks, epi)
// executes: one per pass and one per slice of each pass (none through L1).
// A thread of the block that runs no product passes as many barriers.
__host__ __device__ __forceinline__ int panel_product_syncs(int K, int J, int ks) {
  const int C = J <= 32 ? 1 : J <= 64 ? 2 : J <= 128 ? 4 : kMaxCols;
  const int passes = (J + 32 * C - 1) / (32 * C);
  return ks == 0 ? 0 : passes * (1 + (K + ks - 1) / ks);
}

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

// The termination check that ends a check block: the unscaled residuals
// of the block's R = (kThreads / 32) TR rows from x, z, y (shared memory)
// as FP32 chains, each row's verdict and residuals into s_conv, s_rp, s_rd,
// s_rpr, s_rdr, and the block's vote into the group's count of check chk.
// Run by the kThreads threads of the products; srhs is overwritten (Px).
template <int TR, class A, class D, class Grow>
__device__ __forceinline__ void residual_check(const A& a, const D& d, int chk, int g, int n,
                                               int m, const float* sx, const float* sz,
                                               const float* sy, float* srhs, float* stage,
                                               int ks, float ci, Grow grow, int* s_conv,
                                               float* s_rp, float* s_rd, float* s_rpr,
                                               float* s_rdr) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
    // Unscaled residuals.  A warp owns whole rows, so a row's maxima are
    // the warp's reduction of its lanes' maxima (max is exact: any order).
    float m_rp[TR], m_ax[TR], m_z[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) m_rp[i] = m_ax[i] = m_z[i] = 0.0f;
    panel_product<TR>(sx, a.AbT, n, m, stage, ks, [&](int i, int r, int j, float ax) {
      const float e = __ldg(a.einv + j);
      const float zv = sz[r * m + j];
      m_rp[i] = nmax(m_rp[i], fabsf((ax - zv) * e));
      m_ax[i] = nmax(m_ax[i], fabsf(ax * e));
      m_z[i] = nmax(m_z[i], fabsf(zv * e));
    });
    // Px lands in the slot of srhs that the same thread reads back below
    // (both products are n wide, so the element's owner is the same).
    panel_product<TR>(sx, a.Pb, n, n, stage, ks, [&](int, int r, int j, float px) { srhs[r * n + j] = px; });
    float m_rd[TR], m_aty[TR], m_px[TR], m_q[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) m_rd[i] = m_aty[i] = m_px[i] = m_q[i] = 0.0f;
    panel_product<TR>(sy, a.Ab, m, n, stage, ks, [&](int i, int r, int j, float aty) {
      const float dv = __ldg(a.dinv + j);
      const float px = srhs[r * n + j];
      const float qv = __ldg(a.qb + static_cast<size_t>(grow(r)) * n + j);
      m_rd[i] = nmax(m_rd[i], fabsf(((px + qv) + aty) * dv));
      m_aty[i] = nmax(m_aty[i], fabsf(aty * dv));
      m_px[i] = nmax(m_px[i], fabsf(px * dv));
      m_q[i] = nmax(m_q[i], fabsf(qv * dv));
    });
    int mine = 1;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float r_prim = warp_max(m_rp[i]);
      const float max_prim = nmax(warp_max(m_ax[i]), warp_max(m_z[i]));
      const float r_dual = ci * warp_max(m_rd[i]);
      const float max_dual =
          ci * nmax(nmax(warp_max(m_aty[i]), warp_max(m_px[i])), warp_max(m_q[i]));
      const float eps_pri = d.eps_abs + d.eps_rel * max_prim;
      const float eps_dua = d.eps_abs + d.eps_rel * max_dual;
      const int cv = (r_prim <= eps_pri) && (r_dual <= eps_dua);
      mine &= cv;
      if (lane == 0) {
        const int r = warp * TR + i;
        s_conv[r] = cv;
        s_rp[r] = r_prim;
        s_rd[r] = r_dual;
        // torch.clamp(., min=1e-12) keeps a NaN.
        s_rpr[r] = r_prim / (max_prim != max_prim ? max_prim : fmaxf(max_prim, 1e-12f));
        s_rdr[r] = r_dual / (max_dual != max_dual ? max_dual : fmaxf(max_dual, 1e-12f));
      }
    }
    // The block's vote: every scenario of it converged or not.  (Also the
    // barrier between this check's reads and the write-back below.)
    const int block_all = __syncthreads_and(mine);
    if (tid == 0 && !block_all) atomicAdd(a.votes + g * d.n_checks + chk, 1);
}
