// Host-side reference ADMM QP solver (dense).
//
// Native validation backend mirroring the role of the reference's
// CuCaQP + OSQP stack (the reference's src/sqp_solver/CuCaQP.cpp): the same
// OSQP-style algorithm as the solvers (solvers/admm.py) — modified Ruiz
// equilibration, per-row rho with equality scaling, over-relaxed ADMM with
// sigma regularization, relative+absolute termination — implemented
// independently in C++ so tests can cross-check the JAX implementation
// against a second, scipy-free oracle with identical semantics.
//
// Two entry points, templated on the working precision:
//   ref_admm_solve     — float32 internals, matching the reference's OSQP
//                        build (`OSQP_USE_FLOAT=ON`, cuda_install.sh:44):
//                        every Ruiz pass, factorization, iteration, and
//                        residual is computed in f32, like OSQP-CUDA.
//   ref_admm_solve_f64 — float64 internals (f32 I/O), for tests that want a
//                        higher-precision second opinion on a single QP.
//
// The PyTorch port's copy of the JAX package's csrc/ref_admm.cpp, the same
// text below this header, so both packages' oracles agree bitwise.
// Compiled at runtime by solvers/native.py (the analog of the reference's
// compileLibrary gcc shell-out, OptimalControlProblem.cpp:602-640) and
// loaded via ctypes.
//
// Condensed linear algebra: M = P + sigma*I + A^T R A factorized once per
// rho update with a dense LDL^T (no pivoting; M is positive definite for
// convex P, matching OSQP's quasi-definite guarantee on the hot MPC QPs).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using std::size_t;

constexpr float RHO_MIN = 1e-6f;
constexpr float RHO_MAX = 1e6f;
constexpr float RHO_EQ_SCALE = 1e3f;
constexpr float RHO_TOL = 1e-4f;
constexpr float MIN_SCALING = 1e-4f;
constexpr float MAX_SCALING = 1e4f;

inline float limit_scaling(float v) {
  if (v < MIN_SCALING) return 1.0f;
  if (v > MAX_SCALING) return MAX_SCALING;
  return v;
}

// Dense LDL^T factorization of an n x n symmetric matrix (in place, lower).
template <typename real>
bool ldlt_factor(std::vector<real>& M, int n) {
  for (int j = 0; j < n; ++j) {
    real d = M[j * n + j];
    for (int k = 0; k < j; ++k) {
      real ljk = M[j * n + k];
      d -= ljk * ljk * M[k * n + k];
    }
    if (std::abs(d) < (real)1e-30) return false;
    M[j * n + j] = d;
    for (int i = j + 1; i < n; ++i) {
      real s = M[i * n + j];
      for (int k = 0; k < j; ++k) {
        s -= M[i * n + k] * M[j * n + k] * M[k * n + k];
      }
      M[i * n + j] = s / d;
    }
  }
  return true;
}

template <typename real>
void ldlt_solve(const std::vector<real>& M, int n, std::vector<real>& b) {
  // Forward: L y = b
  for (int i = 0; i < n; ++i) {
    real s = b[i];
    for (int k = 0; k < i; ++k) s -= M[i * n + k] * b[k];
    b[i] = s;
  }
  // Diagonal
  for (int i = 0; i < n; ++i) b[i] /= M[i * n + i];
  // Backward: L^T x = y
  for (int i = n - 1; i >= 0; --i) {
    real s = b[i];
    for (int k = i + 1; k < n; ++k) s -= M[k * n + i] * b[k];
    b[i] = s;
  }
}

template <typename real>
int admm_impl(int n, int m, const float* P_in, const float* q_in,
              const float* A_in, const float* l_in, const float* u_in,
              float rho0, float sigma_f, float alpha_f, float eps_abs,
              float eps_rel, int max_iter, int check_every,
              int scaling_iters, float* x_out, float* y_out,
              int* iters_out, float* r_prim_out, float* r_dual_out) {
  if (n <= 0 || m < 0) return -1;
  const real sigma = (real)sigma_f;
  const real alpha_relax = (real)alpha_f;
  std::vector<real> P(n * n), q(n), A(std::max(m * n, 1)), l(std::max(m, 1)),
      u(std::max(m, 1));
  for (int i = 0; i < n * n; ++i) P[i] = P_in[i];
  for (int i = 0; i < n; ++i) q[i] = q_in[i];
  for (int i = 0; i < m * n; ++i) A[i] = A_in[i];
  for (int i = 0; i < m; ++i) {
    l[i] = l_in[i];
    u[i] = u_in[i];
    if (l[i] > u[i]) l[i] = u[i];
  }

  // ---- Modified Ruiz equilibration (mirrors solvers/admm.py) ----
  std::vector<real> D(n, (real)1), E(std::max(m, 1), (real)1);
  real c = (real)1;
  std::vector<real> Pb(n * n), Ab(std::max(m * n, 1)), qb(n);
  auto rebuild = [&]() {
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j) Pb[i * n + j] = c * D[i] * P[i * n + j] * D[j];
    for (int i = 0; i < m; ++i)
      for (int j = 0; j < n; ++j) Ab[i * n + j] = E[i] * A[i * n + j] * D[j];
    for (int j = 0; j < n; ++j) qb[j] = c * D[j] * q[j];
  };
  rebuild();
  for (int it = 0; it < scaling_iters; ++it) {
    for (int j = 0; j < n; ++j) {
      real nx = (real)0;
      for (int i = 0; i < n; ++i) nx = std::max(nx, std::abs(Pb[i * n + j]));
      for (int i = 0; i < m; ++i) nx = std::max(nx, std::abs(Ab[i * n + j]));
      D[j] *= (real)1 / std::sqrt((real)limit_scaling((float)nx));
    }
    if (m > 0) {
      // Rebuild Ab with updated D before row norms (matches the JAX order:
      // row norms use the pre-update Ab; keep that order for parity).
      for (int i = 0; i < m; ++i) {
        real nz = (real)0;
        for (int j = 0; j < n; ++j) nz = std::max(nz, std::abs(Ab[i * n + j]));
        E[i] *= (real)1 / std::sqrt((real)limit_scaling((float)nz));
      }
    }
    rebuild();
    real mean_pcol = (real)0;
    for (int j = 0; j < n; ++j) {
      real cn = (real)0;
      for (int i = 0; i < n; ++i) cn = std::max(cn, std::abs(Pb[i * n + j]));
      mean_pcol += cn;
    }
    mean_pcol /= (real)n;
    real qn = (real)0;
    for (int j = 0; j < n; ++j) qn = std::max(qn, std::abs(qb[j]));
    real gamma = (real)1 / (real)limit_scaling((float)std::max(mean_pcol, qn));
    c *= gamma;
    rebuild();
  }
  std::vector<real> lb(std::max(m, 1)), ub(std::max(m, 1));
  for (int i = 0; i < m; ++i) {
    lb[i] = E[i] * l[i];
    ub[i] = E[i] * u[i];
  }

  // ---- per-row rho ----
  std::vector<real> rho(std::max(m, 1), (real)rho0);
  for (int i = 0; i < m; ++i) {
    bool loose = std::isinf(lb[i]) && lb[i] < 0 && std::isinf(ub[i]) && ub[i] > 0;
    bool eq = (ub[i] - lb[i]) < (real)RHO_TOL;
    if (eq)
      rho[i] = std::min(std::max((real)(rho0 * RHO_EQ_SCALE), (real)RHO_MIN),
                        (real)RHO_MAX);
    if (loose) rho[i] = (real)RHO_MIN;
  }

  // ---- factor M = Pb + sigma I + Ab^T R Ab ----
  std::vector<real> M(n * n);
  auto factor = [&]() -> bool {
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j) {
        real s = Pb[i * n + j] + (i == j ? sigma : (real)0);
        for (int k = 0; k < m; ++k)
          s += Ab[k * n + i] * rho[k] * Ab[k * n + j];
        M[i * n + j] = s;
      }
    return ldlt_factor(M, n);
  };
  if (!factor()) return -1;

  std::vector<real> x(n, (real)0), z(std::max(m, 1), (real)0),
      y(std::max(m, 1), (real)0);
  std::vector<real> xt(n), zt(std::max(m, 1)), rhs(n), Ax(std::max(m, 1)),
      Px(n), Aty(n);
  // z = clip(Ab x, lb, ub) with x = 0 start.
  for (int i = 0; i < m; ++i)
    z[i] = std::min(std::max((real)0, lb[i]), ub[i]);

  int it = 0;
  real r_prim = INFINITY, r_dual = INFINITY;
  bool converged = false;
  while (it < max_iter && !converged) {
    for (int step = 0; step < check_every; ++step) {
      // rhs = sigma x - qb + Ab^T (rho z - y)
      for (int j = 0; j < n; ++j) rhs[j] = sigma * x[j] - qb[j];
      for (int i = 0; i < m; ++i) {
        real t = rho[i] * z[i] - y[i];
        for (int j = 0; j < n; ++j) rhs[j] += Ab[i * n + j] * t;
      }
      ldlt_solve(M, n, rhs);
      for (int j = 0; j < n; ++j) xt[j] = rhs[j];
      for (int i = 0; i < m; ++i) {
        real s = (real)0;
        for (int j = 0; j < n; ++j) s += Ab[i * n + j] * xt[j];
        zt[i] = s;
      }
      for (int j = 0; j < n; ++j)
        x[j] = alpha_relax * xt[j] + ((real)1 - alpha_relax) * x[j];
      for (int i = 0; i < m; ++i) {
        real zr = alpha_relax * zt[i] + ((real)1 - alpha_relax) * z[i];
        real znew = std::min(std::max(zr + y[i] / rho[i], lb[i]), ub[i]);
        y[i] = y[i] + rho[i] * (zr - znew);
        z[i] = znew;
      }
    }
    it += check_every;

    // ---- unscaled residuals ----
    for (int i = 0; i < m; ++i) {
      real s = (real)0;
      for (int j = 0; j < n; ++j) s += Ab[i * n + j] * x[j];
      Ax[i] = s;
    }
    for (int j = 0; j < n; ++j) {
      real s = (real)0;
      for (int k = 0; k < n; ++k) s += Pb[j * n + k] * x[k];
      Px[j] = s;
    }
    for (int j = 0; j < n; ++j) {
      real s = (real)0;
      for (int i = 0; i < m; ++i) s += Ab[i * n + j] * y[i];
      Aty[j] = s;
    }
    real rp = (real)0, max_prim = (real)0;
    for (int i = 0; i < m; ++i) {
      rp = std::max(rp, std::abs((Ax[i] - z[i]) / E[i]));
      max_prim = std::max(max_prim, std::abs(Ax[i] / E[i]));
      max_prim = std::max(max_prim, std::abs(z[i] / E[i]));
    }
    real rd = (real)0, max_dual = (real)0;
    for (int j = 0; j < n; ++j) {
      rd = std::max(rd, std::abs((Px[j] + qb[j] + Aty[j]) / D[j]) / c);
      max_dual = std::max(max_dual, std::abs(Aty[j] / D[j]) / c);
      max_dual = std::max(max_dual, std::abs(Px[j] / D[j]) / c);
      max_dual = std::max(max_dual, std::abs(qb[j] / D[j]) / c);
    }
    r_prim = rp;
    r_dual = rd;
    real eps_pri = (real)eps_abs + (real)eps_rel * max_prim;
    real eps_dua = (real)eps_abs + (real)eps_rel * max_dual;
    converged = (m == 0 || rp <= eps_pri) && rd <= eps_dua;
  }

  for (int j = 0; j < n; ++j) x_out[j] = (float)(D[j] * x[j]);
  for (int i = 0; i < m; ++i) y_out[i] = (float)(E[i] * y[i] / c);
  *iters_out = it;
  *r_prim_out = (float)r_prim;
  *r_dual_out = (float)r_dual;
  return converged ? 0 : 1;
}

}  // namespace

extern "C" {

// Returns 0 on success (converged), 1 on max_iter reached, -1 on error.
// All matrices row-major. Outputs: x (n), y (m), iters, r_prim, r_dual.
// f32 internals — the faithful analog of the reference's OSQP build
// (OSQP_USE_FLOAT=ON: every iteration and residual in float).
int ref_admm_solve(int n, int m, const float* P_in, const float* q_in,
                   const float* A_in, const float* l_in, const float* u_in,
                   float rho0, float sigma, float alpha_relax, float eps_abs,
                   float eps_rel, int max_iter, int check_every,
                   int scaling_iters, float* x_out, float* y_out,
                   int* iters_out, float* r_prim_out, float* r_dual_out) {
  return admm_impl<float>(n, m, P_in, q_in, A_in, l_in, u_in, rho0, sigma,
                          alpha_relax, eps_abs, eps_rel, max_iter,
                          check_every, scaling_iters, x_out, y_out, iters_out,
                          r_prim_out, r_dual_out);
}

// f64 internals (f32 I/O) — a higher-precision second opinion.
int ref_admm_solve_f64(int n, int m, const float* P_in, const float* q_in,
                       const float* A_in, const float* l_in,
                       const float* u_in, float rho0, float sigma,
                       float alpha_relax, float eps_abs, float eps_rel,
                       int max_iter, int check_every, int scaling_iters,
                       float* x_out, float* y_out, int* iters_out,
                       float* r_prim_out, float* r_dual_out) {
  return admm_impl<double>(n, m, P_in, q_in, A_in, l_in, u_in, rho0, sigma,
                           alpha_relax, eps_abs, eps_rel, max_iter,
                           check_every, scaling_iters, x_out, y_out,
                           iters_out, r_prim_out, r_dual_out);
}

}  // extern "C"
