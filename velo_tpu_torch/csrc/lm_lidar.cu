// Levenberg-Marquardt solve of the 6-DoF LiDAR system with the staged
// observability prior, one thread block per solve.
//
// Computes what velo_tpu_torch.solve.lm.lm_solve(None, T0, cfg, stage=...)
// computes for one set of fixed correspondences (solve/icp: the stage that
// make_lidar_system's prior-less build and obs_prior_basis make): lm_iters
// iterations of
//
//   * the LiDAR build at T: point-to-line over the edges and point-to-plane
//     over the planars, each weighted by the robust loss (Huber or Cauchy)
//     times `ok` and the optional fit quality; H, g and the cost summed in
//     float64 per kind and rounded once (fp.matmul / fp.sum), then the two
//     kinds added in float32;
//   * the prior's eigenbasis from that H for the first prior_obs_stage_iters
//     iterations (at least the first), then the carried basis;
//   * the prior terms at T through se3.log(se3.compose(T, prior_inv));
//   * the Jacobi-scaled, damped 6x6 Cholesky step in float64 (`bad` when the
//     factor fails or the step is not finite), T_try = exp(delta) T;
//   * the trial cost at T_try: the LiDAR cost alone plus the prior's cost in
//     the iteration's basis;
//   * accept / advance as lm._advance.
//
// Every float32 operation of the plain path is one float32 operation here,
// in the same order, and every fp.* helper is computed in float64 and
// rounded once; the source is compiled with -fmad=false so that no multiply
// and add fuse.  Only the order of the float64 sums over points and inside
// the 6x6 Cholesky differs from the libraries the plain path calls.
//
// The block's threads take strided shares of the correspondences; each
// float64 sum is reduced in a fixed order (warp shuffles, then the warps'
// partials in order), so a replay gives the same bits.  Thread 0 does the
// serial part.  grid.x is the batch of independent solves.
//
// Compiled without CUDA (a C++ compiler, no __CUDACC__) the file gives the
// same solve as a serial host function, lm_lidar_host, for tests of the
// arithmetic on machines without a card.

#include "fp32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSys = 43;  // H (6 x 6, row-major), g (6), cost

// A strided tensor of the batch: element [b, i, j] at p + b*sb + i*s0 + j*s1.
struct View {
  const void* p;
  long long sb, s0, s1;
};

}  // namespace

extern "C" {

struct LmArgs {
  View T0, prior_inv, w_prior;                        // (4,4), (4,4), (6,)
  View edges, edge_mask, a, b, e_ok, edge_q;           // (Ne,3|.)
  View planars, planar_mask, n, d, p_ok, planar_q;     // (Np,3|.)
  float* out_T;        // (B, 4, 4)
  float* out_lam;      // (B,)
  float* out_cost;     // (B,)
  uint8_t* out_conv;   // (B,)
  float* out_last;     // (B,)
  int32_t* out_nacc;   // (B,)
  float* out_sys;      // (B, 43): mode 1, the LiDAR build at T0
  int batch, n_edge, n_planar, iters, stage_iters, loss, mode;
  int has_edge_q, has_planar_q;
  // Solver constants, each rounded to float32 as PyTorch rounds the Python
  // number it meets (half_delta = 0.5 * delta, cauchy_c = 0.5 * delta**2
  // and dz_span = 1 - dz_floor in float64 first).
  float lam_init, lam_down, lam_up, tol, delta, half_delta, cauchy_c;
  float obs_ref, gain, dz_t, dz_r, dz_floor, dz_span;
};

}  // extern "C"

namespace {

HD float ldf(const View& v, int b, int i, int j = 0) {
  return static_cast<const float*>(v.p)[b * v.sb + i * v.s0 + j * v.s1];
}

HD bool ldb(const View& v, int b, int i) {
  return static_cast<const uint8_t*>(v.p)[b * v.sb + i * v.s0] != 0;
}

// fp.matmul of (4,4) transforms (se3.compose).
HD void compose(const float* A, const float* B, float* C) {
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) {
      double s = double(A[i * 4]) * double(B[j]);
      for (int k = 1; k < 4; ++k) s += double(A[i * 4 + k]) * double(B[k * 4 + j]);
      C[i * 4 + j] = static_cast<float>(s);
    }
  }
}

// fp.matmul of (3,3) matrices.
HD void matmul3(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      double s = double(A[i * 3]) * double(B[j]);
      for (int k = 1; k < 3; ++k) s += double(A[i * 3 + k]) * double(B[k * 3 + j]);
      C[i * 3 + j] = static_cast<float>(s);
    }
  }
}

// se3._matvec: fp.matmul(M, v[:, None]).
HD void matvec3(const float* M, const float* v, float* o) {
  for (int i = 0; i < 3; ++i) {
    double s = double(M[i * 3]) * double(v[0]);
    s += double(M[i * 3 + 1]) * double(v[1]);
    s += double(M[i * 3 + 2]) * double(v[2]);
    o[i] = static_cast<float>(s);
  }
}

// se3.apply of one point: R p in float64, plus t, rounded once.
HD void apply(const float* T, const float* p, float* o) {
  for (int i = 0; i < 3; ++i) {
    double s = double(p[0]) * double(T[i * 4]);
    s += double(p[1]) * double(T[i * 4 + 1]);
    s += double(p[2]) * double(T[i * 4 + 2]);
    o[i] = static_cast<float>(s + double(T[i * 4 + 3]));
  }
}

HD void hat(const float* w, float* K) {
  K[0] = 0.0f;  K[1] = -w[2]; K[2] = w[1];
  K[3] = w[2];  K[4] = 0.0f;  K[5] = -w[0];
  K[6] = -w[1]; K[7] = w[0];  K[8] = 0.0f;
}

// se3._sinc_coeffs: A = sin(t)/t, B = (1-cos(t))/t^2, C = (t-sin(t))/t^3.
HD void sinc_coeffs(float theta_sq, float* A, float* B, float* C) {
  const float theta = f_sqrt(clamp_min(theta_sq, 1e-24f));
  const bool small = theta_sq < 1e-6f;
  const float st = small ? 1.0f : theta;
  const float sin_t = f_sin(st), cos_t = f_cos(st);
  *A = small ? 1.0f - theta_sq / 6.0f : sin_t / st;
  *B = small ? 0.5f - theta_sq / 24.0f : (1.0f - cos_t) / (st * st);
  *C = small ? static_cast<float>(1.0 / 6.0) - theta_sq / 120.0f
             : (st - sin_t) / (st * st * st);
}

// eye + a K + b KK, as (eye + a*K) + b*KK.
HD void eye_plus(float a, const float* K, float b, const float* KK, float* M) {
  for (int i = 0; i < 9; ++i) {
    const float e = (i % 4 == 0) ? 1.0f : 0.0f;
    M[i] = (e + a * K[i]) + b * KK[i];
  }
}

// se3.exp: (rho, phi) -> (4,4).
HD void exp_se3(const float* xi, float* T) {
  const float* rho = xi;
  const float* phi = xi + 3;
  const float theta_sq = dot3(phi, phi);
  float A, B, C;
  sinc_coeffs(theta_sq, &A, &B, &C);
  float K[9], KK[9], R[9], V[9], t[3];
  hat(phi, K);
  matmul3(K, K, KK);
  eye_plus(A, K, B, KK, R);
  eye_plus(B, K, C, KK, V);
  matvec3(V, rho, t);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) T[i * 4 + j] = R[i * 3 + j];
    T[i * 4 + 3] = t[i];
  }
  T[12] = 0.0f; T[13] = 0.0f; T[14] = 0.0f; T[15] = 1.0f;
}

HD float safe_sqrt(float x) { return f_sqrt(clamp_min(x, 1e-12f)); }

// se3.rotmat_to_quat (Shepperd), R row-major (3,3) inside a (4,4).
HD void rotmat_to_quat(const float* T, float* q) {
  const float m00 = T[0], m01 = T[1], m02 = T[2];
  const float m10 = T[4], m11 = T[5], m12 = T[6];
  const float m20 = T[8], m21 = T[9], m22 = T[10];
  const float tr = m00 + m11 + m22;
  const float q2[4] = {1.0f + tr, 1.0f + m00 - m11 - m22,
                       1.0f - m00 + m11 - m22, 1.0f - m00 - m11 + m22};
  int idx = 0;  // torch.argmax: the first maximum, a NaN above all
  for (int i = 1; i < 4; ++i) {
    if (is_nan(q2[idx])) break;
    if (is_nan(q2[i]) || q2[i] > q2[idx]) idx = i;
  }
  const float s = 2.0f * safe_sqrt(q2[idx]);
  if (idx == 0) {
    q[0] = 0.25f * s; q[1] = (m21 - m12) / s; q[2] = (m02 - m20) / s;
    q[3] = (m10 - m01) / s;
  } else if (idx == 1) {
    q[0] = (m21 - m12) / s; q[1] = 0.25f * s; q[2] = (m01 + m10) / s;
    q[3] = (m02 + m20) / s;
  } else if (idx == 2) {
    q[0] = (m02 - m20) / s; q[1] = (m01 + m10) / s; q[2] = 0.25f * s;
    q[3] = (m12 + m21) / s;
  } else {
    q[0] = (m10 - m01) / s; q[1] = (m02 + m20) / s; q[2] = (m12 + m21) / s;
    q[3] = 0.25f * s;
  }
  double ss = double(q[0]) * double(q[0]);
  for (int i = 1; i < 4; ++i) ss += double(q[i]) * double(q[i]);
  const float nrm = static_cast<float>(sqrt(ss));
  for (int i = 0; i < 4; ++i) q[i] = q[i] / nrm;
  const float sign = q[0] < 0.0f ? -1.0f : 1.0f;
  for (int i = 0; i < 4; ++i) q[i] = q[i] * sign;
}

// se3.log: (4,4) -> (rho, phi).
HD void log_se3(const float* T, float* xi) {
  float q[4];
  rotmat_to_quat(T, q);
  const float qw = q[0];
  const float* qv = q + 1;
  const float n = norm3(qv);
  const bool small = n < 1e-6f;
  const float safe_n = small ? 1.0f : n;
  const float theta = 2.0f * f_atan2(n, qw);
  // 2.0 / tensor is reciprocal(tensor) * 2.0 in PyTorch.
  const float scale = small ? (1.0f / clamp_min(qw, 0.5f)) * 2.0f
                            : theta / safe_n;
  float* phi = xi + 3;
  for (int i = 0; i < 3; ++i) phi[i] = scale * qv[i];
  // se3._left_jacobian_inv(phi)
  const float theta_sq = dot3(phi, phi);
  const float th = f_sqrt(clamp_min(theta_sq, 1e-24f));
  const bool sm = theta_sq < 1e-6f;
  const float st = sm ? 1.0f : th;
  const float cot_term = (1.0f + f_cos(st)) / (2.0f * st * f_sin(st));
  const float D = sm ? static_cast<float>(1.0 / 12.0) + theta_sq / 720.0f
                     : (1.0f / (st * st)) * 1.0f - cot_term;
  float K[9], KK[9], J[9];
  hat(phi, K);
  matmul3(K, K, KK);
  for (int i = 0; i < 9; ++i) {
    const float e = (i % 4 == 0) ? 1.0f : 0.0f;
    J[i] = (e - 0.5f * K[i]) + D * KK[i];
  }
  const float t[3] = {T[3], T[7], T[11]};
  matvec3(J, t, xi);
}

// icp.ObsBasis: [trans, rot] blocks.
struct Basis {
  float V[2][9];
  float w[2][3];
  float dz[2][3];
};

// icp.obs_prior_basis from the prior-less H (row-major 6 x 6).
HD void obs_basis(const LmArgs& a, const float* w_prior, const float* H,
                  Basis* bs) {
  const float dz_base[2] = {a.dz_t, a.dz_r};
  for (int blk = 0; blk < 2; ++blk) {
    const int o = 3 * blk;
    float A[9], ev[3];
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        A[i * 3 + j] = 0.5f * (H[(o + i) * 6 + o + j] + H[(o + j) * 6 + o + i]);
      }
    }
    sym_eig3(A, ev, bs->V[blk]);
    const float top = clamp_min(ev[2], 1e-12f);
    for (int k = 0; k < 3; ++k) {
      const float s = ev[k] / top;
      const float obs = clamp(s / a.obs_ref, 0.0f, 1.0f);
      bs->w[blk][k] = w_prior[o] * (1.0f + a.gain * (1.0f - obs));
      bs->dz[blk][k] = dz_base[blk] * (a.dz_floor + a.dz_span * obs);
    }
  }
}

// icp._obs_prior_terms: the prior's cost and, with H and g, its H (added
// to H's two diagonal blocks) and g (added to g).
HD float obs_terms(const Basis& bs, const float* r_pr, float* H, float* g) {
  double cost = 0.0;
  for (int blk = 0; blk < 2; ++blk) {
    const float* V = bs.V[blk];
    const float* r = r_pr + 3 * blk;
    float wa[3], wr[3];
    for (int j = 0; j < 3; ++j) {
      double s = double(V[j]) * double(r[0]);
      s += double(V[3 + j]) * double(r[1]);
      s += double(V[6 + j]) * double(r[2]);
      const float rv = static_cast<float>(s);
      const float dz = bs.dz[blk][j];
      const float r_eff = rv - t_min(t_max(rv, -dz), dz);
      const float active = fabsf(rv) > dz ? 1.0f : 0.0f;
      wa[j] = bs.w[blk][j] * active;
      wr[j] = bs.w[blk][j] * r_eff;
      cost += double(wr[j] * r_eff);
    }
    if (H == nullptr) continue;
    const int o = 3 * blk;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        double s = 0.0;
        for (int k = 0; k < 3; ++k) {
          s += double(V[i * 3 + k]) * double(wa[k]) * double(V[j * 3 + k]);
        }
        H[(o + i) * 6 + o + j] = H[(o + i) * 6 + o + j] + static_cast<float>(s);
      }
      double s = 0.0;
      for (int j = 0; j < 3; ++j) s += double(V[i * 3 + j]) * double(wr[j]);
      g[o + i] = g[o + i] + static_cast<float>(s);
    }
  }
  return 0.5f * static_cast<float>(cost);
}

// lm._damped_step without a projector: (delta, bad).
HD bool damped_step(const float* H, const float* g, float lam, float* delta) {
  float D[6];
  for (int i = 0; i < 6; ++i) D[i] = f_sqrt(H[i * 7] + 1e-8f);
  double L[36], x[6];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j <= i; ++j) {
      float m = H[i * 6 + j] / (D[i] * D[j]);
      m = m + (i == j ? lam : 0.0f);
      m = m + (i == j ? 1e-7f : 0.0f);
      L[i * 6 + j] = double(m);
    }
    x[i] = -double(g[i] / D[i]);
  }
  bool bad = false;
  for (int j = 0; j < 6 && !bad; ++j) {  // Cholesky, lower, in place
    double s = L[j * 6 + j];
    for (int k = 0; k < j; ++k) s -= L[j * 6 + k] * L[j * 6 + k];
    if (!(s > 0.0)) { bad = true; break; }
    const double ljj = sqrt(s);
    L[j * 6 + j] = ljj;
    for (int i = j + 1; i < 6; ++i) {
      double t = L[i * 6 + j];
      for (int k = 0; k < j; ++k) t -= L[i * 6 + k] * L[j * 6 + k];
      L[i * 6 + j] = t / ljj;
    }
  }
  if (!bad) {
    for (int i = 0; i < 6; ++i) {  // L y = b
      double s = x[i];
      for (int k = 0; k < i; ++k) s -= L[i * 6 + k] * x[k];
      x[i] = s / L[i * 6 + i];
    }
    for (int i = 5; i >= 0; --i) {  // L^T x = y
      double s = x[i];
      for (int k = i + 1; k < 6; ++k) s -= L[k * 6 + i] * x[k];
      x[i] = s / L[i * 6 + i];
    }
    for (int i = 0; i < 6; ++i) {
      delta[i] = static_cast<float>(x[i]) / D[i];
      bad = bad || !is_finite(delta[i]);
    }
  }
  if (bad) {
    for (int i = 0; i < 6; ++i) delta[i] = 0.0f;
  }
  return bad;
}

// residuals.robust_weight / robust_cost (loss 0: Huber, 1: Cauchy).
HD float robust_weight(const LmArgs& a, float r) {
  if (a.loss == 0) {
    const float ar = fabsf(r);
    // delta / tensor is reciprocal(tensor) * delta in PyTorch.
    return ar <= a.delta ? 1.0f : (1.0f / clamp_min(ar, 1e-9f)) * a.delta;
  }
  const float x = r / a.delta;
  return (1.0f / (1.0f + x * x)) * 1.0f;
}

HD float robust_cost(const LmArgs& a, float r) {
  if (a.loss == 0) {
    const float ar = fabsf(r);
    return ar <= a.delta ? 0.5f * r * r : a.delta * (ar - a.half_delta);
  }
  const float x = r / a.delta;
  return a.cauchy_c * log1pf(x * x);
}


// One residual's terms: J = dr/dp [I | -hat(p)] (residuals.point_jacobian
// through icp._chain), then (J w) J^T, J (w r) and the cost into acc.
HD void add_terms(const float* dr, const float* p, float wt, float r,
                  float cost, double* acc) {
  const float P[3][6] = {{1.0f, 0.0f, 0.0f, -0.0f, p[2], -p[1]},
                         {0.0f, 1.0f, 0.0f, -p[2], -0.0f, p[0]},
                         {0.0f, 0.0f, 1.0f, p[1], -p[0], -0.0f}};
  float J[6];
UNROLL
  for (int c = 0; c < 6; ++c) J[c] = dr[0] * P[0][c] + dr[1] * P[1][c] + dr[2] * P[2][c];
UNROLL
  for (int i = 0; i < 6; ++i) {
    const double jw = double(J[i] * wt);
UNROLL
    for (int j = 0; j < 6; ++j) acc[i * 6 + j] += jw * double(J[j]);
  }
  const double wr = double(wt * r);
UNROLL
  for (int i = 0; i < 6; ++i) acc[36 + i] += double(J[i]) * wr;
  acc[42] += double(cost);
}

// Edge i (residuals.point_to_line at T): with kFull its terms into
// acc[0..42], else its cost into acc[0].
template <bool kFull>
HD void add_edge(const LmArgs& a, int b, int i, const float* T, double* acc) {
  const float p[3] = {ldf(a.edges, b, i, 0), ldf(a.edges, b, i, 1),
                      ldf(a.edges, b, i, 2)};
  const float la[3] = {ldf(a.a, b, i, 0), ldf(a.a, b, i, 1), ldf(a.a, b, i, 2)};
  const float lb[3] = {ldf(a.b, b, i, 0), ldf(a.b, b, i, 1), ldf(a.b, b, i, 2)};
  const bool valid = ldb(a.e_ok, b, i) && ldb(a.edge_mask, b, i);
  float pe[3];
  apply(T, p, pe);
  const float u[3] = {lb[0] - la[0], lb[1] - la[1], lb[2] - la[2]};
  const float un = norm3(u);
  bool ok = valid && (un > 1e-4f);
  const float cu = clamp_min(un, 1e-4f);
  const float uh[3] = {u[0] / cu, u[1] / cu, u[2] / cu};
  const float w[3] = {pe[0] - la[0], pe[1] - la[1], pe[2] - la[2]};
  const float t = dot3(w, uh);
  const float v[3] = {w[0] - t * uh[0], w[1] - t * uh[1], w[2] - t * uh[2]};
  const float r = norm3(v);
  const float cr = clamp_min(r, 1e-6f);
  const float dr[3] = {v[0] / cr, v[1] / cr, v[2] / cr};
  ok = ok && (r > 1e-7f);
  const float okf = ok ? 1.0f : 0.0f;
  const float cost = robust_cost(a, r) * okf;
  if (!kFull) {
    acc[0] += double(cost);
    return;
  }
  float wt = robust_weight(a, r) * okf;
  if (a.has_edge_q) wt = wt * ldf(a.edge_q, b, i);
  add_terms(dr, pe, wt, r, cost, acc);
}

// Planar i (residuals.point_to_plane at T), as add_edge.
template <bool kFull>
HD void add_planar(const LmArgs& a, int b, int i, const float* T,
                   double* acc) {
  const float p[3] = {ldf(a.planars, b, i, 0), ldf(a.planars, b, i, 1),
                      ldf(a.planars, b, i, 2)};
  const float nn[3] = {ldf(a.n, b, i, 0), ldf(a.n, b, i, 1), ldf(a.n, b, i, 2)};
  const bool ok = ldb(a.p_ok, b, i) && ldb(a.planar_mask, b, i);
  float pp[3];
  apply(T, p, pp);
  const float r = dot3(nn, pp) + ldf(a.d, b, i);
  const float okf = ok ? 1.0f : 0.0f;
  const float cost = robust_cost(a, r) * okf;
  if (!kFull) {
    acc[0] += double(cost);
    return;
  }
  float wt = robust_weight(a, r) * okf;
  if (a.has_planar_q) wt = wt * ldf(a.planar_q, b, i);
  add_terms(nn, pp, wt, r, cost, acc);
}

// The solve's serial state (lm.LMState and the carried basis).
struct State {
  float T[16], T_try[16], prior_inv[16], w_prior[6], delta[6];
  float lam, cost, lin_cost, last;
  bool conv, bad;
  int n_accept;
  Basis basis;
};

HD void init_state(const LmArgs& a, int b, State* s) {
  for (int k = 0; k < 16; ++k) {
    s->T[k] = ldf(a.T0, b, k / 4, k % 4);
    s->prior_inv[k] = ldf(a.prior_inv, b, k / 4, k % 4);
  }
  for (int i = 0; i < 6; ++i) s->w_prior[i] = ldf(a.w_prior, b, i);
  s->lam = a.lam_init;
  s->cost = INFINITY;
  s->lin_cost = INFINITY;
  s->last = INFINITY;
  s->conv = false;
  s->bad = false;
  s->n_accept = 0;
}

// The prior-less LiDAR system from the two kinds' float64 sums:
// fp.matmul / fp.sum round each kind once, then float32 adds them.
HD void lidar_system(const double* se, const double* sp, float* H, float* g,
                     float* cost) {
  for (int k = 0; k < 36; ++k) H[k] = static_cast<float>(se[k]) + static_cast<float>(sp[k]);
  for (int i = 0; i < 6; ++i) g[i] = static_cast<float>(se[36 + i]) + static_cast<float>(sp[36 + i]);
  *cost = static_cast<float>(se[42]) + static_cast<float>(sp[42]);
}

// Iteration `it` after the build at s->T: the stage's (H, g, cost), the
// damped step and T_try.
HD void linearize(const LmArgs& a, State* s, const double* se,
                  const double* sp, int it) {
  float H[36], g[6], c0;
  lidar_system(se, sp, H, g, &c0);
  if (it == 0 || it < a.stage_iters) obs_basis(a, s->w_prior, H, &s->basis);
  // H0 + block_diag(Hb): the off-block entries add a zero.
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) {
      if ((i < 3) != (j < 3)) H[i * 6 + j] = H[i * 6 + j] + 0.0f;
    }
  }
  float Tp[16], r_pr[6], E[16];
  compose(s->T, s->prior_inv, Tp);
  log_se3(Tp, r_pr);
  const float cp = obs_terms(s->basis, r_pr, H, g);
  s->lin_cost = c0 + cp;
  s->bad = damped_step(H, g, s->lam, s->delta);
  exp_se3(s->delta, E);
  compose(E, s->T, s->T_try);
}

// After the cost-only pass at s->T_try: accept / advance (lm._advance).
HD void advance(const LmArgs& a, State* s, double ce, double cp) {
  float Tp[16], r_pr[6];
  compose(s->T_try, s->prior_inv, Tp);
  log_se3(Tp, r_pr);
  const float lidar = static_cast<float>(ce) + static_cast<float>(cp);
  const float c_try = lidar + obs_terms(s->basis, r_pr, nullptr, nullptr);
  const bool accept = (c_try < s->lin_cost) && !s->bad && !s->conv;
  const float lam_new = clamp(accept ? s->lam * a.lam_down : s->lam * a.lam_up,
                              1e-9f, 1e6f);
  double ss = double(s->delta[0]) * double(s->delta[0]);
  for (int i = 1; i < 6; ++i) ss += double(s->delta[i]) * double(s->delta[i]);
  const float step = static_cast<float>(sqrt(ss));
  if (accept) {
    for (int k = 0; k < 16; ++k) s->T[k] = s->T_try[k];
    s->last = step;
  }
  if (!s->conv) s->lam = lam_new;
  s->cost = accept ? c_try : s->lin_cost;
  s->conv = s->conv || (accept && step < a.tol);
  s->n_accept += accept ? 1 : 0;
}

HD void write_state(const LmArgs& a, int b, const State& s) {
  for (int k = 0; k < 16; ++k) a.out_T[b * 16 + k] = s.T[k];
  a.out_lam[b] = s.lam;
  a.out_cost[b] = s.cost;
  a.out_conv[b] = s.conv ? 1 : 0;
  a.out_last[b] = s.last;
  a.out_nacc[b] = s.n_accept;
}

HD void write_system(const LmArgs& a, int b, const double* se,
                     const double* sp) {
  float* o = a.out_sys + b * kSys;
  lidar_system(se, sp, o, o + 36, o + 42);
}

#ifdef __CUDACC__

__device__ __forceinline__ double warp_sum(double v) {
UNROLL
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// One pass over the correspondences at T (shared): with kFull the two
// kinds' 43 sums into out[0..42] (edges) and out[43..85] (planars), else
// their costs into out[0] and out[1].  Sums run per thread over its strided
// share, then over the warp by shuffles, then over the warps in order.
template <bool kFull>
__device__ void block_pass(const LmArgs& a, int b, const float* sT,
                           double* part, double* out) {
  constexpr int kN = kFull ? kSys : 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float T[16];
UNROLL
  for (int k = 0; k < 16; ++k) T[k] = sT[k];
UNROLL
  for (int kind = 0; kind < 2; ++kind) {
    double acc[kN];
UNROLL
    for (int k = 0; k < kN; ++k) acc[k] = 0.0;
    if (kind == 0) {
      for (int i = tid; i < a.n_edge; i += kThreads) add_edge<kFull>(a, b, i, T, acc);
    } else {
      for (int i = tid; i < a.n_planar; i += kThreads) add_planar<kFull>(a, b, i, T, acc);
    }
UNROLL
    for (int k = 0; k < kN; ++k) {
      const double v = warp_sum(acc[k]);
      if (lane == 0) part[warp * 2 * kN + kind * kN + k] = v;
    }
  }
  __syncthreads();
  for (int k = tid; k < 2 * kN; k += kThreads) {
    double s = part[k];
    for (int w = 1; w < kWarps; ++w) s += part[w * 2 * kN + k];
    out[k] = s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) lm_lidar_kernel(const LmArgs a) {
  __shared__ double part[kWarps * 2 * kSys];
  __shared__ double sums[2 * kSys];
  __shared__ State st;
  const int b = blockIdx.x;
  const bool lead = threadIdx.x == 0;
  if (lead) init_state(a, b, &st);
  __syncthreads();
  if (a.mode == 1) {
    block_pass<true>(a, b, st.T, part, sums);
    if (lead) write_system(a, b, sums, sums + kSys);
    return;
  }
  for (int it = 0; it < a.iters; ++it) {
    block_pass<true>(a, b, st.T, part, sums);
    if (lead) linearize(a, &st, sums, sums + kSys, it);
    __syncthreads();
    block_pass<false>(a, b, st.T_try, part, sums);
    if (lead) advance(a, &st, sums[0], sums[1]);
    __syncthreads();
  }
  if (lead) write_state(a, b, st);
}

#else  // host build

template <bool kFull>
void host_pass(const LmArgs& a, int b, const float* T, double* out) {
  constexpr int kN = kFull ? kSys : 1;
  for (int k = 0; k < 2 * kN; ++k) out[k] = 0.0;
  for (int i = 0; i < a.n_edge; ++i) add_edge<kFull>(a, b, i, T, out);
  for (int i = 0; i < a.n_planar; ++i) add_planar<kFull>(a, b, i, T, out + kN);
}

#endif

}  // namespace

#ifdef __CUDACC__

// Launch the solve (mode 0) or the build at T0 (mode 1) of a.batch
// independent problems on `stream`, a cudaStream_t of the current device:
// one block each.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int lm_lidar_launch(const LmArgs* a, void* stream) {
  if (a->batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  lm_lidar_kernel<<<a->batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

#else

// The same solve, serially on the host, for every problem of the batch.
extern "C" int lm_lidar_host(const LmArgs* a) {
  double sums[2 * kSys];
  for (int b = 0; b < a->batch; ++b) {
    State st;
    init_state(*a, b, &st);
    if (a->mode == 1) {
      host_pass<true>(*a, b, st.T, sums);
      write_system(*a, b, sums, sums + kSys);
      continue;
    }
    for (int it = 0; it < a->iters; ++it) {
      host_pass<true>(*a, b, st.T, sums);
      linearize(*a, &st, sums, sums + kSys, it);
      host_pass<false>(*a, b, st.T_try, sums);
      advance(*a, &st, sums[0], sums[1]);
    }
    write_state(*a, b, st);
  }
  return 0;
}

#endif
