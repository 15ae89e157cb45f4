// Levenberg-Marquardt solve of the joint LiDAR-visual 6-DoF system with the
// staged observability prior, one thread block per solve: lm_lidar.cu's
// solve with the visual blocks of the fused scan-to-scan system.
//
// Computes what velo_tpu_torch.solve.lm.lm_solve(None, T0, cfg, stage=...)
// computes for the stage of make_lidar_system(..., vis=...)'s prior-less
// build (solve/icp): each of lm_iters iterations runs lm_lidar.cu's LiDAR
// pass and, after it, the visual pass of icp._vis_terms6: the
// Huber-weighted reprojection of the depth tracks and, where the epipolar
// block is on, the epipolar residual of the tracks without depth with its
// analytic float64 Jacobian (residuals.epipolar, epipolar_jacobian), each
// kind's H, g and cost summed in float64 and rounded once, then added to the
// LiDAR system in float32 as the plain path adds them; the prior's
// eigenbasis from that joint H, the damped Cholesky step, the trial cost
// with the visual cost included, and the accept / reject decision, all by
// lm_lidar.cu's own device functions.
//
// The float contract is lm_lidar.cu's: every float32 operation of the plain
// path is one float32 operation here, in the same order, every fp.* helper
// and every float64 step of the epipolar block is computed in float64 and
// rounded where the plain path rounds, and the source is compiled with
// -fmad=false.  Only the order of the float64 sums over tracks and inside
// the float64 matrix products differs from the libraries the plain path
// calls.  The epipolar block's inputs that do not depend on T (the tracks'
// normalized coordinates x1, x2 through K^-1, and T_cam_velo^-1) come in
// computed by the plain path's own calls, so no library LU is reproduced.
//
// It replaces no TPU kernel: velo_tpu/solve/lm.py is plain XLA.  A solve is
// a chain of dependent iterations over a few thousand points and 256
// tracks, latency-bound on one block whatever the card's width: the whole
// chain stays in one launch (no host, no kernel boundary between
// iterations), each pass's points and tracks are spread over the block's
// 256 threads, and thread 0 prepares each pass's pose-dependent pieces of
// the visual blocks while it holds the serial part.  lm_lidar.cu is
// included as it is, so lm_lidar_kernel keeps its machine code and its own
// library, which the LiDAR-only step builds without this file.
//
// Compiled without CUDA the file gives the same solve as a serial host
// function, lm_joint_host, for tests of the arithmetic without a card.

#include "lm_lidar.cu"

extern "C" {

// The visual blocks of the joint solve (icp.VisData), per problem of the
// batch; x1 and x2 are float64, the masks uint8, the rest float32.
struct VisArgs {
  View xyz, obs_uv, mask, w_lm;     // (K,3), (K,2), (K,), (K,): reprojection
  View w_scale;                     // ()
  View P, T_cam_velo, T_vc;         // (3,4), (4,4), T_cam_velo^-1 (4,4)
  View mask_nodepth, x1, x2;        // (K,), (K,3), (K,3): epipolar
  int n_track, has_epi;
  // vis_weight, epi_weight and huber_delta_repr rounded to float32 (and
  // half_delta = 0.5 * delta in float64 first); min_baseline of
  // residuals.epipolar.
  float vis_weight, epi_weight, delta, half_delta, min_baseline;
};

}  // extern "C"

namespace {

HD double ldd(const View& v, int b, int i, int j) {
  return static_cast<const double*>(v.p)[b * v.sb + i * v.s0 + j * v.s1];
}

// residuals.huber_weight / huber_cost at huber_delta_repr.
HD float huber_weight(const VisArgs& v, float r) {
  const float ar = fabsf(r);
  return ar <= v.delta ? 1.0f : (1.0f / clamp_min(ar, 1e-9f)) * v.delta;
}

HD float huber_cost(const VisArgs& v, float r) {
  const float ar = fabsf(r);
  return ar <= v.delta ? 0.5f * r * r : v.delta * (ar - v.half_delta);
}

// torch.clamp(x, min=m) of a float64 value: NaN stays NaN.
HD double clamp_min_d(double x, double m) { return x < m ? m : x; }

// A @ B of (4,4) float64 matrices.
HD void matmul4d(const double* A, const double* B, double* C) {
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) {
      double s = A[i * 4] * B[j];
      for (int k = 1; k < 4; ++k) s += A[i * 4 + k] * B[k * 4 + j];
      C[i * 4 + j] = s;
    }
  }
}

// A @ B of (3,3) float64 matrices.
HD void matmul3d(const double* A, const double* B, double* C) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      double s = A[i * 3] * B[j];
      for (int k = 1; k < 3; ++k) s += A[i * 3 + k] * B[k * 3 + j];
      C[i * 3 + j] = s;
    }
  }
}

HD void hat_d(double w0, double w1, double w2, double* K) {
  K[0] = 0.0; K[1] = -w2; K[2] = w1;
  K[3] = w2;  K[4] = 0.0; K[5] = -w0;
  K[6] = -w1; K[7] = w0;  K[8] = 0.0;
}

// The essential matrix hat(t) @ R of a float64 (4,4) transform
// (residuals._epipolar64).
HD void essential(const double* M, double* E) {
  double K[9], R[9];
  hat_d(M[3], M[7], M[11], K);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) R[i * 3 + j] = M[i * 4 + j];
  }
  matmul3d(K, R, E);
}

// x @ E.T of one float64 point: the epipolar line.
HD void line_of(const double* E, const double* x, double* l) {
  for (int i = 0; i < 3; ++i) {
    l[i] = x[0] * E[i * 3] + x[1] * E[i * 3 + 1] + x[2] * E[i * 3 + 2];
  }
}

HD double dot3d(const double* a, const double* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// What the visual blocks need at one pose T, shared by the block's threads.
struct VisLin {
  float Tcv[16], Tvc[16], P[12];  // the camera, loaded once
  float vwws;                     // vis_weight * w_scale
  double fx;                      // K[0, 0]
  float Tinv[16];                 // se3.inv(T)
  float A[9];                     // -R_cv R^T
  double E[9];                    // essential matrix of the rounded M
  double E64[9];                  // ... of M in float64 (the Jacobian's)
  double dE[6][9];                // its derivative along each generator
  bool base_ok;                   // |t(M)| > min_baseline
};

HD void vis_init(const VisArgs& v, int b, VisLin* L) {
  for (int k = 0; k < 16; ++k) {
    L->Tcv[k] = ldf(v.T_cam_velo, b, k / 4, k % 4);
    L->Tvc[k] = ldf(v.T_vc, b, k / 4, k % 4);
  }
  for (int k = 0; k < 12; ++k) L->P[k] = ldf(v.P, b, k / 4, k % 4);
  L->vwws = v.vis_weight * ldf(v.w_scale, b, 0);
  L->fx = double(L->P[0]);
}

// icp._vis_terms6's pose-dependent pieces at T: the residuals' (T^-1, the
// rounded M = T_cv T^-1 T_vc, its essential matrix and baseline gate) and,
// with kFull, the Jacobians' (A; residuals.epipolar_jacobian's float64 M,
// its essential matrix, and dE_k = hat(dt_k) R + hat(t) dR_k for
// dM_k = -(A4 G_k T_vc)).
template <bool kFull>
HD void vis_prepare(const VisArgs& v, const float* T, VisLin* L) {
  float Rt[9], Rtt[3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) Rt[i * 3 + j] = T[j * 4 + i];
  }
  const float t[3] = {T[3], T[7], T[11]};
  matvec3(Rt, t, Rtt);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) L->Tinv[i * 4 + j] = Rt[i * 3 + j];
    L->Tinv[i * 4 + 3] = -Rtt[i];
  }
  L->Tinv[12] = 0.0f; L->Tinv[13] = 0.0f; L->Tinv[14] = 0.0f;
  L->Tinv[15] = 1.0f;
  float A4[16], M[16];
  compose(L->Tcv, L->Tinv, A4);
  compose(A4, L->Tvc, M);
  const float tm[3] = {M[3], M[7], M[11]};
  L->base_ok = norm3(tm) > v.min_baseline;
  double Md[16];
  for (int k = 0; k < 16; ++k) Md[k] = double(M[k]);
  essential(Md, L->E);
  if (!kFull) return;
  float Rcv[9], CA[9];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) Rcv[i * 3 + j] = L->Tcv[i * 4 + j];
  }
  matmul3(Rcv, Rt, CA);
  for (int k = 0; k < 9; ++k) L->A[k] = -CA[k];
  double A64[16], V64[16], M64[16];
  for (int k = 0; k < 16; ++k) {
    A64[k] = double(A4[k]);
    V64[k] = double(L->Tvc[k]);
  }
  matmul4d(A64, V64, M64);
  essential(M64, L->E64);
  double R[9], Kt[9];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) R[i * 3 + j] = M64[i * 4 + j];
  }
  hat_d(M64[3], M64[7], M64[11], Kt);
  for (int k = 0; k < 6; ++k) {
    double G[16], AG[16], D[16];
    for (int e = 0; e < 16; ++e) G[e] = 0.0;
    if (k < 3) {
      G[k * 4 + 3] = 1.0;
    } else {
      double Kg[9];
      hat_d(k == 3 ? 1.0 : 0.0, k == 4 ? 1.0 : 0.0, k == 5 ? 1.0 : 0.0, Kg);
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) G[i * 4 + j] = Kg[i * 3 + j];
      }
    }
    matmul4d(A64, G, AG);
    matmul4d(AG, V64, D);
    for (int e = 0; e < 16; ++e) D[e] = -D[e];
    double Kd[9], dR[9], P1[9], P2[9];
    hat_d(D[3], D[7], D[11], Kd);
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) dR[i * 3 + j] = D[i * 4 + j];
    }
    matmul3d(Kd, R, P1);
    matmul3d(Kt, dR, P2);
    for (int e = 0; e < 9; ++e) L->dE[k][e] = P1[e] + P2[e];
  }
}

// Depth track i (residuals.reprojection at T through T^-1 and T_cv, the
// chain A [I | -hat(X_prev)]): with kFull its terms into acc[0..42] (H and
// g from wv J, summed in float64 as fp.einsum does), else its cost into
// acc[0].
template <bool kFull>
HD void add_reproj(const VisArgs& v, const VisLin& L, int b, int i,
                   double* acc) {
  const float X[3] = {ldf(v.xyz, b, i, 0), ldf(v.xyz, b, i, 1),
                      ldf(v.xyz, b, i, 2)};
  const float obs[2] = {ldf(v.obs_uv, b, i, 0), ldf(v.obs_uv, b, i, 1)};
  const float wlm = ldf(v.w_lm, b, i);
  float Y[3], Xc[3], x[3];
  apply(L.Tinv, X, Y);
  apply(L.Tcv, Y, Xc);
  for (int r = 0; r < 3; ++r) {  // fp.einsum("ij,...j->...i", P, [X, 1])
    double s = double(L.P[r * 4]) * double(Xc[0]);
    s += double(L.P[r * 4 + 1]) * double(Xc[1]);
    s += double(L.P[r * 4 + 2]) * double(Xc[2]);
    s += double(L.P[r * 4 + 3]) * 1.0;
    x[r] = static_cast<float>(s);
  }
  const float z = x[2];
  const bool ok = ldb(v.mask, b, i) && (z > 0.1f);
  const float sz = ok ? z : 1.0f;
  const float uv[2] = {x[0] / sz, x[1] / sz};
  const float rv[2] = {uv[0] - obs[0], uv[1] - obs[1]};
  const float rn = static_cast<float>(
      sqrt(double(rv[0]) * double(rv[0]) + double(rv[1]) * double(rv[1])));
  const float okf = ok ? 1.0f : 0.0f;
  const float cost = (huber_cost(v, rn) * okf) * wlm;
  if (!kFull) {
    acc[0] += double(cost);
    return;
  }
  float dr[2][3];
  for (int c = 0; c < 3; ++c) {
    dr[0][c] = (L.P[c] - uv[0] * L.P[8 + c]) / sz;
    dr[1][c] = (L.P[4 + c] - uv[1] * L.P[8 + c]) / sz;
  }
  const float pj[3][6] = {{1.0f, 0.0f, 0.0f, -0.0f, X[2], -X[1]},
                          {0.0f, 1.0f, 0.0f, -X[2], -0.0f, X[0]},
                          {0.0f, 0.0f, 1.0f, X[1], -X[0], -0.0f}};
  float dX[3][6];
  for (int r = 0; r < 3; ++r) {
    for (int l = 0; l < 6; ++l) {
      double s = double(L.A[r * 3]) * double(pj[0][l]);
      s += double(L.A[r * 3 + 1]) * double(pj[1][l]);
      s += double(L.A[r * 3 + 2]) * double(pj[2][l]);
      dX[r][l] = static_cast<float>(s);
    }
  }
  const float wv = ((huber_weight(v, rn) * okf) * wlm) * L.vwws;
  for (int r = 0; r < 2; ++r) {
    float J[6];
    for (int l = 0; l < 6; ++l) {
      double s = double(dr[r][0]) * double(dX[0][l]);
      s += double(dr[r][1]) * double(dX[1][l]);
      s += double(dr[r][2]) * double(dX[2][l]);
      J[l] = static_cast<float>(s);
    }
    for (int p = 0; p < 6; ++p) {
      const double jw = double(wv) * double(J[p]);
      for (int q = 0; q < 6; ++q) acc[p * 6 + q] += jw * double(J[q]);
      acc[36 + p] += jw * double(rv[r]);
    }
  }
  acc[42] += double(cost);
}

// Track i without depth (residuals.epipolar from the rounded M, its
// Jacobian from the float64 one), as add_reproj.
template <bool kFull>
HD void add_epipolar(const VisArgs& v, const VisLin& L, int b, int i,
                     double* acc) {
  const double x1[3] = {ldd(v.x1, b, i, 0), ldd(v.x1, b, i, 1),
                        ldd(v.x1, b, i, 2)};
  const double x2[3] = {ldd(v.x2, b, i, 0), ldd(v.x2, b, i, 1),
                        ldd(v.x2, b, i, 2)};
  double l[3];
  line_of(L.E, x1, l);
  const double ln = sqrt(l[0] * l[0] + l[1] * l[1]);
  const double s = dot3d(x2, l);
  const bool ok = ldb(v.mask_nodepth, b, i) && L.base_ok && (ln > 1e-8);
  const float r = ok ? static_cast<float>(L.fx * s / clamp_min_d(ln, 1e-8))
                     : 0.0f;
  const float okf = ok ? 1.0f : 0.0f;
  const float cost = huber_cost(v, r) * okf;
  if (!kFull) {
    acc[0] += double(cost);
    return;
  }
  double m[3];
  line_of(L.E64, x1, m);
  const double mn = sqrt(m[0] * m[0] + m[1] * m[1]);
  const double ms = dot3d(x2, m);
  float J[6];
  for (int k = 0; k < 6; ++k) {
    double dl[3];
    line_of(L.dE[k], x1, dl);
    const double ds = dot3d(x2, dl);
    const double dln2 = m[0] * dl[0] + m[1] * dl[1];
    const double jk = L.fx * (ds - ms * dln2 / (mn * mn)) / mn;
    J[k] = ok ? static_cast<float>(jk) : 0.0f;
  }
  const float w = (huber_weight(v, r) * okf) * v.epi_weight;
  for (int p = 0; p < 6; ++p) {
    const double jw = double(w) * double(J[p]);
    for (int q = 0; q < 6; ++q) acc[p * 6 + q] += jw * double(J[q]);
    acc[36 + p] += jw * double(r);
  }
  acc[42] += double(cost);
}

// The joint system from the four kinds' float64 sums (edges, planars,
// reprojection, epipolar): icp.make_lidar_system's H + Hv, g + gv and
// cost + cv, where _vis_terms6 adds each visual kind, rounded once, to
// zeros in float32 and weights the costs (vis_weight * w_scale, epi_weight)
// after their sums.
HD void joint_system(const VisArgs& v, const VisLin& L, const double* sums,
                     float* H, float* g, float* cost) {
  const double* sr = sums + 2 * kSys;
  const double* sq = sums + 3 * kSys;
  lidar_system(sums, sums + kSys, H, g, cost);
  for (int k = 0; k < 42; ++k) {
    float hv = 0.0f + static_cast<float>(sr[k]);
    if (v.has_epi) hv = hv + static_cast<float>(sq[k]);
    if (k < 36) {
      H[k] = H[k] + hv;
    } else {
      g[k - 36] = g[k - 36] + hv;
    }
  }
  float cv = 0.0f + L.vwws * static_cast<float>(sr[42]);
  if (v.has_epi) cv = cv + v.epi_weight * static_cast<float>(sq[42]);
  *cost = *cost + cv;
}

// The joint cost alone from the cost-only pass's four sums.
HD float joint_cost(const VisArgs& v, const VisLin& L, const double* sums) {
  const float lidar = static_cast<float>(sums[0]) + static_cast<float>(sums[1]);
  float cv = 0.0f + L.vwws * static_cast<float>(sums[2]);
  if (v.has_epi) cv = cv + v.epi_weight * static_cast<float>(sums[3]);
  return lidar + cv;
}

// The joint kernel drives lm_lidar_kernel's own linearize and advance,
// which take the LiDAR kinds' two float64 sums and round and add them in
// float32: given the joint system as the first and zeros as the second,
// each entry is x + 0.0f == x (no entry is -0: every sum starts at +0),
// so they compute the joint step exactly without a joint variant of
// either.
HD void joint_as_sums(const VisArgs& v, const VisLin& L, const double* sums,
                      double* js) {
  float H[36], g[6], c;
  joint_system(v, L, sums, H, g, &c);
  for (int k = 0; k < 36; ++k) js[k] = double(H[k]);
  for (int i = 0; i < 6; ++i) js[36 + i] = double(g[i]);
  js[42] = double(c);
}

HD void write_joint_system(const LmArgs& a, const VisArgs& v, const VisLin& L,
                           int b, const double* sums) {
  float* o = a.out_sys + b * kSys;
  joint_system(v, L, sums, o, o + 36, o + 42);
}

#ifdef __CUDACC__

// The visual kinds' pass at the pose vl was prepared for, as block_pass:
// with kFull the reprojection's and the epipolar block's 43 sums each into
// out[0..85], else their costs into out[0] and out[1].
template <bool kFull>
__device__ void vis_pass(const VisArgs& v, const VisLin& vl, int b,
                         double* part, double* out) {
  constexpr int kN = kFull ? kSys : 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
UNROLL
  for (int kind = 0; kind < 2; ++kind) {
    double acc[kN];
UNROLL
    for (int k = 0; k < kN; ++k) acc[k] = 0.0;
    if (kind == 0) {
      for (int i = tid; i < v.n_track; i += kThreads) add_reproj<kFull>(v, vl, b, i, acc);
    } else if (v.has_epi) {
      for (int i = tid; i < v.n_track; i += kThreads) add_epipolar<kFull>(v, vl, b, i, acc);
    }
UNROLL
    for (int k = 0; k < kN; ++k) {
      const double w = warp_sum(acc[k]);
      if (lane == 0) part[warp * 2 * kN + kind * kN + k] = w;
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

// The joint solve: lm_lidar_kernel's loop with the visual pass after each
// LiDAR pass; thread 0 prepares the visual blocks' pose-dependent pieces
// for each pass while it holds the serial part.
__global__ void __launch_bounds__(kThreads) lm_joint_kernel(const LmArgs a,
                                                            const VisArgs v) {
  __shared__ double part[kWarps * 2 * kSys];
  __shared__ double sums[4 * kSys];
  __shared__ State st;
  __shared__ VisLin vl;
  const int b = blockIdx.x;
  const bool lead = threadIdx.x == 0;
  if (lead) {
    init_state(a, b, &st);
    vis_init(v, b, &vl);
    vis_prepare<true>(v, st.T, &vl);
  }
  __syncthreads();
  if (a.mode == 1) {
    block_pass<true>(a, b, st.T, part, sums);
    vis_pass<true>(v, vl, b, part, sums + 2 * kSys);
    if (lead) write_joint_system(a, v, vl, b, sums);
    return;
  }
  for (int it = 0; it < a.iters; ++it) {
    block_pass<true>(a, b, st.T, part, sums);
    vis_pass<true>(v, vl, b, part, sums + 2 * kSys);
    if (lead) {
      double js[kSys], zeros[kSys];
      joint_as_sums(v, vl, sums, js);
      for (int k = 0; k < kSys; ++k) zeros[k] = 0.0;
      linearize(a, &st, js, zeros, it);
      vis_prepare<false>(v, st.T_try, &vl);
    }
    __syncthreads();
    block_pass<false>(a, b, st.T_try, part, sums);
    vis_pass<false>(v, vl, b, part, sums + 2);
    if (lead) {
      advance(a, &st, double(joint_cost(v, vl, sums)), 0.0);
      if (it + 1 < a.iters) vis_prepare<true>(v, st.T, &vl);
    }
    __syncthreads();
  }
  if (lead) write_state(a, b, st);
}

#else  // host build

template <bool kFull>
void host_vis_pass(const VisArgs& v, const VisLin& vl, int b, double* out) {
  constexpr int kN = kFull ? kSys : 1;
  for (int k = 0; k < 2 * kN; ++k) out[k] = 0.0;
  for (int i = 0; i < v.n_track; ++i) add_reproj<kFull>(v, vl, b, i, out);
  if (!v.has_epi) return;
  for (int i = 0; i < v.n_track; ++i) add_epipolar<kFull>(v, vl, b, i, out + kN);
}

#endif

}  // namespace

#ifdef __CUDACC__

// Launch the joint solve (mode 0) or the joint build at T0 (mode 1) of
// a->batch independent problems on `stream`: one block each.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int lm_joint_launch(const LmArgs* a, const VisArgs* v, void* stream) {
  if (a->batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  lm_joint_kernel<<<a->batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a, *v);
  return static_cast<int>(cudaGetLastError());
}

#else

// The joint solve, serially on the host.
extern "C" int lm_joint_host(const LmArgs* a, const VisArgs* v) {
  double sums[4 * kSys], js[kSys], zeros[kSys];
  for (int k = 0; k < kSys; ++k) zeros[k] = 0.0;
  for (int b = 0; b < a->batch; ++b) {
    State st;
    VisLin vl;
    init_state(*a, b, &st);
    vis_init(*v, b, &vl);
    vis_prepare<true>(*v, st.T, &vl);
    if (a->mode == 1) {
      host_pass<true>(*a, b, st.T, sums);
      host_vis_pass<true>(*v, vl, b, sums + 2 * kSys);
      write_joint_system(*a, *v, vl, b, sums);
      continue;
    }
    for (int it = 0; it < a->iters; ++it) {
      host_pass<true>(*a, b, st.T, sums);
      host_vis_pass<true>(*v, vl, b, sums + 2 * kSys);
      joint_as_sums(*v, vl, sums, js);
      linearize(*a, &st, js, zeros, it);
      vis_prepare<false>(*v, st.T_try, &vl);
      host_pass<false>(*a, b, st.T_try, sums);
      host_vis_pass<false>(*v, vl, b, sums + 2);
      advance(*a, &st, double(joint_cost(*v, vl, sums)), 0.0);
      vis_prepare<true>(*v, st.T, &vl);
    }
    write_state(*a, b, st);
  }
  return 0;
}

#endif
