// The float32 arithmetic of velo_tpu_torch/fp.py and geom/linalg.py for the
// port's CUDA kernels that mirror the plain path bit for bit (lm_lidar.cu,
// lm_joint.cu, corr_fit.cu).
//
// Each fp.* helper is computed in float64 and rounded once to float32;
// every other float32 operation is one float32 operation, in the plain
// path's order.  The including sources are compiled with -fmad=false
// (nvcc) or -ffp-contract=off (g++), so that no multiply and add fuse.
// Without __CUDACC__ the functions are plain host functions.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#define UNROLL _Pragma("unroll")
#else
#define HD inline
#define UNROLL
#endif

namespace {

HD bool is_nan(float x) { return x != x; }
HD bool is_finite(float x) { return (x - x) == 0.0f; }

// torch.clamp(x, min=m): NaN stays NaN.
HD float clamp_min(float x, float m) { return x < m ? m : x; }
HD float clamp_max(float x, float m) { return m < x ? m : x; }
HD float clamp(float x, float lo, float hi) {
  return is_nan(x) ? x : clamp_max(clamp_min(x, lo), hi);
}
HD float t_max(float a, float b) {  // torch.maximum
  return (is_nan(a) || is_nan(b)) ? (a + b) : (a > b ? a : b);
}
HD float t_min(float a, float b) {  // torch.minimum
  return (is_nan(a) || is_nan(b)) ? (a + b) : (a < b ? a : b);
}

// fp.py: the operation in float64, rounded once.
HD float f_sqrt(float x) { return static_cast<float>(sqrt(double(x))); }
HD float f_sin(float x) { return static_cast<float>(sin(double(x))); }
HD float f_cos(float x) { return static_cast<float>(cos(double(x))); }
HD float f_acos(float x) { return static_cast<float>(acos(double(x))); }
HD float f_atan2(float y, float x) {
  return static_cast<float>(atan2(double(y), double(x)));
}
HD float f_fma(float a, float b, float c) {
  return static_cast<float>(double(a) * double(b) + double(c));
}
HD float dot3(const float* a, const float* b) {
  float acc = a[0] * b[0];
  acc = f_fma(a[1], b[1], acc);
  return f_fma(a[2], b[2], acc);
}
HD float norm3(const float* a) { return f_sqrt(dot3(a, a)); }
HD void cross3(const float* a, const float* b, float* o) {
  o[0] = f_fma(a[1], b[2], -(a[2] * b[1]));
  o[1] = f_fma(a[2], b[0], -(a[0] * b[2]));
  o[2] = f_fma(a[0], b[1], -(a[1] * b[0]));
}

// linalg.sym_eig3x3 of the symmetric (3,3) A: ascending eigenvalues and
// the eigenvectors as the columns of V (row-major).
HD void eigvec3(float a00, float a01, float a02, float a11, float a12,
                float a22, float lam, float* v) {
  const float r0[3] = {a00 - lam, a01, a02};
  const float r1[3] = {a01, a11 - lam, a12};
  const float r2[3] = {a02, a12, a22 - lam};
  float c01[3], c02[3], c12[3];
  cross3(r0, r1, c01);
  cross3(r0, r2, c02);
  cross3(r1, r2, c12);
  const float n01 = dot3(c01, c01), n02 = dot3(c02, c02), n12 = dot3(c12, c12);
  const float* best = (n01 >= n02 && n01 >= n12) ? c01 : (n02 >= n12 ? c02 : c12);
  const float nrm = norm3(best);
  if (nrm > 1e-12f) {
    const float c = clamp_min(nrm, 1e-12f);
    for (int i = 0; i < 3; ++i) v[i] = best[i] / c;
  } else {
    v[0] = 1.0f; v[1] = 0.0f; v[2] = 0.0f;
  }
}

HD void sym_eig3(const float* A, float* ev, float* V) {
  const float a00 = A[0], a11 = A[4], a22 = A[8];
  const float a01 = A[1], a02 = A[2], a12 = A[5];
  const float p1 = a01 * a01 + a02 * a02 + a12 * a12;
  const float q = (a00 + a11 + a22) / 3.0f;
  const float d0 = a00 - q, d1 = a11 - q, d2 = a22 - q;
  const float p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0f * p1;
  const float p = f_sqrt(clamp_min(p2 / 6.0f, 1e-30f));
  const float b00 = (a00 - q) / p, b11 = (a11 - q) / p, b22 = (a22 - q) / p;
  const float b01 = a01 / p, b02 = a02 / p, b12 = a12 / p;
  const float detB = b00 * (b11 * b22 - b12 * b12)
                     - b01 * (b01 * b22 - b12 * b02)
                     + b02 * (b01 * b12 - b11 * b02);
  const float r = clamp(detB * 0.5f, -1.0f, 1.0f);
  const float phi = f_acos(r) / 3.0f;
  const float two_pi_3 = static_cast<float>(2.0 * 3.141592653589793 / 3.0);
  float e_hi = q + 2.0f * p * f_cos(phi);
  float e_lo = q + 2.0f * p * f_cos(phi + two_pi_3);
  float e_mid = 3.0f * q - e_hi - e_lo;
  if (p2 < 1e-20f) { e_hi = q; e_mid = q; e_lo = q; }
  ev[0] = e_lo; ev[1] = e_mid; ev[2] = e_hi;
  float v_lo[3], v_hi[3], v_mid[3];
  eigvec3(a00, a01, a02, a11, a12, a22, e_lo, v_lo);
  eigvec3(a00, a01, a02, a11, a12, a22, e_hi, v_hi);
  cross3(v_hi, v_lo, v_mid);
  const float c = clamp_min(norm3(v_mid), 1e-12f);
  for (int i = 0; i < 3; ++i) v_mid[i] = v_mid[i] / c;
  for (int i = 0; i < 3; ++i) {
    V[i * 3] = v_lo[i]; V[i * 3 + 1] = v_mid[i]; V[i * 3 + 2] = v_hi[i];
  }
}

}  // namespace
