// Level-0 inverse-compositional Lucas-Kanade for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel velo_tpu/pallas/klt_l0.py:_kernel (called
// through track_level0 there, klt_l0.py:185).  Contract, shared with the
// plain PyTorch version in velo_tpu_torch/kernels/klt_l0.py:
//
//   per track: NaN positions read -1e6; the TPU kernel's block origins
//   (8-row / 128-column tiles) are recomputed as arithmetic:
//     pry = clip((floor(y_prev) - 9) // 8, 0, (H-32)/8) * 8
//     prx = clip((floor(x_prev) - 9) // 128, 0, W/128 - 3) * 128
//     cry = clip((floor(y_cur) - 19) // 8, 0, (H-48)/8) * 8
//     crx = clip(floor(x_cur) // 128 - 1, 0, W/128 - 3) * 128
//   (// is floor division; a NaN coordinate gives origin 0);
//   t_in: the template support (the 16x16 bilinear support plus the
//   Scharr ring) lies >= 1 px inside the image, so the TPU kernel's
//   in-block gradients equal the image's Scharr gradients there;
//   15x15 template and gx/gy patches at uv_prev, rows lerped first;
//   gxx, gxy, gyy; ok = t_in & det > 1e-9; the inverse 2x2 matrix;
//   iters Gauss-Newton steps at uv_cur, each applied only while the patch
//   lies inside the image and inside the 48x384 current block fixed by
//   the initial uv_cur; out: (x, y) and ok & (1 <= x <= W-2) &
//   (1 <= y <= H-2).
//
// Numerics: every product, sum and quotient is an explicit
// __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn, so nvcc contracts nothing into
// FMAs; each 225-sum runs left to right along each patch row, then over
// rows 0..14 in order, as the plain version's loops do.  The two agree to
// the bit on the card.
//
// What bounds it on the H100: one call reads two 192x640 float32 images
// (~1 MB, 0.3 us at 3.35 TB/s) and does ~10 MFLOP (well under 1 us on the
// CUDA cores), so neither bytes nor operations bound it: it is bound by
// latency, 4-8 dependent Gauss-Newton steps per track, each a gather, two
// 225-sums and a shuffle chain.  The design keeps it simple: one warp per
// track, lane i owning patch row i (lanes 15-31 repeat row 14 and are never
// read), template and gradient rows in registers, both images read through
// the read-only cache (they stay L2-resident), no shared memory, and the
// sums gathered by 15 broadcast shuffles so every lane holds the total.
// A track that fails its template test exits before any step.
//
// Build: see velo_tpu_torch/kernels/_build.py.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kH = 7;            // patch half-window
constexpr int kS = 2 * kH + 1;   // 15
constexpr int kPBR = 32;         // previous-image block rows
constexpr int kCBR = 48;         // current-image block rows
constexpr int kBW = 384;         // block width
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNanPos = -1e6f;
constexpr float kDetMin = 1e-9f;
constexpr float kSat = 1073741824.0f;  // 2^30

__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return kNanPos;
  if (isinf(v)) return v > 0.f ? FLT_MAX : -FLT_MAX;
  return v;
}

// nan_to_num(floor(v), nan=0) as an int, saturated at +-2^30.
__device__ __forceinline__ int floor_int(float v) {
  float f = floorf(v);
  if (isnan(f)) return 0;
  return static_cast<int>(fminf(fmaxf(f, -kSat), kSat));
}

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ float lerp(float a, float b, float t, float omt) {
  return __fadd_rn(__fmul_rn(a, omt), __fmul_rn(b, t));
}

// Scharr gradients at interior pixel (r, c), in the operation order of
// vision/pyramid.scharr_gradients: (3 d0 + 10 d1) + 3 d2, then / 32.
__device__ __forceinline__ float scharr_x(const float* __restrict__ img,
                                          int W, int r, int c) {
  const float* u = img + (r - 1) * W + c;
  const float* m = img + r * W + c;
  const float* d = img + (r + 1) * W + c;
  float s = __fadd_rn(__fmul_rn(3.f, __fsub_rn(__ldg(u + 1), __ldg(u - 1))),
                      __fmul_rn(10.f, __fsub_rn(__ldg(m + 1), __ldg(m - 1))));
  s = __fadd_rn(s, __fmul_rn(3.f, __fsub_rn(__ldg(d + 1), __ldg(d - 1))));
  return __fmul_rn(s, 0.03125f);
}

__device__ __forceinline__ float scharr_y(const float* __restrict__ img,
                                          int W, int r, int c) {
  const float* u = img + (r - 1) * W + c;
  const float* d = img + (r + 1) * W + c;
  float s = __fadd_rn(__fmul_rn(3.f, __fsub_rn(__ldg(d - 1), __ldg(u - 1))),
                      __fmul_rn(10.f, __fsub_rn(__ldg(d), __ldg(u))));
  s = __fadd_rn(s, __fmul_rn(3.f, __fsub_rn(__ldg(d + 1), __ldg(u + 1))));
  return __fmul_rn(s, 0.03125f);
}

// Row `i` of a 15x15 bilinear patch whose support starts at (r0, c0).
__device__ __forceinline__ void patch_row(const float* __restrict__ img,
                                          int W, int r0, int c0, int i,
                                          float fx, float fy,
                                          float out[kS]) {
  const float omfx = __fsub_rn(1.f, fx);
  const float omfy = __fsub_rn(1.f, fy);
  const float* a = img + (r0 + i) * W + c0;
  const float* b = a + W;
  float prev = lerp(__ldg(a), __ldg(b), fy, omfy);
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const float next = lerp(__ldg(a + j + 1), __ldg(b + j + 1), fy, omfy);
    out[j] = lerp(prev, next, fx, omfx);
    prev = next;
  }
}

// The same row of the Scharr gx and gy patches.
__device__ __forceinline__ void grad_rows(const float* __restrict__ img,
                                          int W, int r0, int c0, int i,
                                          float fx, float fy, float gx[kS],
                                          float gy[kS]) {
  const float omfx = __fsub_rn(1.f, fx);
  const float omfy = __fsub_rn(1.f, fy);
  const int r = r0 + i;
  float px = lerp(scharr_x(img, W, r, c0), scharr_x(img, W, r + 1, c0), fy,
                  omfy);
  float py = lerp(scharr_y(img, W, r, c0), scharr_y(img, W, r + 1, c0), fy,
                  omfy);
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const int c = c0 + j + 1;
    const float nx = lerp(scharr_x(img, W, r, c), scharr_x(img, W, r + 1, c),
                          fy, omfy);
    const float ny = lerp(scharr_y(img, W, r, c), scharr_y(img, W, r + 1, c),
                          fy, omfy);
    gx[j] = lerp(px, nx, fx, omfx);
    gy[j] = lerp(py, ny, fx, omfx);
    px = nx;
    py = ny;
  }
}

// Sum over the warp's 15 patch rows, row 0 first; every lane gets it.
__device__ __forceinline__ float rows_total(float row) {
  float tot = __shfl_sync(kFull, row, 0);
#pragma unroll
  for (int i = 1; i < kS; ++i) tot = __fadd_rn(tot, __shfl_sync(kFull, row, i));
  return tot;
}

__global__ void klt_l0_kernel(const float* __restrict__ prev,
                              const float* __restrict__ cur, int H, int W,
                              const float* __restrict__ uv_prev,
                              const float* __restrict__ uv_cur, int K,
                              int iters, float* __restrict__ uv_out,
                              bool* __restrict__ ok_out) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (k >= K) return;  // whole warps exit; no block-wide barrier follows
  const int i = min(lane, kS - 1);  // this lane's patch row

  const float xp = nan_to_num(uv_prev[2 * k]);
  const float yp = nan_to_num(uv_prev[2 * k + 1]);
  float x = nan_to_num(uv_cur[2 * k]);
  float y = nan_to_num(uv_cur[2 * k + 1]);
  const float fH = static_cast<float>(H);
  const float fW = static_cast<float>(W);

  const float ixp = floorf(xp);
  const float iyp = floorf(yp);
  const bool t_in = __fsub_rn(ixp, kH) >= 1.f &&
                    __fadd_rn(__fadd_rn(ixp, kH), 2.f) <= fW - 1.f &&
                    __fsub_rn(iyp, kH) >= 1.f &&
                    __fadd_rn(__fadd_rn(iyp, kH), 2.f) <= fH - 1.f;
  bool ok = false;
  if (t_in) {
    const int top = W / 128 - kBW / 128;
    const int pry =
        clampi(floordiv(floor_int(uv_prev[2 * k + 1]) - kH - 2, 8), 0,
               (H - kPBR) / 8) * 8;
    const int prx =
        clampi(floordiv(floor_int(uv_prev[2 * k]) - kH - 2, 128), 0, top) *
        128;
    const int cry =
        clampi(floordiv(floor_int(uv_cur[2 * k + 1]) - kH - 12, 8), 0,
               (H - kCBR) / 8) * 8;
    const int crx =
        clampi(floordiv(floor_int(uv_cur[2 * k]), 128) - 1, 0, top) * 128;

    const float lx = __fsub_rn(xp, static_cast<float>(prx));
    const float ly = __fsub_rn(yp, static_cast<float>(pry));
    const float fix = floorf(lx);
    const float fiy = floorf(ly);
    const float fx = __fsub_rn(lx, fix);
    const float fy = __fsub_rn(ly, fiy);
    const int r0 = pry + static_cast<int>(fiy) - kH;
    const int c0 = prx + static_cast<int>(fix) - kH;

    float tmpl[kS], gx[kS], gy[kS];
    patch_row(prev, W, r0, c0, i, fx, fy, tmpl);
    grad_rows(prev, W, r0, c0, i, fx, fy, gx, gy);
    float sxx = __fmul_rn(gx[0], gx[0]);
    float sxy = __fmul_rn(gx[0], gy[0]);
    float syy = __fmul_rn(gy[0], gy[0]);
#pragma unroll
    for (int j = 1; j < kS; ++j) {
      sxx = __fadd_rn(sxx, __fmul_rn(gx[j], gx[j]));
      sxy = __fadd_rn(sxy, __fmul_rn(gx[j], gy[j]));
      syy = __fadd_rn(syy, __fmul_rn(gy[j], gy[j]));
    }
    const float gxx = rows_total(sxx);
    const float gxy = rows_total(sxy);
    const float gyy = rows_total(syy);
    const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
    ok = det > kDetMin;
    if (ok) {
      const float inv00 = __fdiv_rn(gyy, det);
      const float inv01 = __fdiv_rn(-gxy, det);
      const float inv11 = __fdiv_rn(gxx, det);
      const float fcrx = static_cast<float>(crx);
      const float fcry = static_cast<float>(cry);
      for (int it = 0; it < iters; ++it) {
        const float clx = __fsub_rn(x, fcrx);
        const float cly = __fsub_rn(y, fcry);
        const float cix = floorf(clx);
        const float ciy = floorf(cly);
        const bool c_inw = __fsub_rn(ciy, kH) >= 0.f &&
                           __fadd_rn(__fadd_rn(ciy, kH), 1.f) < kCBR &&
                           __fsub_rn(cix, kH) >= 0.f &&
                           __fadd_rn(__fadd_rn(cix, kH), 1.f) < kBW;
        const float x0 = __fsub_rn(floorf(x), kH);
        const float y0 = __fsub_rn(floorf(y), kH);
        const bool c_img = x0 >= 0.f && y0 >= 0.f &&
                           __fadd_rn(x0, kS) < fW && __fadd_rn(y0, kS) < fH;
        if (!(c_inw && c_img)) continue;  // warp-uniform: a frozen step

        float patch[kS];
        patch_row(cur, W, cry + static_cast<int>(ciy) - kH,
                  crx + static_cast<int>(cix) - kH, i,
                  __fsub_rn(clx, cix), __fsub_rn(cly, ciy), patch);
        float e = __fsub_rn(patch[0], tmpl[0]);
        float bx = __fmul_rn(gx[0], e);
        float by = __fmul_rn(gy[0], e);
#pragma unroll
        for (int j = 1; j < kS; ++j) {
          e = __fsub_rn(patch[j], tmpl[j]);
          bx = __fadd_rn(bx, __fmul_rn(gx[j], e));
          by = __fadd_rn(by, __fmul_rn(gy[j], e));
        }
        bx = rows_total(bx);
        by = rows_total(by);
        x = __fsub_rn(x, __fadd_rn(__fmul_rn(inv00, bx), __fmul_rn(inv01, by)));
        y = __fsub_rn(y, __fadd_rn(__fmul_rn(inv01, bx), __fmul_rn(inv11, by)));
      }
    }
  }
  if (lane == 0) {
    uv_out[2 * k] = x;
    uv_out[2 * k + 1] = y;
    ok_out[k] = ok && x >= 1.f && x <= fW - 2.f && y >= 1.f && y <= fH - 2.f;
  }
}

}  // namespace

// prev, cur (H, W) f32; uv_prev, uv_cur, uv_out (K, 2) f32; ok_out (K,)
// bool; all contiguous on the current device; stream is a cudaStream_t.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int klt_l0_launch(const void* prev, const void* cur, int H, int W,
                             const void* uv_prev, const void* uv_cur, int K,
                             int iters, void* uv_out, void* ok_out,
                             void* stream) {
  if (K <= 0 || iters < 0 || W % 128 != 0 || W < kBW || H < kCBR ||
      H % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (K + kWarpsPerBlock - 1) / kWarpsPerBlock;
  klt_l0_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prev), static_cast<const float*>(cur), H, W,
      static_cast<const float*>(uv_prev), static_cast<const float*>(uv_cur),
      K, iters, static_cast<float*>(uv_out), static_cast<bool*>(ok_out));
  return static_cast<int>(cudaGetLastError());
}
