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
// What bounds it on the H100: one call reads the distinct pixels its tracks
// touch (~0.4 MB, 0.1 us at 3.35 TB/s) and does ~5 MFLOP (under 0.1 us on
// the CUDA cores), so neither bytes nor operations bound it, and the bound
// is below the time of any launch: it is bound by latency, 4-8 dependent
// Gauss-Newton steps per track, each a window load, a patch, a 225-sum per
// normal-equation term and an ordered total over the 15 patch rows.  The
// design shortens every link of that chain:
//
//  * Stage, then compute.  All 32 lanes copy the template's 18x18 support
//    of the previous image (16x16 bilinear support plus the Scharr ring)
//    into shared memory, neighbouring lanes on neighbouring columns; each
//    of the 16x16 Scharr gx and gy values is then computed once, spread
//    over the lanes, and the three 15x15 patches are lerped from shared
//    memory.  Every step copies the 16x16 support of the current patch the
//    same way (8 loads per lane, two 64-byte row segments per warp load)
//    before a lane lerps its row, instead of 32 loads per lane at a row
//    stride between lanes.
//  * Both half-warps work.  Lane l owns patch row l mod 16 (row 15 repeats
//    row 14 and is never read); lanes 0-15 hold the gx row and sum gx*e,
//    lanes 16-31 hold the gy row and sum gy*e, so the two ordered totals
//    of a step (rows 0..14, one broadcast shuffle and one sum each) run as
//    one chain of 15 with a last exchange between the halves; likewise gxx
//    and gyy of the template.
//  * One warp per block: K = 256 tracks are 256 blocks, two per SM, and a
//    track that fails its template test exits before any step.
//  * A batch of sequences (torch.func.vmap over the odometry step, the
//    counterpart of jax.vmap extending the Pallas grid) is one launch: the
//    grid is (K / warps per block, batch), blockIdx.y the sequence, and
//    the images and positions take a batch stride (0: shared by all
//    sequences).  A block reads only its own sequence, so each sequence's
//    result is the unbatched call's to the bit; an unbatched call is a
//    batch of 1.
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
constexpr int kWarpsPerBlock = 1;
constexpr int kWinS = 18;        // row stride of the staged 18x18 window
constexpr int kPatS = 17;        // row stride of the staged 16x16 arrays
                                 // (odd: lanes on successive rows hit
                                 // distinct banks)
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

// Scharr gradients at position (r, c) of the staged window (r, c >= 1), in
// the operation order of vision/pyramid.scharr_gradients:
// (3 d0 + 10 d1) + 3 d2, then / 32.
__device__ __forceinline__ float scharr_x(const float* win, int r, int c) {
  const float* u = win + (r - 1) * kWinS + c;
  const float* m = u + kWinS;
  const float* d = m + kWinS;
  float s = __fadd_rn(__fmul_rn(3.f, __fsub_rn(u[1], u[-1])),
                      __fmul_rn(10.f, __fsub_rn(m[1], m[-1])));
  s = __fadd_rn(s, __fmul_rn(3.f, __fsub_rn(d[1], d[-1])));
  return __fmul_rn(s, 0.03125f);
}

__device__ __forceinline__ float scharr_y(const float* win, int r, int c) {
  const float* u = win + (r - 1) * kWinS + c;
  const float* d = u + 2 * kWinS;
  float s = __fadd_rn(__fmul_rn(3.f, __fsub_rn(d[-1], u[-1])),
                      __fmul_rn(10.f, __fsub_rn(d[0], u[0])));
  s = __fadd_rn(s, __fmul_rn(3.f, __fsub_rn(d[1], u[1])));
  return __fmul_rn(s, 0.03125f);
}

// Row of a 15x15 bilinear patch from two staged support rows a (upper) and
// b (lower) of 16 values each: rows lerped first, then columns.
__device__ __forceinline__ void patch_row(const float* a, const float* b,
                                          float fx, float fy,
                                          float out[kS]) {
  const float omfx = __fsub_rn(1.f, fx);
  const float omfy = __fsub_rn(1.f, fy);
  float prev = lerp(a[0], b[0], fy, omfy);
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const float next = lerp(a[j + 1], b[j + 1], fy, omfy);
    out[j] = lerp(prev, next, fx, omfx);
    prev = next;
  }
}

// `part` holds a patch-row sum in lanes 0-14 and another one in lanes
// 16-30.  Sums rows 0..14 in order within each half; returns the lower
// half's total in `lo` and the upper half's in `hi`, on every lane.
__device__ __forceinline__ void halves_total(float part, int lane, float& lo,
                                             float& hi) {
  const int base = lane & 16;
  float tot = __shfl_sync(kFull, part, base);
#pragma unroll
  for (int i = 1; i < kS; ++i) {
    tot = __fadd_rn(tot, __shfl_sync(kFull, part, base + i));
  }
  const float other = __shfl_xor_sync(kFull, tot, 16);
  lo = base ? other : tot;
  hi = base ? tot : other;
}

// Sum over the 15 patch rows held by lanes 0-14, row 0 first; every lane
// gets it.
__device__ __forceinline__ float rows_total(float row) {
  float tot = __shfl_sync(kFull, row, 0);
#pragma unroll
  for (int i = 1; i < kS; ++i) tot = __fadd_rn(tot, __shfl_sync(kFull, row, i));
  return tot;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    klt_l0_kernel(const float* __restrict__ prev, long long prev_bs,
                  const float* __restrict__ cur, long long cur_bs, int H,
                  int W, const float* __restrict__ uv_prev, long long uvp_bs,
                  const float* __restrict__ uv_cur, long long uvc_bs, int K,
                  int iters, float* __restrict__ uv_out,
                  bool* __restrict__ ok_out) {
  __shared__ float s_win[kWarpsPerBlock][kWinS * kWinS];
  __shared__ float s_gx[kWarpsPerBlock][16 * kPatS];
  __shared__ float s_gy[kWarpsPerBlock][16 * kPatS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarpsPerBlock + warp;
  if (k >= K) return;  // whole warps exit; no block-wide barrier follows
  // Sequence blockIdx.y: its inputs at the batch strides, its outputs packed.
  const long long b = blockIdx.y;
  prev += b * prev_bs;
  cur += b * cur_bs;
  uv_prev += b * uvp_bs;
  uv_cur += b * uvc_bs;
  uv_out += b * 2 * K;
  ok_out += b * K;
  const int i = min(lane & 15, kS - 1);  // this lane's patch row
  const bool upper = (lane & 16) != 0;   // lanes 16-31: the gy half
  float* win = s_win[warp];
  float* sgx = s_gx[warp];
  float* sgy = s_gy[warp];

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

    // Stage the 18x18 support (t_in keeps it inside the image), then each
    // Scharr value of the 16x16 bilinear support once.
    {
      const float* src = prev + (r0 - 1) * W + (c0 - 1);
      for (int e = lane; e < kWinS * kWinS; e += 32) {
        const int r = e / kWinS;
        win[e] = __ldg(src + r * W + (e - r * kWinS));
      }
    }
    __syncwarp();
#pragma unroll
    for (int m = 0; m < 8; ++m) {  // lanes 0-15 row 2m, lanes 16-31 row 2m+1
      const int r = 2 * m + (lane >> 4);
      const int c = lane & 15;
      sgx[r * kPatS + c] = scharr_x(win, r + 1, c + 1);
      sgy[r * kPatS + c] = scharr_y(win, r + 1, c + 1);
    }
    __syncwarp();

    float tmpl[kS], g[kS];  // g: the gx row (lanes 0-15) or the gy row
    float sxy, sown;
    {
      float gx[kS], gy[kS];
      patch_row(win + (i + 1) * kWinS + 1, win + (i + 2) * kWinS + 1, fx, fy,
                tmpl);
      patch_row(sgx + i * kPatS, sgx + (i + 1) * kPatS, fx, fy, gx);
      patch_row(sgy + i * kPatS, sgy + (i + 1) * kPatS, fx, fy, gy);
      sxy = __fmul_rn(gx[0], gy[0]);
#pragma unroll
      for (int j = 1; j < kS; ++j) {
        sxy = __fadd_rn(sxy, __fmul_rn(gx[j], gy[j]));
      }
#pragma unroll
      for (int j = 0; j < kS; ++j) g[j] = upper ? gy[j] : gx[j];
      sown = __fmul_rn(g[0], g[0]);
#pragma unroll
      for (int j = 1; j < kS; ++j) {
        sown = __fadd_rn(sown, __fmul_rn(g[j], g[j]));
      }
    }
    float gxx, gyy;
    halves_total(sown, lane, gxx, gyy);
    const float gxy = rows_total(sxy);
    const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
    ok = det > kDetMin;
    if (ok) {
      const float inv00 = __fdiv_rn(gyy, det);
      const float inv01 = __fdiv_rn(-gxy, det);
      const float inv11 = __fdiv_rn(gxx, det);
      const float fcrx = static_cast<float>(crx);
      const float fcry = static_cast<float>(cry);
      float* cwin = sgx;  // the gradient staging is free again: g holds it
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

        // Stage the 16x16 support of the current patch.
        {
          const float* src = cur + (cry + static_cast<int>(ciy) - kH) * W +
                             (crx + static_cast<int>(cix) - kH);
          __syncwarp();  // the previous step's reads are done
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            const int r = 2 * m + (lane >> 4);
            const int c = lane & 15;
            cwin[r * kPatS + c] = __ldg(src + r * W + c);
          }
          __syncwarp();
        }
        float patch[kS];
        patch_row(cwin + i * kPatS, cwin + (i + 1) * kPatS,
                  __fsub_rn(clx, cix), __fsub_rn(cly, ciy), patch);
        float b = __fmul_rn(g[0], __fsub_rn(patch[0], tmpl[0]));
#pragma unroll
        for (int j = 1; j < kS; ++j) {
          b = __fadd_rn(b, __fmul_rn(g[j], __fsub_rn(patch[j], tmpl[j])));
        }
        float bx, by;
        halves_total(b, lane, bx, by);
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

// A batch of `batch` sequences: prev, cur (batch, H, W) f32 and uv_prev,
// uv_cur (batch, K, 2) f32, each sequence's (H, W) or (K, 2) contiguous,
// with batch strides in elements (0: shared by all sequences); uv_out
// (batch, K, 2) f32 and ok_out (batch, K) bool contiguous; all on the
// current device; stream is a cudaStream_t.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int klt_l0_launch(const void* prev, long long prev_bs,
                             const void* cur, long long cur_bs, int H, int W,
                             const void* uv_prev, long long uvp_bs,
                             const void* uv_cur, long long uvc_bs, int K,
                             int iters, int batch, void* uv_out, void* ok_out,
                             void* stream) {
  if (batch <= 0 || batch > 65535 || K <= 0 || iters < 0 || W % 128 != 0 ||
      W < kBW || H < kCBR || H % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (K + kWarpsPerBlock - 1) / kWarpsPerBlock;
  klt_l0_kernel<<<dim3(blocks, batch), kWarpsPerBlock * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prev), prev_bs,
      static_cast<const float*>(cur), cur_bs, H, W,
      static_cast<const float*>(uv_prev), uvp_bs,
      static_cast<const float*>(uv_cur), uvc_bs, K, iters,
      static_cast<float*>(uv_out), static_cast<bool*>(ok_out));
  return static_cast<int>(cudaGetLastError());
}
