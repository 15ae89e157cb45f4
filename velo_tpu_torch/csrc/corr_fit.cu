// One ICP outer iteration's correspondence fit, one thread per query: the
// edge set and the planar set of a solve in one launch.
//
// Computes what the fit closures of velo_tpu_torch.solve.icp compute at one
// pose (corr_fit.corr_fit_reference, on the plain functions):
//
//   * the rows of each query: with `rerank` (the dense engine) the query's
//     cached candidates re-ranked as icp._cand_query ranks them (d^2 by
//     fp.dot3, inf where the candidate or the query is masked, a stable
//     ascending order with the lower candidate first among ties and NaN
//     before all), the first k of them, valid where d^2 is finite and
//     <= corr_max_dist^2; without it (the hash engine) the k rows that the
//     voxel-hash query returned, in its order, with its validity;
//   * then one of three fits on those rows:
//       mode 0, icp._edge_lines_2pt: the nearest row and the nearest valid
//         row on another ring -> (a, b, ok);
//       mode 1, residuals.fit_line_eig and the two virtual points
//         mu -/+ 0.1 dir of icp.solve_scan_to_map -> (a, b, ok, quality);
//       mode 2, residuals.fit_plane_eig with icp._planar_planes_fit's gates
//         -> (n, d, ok, quality).
//
// Every float32 operation of the plain path is one float32 operation here,
// in the same order, and every fp.* helper is computed in float64 and
// rounded once (fp32.cuh, compiled with -fmad=false); _weighted_cov's sums
// run sequentially over the rows, as the plain loop adds them.  Nothing is
// summed in another order, so the outputs are the plain path's bits.
//
// It replaces no TPU kernel: the reference's fits are plain XLA, which fuses
// them.  In PyTorch a fit call is ~750 small kernels over its two feature sets
// (per set the re-rank ~40, the covariance ~40, the closed-form eigen-solve
// most of the rest), each a microsecond or two of launch and drain on this
// card for pointwise work on 1024 or 2048 queries.  The work is bound by
// neither bytes (~0.4 MB a call) nor operations (well under a microsecond of
// the card's float64 rate): it is bound by latency, the chain of dependent
// float64 steps of one query.  So the design keeps one query's chain in one
// thread's registers (the re-rank as an insertion into a k-slot list, the
// rows, the covariance, the eigen-solve), reads each input once, writes each
// output once, uses small blocks of 128 threads so that the 24 blocks of a
// frame's call spread over the SMs, and puts both feature sets in one grid:
// grid.x covers the edge queries, then the planar queries; grid.y is the
// batch of independent problems (the sequences of pipeline/batch).  What it
// buys is the launch count, a call's ~750 graph nodes become one; no roofline
// share is claimed for it.
//
// Compiled without CUDA the file gives the same fit as a serial host
// function, corr_fit_host, for tests of the arithmetic without a card.

#include "fp32.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRows = 16;  // k, the rows a fit reads
constexpr int kMaxCand = 32;  // C, the candidates a query re-ranks

// A strided tensor of the batch: element [b, i, j, l] at
// p + b*sb + i*s0 + j*s1 + l*s2 (in elements).
struct View {
  const void* p;
  long long sb, s0, s1, s2;
};

}  // namespace

extern "C" {

// One feature set of the fit.
struct FitSet {
  View pts;     // (Q, C, 3) float32: candidates (rerank) or rows
  View ring;    // (Q, C) int32: the rows' ring ids, mode 0 only
  View ok;      // (Q, C) uint8: candidate or row validity
  View p;       // (Q, 3) float32: the queries, moved to the target frame
  View mask;    // (Q,) uint8
  float* out_u;      // (B, Q, 3): a (modes 0, 1) or n (mode 2)
  float* out_v;      // (B, Q, 3): b (modes 0, 1); unused in mode 2
  float* out_d;      // (B, Q): d (mode 2); unused otherwise
  uint8_t* out_ok;   // (B, Q)
  float* out_q;      // (B, Q): quality (modes 1, 2); 0 in mode 0
  int n, c, k, mode;  // queries, candidates or rows, rows fitted, mode
};

struct CorrFitArgs {
  FitSet set[2];  // edges, planars
  int batch, rerank;
  float r2;  // corr_max_dist**2, rounded to float32 as PyTorch rounds it
};

}  // extern "C"

namespace {

HD float ldf(const View& v, int b, int i, int j = 0, int l = 0) {
  return static_cast<const float*>(v.p)[b * v.sb + i * v.s0 + j * v.s1 + l * v.s2];
}

HD bool ldb(const View& v, int b, int i, int j = 0) {
  return static_cast<const uint8_t*>(v.p)[b * v.sb + i * v.s0 + j * v.s1] != 0;
}

HD int ldi(const View& v, int b, int i, int j) {
  return static_cast<const int32_t*>(v.p)[b * v.sb + i * v.s0 + j * v.s1];
}

// Whether d^2 `x` of a later candidate goes before `y` of an earlier one in
// torch.sort(-d2, descending=True, stable=True): NaN first, then ascending,
// and never on a tie.
HD bool ranks_before(float x, float y) {
  if (is_nan(x)) return !is_nan(y);
  return !is_nan(y) && x < y;
}

// The k rows of query i: their indices along C and their validity.
HD void select_rows(const CorrFitArgs& a, const FitSet& f, int b, int i,
                    bool m, int* idx, bool* val) {
  if (!a.rerank) {
UNROLL
    for (int j = 0; j < kMaxRows; ++j) {
      if (j < f.k) {
        idx[j] = j;
        val[j] = ldb(f.ok, b, i, j);
      }
    }
    return;
  }
  const float p[3] = {ldf(f.p, b, i, 0), ldf(f.p, b, i, 1), ldf(f.p, b, i, 2)};
  float key[kMaxRows];
  int slot[kMaxRows];
  for (int c = 0; c < f.c; ++c) {
    const float diff[3] = {p[0] - ldf(f.pts, b, i, c, 0),
                           p[1] - ldf(f.pts, b, i, c, 1),
                           p[2] - ldf(f.pts, b, i, c, 2)};
    float d2 = dot3(diff, diff);
    if (!(ldb(f.ok, b, i, c) && m)) d2 = INFINITY;
    // Insert (d2, c) into the sorted slots [0, min(c, k)): find its place,
    // then shift the slots after it down by one (the last one drops out).
    float ck = d2;
    int cs = c;
    bool placed = false;
UNROLL
    for (int j = 0; j < kMaxRows; ++j) {
      if (j < f.k && j <= c) {
        if (placed || j == c || ranks_before(d2, key[j])) {
          placed = true;
          const float tk = key[j];
          const int ts = slot[j];
          key[j] = ck;
          slot[j] = cs;
          ck = tk;
          cs = ts;
        }
      }
    }
  }
UNROLL
  for (int j = 0; j < kMaxRows; ++j) {
    if (j < f.k) {
      idx[j] = slot[j];
      // dist2 = clamp(-neg, min=0) is d2 itself for d2 >= 0, inf or NaN.
      val[j] = is_finite(key[j]) && key[j] <= a.r2;
    }
  }
}

// residuals._weighted_cov over the k rows -> mu (3), cov (row-major 3x3).
HD void weighted_cov(const float (*r)[3], const bool* val, int k, float* mu,
                     float* cov) {
  float w[kMaxRows];
UNROLL
  for (int j = 0; j < kMaxRows; ++j) w[j] = (j < k && val[j]) ? 1.0f : 0.0f;
  float cnt = w[0];
  float s[3] = {r[0][0] * w[0], r[0][1] * w[0], r[0][2] * w[0]};
UNROLL
  for (int j = 1; j < kMaxRows; ++j) {
    if (j < k) {
      cnt = cnt + w[j];
      for (int d = 0; d < 3; ++d) s[d] = s[d] + r[j][d] * w[j];
    }
  }
  cnt = clamp_min(cnt, 1.0f);
  for (int d = 0; d < 3; ++d) mu[d] = s[d] / cnt;
  float c[9];
UNROLL
  for (int j = 0; j < kMaxRows; ++j) {
    if (j < k) {
      const float dj[3] = {(r[j][0] - mu[0]) * w[j], (r[j][1] - mu[1]) * w[j],
                           (r[j][2] - mu[2]) * w[j]};
      for (int u = 0; u < 3; ++u) {
        for (int v = 0; v < 3; ++v) {
          c[u * 3 + v] = j == 0 ? dj[u] * dj[v] : f_fma(dj[u], dj[v], c[u * 3 + v]);
        }
      }
    }
  }
  for (int e = 0; e < 9; ++e) cov[e] = c[e] / cnt;
}

// 1 - 3 lo / clamp(hi, min=1e-9), clamped to [0, 1]: a fit's quality.
HD float quality(float lo, float hi) {
  return clamp(1.0f - 3.0f * lo / clamp_min(hi, 1e-9f), 0.0f, 1.0f);
}

HD void store3(float* out, int at, const float* x) {
  for (int d = 0; d < 3; ++d) out[at * 3 + d] = x[d];
}

HD void fit_query(const CorrFitArgs& a, const FitSet& f, int b, int i) {
  const bool m = ldb(f.mask, b, i);
  int idx[kMaxRows];
  bool val[kMaxRows];
  select_rows(a, f, b, i, m, idx, val);
  float r[kMaxRows][3];
  int n_val = 0;
UNROLL
  for (int j = 0; j < kMaxRows; ++j) {
    if (j < f.k) {
      for (int d = 0; d < 3; ++d) r[j][d] = ldf(f.pts, b, i, idx[j], d);
      n_val += val[j] ? 1 : 0;
    }
  }
  const int at = b * f.n + i;
  if (f.mode == 0) {  // icp._edge_lines_2pt
    const int ring0 = ldi(f.ring, b, i, idx[0]);
    int jb = 0;
    bool any = false;
UNROLL
    for (int j = 0; j < kMaxRows; ++j) {
      if (j < f.k && !any && val[j] && ldi(f.ring, b, i, idx[j]) != ring0) {
        jb = j;
        any = true;
      }
    }
    float rb[3] = {r[0][0], r[0][1], r[0][2]};
UNROLL
    for (int j = 1; j < kMaxRows; ++j) {
      if (j < f.k && j == jb) {
        for (int d = 0; d < 3; ++d) rb[d] = r[j][d];
      }
    }
    store3(f.out_u, at, r[0]);
    store3(f.out_v, at, rb);
    f.out_ok[at] = m && val[0] && any;
    f.out_q[at] = 0.0f;
    return;
  }
  float mu[3], cov[9], ev[3], V[9];
  weighted_cov(r, val, f.k, mu, cov);
  sym_eig3(cov, ev, V);
  if (f.mode == 1) {  // fit_line_eig, then mu -/+ 0.1 dir
    const float dir[3] = {V[2], V[5], V[8]};
    float pa[3], pb[3];
    for (int d = 0; d < 3; ++d) {
      const float step = 0.1f * dir[d];
      pa[d] = mu[d] - step;
      pb[d] = mu[d] + step;
    }
    store3(f.out_u, at, pa);
    store3(f.out_v, at, pb);
    f.out_ok[at] = (ev[2] > 3.0f * ev[1]) && n_val >= 3 && m;
    f.out_q[at] = quality(ev[1], ev[2]);
    return;
  }
  // fit_plane_eig, then _planar_planes_fit's gates.
  const float n[3] = {V[0], V[3], V[6]};
  const float d0 = -dot3(n, mu);
  bool flat = true;
UNROLL
  for (int j = 0; j < kMaxRows; ++j) {
    if (j < f.k && val[j]) {
      const float dist = fabsf(dot3(r[j], n) + d0);
      flat = flat && dist < 0.2f;
    }
  }
  store3(f.out_u, at, n);
  f.out_d[at] = d0;
  f.out_ok[at] = (ev[1] > 3.0f * ev[0]) && n_val >= 3 && flat && m;
  f.out_q[at] = quality(ev[0], ev[1]);
}

HD int set_blocks(const FitSet& f) { return (f.n + kThreads - 1) / kThreads; }

#ifdef __CUDACC__

__global__ void __launch_bounds__(kThreads) corr_fit_kernel(const CorrFitArgs a) {
  const int edge_blocks = set_blocks(a.set[0]);
  const int s = static_cast<int>(blockIdx.x) < edge_blocks ? 0 : 1;
  const int i = (blockIdx.x - (s ? edge_blocks : 0)) * kThreads + threadIdx.x;
  if (i < a.set[s].n) fit_query(a, a.set[s], blockIdx.y, i);
}

#endif

}  // namespace

#ifdef __CUDACC__

// Launch the fit of a.batch independent problems on `stream`, a
// cudaStream_t of the current device.  Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for arguments outside the
// kernel's limits.
extern "C" int corr_fit_launch(const CorrFitArgs* a, void* stream) {
  if (a->batch < 1 || a->batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  for (const FitSet& f : a->set) {
    if (f.k < 1 || f.k > kMaxRows || f.c < f.k || f.c > kMaxCand)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = set_blocks(a->set[0]) + set_blocks(a->set[1]);
  if (blocks == 0) return 0;
  const dim3 grid(blocks, a->batch);
  corr_fit_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

#else

// The same fit, serially on the host, for every problem of the batch.
extern "C" int corr_fit_host(const CorrFitArgs* a) {
  for (const FitSet& f : a->set) {
    if (f.k < 1 || f.k > kMaxRows || f.c < f.k || f.c > kMaxCand) return 1;
  }
  for (int b = 0; b < a->batch; ++b) {
    for (const FitSet& f : a->set) {
      for (int i = 0; i < f.n; ++i) fit_query(*a, f, b, i);
    }
  }
  return 0;
}

#endif
