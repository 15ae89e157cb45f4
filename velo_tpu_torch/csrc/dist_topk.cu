// Fused distance + binned top-k for Hopper (sm_90a): one launch per call,
// for one sequence or a batch of them.
//
// Replaces the Pallas TPU kernel velo_tpu/pallas/dist_topk.py:_kernel
// (called through dist_topk there).  Contract, shared with the plain
// PyTorch version dist_topk_reference in velo_tpu_torch/kernels/dist_topk.py:
//
//   |t|^2, |q|^2 = a0*a0 rounded to float32, then twice
//                  (float)((double)a_i*(double)a_i + (double)acc)
//   m[j] = (-2 t0, -2 t1, -2 t2, |t|^2 + (mask[j] ? 0 : 1e30))
//   s[q, j] = ((q0*m0[j] + q1*m1[j]) + q2*m2[j]) + m3[j]
//
// Each tile of TN targets folds B = TN/NBt ways into NBt strided bins
// (element j of the tile -> bin j mod NBt); a bin keeps its minimum and the
// first element that attains it.  Then k rounds take the (value, bin index)
// lexicographic minimum over all NB = N/B bins and overwrite the winner
// with 1e30.  Outputs: d2 = max(s + |q|^2, 0) of the winners and their
// target indices.  With fewer than k live bins every remaining value is
// exactly 1e30 and the rounds return the lowest such bin again and again;
// the bins, the rounds and the tie rules here are the plain version's, so
// those duplicates come out the same.
//
// Numerics: every float32 product and sum is __fmul_rn/__fadd_rn, so nvcc
// contracts nothing into an FMA; the float64 steps of |t|^2 and |q|^2 are
// one __fma_rn each, which equals the separate product and sum because the
// double product of two float32 values is exact.  d2 and idx are bitwise
// the plain version's on the card.
//
// What bounds it on the H100: Q*N scores of 7 float32 instructions each
// (3 products, 3 sums, one minimum) on the CUDA cores; the tensor cores do
// not apply (their float32 inputs are TF32, which mis-ranks centimetre
// near-ties).  The inputs are small (N <= 32768 targets: 0.4 MB) and stay in
// the 50 MB L2.  Measured with clock64 per phase, a call is the fold, bound
// by instruction throughput once its loads are batched, plus three chains of
// dependent latencies that no other work hides because every block reaches
// them together: the k rounds, the index recomputation and the first loads.
// The design:
//
//  * A block owns TQ queries (8, or fewer for a small Q so that the grid
//    still covers the 132 SMs) and all N targets.  A thread owns bin
//    columns: it reads one target and its mask bit straight from L2 into
//    registers, neighbouring threads on neighbouring targets, forms m[j]
//    once, and scores it against the block's TQ queries, which it holds in
//    registers with the TQ running minima of the bin; the next 4 targets
//    are in flight while 4 are scored.  Every element is touched by exactly
//    one thread of the block, so a stage of m in shared memory would serve
//    nobody a second time: the register tile gives the reuse, and L2 reads
//    fall from 16 N bytes per query to 13 N / TQ.
//  * m is formed in the kernel from the raw (N, 3) targets and the bool
//    mask, and |q|^2, the clamp and the index come out of it too: the
//    wrapper makes two torch.empty outputs and this one launch.  Forming m
//    per block costs about a fifth of the fold: a pre-pass into an (N, 4)
//    scratch was measured 17 % faster at 2048 x 32768 and equal at
//    1024 x 3072.  One launch stays, because the odometry step around this
//    kernel is bound by the host's dispatch, where a second launch costs
//    more than those microseconds of card time.
//  * Tried and dropped: a thread block cluster of 8 blocks that splits the
//    bins, stages m in shared memory once for 32-64 queries and gathers
//    each query's bins through distributed shared memory.  Its fold ran at
//    the instruction limit, but the cluster barriers, the gather and the staging
//    are further unhidden latencies, and it was slower at three of the four
//    path shapes.
//  * Shared memory holds only the bins' minima, about TQ * NB * 4 bytes
//    (49 KB at NB = 1536, TQ = 8).  The element index of a bin's minimum is
//    not kept through the fold (that would double the shared memory and add
//    two instructions per score); it is recomputed for the k winning bins
//    only, B scores each, first index on a strict '<' as in the fold.
//  * Extraction: one warp per query.  Lane l owns the column of bins
//    b = l (mod 32), stored contiguously at an odd stride (conflict-free
//    both for 32 lanes on 32 columns and for 32 lanes on one column), and
//    keeps the two lowest (value, bin) of its column in registers.  A round
//    is two redux.sync minima (order-preserving integer key of the value,
//    then the lowest bin among the lanes that hold it); the owner retires
//    the winner and moves up its second bin, and only a lane that wins a
//    third time, or whose second bin already reads 1e30, has its column
//    rescanned, by all 32 lanes and two more redux.sync.  A round is a
//    chain of dependent warp operations, ~380 cycles measured, and the 16
//    of them are a third of a call at the small path shapes.  Lane r keeps
//    round r's winner; after the rounds the lanes, in groups, recompute
//    each winning bin's first-minimum element, 8 loads in flight per lane,
//    and write d2 and idx, so the k rounds do not wait on L2.
//
//  * A batch of sequences (torch.func.vmap over the odometry step, the
//    counterpart of jax.vmap extending the Pallas grid) is one launch: the
//    grid's y axis is the sequence, x the query tile, and every input has
//    a batch stride, 0 for an input that all sequences share.  A block
//    reads only its own sequence, so each sequence's (d2, idx) is the
//    unbatched call's to the bit; an unbatched call is a batch of 1.
//
// Inputs must be finite.  Build: see velo_tpu_torch/kernels/_build.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kFoldBatch = 4;  // targets a thread loads ahead in the fold
constexpr int kBatch = 8;      // loads a lane has in flight elsewhere
constexpr int kMaxSmem = 232448;
constexpr int kDefaultSmem = 48 * 1024;

struct Args {
  const float* t;            // targets, element (j, c) at t[j * ts0 + c * ts1]
  const unsigned char* mask;  // element j at mask[j * ms0]
  const float* q;            // queries, element (i, c) at q[i * qs0 + c * qs1]
  long long ts0, ts1, ms0, qs0, qs1;
  long long tsb, msb, qsb;  // batch strides of t, mask and q (0: shared)
  int nq, n, tn, nbt, k;
  float* out_d2;  // (batch, nq, k)
  int* out_idx;   // (batch, nq, k)
};

// The arguments of sequence b of the batch: its inputs at the batch
// strides, its rows of the packed outputs.
__device__ __forceinline__ Args sequence(const Args& batch, int b) {
  Args a = batch;
  a.t += b * batch.tsb;
  a.mask += b * batch.msb;
  a.q += b * batch.qsb;
  const long long o = static_cast<long long>(b) * batch.nq * batch.k;
  a.out_d2 += o;
  a.out_idx += o;
  return a;
}

// a.a as the plain version sums it: a0*a0 in float32, then two multiply-adds
// in float64, each rounded to float32.
__device__ __forceinline__ float dot3_self(float a0, float a1, float a2) {
  float acc = __fmul_rn(a0, a0);
  acc = __double2float_rn(__fma_rn(static_cast<double>(a1),
                                   static_cast<double>(a1),
                                   static_cast<double>(acc)));
  return __double2float_rn(__fma_rn(static_cast<double>(a2),
                                    static_cast<double>(a2),
                                    static_cast<double>(acc)));
}

struct M {
  float m0, m1, m2, m3;
};

// The raw target j and its mask bit; make_m turns them into m[j].  Split so
// that a thread can start a batch of loads before it waits for the first.
struct Raw {
  float t0, t1, t2;
  unsigned char live;
};

__device__ __forceinline__ Raw load_raw(const Args& a, int j) {
  const float* p = a.t + j * a.ts0;
  Raw r;
  r.t0 = __ldg(p);
  r.t1 = __ldg(p + a.ts1);
  r.t2 = __ldg(p + 2 * a.ts1);
  r.live = __ldg(a.mask + j * a.ms0);
  return r;
}

__device__ __forceinline__ M make_m(const Raw& r) {
  M m;
  m.m0 = __fmul_rn(-2.f, r.t0);
  m.m1 = __fmul_rn(-2.f, r.t1);
  m.m2 = __fmul_rn(-2.f, r.t2);
  m.m3 = __fadd_rn(dot3_self(r.t0, r.t1, r.t2), r.live ? 0.f : kBig);
  return m;
}

__device__ __forceinline__ float score(float q0, float q1, float q2,
                                       const M& m) {
  float s = __fadd_rn(__fmul_rn(q0, m.m0), __fmul_rn(q1, m.m1));
  s = __fadd_rn(s, __fmul_rn(q2, m.m2));
  return __fadd_rn(s, m.m3);  // q3 = 1: the product is exact
}

// Order-preserving map of a float (no NaN) onto unsigned integers, and back.
__device__ __forceinline__ unsigned ordered_key(float v) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.f));  // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// Warp-wide minimum of v and the lowest `tag` among the lanes that hold it.
// Two redux.sync; a shuffle butterfly over a packed 64-bit (key, tag) was
// measured a third slower.
__device__ __forceinline__ void warp_first_min(float v, unsigned tag,
                                               float& min_v,
                                               unsigned& min_tag) {
  const unsigned key = ordered_key(v);
  const unsigned kmin = __reduce_min_sync(kFull, key);
  min_tag = __reduce_min_sync(kFull, key == kmin ? tag : kFull);
  min_v = key_value(kmin);
}

// Bin b of a query lives at slot(b): column b mod 32 at stride `cs`.
__device__ __forceinline__ int slot(int b, int cs) {
  return (b & 31) * cs + (b >> 5);
}

template <int TQ>
__global__ void __launch_bounds__(kThreads) dist_topk_kernel(const Args batch) {
  extern __shared__ float bins[];  // [TQ][32 columns][cs] minima
  const Args a = sequence(batch, blockIdx.y);
  const int fold = a.tn / a.nbt;
  const int nb = (a.n / a.tn) * a.nbt;
  const int cs = ((nb + 31) >> 5) | 1;
  const int q_base = blockIdx.x * TQ;

  // Phase 1: strided B-way fold of every tile into its NBt bins.
  {
    float q0[TQ], q1[TQ], q2[TQ];
#pragma unroll
    for (int c = 0; c < TQ; ++c) {
      const float* p = a.q + min(q_base + c, a.nq - 1) * a.qs0;
      q0[c] = __ldg(p);
      q1[c] = __ldg(p + a.qs1);
      q2[c] = __ldg(p + 2 * a.qs1);
    }
    const float kInf = __int_as_float(0x7f800000);
    for (int u = threadIdx.x; u < nb; u += kThreads) {
      const int tile = u / a.nbt;
      const int j0 = tile * a.tn + (u - tile * a.nbt);
      float mn[TQ];
#pragma unroll
      for (int c = 0; c < TQ; ++c) mn[c] = kInf;
      // Batches of kFoldBatch elements; the next batch is in flight while
      // this one is scored.  An index past the end repeats the last
      // element, which changes no minimum.
      Raw cur[kFoldBatch];
#pragma unroll
      for (int x = 0; x < kFoldBatch; ++x) {
        cur[x] = load_raw(a, j0 + min(x, fold - 1) * a.nbt);
      }
      for (int i0 = 0; i0 < fold; i0 += kFoldBatch) {
        Raw nxt[kFoldBatch];
        if (i0 + kFoldBatch < fold) {
#pragma unroll
          for (int x = 0; x < kFoldBatch; ++x) {
            nxt[x] = load_raw(
                a, j0 + min(i0 + kFoldBatch + x, fold - 1) * a.nbt);
          }
        }
#pragma unroll
        for (int x = 0; x < kFoldBatch; ++x) {
          const M m = make_m(cur[x]);
#pragma unroll
          for (int c = 0; c < TQ; ++c) {
            mn[c] = fminf(mn[c], score(q0[c], q1[c], q2[c], m));
          }
        }
#pragma unroll
        for (int x = 0; x < kFoldBatch; ++x) cur[x] = nxt[x];
      }
#pragma unroll
      for (int c = 0; c < TQ; ++c) bins[c * 32 * cs + slot(u, cs)] = mn[c];
    }
  }
  __syncthreads();

  // Phase 2: warp w extracts query q_base + w.  No block barrier follows.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = q_base + warp;
  if (warp >= TQ || qi >= a.nq) return;
  float* col = bins + warp * 32 * cs;
  const float* qp = a.q + qi * a.qs0;
  const float q0 = __ldg(qp);
  const float q1 = __ldg(qp + a.qs1);
  const float q2 = __ldg(qp + 2 * a.qs1);
  const float qq = dot3_self(q0, q1, q2);

  // This lane's column: its two lowest bins, (lv, lb) before (lv2, lb2) in
  // (value, bin) order; ascending b with '<' keeps the earlier bin first.
  const float kInf = __int_as_float(0x7f800000);
  float lv = kInf, lv2 = kInf;
  unsigned lb = kFull, lb2 = kFull;
#pragma unroll 8
  for (int b = lane; b < nb; b += 32) {
    const float v = col[slot(b, cs)];
    if (v < lv) {
      lv2 = lv;
      lb2 = lb;
      lv = v;
      lb = b;
    } else if (v < lv2) {
      lv2 = v;
      lb2 = b;
    }
  }

  for (int r0 = 0; r0 < a.k; r0 += 32) {
    const int cnt = min(32, a.k - r0);
    float my_v = 0.f;
    int my_b = 0;
    for (int r = 0; r < cnt; ++r) {
      float bv;
      unsigned bb;
      warp_first_min(lv, lb, bv, bb);
      if (lane == r) {
        my_v = bv;
        my_b = static_cast<int>(bb);
      }
      // The owner retires the winner (it reads 1e30 from now on) and moves
      // up its second bin.  That one is the column's minimum only while it
      // is below 1e30: a retired bin with a lower index would come first
      // among equals.  Without such a second bin, all lanes rescan the
      // column.
      const int owner = bb & 31;
      bool rescan = false;
      if (lane == owner) {
        col[slot(bb, cs)] = kBig;
        rescan = !(lv2 < kBig);
        lv = lv2;
        lb = lb2;
        lv2 = kInf;
        lb2 = kFull;
      }
      if (__shfl_sync(kFull, rescan, owner)) {
        __syncwarp();
        float v = kInf;
        unsigned vb = kFull;
        for (int b = owner + 32 * lane; b < nb; b += 1024) {
          const float x = col[slot(b, cs)];
          if (x < v) {
            v = x;
            vb = b;
          }
        }
        float nv;
        unsigned nbin;
        warp_first_min(v, vb, nv, nbin);
        if (lane == owner) {
          lv = nv;
          lb = nbin;
        }
      }
    }

    // Lanes in groups of g per winner recompute the first element of each
    // winning bin that attains the bin's minimum.
    int g = 1;
    while (2 * g * cnt <= 32) g *= 2;
    const int w = lane / g;
    const int sub = lane - w * g;
    const int wb = __shfl_sync(kFull, my_b, w);
    const float wv = __shfl_sync(kFull, my_v, w);
    const int tile = wb / a.nbt;
    const int j0 = tile * a.tn + (wb - tile * a.nbt);
    float best = kInf;
    int ag = 0x7fffffff;
    for (int i0 = sub; i0 < fold; i0 += g * kBatch) {
      Raw raw[kBatch];
#pragma unroll
      for (int x = 0; x < kBatch; ++x) {
        const int i = i0 + x * g;
        if (i < fold) raw[x] = load_raw(a, j0 + i * a.nbt);
      }
#pragma unroll
      for (int x = 0; x < kBatch; ++x) {
        if (i0 + x * g < fold) {
          const float s = score(q0, q1, q2, make_m(raw[x]));
          if (s < best || ag == 0x7fffffff) {
            best = s;
            ag = i0 + x * g;
          }
        }
      }
    }
    for (int off = g >> 1; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, ag, off);
      if (oi != 0x7fffffff && (ag == 0x7fffffff || ov < best ||
                               (ov == best && oi < ag))) {
        best = ov;
        ag = oi;
      }
    }
    if (sub == 0 && w < cnt) {
      const long long o = static_cast<long long>(qi) * a.k + r0 + w;
      a.out_d2[o] = fmaxf(__fadd_rn(wv, qq), 0.f);
      a.out_idx[o] = max(j0 + ag * a.nbt, 0);
    }
  }
}

template <int TQ>
int launch(const Args& a, int batch, int blocks, int smem_bytes,
           cudaStream_t stream) {
  if (smem_bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        dist_topk_kernel<TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dist_topk_kernel<TQ><<<dim3(blocks, batch), kThreads, smem_bytes, stream>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A batch of `batch` sequences: targets (batch, n, 3) f32 with element
// strides (tsb, ts0, ts1), mask (batch, n) bool with strides (msb, ms0),
// queries (batch, nq, 3) f32 with strides (qsb, qs0, qs1), a batch stride of
// 0 for an input that all sequences share; out_d2 (batch, nq, k) f32 and
// out_idx (batch, nq, k) i32 contiguous; all on the current device; stream
// is a cudaStream_t.  The geometry (tn, nbt, tq, threads, blocks per
// sequence, smem_bytes) is computed by the Python wrapper and only checked
// here.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dist_topk_launch(const void* targets, long long tsb,
                                long long ts0, long long ts1,
                                const void* mask, long long msb,
                                long long ms0, const void* queries,
                                long long qsb, long long qs0, long long qs1,
                                int batch, int nq, int n, int tn, int nbt,
                                int k, int tq, int threads, int blocks,
                                int smem_bytes, void* out_d2, void* out_idx,
                                void* stream) {
  if (batch <= 0 || batch > 65535 || nq <= 0 || n <= 0 || tn <= 0 ||
      nbt <= 0 || n % tn != 0 ||
      tn % nbt != 0 || k <= 0 || k > (n / tn) * nbt || tq <= 0 ||
      threads != kThreads || tq * 32 > threads ||
      blocks != (nq + tq - 1) / tq ||
      static_cast<long long>(smem_bytes) !=
          4LL * tq * 32 * ((((n / tn) * nbt + 31) >> 5) | 1) ||
      smem_bytes > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.t = static_cast<const float*>(targets);
  a.mask = static_cast<const unsigned char*>(mask);
  a.q = static_cast<const float*>(queries);
  a.ts0 = ts0;
  a.ts1 = ts1;
  a.ms0 = ms0;
  a.qs0 = qs0;
  a.qs1 = qs1;
  a.tsb = tsb;
  a.msb = msb;
  a.qsb = qsb;
  a.nq = nq;
  a.n = n;
  a.tn = tn;
  a.nbt = nbt;
  a.k = k;
  a.out_d2 = static_cast<float*>(out_d2);
  a.out_idx = static_cast<int*>(out_idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tq) {
    case 8: return launch<8>(a, batch, blocks, smem_bytes, s);
    case 4: return launch<4>(a, batch, blocks, smem_bytes, s);
    case 2: return launch<2>(a, batch, blocks, smem_bytes, s);
    case 1: return launch<1>(a, batch, blocks, smem_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
