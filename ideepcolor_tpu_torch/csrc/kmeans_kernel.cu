// K5: the color-suggestion chain for sm_90a, from the uniform numbers to
// the sorted palette, in one launch.
//
// Replaces: ideepcolor_tpu/ops/kmeans.py ab_recommendations after its two
// random draws (sample_bins' histogram, _kmeanspp_init, _lloyd, the
// winning restart, the sort), which the port ran as about 550 PyTorch
// launches of 2-3 us each (ops/kmeans.py bins_from_uniform, then
// kmeans_from_uniform), one CUDA graph node each inside a suggestion.
//
// What bounds it on an H100: latency. A suggestion is 25,000 lookups in a
// 529-entry table and about 0.6 M squared distances (529 weighted points x
// 9 centers x 4 restarts x 30 Lloyd steps): a few microseconds of work,
// every step of it waiting on the one before. The design keeps it all in
// shared memory, so a step costs a barrier and not a launch, and gives
// each restart an SM of its own.
//
// Design: a cluster of four blocks of 1024 threads, block r the restart r,
// joined through distributed shared memory.
// - The sampler: the cmf is the caller's torch.cumsum of the pdf, divided
//   here by its last value (the chain's cmf / cmf[-1], an IEEE division).
//   Each draw's bin is PyTorch's searchsorted(right=True): the first bin
//   whose cmf is greater than the draw, one past the last bin dropped. A
//   table of the answers at the 1025 points b / 1024 gives the bin of every
//   draw in a bucket [b / 1024, (b + 1) / 1024) that one bin covers whole
//   (where the cmf never decreases, the answer lies between the bucket's
//   ends), so such a draw only counts its bucket, an atomic add on 1024
//   counters that uniform draws spread; a draw in a bucket that holds a
//   boundary is searched between the bucket's ends and counted in its bin.
//   A cmf that steps down (a parallel cumsum may, by an ulp, where two of
//   its partial sums meet) or holds a NaN is searched whole, on PyTorch's
//   own path. Each block takes a quarter of the draws; the bucket counts
//   go to their bins by a segmented scan of each warp's 32 buckets; then
//   every block adds the four blocks' counts (integers: order-free), a
//   thread a bin.
// - Bins that drew nothing weigh nothing: in a sum of weights they add 0,
//   and a pick by weight never stops at them. A block scan keeps the drawn
//   bins in bin order (x, y, weight) with the running sum of their
//   weights, at most one a thread, and everything after works on them
//   alone. The one
//   place where an undrawn bin can win is kept: a pick past the end of its
//   cumulative sum takes the last point of the table, as the chain's clamp
//   to P-1 does.
// - k-means++ seeding: a thread forms weight x squared distance of its
//   point, a warp scans its 32, one warp scans the 32 warps and finds the
//   first point whose running sum passes the draw x total, then every
//   thread lowers its point's squared distance to the new seed. The first
//   pick, and any pick where all weight already sits on a seed (the
//   chain's `p.sum() > 0` else the weights), search the integer running
//   sum of the weights.
// - Lloyd: a thread assigns its point to the nearest center; then warp c
//   sums weight, weight x a and weight x b over the points of center c and
//   divides. An empty cluster keeps its center. The steps stop at a fixed
//   point (no center moved), where the rest would change nothing.
// - The final assignment and each restart's inertia; block 0 takes the
//   first restart of lowest inertia, ranks its clusters by mass
//   (descending, stable) and writes (K, 3) rows (a, b, mass / total).
//
// Exactness: the palette is the plain chain's bit for bit, but where float32
// rounding decides a choice either way.
// - Squared distances are (dx * dx) + (dy * dy), each product and the sum
//   rounded on its own (__fmul_rn, __fadd_rn: nvcc would contract them into
//   an FMA, PyTorch squares, then sums); argmin keeps the first index on
//   ties, and so does the winner across restarts.
// - Divisions are __fdiv_rn. A Lloyd center is its cluster's weighted sum
//   over its mass: the weights are integer counts and the table's
//   coordinates integers (multiples of 10), so each sum is an integer below
//   2^24, exact in float32 in any order of summation, as cuBLAS's float32
//   product is in the chain. A nonzero mass is at least 1, so the chain's
//   clamp_min(1e-12) never acts.
// - Two sums may round otherwise than PyTorch's: the seeding's cumulative
//   sum of the float32 products weight x distance, which is taken here
//   exactly (in double: integers below 2^53), and each restart's inertia
//   (a double sum of the float32 products, rounded to float32). So a
//   seeding draw that falls within rounding of a boundary between two
//   points, or two restarts whose inertias lie within rounding of each
//   other, may go the other way; the first pick's sum (integer counts) is
//   exact in any order.
// No --use_fast_math.

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRestarts = 4;     // the cluster's blocks
constexpr int kMaxK = 32;        // a warp a center; one warp sorts
constexpr int kMaxPoints = 768;  // at most one a thread
constexpr int kBuckets = 1024;   // the sampler's table: one a thread
constexpr unsigned kFull = 0xffffffffu;
static_assert(kBuckets == kThreads && kMaxPoints <= kThreads,
              "a thread a bucket, at most one drawn bin a thread");
static_assert(kMaxK <= kWarps, "a warp a center");

struct Shared {
  float cmf[kMaxPoints];
  int lo[kBuckets + 1];       // the bin of the draw b / kBuckets
  int bucket[kBuckets];       // this block's draws in each whole bucket
  int part[kMaxPoints];       // this block's draws in each bin
  int warp_nz[kWarps];        // step 3: the warps' drawn bins and draws
  int warp_cw[kWarps];
  float4 pt[kMaxPoints];      // the drawn bins: a, b, weight, 0; bin order
  int cw[kMaxPoints];         // the running sum of their weights
  double lane_incl[kThreads];  // seeding: the running sum within a warp
  double warp_sum[kWarps];
  unsigned char assign[kMaxPoints];  // Lloyd: a point's center
  float2 centers[kMaxK];
  float mass[kMaxK];
  double inertia;
  int m;                      // drawn bins
  int total;                  // draws kept
};

__device__ __forceinline__ float sq_dist(float px, float py, float2 c) {
  const float dx = __fsub_rn(px, c.x), dy = __fsub_rn(py, c.y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// The first index in [start, end) whose value is greater than val, else
// end: PyTorch's searchsorted(right=True) as its CUDA kernel writes it.
__device__ __forceinline__ int upper_bound(const float* v, int start,
                                           int end, float val) {
  while (start < end) {
    const int mid = start + ((end - start) >> 1);
    if (!(v[mid] > val)) {
      start = mid + 1;
    } else {
      end = mid;
    }
  }
  return start;
}

// The first drawn bin whose running weight passes x, or -1 past the end.
__device__ __forceinline__ int pick_by_weight(const int* cw, int m,
                                              float x) {
  int start = 0, end = m;
  while (start < end) {
    const int mid = start + ((end - start) >> 1);
    if (!(static_cast<float>(cw[mid]) > x)) {
      start = mid + 1;
    } else {
      end = mid;
    }
  }
  return start < m ? start : -1;
}

__device__ __forceinline__ double warp_incl_scan(double v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += o;
  }
  return v;
}

// A seeding pick after the first, by warp 0 from the warps' running sums
// of weight x dmin: the drawn bin whose running sum passes u x total, -1
// past the end (the table's last point).
__device__ int pick_seed(const Shared& s, float u, float wtot, int lane) {
  const double own = s.warp_sum[lane];
  const double incl = warp_incl_scan(own, lane);
  const double total = __shfl_sync(kFull, incl, 31);
  // degenerate: all weight already sits on a seed
  if (!(total > 0.0)) return pick_by_weight(s.cw, s.m, __fmul_rn(u, wtot));
  const double x = __fmul_rn(u, static_cast<float>(total));
  const unsigned hit = __ballot_sync(kFull, incl > x);
  if (!hit) return -1;
  const int f = __ffs(hit) - 1;
  const double base = __shfl_sync(kFull, incl - own, f);
  const double v = base + s.lane_incl[f * 32 + lane];
  const unsigned in = __ballot_sync(kFull, v > x);
  if (in) return f * 32 + __ffs(in) - 1;
  // a warp that rounds short (not with integer sums): its last point of
  // nonzero weight x dmin
  const double before = lane ? s.lane_incl[f * 32 + lane - 1] : 0.0;
  const unsigned grew =
      __ballot_sync(kFull, s.lane_incl[f * 32 + lane] > before);
  return grew ? f * 32 + 31 - __clz(grew) : -1;
}

__global__ void __cluster_dims__(kRestarts, 1, 1)
    __launch_bounds__(kThreads, 1)
    kmeans_kernel(const float* __restrict__ cum, int q,
                  const float* __restrict__ u_bins, int n,
                  const float2* __restrict__ pts,
                  const float* __restrict__ u_seeds, int k, int iters,
                  float* __restrict__ out, int* __restrict__ counts_out) {
  __shared__ Shared s;
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());  // the restart
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. the cmf, cmf / cmf[-1], and the sampler's table; thread i's bin
  // center, read now for step 3
  const float2 tp = tid < q ? pts[tid] : make_float2(0.0f, 0.0f);
  const float last = cum[q - 1];
  for (int i = tid; i < q; i += kThreads) {
    s.cmf[i] = __fdiv_rn(cum[i], last);
    s.part[i] = 0;
  }
  s.bucket[tid] = 0;
  __syncthreads();
  bool rising = true;
  for (int i = tid + 1; i < q; i += kThreads)
    rising = rising && s.cmf[i - 1] <= s.cmf[i];
  const bool narrow = __syncthreads_and(rising) != 0;
  for (int b = tid; b <= kBuckets; b += kThreads)
    s.lo[b] = upper_bound(s.cmf, 0, q,
                          static_cast<float>(b) * (1.0f / kBuckets));
  __syncthreads();

  // 2. this block's quarter of the draws; four a thread in flight
  const int per = (n + kRestarts - 1) / kRestarts;
  const int d0 = min(n, r * per), d1 = min(n, d0 + per);
  constexpr int kUnroll = 4;
  for (int base = d0 + tid; base < d1; base += kThreads * kUnroll) {
    float u[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int i = base + j * kThreads;
      u[j] = i < d1 ? __ldg(u_bins + i) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (base + j * kThreads >= d1) break;
      int lo = 0, hi = q;
      if (narrow && u[j] >= 0.0f && u[j] < 1.0f) {
        const int b = static_cast<int>(u[j] * kBuckets);
        lo = s.lo[b];
        hi = s.lo[b + 1];
        if (lo == hi) {  // one bin holds the whole bucket
          atomicAdd(&s.bucket[b], 1);
          continue;
        }
      }
      const int bin = upper_bound(s.cmf, lo, hi, u[j]);
      if (bin < q) atomicAdd(&s.part[bin], 1);
    }
  }
  __syncthreads();
  {
    // the whole buckets to their bins: a bin's buckets are consecutive,
    // so a segmented scan over each warp's 32 buckets sums them
    const int b = tid;
    const bool whole = narrow && s.lo[b] == s.lo[b + 1] && s.lo[b] < q;
    const int key = whole ? s.lo[b] : -1 - b;
    int c = whole ? s.bucket[b] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int oc = __shfl_up_sync(kFull, c, off);
      const int ok = __shfl_up_sync(kFull, key, off);
      if (lane >= off && ok == key) c += oc;
    }
    const int next = __shfl_down_sync(kFull, key, 1);
    if (key >= 0 && c > 0 && (lane == 31 || next != key))
      atomicAdd(&s.part[key], c);
  }
  cluster.sync();  // every block's counts are complete

  // 3. the drawn bins, in bin order: thread i adds the four blocks' counts
  // of bin i, and a block scan places the bins that drew
  int drawn = 0;
  if (tid < q) {
    for (int rr = 0; rr < kRestarts; ++rr)
      drawn += cluster.map_shared_rank(s.part, rr)[tid];
    if (r == 0 && counts_out != nullptr) counts_out[tid] = drawn;
  }
  int nz = drawn > 0, sum = drawn;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int a = __shfl_up_sync(kFull, nz, off);
    const int b = __shfl_up_sync(kFull, sum, off);
    if (lane >= off) {
      nz += a;
      sum += b;
    }
  }
  if (lane == 31) {
    s.warp_nz[warp] = nz;
    s.warp_cw[warp] = sum;
  }
  __syncthreads();
  if (warp == 0) {
    const int wn = s.warp_nz[lane], wc = s.warp_cw[lane];
    int n_incl = wn, c_incl = wc;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int a = __shfl_up_sync(kFull, n_incl, off);
      const int b = __shfl_up_sync(kFull, c_incl, off);
      if (lane >= off) {
        n_incl += a;
        c_incl += b;
      }
    }
    s.warp_nz[lane] = n_incl - wn;  // the warps' exclusive prefixes
    s.warp_cw[lane] = c_incl - wc;
    if (lane == 31) {
      s.m = n_incl;
      s.total = c_incl;
    }
  }
  __syncthreads();
  if (drawn > 0) {
    const int at = s.warp_nz[warp] + nz - 1;
    s.pt[at] = make_float4(tp.x, tp.y, static_cast<float>(drawn), 0.0f);
    s.cw[at] = s.warp_cw[warp] + sum;
  }
  __syncthreads();

  // 4. k-means++ seeding of restart r: thread j holds drawn bin j
  const int m = s.m;
  const float wtot = static_cast<float>(s.total);
  const bool mine = tid < m;
  const float4 p = mine ? s.pt[tid] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float2 last_pt = pts[q - 1];
  float dmin = 0.0f;
  for (int i = 0; i < k; ++i) {
    if (i > 0) {
      const double v = mine ? __fmul_rn(p.z, dmin) : 0.0f;
      const double incl = warp_incl_scan(v, lane);
      s.lane_incl[tid] = incl;
      if (lane == 31) s.warp_sum[warp] = incl;
    }
    __syncthreads();
    if (warp == 0) {
      const float u = u_seeds[r * k + i];
      const int idx = i == 0 ? pick_by_weight(s.cw, m, __fmul_rn(u, wtot))
                             : pick_seed(s, u, wtot, lane);
      if (lane == 0)
        s.centers[i] =
            idx >= 0 ? make_float2(s.pt[idx].x, s.pt[idx].y) : last_pt;
    }
    __syncthreads();
    const float d = sq_dist(p.x, p.y, s.centers[i]);
    dmin = i == 0 ? d : fminf(dmin, d);
  }

  // 5. Lloyd, then (step == iters) the final assignment and masses. A step
  // that moves no center is a fixed point: every later step would assign
  // and sum the same, so its assignment and masses are the final ones
  float best = 0.0f;
  for (int step = 0; step <= iters; ++step) {
    if (mine) {
      best = sq_dist(p.x, p.y, s.centers[0]);
      int arg = 0;
      for (int c = 1; c < k; ++c) {
        const float d = sq_dist(p.x, p.y, s.centers[c]);
        if (d < best) {
          best = d;
          arg = c;
        }
      }
      s.assign[tid] = static_cast<unsigned char>(arg);
    }
    __syncthreads();
    bool moved = false;
    if (warp < k) {
      float sx = 0.0f, sy = 0.0f, sm = 0.0f;
#pragma unroll 4
      for (int j = lane; j < m; j += 32) {
        if (s.assign[j] == warp) {
          const float4 o = s.pt[j];
          sx = __fmaf_rn(o.z, o.x, sx);
          sy = __fmaf_rn(o.z, o.y, sy);
          sm = __fadd_rn(sm, o.z);
        }
      }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) {
        sx = __fadd_rn(sx, __shfl_xor_sync(kFull, sx, off));
        sy = __fadd_rn(sy, __shfl_xor_sync(kFull, sy, off));
        sm = __fadd_rn(sm, __shfl_xor_sync(kFull, sm, off));
      }
      if (lane == 0) {
        s.mass[warp] = sm;
        if (step < iters && sm > 0.0f) {
          const float2 c = s.centers[warp];
          const float2 to = make_float2(__fdiv_rn(sx, sm), __fdiv_rn(sy, sm));
          moved = to.x != c.x || to.y != c.y;
          s.centers[warp] = to;
        }
      }
    }
    if (!__syncthreads_or(moved)) break;
  }

  // 6. the restart's inertia; block 0 takes the winner and ranks it
  double in = mine ? __fmul_rn(p.z, best) : 0.0f;
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    in += __shfl_xor_sync(kFull, in, off);
  if (lane == 0) s.warp_sum[warp] = in;
  __syncthreads();
  if (warp == 0) {
    double v = s.warp_sum[lane];
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) s.inertia = v;
  }
  cluster.sync();  // every restart's answer is complete
  if (r == 0 && warp == 0) {
    int win = 0;
    float low = static_cast<float>(s.inertia);
    for (int rr = 1; rr < kRestarts; ++rr) {
      const float v = static_cast<float>(
          *cluster.map_shared_rank(&s.inertia, rr));
      if (v < low) {
        low = v;
        win = rr;
      }
    }
    const Shared* w = cluster.map_shared_rank(&s, win);
    if (lane < k) {
      const float own = w->mass[lane];
      int rank = 0;
      for (int c = 0; c < k; ++c) {
        const float other = w->mass[c];
        rank += other > own || (other == own && c < lane);
      }
      const float2 ctr = w->centers[lane];
      out[3 * rank] = ctr.x;
      out[3 * rank + 1] = ctr.y;
      out[3 * rank + 2] = __fdiv_rn(own, wtot);
    }
  }
  cluster.sync();  // block 0 has read the others' shared memory
}

}  // namespace

// cum: (q,) f32, torch.cumsum of the pdf, 1 <= q <= 768; u_bins: (n,) f32,
// n >= 0; pts: (q, 2) f32, the bins' ab centers; u_seeds: (4, k) f32, the
// restarts' seeding draws, 1 <= k <= 32; iters >= 0 Lloyd steps; out: (k, 3)
// f32; counts: (q,) int32, the histogram, or null. All contiguous, in
// device memory. One launch (a cluster of four blocks) on stream. Returns
// cudaGetLastError().
extern "C" int ideepcolor_kmeans(const void* cum, int q, const void* u_bins,
                                 int n, const void* pts, const void* u_seeds,
                                 int k, int iters, void* out, void* counts,
                                 void* stream) {
  kmeans_kernel<<<kRestarts, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cum), q, static_cast<const float*>(u_bins),
      n, static_cast<const float2*>(pts),
      static_cast<const float*>(u_seeds), k, iters, static_cast<float*>(out),
      static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}
