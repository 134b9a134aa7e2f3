// K3: the global color statistics of a reference image for sm_90a, the
// blobs the global-hints net is conditioned on.
//
// Replaces: ideepcolor_tpu/models/global_stats.py extract, one jitted XLA
// program (no Pallas kernel): sRGB -> Lab -> 4 x 4 average pool of ab ->
// the nearest of the 313 bin centers of each pooled pixel, one-hot ->
// the mean over pooled pixels (glob_ab_313); the mean HSV saturation
// (s_avg); the channel means in BGR order (bgr_avg). In the port the same
// chain ran as about 85 eager PyTorch launches.
//
// What bounds it on an H100: neither bytes nor operations, but latency.
// A 256 x 256 reference is 786 KB in (12 B/px: 0.23 us at 3.35 TB/s) and
// about 65 k pixels of Lab (six powf each) plus 4096 x 313 distances: a
// few microseconds of work that no single SM should hold alone. The design
// spreads it over many blocks and keeps every step on the card.
//
// Design: two launches, no host synchronisation, no atomics in device
// memory, so no scratch that must start zeroed.
// - The partials kernel: a block takes 64 pooled pixels a step (grid-stride
//   over any (H/4) x (W/4)), four threads to a pooled pixel, one per row of
//   its 4 x 4 patch. A thread loads its row's 4 pixels (three float4, 48 B)
//   and works out their Lab, saturation and channels. The patch's ab sum is
//   the row sums combined by two xor shuffles, so all four threads hold the
//   same pooled ab; each then scans a quarter of the 313 centers (held in
//   shared memory) and two more shuffles keep the smallest distance, ties
//   to the lower bin index. One thread of the four counts the bin in a
//   shared-memory histogram of ints (integer atomics: order-free). At the
//   end the block writes its 313 counts and its four float sums (a fixed
//   shuffle tree, then the warps in order) to its own row of the partials.
// - The finish kernel: one block; thread k adds bin k's counts over the
//   blocks and divides by the number of pooled pixels; four threads add
//   the float sums over the blocks in order, in double, and divide by the
//   number of pixels. Every sum has a fixed order, so one input gives the
//   same bits on every call.
//
// Numerics follow the port's plain chain as PyTorch runs it on the card
// (ops/colorspace.py rgb_to_lab, rgb_to_hsv): the same f32 constants, powf
// for the 2.4 and the 1/3 powers, the same branches, each product and sum
// rounded on its own (the __f*_rn intrinsics keep nvcc from contracting
// them into FMAs), and a division by a constant taken as PyTorch's CUDA
// kernels take a division by a host scalar: a multiply by the f32
// reciprocal. The nearest bin is the direct squared distance
// (x - c)^2 + (y - c)^2 at f32, as the prototxt's NNEncLayer and
// benchmark/reference/glob_stats.py find it; the port's plain chain uses
// the product expansion |x|^2 - 2 x.c + |c|^2, which can pick the other
// bin for a pooled pixel within rounding of a boundary. No
// --use_fast_math.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBins = 313;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPatches = kThreads / 4;  // pooled pixels a block step
constexpr int kSums = 4;                // saturation, r, g, b
// a block's row of the partials: 313 int counts, then the 4 float sums
constexpr int kWords = 320;
constexpr int kFinishThreads = 320;

#define F32(x) static_cast<float>(x)

// linear sRGB -> XYZ (ops/colorspace.py RGB2XYZ)
constexpr float kR00 = F32(0.412456439089692), kR01 = F32(0.357576077643909),
                kR02 = F32(0.180437483266399);
constexpr float kR10 = F32(0.212672851405623), kR11 = F32(0.715152155287818),
                kR12 = F32(0.072174993306560);
constexpr float kR20 = F32(0.019333895582329), kR21 = F32(0.119192025881303),
                kR22 = F32(0.950304078536368);
constexpr float kEps = F32(216.0 / 24389.0);
constexpr float kKappa = F32(24389.0 / 27.0);
constexpr float kLinEdge = F32(0.04045);
constexpr float kGamma = F32(2.4);
constexpr float kThird = F32(1.0 / 3.0);
// reciprocals of the constant divisors, as PyTorch forms them in f32
constexpr float kInv1292 = 1.0f / F32(12.92);
constexpr float kInv1055 = 1.0f / F32(1.055);
constexpr float kInvWX = 1.0f / F32(0.95047);
constexpr float kInvWY = 1.0f / F32(1.0);
constexpr float kInvWZ = 1.0f / F32(1.08883);
constexpr float kInv116 = 1.0f / F32(116.0);

__device__ __forceinline__ float srgb_to_linear(float v) {
  return v <= kLinEdge
             ? __fmul_rn(v, kInv1292)
             : powf(__fmul_rn(__fadd_rn(v, F32(0.055)), kInv1055), kGamma);
}

__device__ __forceinline__ float dot3(float m0, float m1, float m2, float x,
                                      float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(m0, x), __fmul_rn(m1, y)),
                   __fmul_rn(m2, z));
}

__device__ __forceinline__ float lab_f(float t) {
  return t > kEps ? powf(t, kThird)
                  : __fmul_rn(__fadd_rn(__fmul_rn(kKappa, t), 16.0f),
                              kInv116);
}

// One pixel: its Lab a and b, its HSV saturation.
__device__ __forceinline__ void pixel(float r, float g, float b, float* a_out,
                                      float* b_out, float* s_out) {
  const float lr = srgb_to_linear(r), lg = srgb_to_linear(g),
              lb = srgb_to_linear(b);
  const float fx =
      lab_f(__fmul_rn(dot3(kR00, kR01, kR02, lr, lg, lb), kInvWX));
  const float fy =
      lab_f(__fmul_rn(dot3(kR10, kR11, kR12, lr, lg, lb), kInvWY));
  const float fz =
      lab_f(__fmul_rn(dot3(kR20, kR21, kR22, lr, lg, lb), kInvWZ));
  *a_out = __fmul_rn(500.0f, __fsub_rn(fx, fy));
  *b_out = __fmul_rn(200.0f, __fsub_rn(fy, fz));
  const float v = fmaxf(fmaxf(r, g), b);
  const float c = __fsub_rn(v, fminf(fminf(r, g), b));
  *s_out = v == 0.0f ? 0.0f : __fdiv_rn(c, v);
}

__global__ void __launch_bounds__(kThreads)
    stats_partial_kernel(const float* __restrict__ rgb, int height,
                         int width, const float2* __restrict__ centers,
                         int* __restrict__ partials) {
  __shared__ float2 s_centers[kBins];
  __shared__ int s_hist[kBins];
  __shared__ float s_sums[kWarps][kSums];
  for (int k = threadIdx.x; k < kBins; k += kThreads) {
    s_centers[k] = centers[k];
    s_hist[k] = 0;
  }
  __syncthreads();

  const unsigned full = 0xffffffffu;
  const int q = threadIdx.x & 3;  // the patch row, and the centers' quarter
  const int pooled_w = width >> 2;
  const int pooled = (height >> 2) * pooled_w;
  float acc[kSums] = {0.0f, 0.0f, 0.0f, 0.0f};
  // the bound is the same for every thread of the block, so all of them
  // reach every shuffle
  for (int base = blockIdx.x * kPatches; base < pooled;
       base += gridDim.x * kPatches) {
    const int p = base + (threadIdx.x >> 2);
    float sa = 0.0f, sb = 0.0f;
    if (p < pooled) {
      const int py = p / pooled_w, px = p - py * pooled_w;
      const float4* row = reinterpret_cast<const float4*>(
          rgb + 3 * ((4 * py + q) * width + 4 * px));
      const float4 t0 = __ldg(row), t1 = __ldg(row + 1), t2 = __ldg(row + 2);
      const float v[12] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y,
                           t1.z, t1.w, t2.x, t2.y, t2.z, t2.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a, b, s;
        pixel(v[3 * j], v[3 * j + 1], v[3 * j + 2], &a, &b, &s);
        sa = __fadd_rn(sa, a);
        sb = __fadd_rn(sb, b);
        acc[0] = __fadd_rn(acc[0], s);
        acc[1] = __fadd_rn(acc[1], v[3 * j]);
        acc[2] = __fadd_rn(acc[2], v[3 * j + 1]);
        acc[3] = __fadd_rn(acc[3], v[3 * j + 2]);
      }
    }
    // (r0 + r1) + (r2 + r3) on all four threads (an f32 add commutes)
    sa = __fadd_rn(sa, __shfl_xor_sync(full, sa, 1));
    sb = __fadd_rn(sb, __shfl_xor_sync(full, sb, 1));
    sa = __fadd_rn(sa, __shfl_xor_sync(full, sa, 2));
    sb = __fadd_rn(sb, __shfl_xor_sync(full, sb, 2));
    const float pa = __fmul_rn(sa, 0.0625f), pb = __fmul_rn(sb, 0.0625f);

    float best = __int_as_float(0x7f800000);  // +inf
    int arg = q;
    for (int k = q; k < kBins; k += 4) {
      const float2 c = s_centers[k];
      const float dx = __fsub_rn(pa, c.x), dy = __fsub_rn(pb, c.y);
      const float d = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      if (d < best) {
        best = d;
        arg = k;
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float d = __shfl_xor_sync(full, best, off);
      const int k = __shfl_xor_sync(full, arg, off);
      if (d < best || (d == best && k < arg)) {
        best = d;
        arg = k;
      }
    }
    if (q == 0 && p < pooled) atomicAdd(&s_hist[arg], 1);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kSums; ++j) {
    float x = acc[j];
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      x = __fadd_rn(x, __shfl_xor_sync(full, x, off));
    if (lane == 0) s_sums[warp][j] = x;
  }
  __syncthreads();  // the histogram and the warps' sums are complete
  int* out = partials + blockIdx.x * kWords;
  for (int k = threadIdx.x; k < kBins; k += kThreads) out[k] = s_hist[k];
  if (threadIdx.x < kSums) {
    float x = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x = __fadd_rn(x, s_sums[w][threadIdx.x]);
    out[kBins + threadIdx.x] = __float_as_int(x);
  }
}

__global__ void __launch_bounds__(kFinishThreads)
    stats_finish_kernel(const int* __restrict__ partials, int blocks,
                        int pooled, int pixels, float* __restrict__ glob,
                        float* __restrict__ s_avg,
                        float* __restrict__ bgr_avg) {
  const int t = threadIdx.x;
  if (t < kBins) {
    int n = 0;
    for (int b = 0; b < blocks; ++b) n += partials[b * kWords + t];
    glob[t] = __fdiv_rn(static_cast<float>(n), static_cast<float>(pooled));
  } else if (t < kBins + kSums) {
    const int j = t - kBins;  // 0: saturation, 1-3: r, g, b
    double x = 0.0;
    for (int b = 0; b < blocks; ++b)
      x += static_cast<double>(__int_as_float(partials[b * kWords + t]));
    const float mean = static_cast<float>(x / pixels);
    if (j == 0) {
      *s_avg = mean;
    } else {
      bgr_avg[3 - j] = mean;  // BGR order
    }
  }
}

}  // namespace

// rgb: (height, width, 3) f32, contiguous, 16-byte aligned, height and
// width positive multiples of 4, 3 * height * width < 2^31; centers: (313, 2)
// f32 in device memory; blocks: the partials kernel's grid, 1 to 65535;
// partials: blocks * 320 words of scratch (no initial value); glob: (313,),
// s_avg: (), bgr_avg: (3,) f32. Two launches on stream. Returns
// cudaGetLastError() after the second.
extern "C" int ideepcolor_global_stats(const void* rgb, int height,
                                       int width, const void* centers,
                                       int blocks, void* partials, void* glob,
                                       void* s_avg, void* bgr_avg,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  stats_partial_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(rgb), height, width,
      static_cast<const float2*>(centers), static_cast<int*>(partials));
  const int first = static_cast<int>(cudaGetLastError());
  if (first != 0) return first;
  stats_finish_kernel<<<1, kFinishThreads, 0, s>>>(
      static_cast<const int*>(partials), blocks, (height / 4) * (width / 4),
      height * width, static_cast<float*>(glob), static_cast<float*>(s_avg),
      static_cast<float*>(bgr_avg));
  return static_cast<int>(cudaGetLastError());
}
