// K4: the epilogue of a SIGGRAPH conv group for sm_90a, in place on the
// conv's output: + bias[c]; optionally + (a second conv output + its
// bias), the U-Net's skip sums; ReLU or LeakyReLU; optionally the block's
// inference BatchNorm.
//
// Replaces: the eager chain after each conv of models/siggraph.py on the
// card. PyTorch's cuDNN path adds a conv's bias as a broadcast add after
// the conv; nn.ReLU writes a new tensor; BatchNorm and the skip add are
// passes of their own. That is 67 elementwise launches a forward, each a
// read and a write (the adds two reads) of a whole activation. The JAX
// package leaves the same chain to XLA, which fuses it into the conv.
//
// What bounds it on an H100: bytes. Each element is read once and written
// once (the pairs read a second output), 8 or 12 B an element at
// 3.35 TB/s: 64 x 256 x 256 x 16 f32 (268 MB) is 160 us. The few
// operations an element are free beside that.
//
// Design: one launch a group, a grid-stride loop over the flat tensor.
// - A block first copies the per-channel terms it needs into shared
//   memory (the bias, the pair's bias, and the BatchNorm's terms below),
//   from the modules' own tensors by pointer: nothing is kept between
//   launches, so a weight load or an in-place update reaches the next
//   launch, eager or replayed.
// - The layout comes from the strides (the wrapper passes it): NHWC takes
//   the channel as the flat index mod C, NCHW as (index / (H * W)) mod C.
// - Vector path: each thread moves four consecutive elements as one
//   float4. In NHWC those are four channels (C a multiple of 4), in NCHW
//   four W of one channel (H * W a multiple of 4). Any other shape takes
//   the scalar path, one element a thread step.
//
// Numerics follow the eager chain on the card op by op, so K4 gives its
// bits: (y + b), then + (p + pb), each sum rounded on its own (the
// __f*_rn intrinsics keep nvcc from contracting them); ReLU as PyTorch's
// clamp_min (NaN kept, else fmaxf(v, 0)), LeakyReLU as v > 0 ? v :
// v * slope. BatchNorm in the order of the cuDNN inference kernel that
// F.batch_norm calls for the layout, found bit for bit on an H100:
// inv = rsqrtf(var + eps) per channel, then
//   NCHW: fmaf(gamma * (v - mean), inv, beta);
//   NHWC: fmaf(v, gamma * inv, fmaf(-(mean * gamma), inv, beta)),
// the two per-channel terms of NHWC taken once a block. No
// --use_fast_math.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Args {
  float* y;
  const float* pair;        // null: no skip sum
  unsigned n;               // elements
  int channels;
  unsigned plane;           // H * W (the NCHW channel's stride)
  const float* bias;
  const float* pair_bias;
  const float* mean;        // null: no BatchNorm
  const float* var;
  const float* gamma;
  const float* beta;
  float eps;
  int leaky;
  float slope;
};

// shared memory: rows of C floats, in this order; NHWC keeps its
// BatchNorm's scale and shift in the first two BatchNorm rows
enum Row { kBias = 0, kPairBias, kMean, kInv, kGamma, kBeta, kRows };
constexpr int kScale = kMean, kShift = kInv;

template <bool kNhwc>
__device__ __forceinline__ float finish(float v, float p, int c,
                                        const float* sm, int C,
                                        const Args& a) {
  v = __fadd_rn(v, sm[kBias * C + c]);
  if (a.pair) v = __fadd_rn(v, __fadd_rn(p, sm[kPairBias * C + c]));
  if (a.leaky) {
    v = v > 0.f ? v : __fmul_rn(v, a.slope);
  } else {
    v = isnan(v) ? v : fmaxf(v, 0.f);
  }
  if (a.mean) {
    v = kNhwc ? fmaf(v, sm[kScale * C + c], sm[kShift * C + c])
              : fmaf(__fmul_rn(sm[kGamma * C + c],
                               __fsub_rn(v, sm[kMean * C + c])),
                     sm[kInv * C + c], sm[kBeta * C + c]);
  }
  return v;
}

template <bool kNhwc, bool kVec>
__global__ void __launch_bounds__(kThreads)
    epilogue_pointwise_kernel(const Args a) {
  extern __shared__ float sm[];
  const int C = a.channels;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    sm[kBias * C + c] = a.bias[c];
    if (a.pair) sm[kPairBias * C + c] = a.pair_bias[c];
    if (a.mean) {
      const float inv = rsqrtf(__fadd_rn(a.var[c], a.eps));
      if (kNhwc) {
        sm[kScale * C + c] = __fmul_rn(a.gamma[c], inv);
        sm[kShift * C + c] =
            fmaf(-__fmul_rn(a.mean[c], a.gamma[c]), inv, a.beta[c]);
      } else {
        sm[kMean * C + c] = a.mean[c];
        sm[kInv * C + c] = inv;
        sm[kGamma * C + c] = a.gamma[c];
        sm[kBeta * C + c] = a.beta[c];
      }
    }
  }
  __syncthreads();
  const unsigned step = gridDim.x * blockDim.x;
  const unsigned first = blockIdx.x * blockDim.x + threadIdx.x;
  if (kVec) {
    float4* y4 = reinterpret_cast<float4*>(a.y);
    const float4* p4 = reinterpret_cast<const float4*>(a.pair);
    for (unsigned i = first; i < a.n / 4; i += step) {
      float4 v = y4[i];
      const float4 p = a.pair ? __ldg(p4 + i) : make_float4(0, 0, 0, 0);
      const unsigned e = 4 * i;
      if (kNhwc) {
        const int c = e % C;
        v.x = finish<kNhwc>(v.x, p.x, c, sm, C, a);
        v.y = finish<kNhwc>(v.y, p.y, c + 1, sm, C, a);
        v.z = finish<kNhwc>(v.z, p.z, c + 2, sm, C, a);
        v.w = finish<kNhwc>(v.w, p.w, c + 3, sm, C, a);
      } else {
        const int c = (e / a.plane) % C;
        v.x = finish<kNhwc>(v.x, p.x, c, sm, C, a);
        v.y = finish<kNhwc>(v.y, p.y, c, sm, C, a);
        v.z = finish<kNhwc>(v.z, p.z, c, sm, C, a);
        v.w = finish<kNhwc>(v.w, p.w, c, sm, C, a);
      }
      y4[i] = v;
    }
  } else {
    for (unsigned i = first; i < a.n; i += step) {
      const int c = kNhwc ? i % C : (i / a.plane) % C;
      const float p = a.pair ? __ldg(a.pair + i) : 0.f;
      a.y[i] = finish<kNhwc>(a.y[i], p, c, sm, C, a);
    }
  }
}

}  // namespace

extern "C" int ideepcolor_conv_epilogue(
    void* y, const void* pair, int n, int channels, int plane, int nhwc,
    int vec, const void* bias, const void* pair_bias, const void* mean,
    const void* var, const void* gamma, const void* beta, float eps,
    int leaky, float slope, int blocks, void* stream) {
  const Args a{static_cast<float*>(y),
               static_cast<const float*>(pair),
               static_cast<unsigned>(n),
               channels,
               static_cast<unsigned>(plane),
               static_cast<const float*>(bias),
               static_cast<const float*>(pair_bias),
               static_cast<const float*>(mean),
               static_cast<const float*>(var),
               static_cast<const float*>(gamma),
               static_cast<const float*>(beta),
               eps,
               leaky,
               slope};
  const size_t shared = sizeof(float) * kRows * channels;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nhwc && vec) {
    epilogue_pointwise_kernel<true, true><<<blocks, kThreads, shared, s>>>(a);
  } else if (nhwc) {
    epilogue_pointwise_kernel<true, false><<<blocks, kThreads, shared, s>>>(a);
  } else if (vec) {
    epilogue_pointwise_kernel<false, true><<<blocks, kThreads, shared, s>>>(a);
  } else {
    epilogue_pointwise_kernel<false, false>
        <<<blocks, kThreads, shared, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
