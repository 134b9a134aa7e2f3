// K2: Lab -> clipped, truncated uint8 RGB compose for sm_90a, and the
// click's fused form that also returns the ab of the uint8 frame's own Lab.
//
// Replaces: ideepcolor_tpu/ops/pallas/colorspace_kernel.py
// lab_to_rgb_u8_planar (body _lab2rgb_u8_kernel; wrapper compose_frame_u8):
// Lab -> XYZ (D65) -> linear sRGB (3x3) -> sRGB gamma -> clip [0, 1] -> x255
// -> truncate to uint8. The fused entry adds the JAX click's requantized ab
// (ideepcolor_tpu/engine/pipeline.py requantized_ab): uint8 RGB -> /255 ->
// linear sRGB -> XYZ -> Lab, keeping a and b.
//
// What bounds it on an H100: bytes. The compose reads three f32 (12 B) and
// writes three uint8 (3 B) per pixel, 15 B/px, for about 60 f32 operations;
// the fused entry writes 8 B of ab more, 23 B/px. At 3.35 TB/s that is
// 0.29 us for the 256 x 256 click frame and 14 us for 2048 x 1536.
//
// Design, for a streaming per-pixel map on Hopper: 16-byte accesses, enough
// bytes in flight per SM, few instructions per byte.
// - 2-D grid: blockIdx.y is the row, threads walk it in groups of four
//   pixels. 32-bit index arithmetic (the wrapper checks that every offset
//   fits) and no division.
// - Groups follow the output's flat pixel index: group g of row y starts at
//   x0 = 4g - (y*W mod 4), so every full group's 12 output bytes start on a
//   4-byte boundary (three 32-bit stores) and its contiguous planes on a
//   16-byte one (one float4 load each), also when W is not a multiple of 4
//   (the full-res width 750). The part-groups at the two ends of a row take
//   the scalar path in the same kernel.
// - Each plane is read in one of three modes, a template parameter picked
//   by the wrapper from strides and alignment: kVec (float4), kAny (scalar
//   loads through the strides: a channel of an interleaved image, a
//   misaligned plane) and kZero (stride 0: one load). L and the ab pair
//   have a mode each: the compose entry is built for a kVec L with each ab
//   mode, the fused entry for (kVec, kVec), the click's layout, and both
//   for (kAny, kAny), which every other layout takes.
// - 64-thread blocks, so the 256 x 256 click frame is still 256 blocks,
//   enough for the 132 SMs.
// - A batch of N frames is one launch: the grid's z axis is the frame, each
//   plane has a batch stride of its own (a (N, 2, S, S) prediction's a and b
//   planes do not fold into one 2-D plane), and the groups follow the flat
//   pixel index of the whole (N, H, W, 3) output, so the alignment argument
//   above holds for every frame whatever H * W is. The single-frame entries
//   are the N = 1 case.
// - The fused entry's sRGB -> linear step has 256 possible inputs: it reads
//   a 256-entry table in shared memory that the wrapper builds once per
//   device with the plain version's own torch ops.
// - Few instructions per pixel: with the plain version's IEEE divisions and
//   powf the kernel is bound by instruction issue, not bytes, so it takes
//   cheaper forms (below) and truncates to uint8 with a round-toward-zero
//   add instead of a conversion (exact for 0 <= x < 2^23).
//
// Numerics: the divisions by constants are reciprocal multiplies, and the
// gamma's pow and the fused entry's cube root go through the SFU's
// approximate log2 and exp2 (~2^-22 relative). chip_smoke.py holds this
// build within the bar (1 LSB on fewer than 1e-3 of the values) at every
// size and layout; PERF.md records the error and time of the plain
// version's own forms (IEEE division, powf, cbrtf) against it. No
// --use_fast_math: it would also flush denormals and approximate every
// other division. nvcc's default FMA contraction stays on.

#include <cstdint>

#include "common.cuh"

namespace {

// XYZ -> linear sRGB: the f32 inverse the JAX package's compose uses
// (ops/colorspace.py XYZ2RGB of this port says why not the Pallas kernel's
// float64 inverse: the white point would truncate to 254 instead of 255).
constexpr float kM00 = 3.2404537200927734f, kM01 = -1.5371384620666504f,
                kM02 = -0.498531311750412f;
constexpr float kM10 = -0.969265878200531f, kM11 = 1.8760108947753906f,
                kM12 = 0.041555989533662796f;
constexpr float kM20 = 0.05564342439174652f, kM21 = -0.20402590930461884f,
                kM22 = 1.0572251081466675f;
// linear sRGB -> XYZ, for the fused ab (ops/colorspace.py RGB2XYZ).
constexpr float kR00 = 0.412456439089692f, kR01 = 0.357576077643909f,
                kR02 = 0.180437483266399f;
constexpr float kR10 = 0.212672851405623f, kR11 = 0.715152155287818f,
                kR12 = 0.072174993306560f;
constexpr float kR20 = 0.019333895582329f, kR21 = 0.119192025881303f,
                kR22 = 0.950304078536368f;
constexpr float kWX = 0.95047f, kWY = 1.0f, kWZ = 1.08883f;
constexpr float kKappa = 903.2963f;       // 24389 / 27
constexpr float kFinvEdge = 0.20689656f;  // 6 / 29
constexpr float kEps = 0.008856452f;      // (6 / 29)^3
constexpr float kGamma = 0.41666666f;     // 1 / 2.4

#define K2_DIV(x, c) ((x) * (1.0f / (c)))

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float lg2(float x) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
// x > 0 wherever the result is used
__device__ __forceinline__ float pow_pos(float x, float y) {
  return ex2(y * lg2(x));
}
__device__ __forceinline__ float cube_root(float x) {
  return ex2(lg2(x) * (1.0f / 3.0f));
}

enum Mode : int { kVec = 0, kAny = 1, kZero = 2 };

constexpr int kThreads = 64;

struct Plane {
  const float* p;
  int sb, sy, sx;  // element strides: frame, row, pixel
};

__device__ __forceinline__ float finv(float ft) {
  return ft > kFinvEdge ? ft * ft * ft : K2_DIV(116.0f * ft - 16.0f, kKappa);
}

__device__ __forceinline__ uint32_t to_u8(float lin) {
  const float safe = fmaxf(lin, 0.0f);
  float s = lin <= 0.0031308f ? lin * 12.92f
                              : 1.055f * pow_pos(safe, kGamma) - 0.055f;
  s = fminf(fmaxf(s, 0.0f), 1.0f);
  // trunc(s * 255): adding 2^23 rounding toward zero leaves it in the low
  // mantissa bits
  return __float_as_uint(__fadd_rz(s * 255.0f, 8388608.0f)) - 0x4b000000u;
}

__device__ __forceinline__ void lab_to_rgb8(float L, float A, float B,
                                            uint32_t c[3]) {
  const float fy = K2_DIV(L + 16.0f, 116.0f);
  const float fx = fy + K2_DIV(A, 500.0f);
  const float fz = fy - K2_DIV(B, 200.0f);
  const float X = finv(fx) * kWX;
  const float Y = finv(fy) * kWY;
  const float Z = finv(fz) * kWZ;
  c[0] = to_u8(kM00 * X + kM01 * Y + kM02 * Z);
  c[1] = to_u8(kM10 * X + kM11 * Y + kM12 * Z);
  c[2] = to_u8(kM20 * X + kM21 * Y + kM22 * Z);
}

__device__ __forceinline__ float lab_f(float t) {
  return t > kEps ? cube_root(t) : K2_DIV(kKappa * t + 16.0f, 116.0f);
}

// ab of the uint8 pixel c's own Lab; lut[v] = srgb_to_linear(v / 255).
__device__ __forceinline__ void rgb8_to_ab(const float* lut,
                                           const uint32_t c[3], float ab[2]) {
  const float r = lut[c[0]], g = lut[c[1]], b = lut[c[2]];
  const float fx = lab_f(K2_DIV(kR00 * r + kR01 * g + kR02 * b, kWX));
  const float fy = lab_f(K2_DIV(kR10 * r + kR11 * g + kR12 * b, kWY));
  const float fz = lab_f(K2_DIV(kR20 * r + kR21 * g + kR22 * b, kWZ));
  ab[0] = 500.0f * (fx - fy);
  ab[1] = 200.0f * (fy - fz);
}

template <int M>
__device__ __forceinline__ void load4(const Plane& q, int y, int x0,
                                      float v[4]) {
  if constexpr (M == kVec) {
    const float4 t =
        __ldg(reinterpret_cast<const float4*>(q.p + y * q.sy + x0));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (M == kZero) {
    v[0] = v[1] = v[2] = v[3] = __ldg(q.p);
  } else {
    const float* r = q.p + y * q.sy + x0 * q.sx;
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __ldg(r + j * q.sx);
  }
}

template <int M>
__device__ __forceinline__ float load1(const Plane& q, int y, int x) {
  if constexpr (M == kZero) return __ldg(q.p);
  return __ldg(q.p + y * q.sy + x * q.sx);
}

template <int LM, int ABM, bool kAb>
__global__ void __launch_bounds__(kThreads)
    lab2rgb_kernel(Plane l, Plane a, Plane b, int height, int width,
                   uint8_t* __restrict__ out, float* __restrict__ ab_out,
                   const float* __restrict__ lut) {
  __shared__ float s_lut[kAb ? 256 : 1];
  if constexpr (kAb) {
    for (int i = threadIdx.x; i < 256; i += kThreads) s_lut[i] = lut[i];
    __syncthreads();
  }
  const int y = blockIdx.y;
  const int frame = blockIdx.z;
  l.p += frame * l.sb;
  a.p += frame * a.sb;
  b.p += frame * b.sb;
  // flat index, in the whole output, of the row's first pixel
  const int row = (frame * height + y) * width;
  const int x0 = 4 * static_cast<int>(blockIdx.x * kThreads + threadIdx.x) -
                 (row & 3);
  if (x0 >= width) return;

  if (x0 >= 0 && x0 + 4 <= width) {  // a full group: wide loads and stores
    float L[4], A[4], B[4];
    load4<LM>(l, y, x0, L);
    load4<ABM>(a, y, x0, A);
    load4<ABM>(b, y, x0, B);
    uint32_t c[12];
#pragma unroll
    for (int j = 0; j < 4; ++j) lab_to_rgb8(L[j], A[j], B[j], c + 3 * j);
    uint32_t* o = reinterpret_cast<uint32_t*>(out + 3 * (row + x0));
    o[0] = c[0] | c[1] << 8 | c[2] << 16 | c[3] << 24;
    o[1] = c[4] | c[5] << 8 | c[6] << 16 | c[7] << 24;
    o[2] = c[8] | c[9] << 8 | c[10] << 16 | c[11] << 24;
    if constexpr (kAb) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) rgb8_to_ab(s_lut, c + 3 * j, v + 2 * j);
      float4* q = reinterpret_cast<float4*>(ab_out + 2 * (row + x0));
      q[0] = make_float4(v[0], v[1], v[2], v[3]);
      q[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    return;
  }
  for (int x = max(x0, 0); x < min(x0 + 4, width); ++x) {  // a row's ends
    uint32_t c[3];
    lab_to_rgb8(load1<LM>(l, y, x), load1<ABM>(a, y, x), load1<ABM>(b, y, x),
                c);
    uint8_t* o = out + 3 * (row + x);
    o[0] = static_cast<uint8_t>(c[0]);
    o[1] = static_cast<uint8_t>(c[1]);
    o[2] = static_cast<uint8_t>(c[2]);
    if constexpr (kAb) rgb8_to_ab(s_lut, c, ab_out + 2 * (row + x));
  }
}

struct Args {
  Plane l, a, b;
  int frames, height, width;
  uint8_t* out;
  float* ab_out;
  const float* lut;
  cudaStream_t stream;
};

template <int LM, int ABM, bool kAb>
int run(const Args& g) {
  // groups per row: W/4, or one more (and a part) when rows start unaligned
  const int groups = (g.width & 3) ? (g.width + 6) / 4 : g.width / 4;
  const dim3 grid((groups + kThreads - 1) / kThreads, g.height, g.frames);
  lab2rgb_kernel<LM, ABM, kAb><<<grid, kThreads, 0, g.stream>>>(
      g.l, g.a, g.b, g.height, g.width, g.out, g.ab_out, g.lut);
  return static_cast<int>(cudaGetLastError());
}

Args args(const void* l, int l_sy, int l_sx, const void* a, int a_sy,
          int a_sx, const void* b, int b_sy, int b_sx, int height, int width,
          void* out, void* ab_out, const void* lut, void* stream) {
  return {{static_cast<const float*>(l), 0, l_sy, l_sx},
          {static_cast<const float*>(a), 0, a_sy, a_sx},
          {static_cast<const float*>(b), 0, b_sy, b_sx},
          1,
          height,
          width,
          static_cast<uint8_t*>(out),
          static_cast<float*>(ab_out),
          static_cast<const float*>(lut),
          static_cast<cudaStream_t>(stream)};
}

}  // namespace

// l, a, b: f32 (height, width) planes addressed by element strides (sy, sx),
// read in l_mode and ab_mode (Mode above); out:
// (height, width, 3) uint8, contiguous. The wrapper checks that every
// element offset fits in 32 bits. Returns cudaGetLastError().
extern "C" int ideepcolor_lab_to_rgb_u8(const void* l, int l_sy, int l_sx,
                                        const void* a, int a_sy, int a_sx,
                                        const void* b, int b_sy, int b_sx,
                                        int height, int width, int l_mode,
                                        int ab_mode, void* out, void* stream) {
  const Args g = args(l, l_sy, l_sx, a, a_sy, a_sx, b, b_sy, b_sx, height,
                      width, out, nullptr, nullptr, stream);
  switch (l_mode * 3 + ab_mode) {
    case kVec * 3 + kVec: return run<kVec, kVec, false>(g);
    case kVec * 3 + kAny: return run<kVec, kAny, false>(g);
    case kVec * 3 + kZero: return run<kVec, kZero, false>(g);
    case kAny * 3 + kAny: return run<kAny, kAny, false>(g);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The fused click entry: as above, plus ab_out (height, width, 2) f32,
// contiguous, the ab of out's own Lab; lut: 256 f32, srgb_to_linear(v/255).
// Modes (kVec, kVec) or (kAny, kAny).
extern "C" int ideepcolor_lab_to_rgb_u8_ab(
    const void* l, int l_sy, int l_sx, const void* a, int a_sy, int a_sx,
    const void* b, int b_sy, int b_sx, int height, int width, int l_mode,
    int ab_mode, void* out, void* ab_out, const void* lut, void* stream) {
  const Args g = args(l, l_sy, l_sx, a, a_sy, a_sx, b, b_sy, b_sx, height,
                      width, out, ab_out, lut, stream);
  switch (l_mode * 3 + ab_mode) {
    case kVec * 3 + kVec: return run<kVec, kVec, true>(g);
    case kAny * 3 + kAny: return run<kAny, kAny, true>(g);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The batched compose: frames x (height, width) planes, each addressed by
// element strides (sb, sy, sx) with sb the stride from one frame to the
// next; out: (frames, height, width, 3) uint8, contiguous; frames <= 65535.
// Modes as the compose entry's. Returns cudaGetLastError().
extern "C" int ideepcolor_lab_to_rgb_u8_batch(
    const void* l, int l_sb, int l_sy, int l_sx, const void* a, int a_sb,
    int a_sy, int a_sx, const void* b, int b_sb, int b_sy, int b_sx,
    int frames, int height, int width, int l_mode, int ab_mode, void* out,
    void* stream) {
  Args g = args(l, l_sy, l_sx, a, a_sy, a_sx, b, b_sy, b_sx, height, width,
                out, nullptr, nullptr, stream);
  g.l.sb = l_sb;
  g.a.sb = a_sb;
  g.b.sb = b_sb;
  g.frames = frames;
  switch (l_mode * 3 + ab_mode) {
    case kVec * 3 + kVec: return run<kVec, kVec, false>(g);
    case kVec * 3 + kAny: return run<kVec, kAny, false>(g);
    case kVec * 3 + kZero: return run<kVec, kZero, false>(g);
    case kAny * 3 + kAny: return run<kAny, kAny, false>(g);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
