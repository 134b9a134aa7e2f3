// K2: Lab -> clipped, truncated uint8 RGB compose for sm_90a.
//
// Replaces: ideepcolor_tpu/ops/pallas/colorspace_kernel.py
// lab_to_rgb_u8_planar (body _lab2rgb_u8_kernel; wrapper compose_frame_u8):
// Lab -> XYZ (D65) -> linear sRGB (3x3) -> sRGB gamma -> clip [0, 1] -> x255
// -> truncate to uint8.
//
// What bounds it on an H100: bytes. Each pixel reads three f32 (12 B) and
// writes three uint8 (3 B) for about 60 f32 operations, 4 operations per
// byte against the card's ~20 at its f32 rate, so the byte bound rules:
// 983 KB (~0.29 us at 3.35 TB/s) for the 256 x 256 click frame, 47 MB
// (~14 us) for a 2048 x 1536 full-resolution frame. The pow of the sRGB
// gamma runs on the SFU and is not the limit at this intensity.
//
// Design: one thread per pixel over a flat index, f32 throughout, with the
// Pallas kernel's chain. The three input planes are read through their
// own (row, column) element strides, so callers hand over the planes in the
// layout they already hold -- the U-Net's planar NCHW output, a channel of
// an interleaved (H, W, 3) Lab image, an (H, W, 2) ab view -- and nothing is
// copied into a planar buffer first. The frame is written interleaved
// (H, W, 3), the layout every consumer reads. A flat grid masks its own
// ragged tail, so the tile padding the Pallas wrapper needed for its VMEM
// budget has no counterpart here.
//
// Numerics: built without --use_fast_math (powf, not __powf: the fast pow
// moves the truncation boundary by more than 1 LSB). nvcc's default FMA
// contraction stays on, which is why the bar against the plain version is
// 1 LSB on fewer than 1e-3 of the pixels.

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
constexpr float kWX = 0.95047f, kWY = 1.0f, kWZ = 1.08883f;
constexpr float kKappa = 903.2963f;       // 24389 / 27
constexpr float kFinvEdge = 0.20689656f;  // 6 / 29
constexpr float kGamma = 0.41666666f;     // 1 / 2.4

__device__ __forceinline__ float finv(float ft) {
  return ft > kFinvEdge ? ft * ft * ft : (116.0f * ft - 16.0f) / kKappa;
}

__device__ __forceinline__ uint8_t to_u8(float lin) {
  const float safe = fmaxf(lin, 0.0f);
  float s = lin <= 0.0031308f ? lin * 12.92f
                              : 1.055f * powf(safe, kGamma) - 0.055f;
  s = fminf(fmaxf(s, 0.0f), 1.0f);
  return static_cast<uint8_t>(static_cast<int>(s * 255.0f));
}

__global__ void lab2rgb_u8_kernel(const float* __restrict__ l, int64_t l_sy,
                                  int64_t l_sx, const float* __restrict__ a,
                                  int64_t a_sy, int64_t a_sx,
                                  const float* __restrict__ b, int64_t b_sy,
                                  int64_t b_sx, int64_t height, int64_t width,
                                  uint8_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= height * width) return;
  const int64_t y = i / width, x = i - y * width;

  const float L = l[y * l_sy + x * l_sx];
  const float A = a[y * a_sy + x * a_sx];
  const float B = b[y * b_sy + x * b_sx];
  const float fy = (L + 16.0f) / 116.0f;
  const float fx = fy + A / 500.0f;
  const float fz = fy - B / 200.0f;
  const float X = finv(fx) * kWX;
  const float Y = finv(fy) * kWY;
  const float Z = finv(fz) * kWZ;

  uint8_t* o = out + 3 * i;
  o[0] = to_u8(kM00 * X + kM01 * Y + kM02 * Z);
  o[1] = to_u8(kM10 * X + kM11 * Y + kM12 * Z);
  o[2] = to_u8(kM20 * X + kM21 * Y + kM22 * Z);
}

constexpr int kThreads = 256;

}  // namespace

// l, a, b: f32 (height, width) planes addressed by element strides (sy, sx);
// out: (height, width, 3) uint8, contiguous. Returns cudaGetLastError().
extern "C" int ideepcolor_lab_to_rgb_u8(const void* l, int64_t l_sy,
                                        int64_t l_sx, const void* a,
                                        int64_t a_sy, int64_t a_sx,
                                        const void* b, int64_t b_sy,
                                        int64_t b_sx, int64_t height,
                                        int64_t width, void* out,
                                        void* stream) {
  const int64_t n = height * width;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  lab2rgb_u8_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(l), l_sy, l_sx, static_cast<const float*>(a),
      a_sy, a_sx, static_cast<const float*>(b), b_sy, b_sx, height, width,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
