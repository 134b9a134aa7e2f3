// Native host-side ops of the PyTorch/CUDA port (ideepcolor_tpu_torch).
//
// The port's own copy of ideepcolor_tpu/native/hostops.cpp, with the same
// exported symbols and the same arithmetic, so the two libraries give the
// same bytes for the same inputs. It is the port's CPU runtime, not a GPU
// kernel: colorspace transforms, hint rasterization and banded resampling
// as OpenMP-parallel loops, built with g++ and called through ctypes by
// ideepcolor_tpu_torch/ops/host.py, for the numpy hint mirrors of every
// click, the host-composed window and abq frames, and host Lab
// conversions. The reference delegates the same work to Caffe's C++
// engine and to cv2/skimage/scipy C internals (ref
// data/colorize_image.py:54-58 cv2.resize, :27-36 skimage lab<->rgb,
// ui/ui_control.py:61-63 cv2.rectangle).
//
// Numerics: sRGB (IEC 61966-2-1), D65 2-degree observer, Lab f/finv with
// kappa = 24389/27.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr double kXYZ2RGB[3][3] = {
    {3.240454162114109, -1.5371385127977184, -0.49853140955601616},
    {-0.9692660305051904, 1.876010845446696, 0.041556017530349584},
    {0.05564343095911613, -0.2040259135167545, 1.0572251882231787}};
constexpr double kRGB2XYZ[3][3] = {
    {0.412456439089692, 0.357576077643909, 0.180437483266399},
    {0.212672851405623, 0.715152155287818, 0.072174993306560},
    {0.019333895582329, 0.119192025881303, 0.950304078536368}};
constexpr double kWhite[3] = {0.95047, 1.0, 1.08883};
constexpr double kKappa = 24389.0 / 27.0;
constexpr double kEps = 216.0 / 24389.0;

inline double srgb_to_linear(double v) {
  return v <= 0.04045 ? v / 12.92 : std::pow((v + 0.055) / 1.055, 2.4);
}

inline double linear_to_srgb(double v) {
  return v <= 0.0031308 ? v * 12.92
                        : 1.055 * std::pow(std::max(v, 0.0), 1.0 / 2.4) -
                              0.055;
}

inline double lab_f(double t) {
  return t > kEps ? std::cbrt(t) : (kKappa * t + 16.0) / 116.0;
}

inline double lab_finv(double ft) {
  return ft > 6.0 / 29.0 ? ft * ft * ft : (116.0 * ft - 16.0) / kKappa;
}

// ---- LUT fast paths (the per-pixel pow() calls dominate the window
// compose) ----

// Exact 256-entry LUT: srgb_to_linear(v/255) for uint8 inputs.
struct U8LinearLut {
  double t[256];
  U8LinearLut() {
    for (int i = 0; i < 256; ++i) t[i] = srgb_to_linear(i / 255.0);
  }
};
const U8LinearLut& u8_linear_lut() {
  static const U8LinearLut lut;   // thread-safe static init
  return lut;
}

// linear -> srgb gamma encode via a sqrt-indexed LUT + lerp. Indexing by
// u = sqrt(v) bounds the curve's derivative over the LUT domain (the pow
// branch only applies for v > 0.0031308; the linear branch is computed
// exactly), so 4096 entries give ~3e-8 abs error — far below the 1/255
// uint8 quantization step.
constexpr int kGammaLutN = 4096;
struct GammaLut {
  double t[kGammaLutN + 2];
  GammaLut() {
    for (int i = 0; i <= kGammaLutN + 1; ++i) {
      const double u = std::min(double(i) / kGammaLutN, 1.0);
      t[i] = 1.055 * std::pow(u, 2.0 / 2.4) - 0.055;
    }
  }
};
const GammaLut& gamma_lut() {
  static const GammaLut lut;
  return lut;
}

inline double linear_to_srgb_fast(double v) {
  if (v <= 0.0031308) return v * 12.92;
  if (v >= 1.0) return 1.0;
  const double x = std::sqrt(v) * kGammaLutN;
  const int i = int(x);
  const double f = x - i;
  const double* t = gamma_lut().t;
  return t[i] + (t[i + 1] - t[i]) * f;
}

}  // namespace

extern "C" {

// rgb (N,3) float32 in [0,1] -> lab (N,3) float32.
void rgb2lab_f32(const float* rgb, float* lab, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    double lin[3], xyz[3];
    for (int c = 0; c < 3; ++c) lin[c] = srgb_to_linear(rgb[3 * i + c]);
    for (int c = 0; c < 3; ++c)
      xyz[c] = kRGB2XYZ[c][0] * lin[0] + kRGB2XYZ[c][1] * lin[1] +
               kRGB2XYZ[c][2] * lin[2];
    const double fx = lab_f(xyz[0] / kWhite[0]);
    const double fy = lab_f(xyz[1] / kWhite[1]);
    const double fz = lab_f(xyz[2] / kWhite[2]);
    lab[3 * i + 0] = static_cast<float>(116.0 * fy - 16.0);
    lab[3 * i + 1] = static_cast<float>(500.0 * (fx - fy));
    lab[3 * i + 2] = static_cast<float>(200.0 * (fy - fz));
  }
}

// lab (N,3) float32 -> rgb (N,3) float32 clipped to [0,1].
void lab2rgb_f32(const float* lab, float* rgb, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const double fy = (lab[3 * i + 0] + 16.0) / 116.0;
    const double fx = fy + lab[3 * i + 1] / 500.0;
    const double fz = fy - lab[3 * i + 2] / 200.0;
    const double xyz[3] = {lab_finv(fx) * kWhite[0], lab_finv(fy) * kWhite[1],
                           lab_finv(fz) * kWhite[2]};
    for (int c = 0; c < 3; ++c) {
      double v = kXYZ2RGB[c][0] * xyz[0] + kXYZ2RGB[c][1] * xyz[1] +
                 kXYZ2RGB[c][2] * xyz[2];
      v = linear_to_srgb(v);
      rgb[3 * i + c] = static_cast<float>(std::min(std::max(v, 0.0), 1.0));
    }
  }
}

// Fused lab (N,3) -> uint8 rgb (N,3), reference truncation semantics
// ((clip(rgb,0,1)*255).astype(uint8), ref data/colorize_image.py:27).
void lab2rgb_u8(const float* lab, uint8_t* out, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const double fy = (lab[3 * i + 0] + 16.0) / 116.0;
    const double fx = fy + lab[3 * i + 1] / 500.0;
    const double fz = fy - lab[3 * i + 2] / 200.0;
    const double xyz[3] = {lab_finv(fx) * kWhite[0], lab_finv(fy) * kWhite[1],
                           lab_finv(fz) * kWhite[2]};
    for (int c = 0; c < 3; ++c) {
      double v = kXYZ2RGB[c][0] * xyz[0] + kXYZ2RGB[c][1] * xyz[1] +
                 kXYZ2RGB[c][2] * xyz[2];
      // LUT gamma encode (~3e-8 abs error, far below the 1/255 step the
      // truncation below quantizes to)
      v = std::min(std::max(linear_to_srgb_fast(v), 0.0), 1.0);
      out[3 * i + c] = static_cast<uint8_t>(v * 255.0);
    }
  }
}

// uint8 rgb (N,3) -> lab (N,3) float32. Exact (the 256-entry
// linearization LUT is exact for uint8 inputs; cbrt stays analytic) and
// several times faster than rgb2lab_f32's per-pixel pow.
void rgb2lab_u8f(const uint8_t* rgb, float* lab, int64_t n) {
  const double* lin_lut = u8_linear_lut().t;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    double lin[3], xyz[3];
    for (int c = 0; c < 3; ++c) lin[c] = lin_lut[rgb[3 * i + c]];
    for (int c = 0; c < 3; ++c)
      xyz[c] = kRGB2XYZ[c][0] * lin[0] + kRGB2XYZ[c][1] * lin[1] +
               kRGB2XYZ[c][2] * lin[2];
    const double fx = lab_f(xyz[0] / kWhite[0]);
    const double fy = lab_f(xyz[1] / kWhite[1]);
    const double fz = lab_f(xyz[2] / kWhite[2]);
    lab[3 * i + 0] = static_cast<float>(116.0 * fy - 16.0);
    lab[3 * i + 1] = static_cast<float>(500.0 * (fx - fy));
    lab[3 * i + 2] = static_cast<float>(200.0 * (fy - fz));
  }
}

// Planar Lab -> interleaved uint8 RGB: l (N,), a (N,), b (N,) -> out
// (N,3). Fused variant for the host window compose: takes the zoom
// outputs directly as planes, so no interleaved Lab array is ever
// materialized. Same truncation semantics as lab2rgb_u8.
//
// float arithmetic throughout: the largest relative error (~1e-6 at the
// gamma encode) is ~4000x below the 1/255 quantization step the final
// truncation lands on, and the hot consumer (the per-click window
// compose) is latency-critical — float halves both the ALU cost and the
// LUT/accumulator bandwidth against the double path. The tests hold this
// path within 1 uint8 LSB of the device (f32) compose.
void lab2rgb_u8_planar(const float* l, const float* a, const float* b,
                       uint8_t* out, int64_t n) {
  const double* gt = gamma_lut().t;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const float fy = (l[i] + 16.0f) * (1.0f / 116.0f);
    const float fx = fy + a[i] * (1.0f / 500.0f);
    const float fz = fy - b[i] * (1.0f / 200.0f);
    const float f3[3] = {fx, fy, fz};
    float xyz[3];
    for (int c = 0; c < 3; ++c) {
      const float ft = f3[c];
      xyz[c] = float(kWhite[c]) *
               (ft > float(6.0 / 29.0)
                    ? ft * ft * ft
                    : (116.0f * ft - 16.0f) * float(1.0 / kKappa));
    }
    for (int c = 0; c < 3; ++c) {
      float v = float(kXYZ2RGB[c][0]) * xyz[0] +
                float(kXYZ2RGB[c][1]) * xyz[1] +
                float(kXYZ2RGB[c][2]) * xyz[2];
      float s;
      if (v <= 0.0031308f) {
        s = std::max(v * 12.92f, 0.0f);
      } else if (v >= 1.0f) {
        s = 1.0f;
      } else {
        const float x = std::sqrt(v) * kGammaLutN;
        const int j = int(x);
        const float f = x - j;
        s = float(gt[j]) + (float(gt[j + 1]) - float(gt[j])) * f;
      }
      out[3 * i + c] = static_cast<uint8_t>(
          std::min(std::max(s, 0.0f), 1.0f) * 255.0f);
    }
  }
}

// uint8 rgb (N,3) -> PLANAR a/b float32 planes, skipping L entirely:
// the host window compose only needs the requantized ab (the window L
// plane is already on the host), so this saves the interleaved Lab
// write + two strided de-interleave copies + a third of the transform.
void rgb2lab_u8_ab_planar(const uint8_t* rgb, float* a, float* b,
                          int64_t n) {
  const double* lin_lut = u8_linear_lut().t;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float lin[3], xyz[3];
    for (int c = 0; c < 3; ++c) lin[c] = float(lin_lut[rgb[3 * i + c]]);
    for (int c = 0; c < 3; ++c)
      xyz[c] = float(kRGB2XYZ[c][0]) * lin[0] +
               float(kRGB2XYZ[c][1]) * lin[1] +
               float(kRGB2XYZ[c][2]) * lin[2];
    float f3[3];
    for (int c = 0; c < 3; ++c) {
      const float t = xyz[c] * float(1.0 / kWhite[c]);
      f3[c] = t > float(kEps) ? std::cbrt(t)
                              : (float(kKappa) * t + 16.0f) *
                                    (1.0f / 116.0f);
    }
    a[i] = 500.0f * (f3[0] - f3[1]);
    b[i] = 200.0f * (f3[1] - f3[2]);
  }
}

// Rasterize hint boxes into dense ab (H,W,2) + mask (H,W) planes.
// boxes: (m,4) int32 [y1,x1,y2,x2] inclusive; values: (m,2) float32.
// Later boxes overwrite earlier ones (cv2.rectangle loop semantics,
// ref ui/ui_control.py:177-187).
void rasterize_hints(const int32_t* boxes, const float* values, int32_t m,
                     int32_t h, int32_t w, float* ab, float* mask) {
  std::memset(ab, 0, sizeof(float) * 2 * h * w);
  std::memset(mask, 0, sizeof(float) * h * w);
  for (int32_t i = 0; i < m; ++i) {
    const int32_t y1 = std::max(boxes[4 * i + 0], 0);
    const int32_t x1 = std::max(boxes[4 * i + 1], 0);
    const int32_t y2 = std::min(boxes[4 * i + 2], h - 1);
    const int32_t x2 = std::min(boxes[4 * i + 3], w - 1);
    const float a = values[2 * i], b = values[2 * i + 1];
    for (int32_t y = y1; y <= y2; ++y) {
      for (int32_t x = x1; x <= x2; ++x) {
        ab[2 * (y * w + x) + 0] = a;
        ab[2 * (y * w + x) + 1] = b;
        mask[y * w + x] = 1.0f;
      }
    }
  }
}

// Align-corners bilinear resize, (h,w,c) -> (H,W,c), scipy zoom order=1
// semantics (ref data/colorize_image.py:123-131 full-res path).
void zoom_bilinear_f32(const float* in, int32_t h, int32_t w, int32_t c,
                       float* out, int32_t H, int32_t W) {
  const double sy = H > 1 && h > 1 ? double(h - 1) / double(H - 1) : 0.0;
  const double sx = W > 1 && w > 1 ? double(w - 1) / double(W - 1) : 0.0;
#pragma omp parallel for schedule(static)
  for (int32_t Y = 0; Y < H; ++Y) {
    const double fy = Y * sy;
    const int32_t y0 = std::min(int32_t(fy), h - 1);
    const int32_t y1 = std::min(y0 + 1, h - 1);
    const double wy = fy - y0;
    for (int32_t X = 0; X < W; ++X) {
      const double fx = X * sx;
      const int32_t x0 = std::min(int32_t(fx), w - 1);
      const int32_t x1 = std::min(x0 + 1, w - 1);
      const double wx = fx - x0;
      for (int32_t ch = 0; ch < c; ++ch) {
        const double v00 = in[(y0 * w + x0) * c + ch];
        const double v01 = in[(y0 * w + x1) * c + ch];
        const double v10 = in[(y1 * w + x0) * c + ch];
        const double v11 = in[(y1 * w + x1) * c + ch];
        out[(Y * W + X) * c + ch] = static_cast<float>(
            (1 - wy) * ((1 - wx) * v00 + wx * v01) +
            wy * ((1 - wx) * v10 + wx * v11));
      }
    }
  }
}

// Separable resize of two (S,S) planes through dense row-banded
// interpolation matrices: out_c = rh @ X_c @ rw^T, c in {a, b}.
//
// The cubic/linear data-resize matrices (ops/resize.py) have <= 4
// nonzeros per row, so a dense per-channel GEMM chain (rh @ X @ rw^T,
// ~200 MFLOP at 512 px) does ~64x more work than the information
// content. This loop detects each row's nonzero band once and applies
// the same contraction with only the banded terms (double accumulators,
// so it is at least as accurate as an f32 BLAS product; output stays
// within f32 rounding of the dense product). Falls back to full rows automatically when a
// matrix is not banded (band detection just finds first/last nonzero).
void zoom2_banded_f32(const float* rh, int32_t H, const float* rw,
                      int32_t W, const float* xa, const float* xb,
                      int32_t S, float* oa, float* ob) {
  struct Band { int32_t start, len; };
  auto detect = [S](const float* m, int32_t rows, Band* bands) {
    for (int32_t i = 0; i < rows; ++i) {
      const float* row = m + int64_t(i) * S;
      int32_t lo = 0, hi = S - 1;
      while (lo < S && row[lo] == 0.0f) ++lo;
      while (hi >= lo && row[hi] == 0.0f) --hi;
      bands[i] = {lo, hi < lo ? 0 : hi - lo + 1};
    }
  };
  Band* hb = new Band[H];
  Band* wb = new Band[W];
  detect(rh, H, hb);
  detect(rw, W, wb);
  // tmp_c = X_c @ rw^T, (S, W)
  float* ta = new float[int64_t(S) * W];
  float* tb = new float[int64_t(S) * W];
#pragma omp parallel for schedule(static)
  for (int32_t s = 0; s < S; ++s) {
    const float* xrow_a = xa + int64_t(s) * S;
    const float* xrow_b = xb + int64_t(s) * S;
    for (int32_t y = 0; y < W; ++y) {
      const float* wrow = rw + int64_t(y) * S + wb[y].start;
      const float* va = xrow_a + wb[y].start;
      const float* vb = xrow_b + wb[y].start;
      double acc_a = 0.0, acc_b = 0.0;
      for (int32_t k = 0; k < wb[y].len; ++k) {
        acc_a += double(wrow[k]) * va[k];
        acc_b += double(wrow[k]) * vb[k];
      }
      ta[int64_t(s) * W + y] = float(acc_a);
      tb[int64_t(s) * W + y] = float(acc_b);
    }
  }
  // out_c = rh @ tmp_c, (H, W); double row accumulators
#pragma omp parallel for schedule(static)
  for (int32_t i = 0; i < H; ++i) {
    const float* hrow = rh + int64_t(i) * S;
    std::vector<double> acc_a(W, 0.0), acc_b(W, 0.0);
    for (int32_t k = 0; k < hb[i].len; ++k) {
      const int32_t s = hb[i].start + k;
      const double h = hrow[s];
      const float* trow_a = ta + int64_t(s) * W;
      const float* trow_b = tb + int64_t(s) * W;
      for (int32_t y = 0; y < W; ++y) {
        acc_a[y] += h * trow_a[y];
        acc_b[y] += h * trow_b[y];
      }
    }
    float* out_a = oa + int64_t(i) * W;
    float* out_b = ob + int64_t(i) * W;
    for (int32_t y = 0; y < W; ++y) out_a[y] = float(acc_a[y]);
    for (int32_t y = 0; y < W; ++y) out_b[y] = float(acc_b[y]);
  }
  delete[] ta;
  delete[] tb;
  delete[] hb;
  delete[] wb;
}

int num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
