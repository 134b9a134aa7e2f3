// K1: hint-table rasterizer for sm_90a.
//
// Replaces: ideepcolor_tpu/ops/pallas/hints_kernel.py rasterize_hints_pallas
// (body _raster_kernel), which replays the live hints over (tile, S) slabs
// with predicated overwrites.
//
// What bounds it on an H100: at the main path's shape (S = 256, a few to a
// few hundred live hints) the kernel writes S*S*3 f32 (786 KB) and reads at
// most 24 B per live hint, so the byte bound is ~0.24 us at 3.35 TB/s; the
// box tests are up to 4 integer compares per (pixel, hint) scanned, which
// only passes the byte bound when hundreds of hints are live. Either way
// the launch itself (a few us) dominates; this kernel does not try to hide
// it (CUDA-graph capture of the whole click is the tool for that).
//
// Design: one thread per output pixel, 16x16 pixels per block. The block
// stages the live part of the table in shared memory (24 B per hint, at most
// 6 KB for the 256-slot table) so every thread's scan reads shared memory,
// not device memory. Each thread scans from slot count-1 down and stops at
// the first box that covers it: that is last-hint-wins with an early exit,
// and it writes exactly the value the plain version selects, so the two
// are bit-exact. The box test is plain int compares against the inclusive
// corners, with no clipping, so boxes with negative corners or corners past
// S behave as in the JAX compare. Output is planar f32, (3, S, S): planes
// 0 and 1 are ab, plane 2 is the mask, which is the channel order the U-Net
// input concatenates (ab, mask) and needs no transpose.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBlock = 16;

__global__ void raster_kernel(const int4* __restrict__ boxes,
                              const float2* __restrict__ values, int count,
                              int size, float* __restrict__ out) {
  extern __shared__ int4 smem[];
  int4* s_box = smem;                                       // count x 16 B
  float2* s_val = reinterpret_cast<float2*>(smem + count);  // count x 8 B

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = tid; k < count; k += blockDim.x * blockDim.y) {
    s_box[k] = boxes[k];
    s_val[k] = values[k];
  }
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= size || y >= size) return;

  float a = 0.f, b = 0.f, m = 0.f;
  for (int k = count - 1; k >= 0; --k) {
    const int4 bx = s_box[k];                  // [y1, x1, y2, x2] inclusive
    if (y >= bx.x && x >= bx.y && y <= bx.z && x <= bx.w) {
      const float2 v = s_val[k];
      a = v.x;
      b = v.y;
      m = 1.f;
      break;
    }
  }
  const int64_t plane = static_cast<int64_t>(size) * size;
  const int64_t p = static_cast<int64_t>(y) * size + x;
  out[p] = a;
  out[plane + p] = b;
  out[2 * plane + p] = m;
}

}  // namespace

// boxes: (count, 4) int32, 16-byte aligned; values: (count, 2) f32, 8-byte
// aligned; count already clamped to [0, M] by the caller; out: (3, size,
// size) f32. Returns cudaGetLastError() after the launch.
extern "C" int ideepcolor_rasterize_hints(const void* boxes,
                                          const void* values, int count,
                                          int size, void* out,
                                          void* stream) {
  const dim3 block(kBlock, kBlock);
  const dim3 grid((size + kBlock - 1) / kBlock, (size + kBlock - 1) / kBlock);
  const size_t smem = static_cast<size_t>(count) * (sizeof(int4) + sizeof(float2));
  raster_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(boxes), static_cast<const float2*>(values),
      count, size, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
