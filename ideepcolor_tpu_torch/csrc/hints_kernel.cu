// K1: hint-table rasterizer for sm_90a.
//
// Replaces: ideepcolor_tpu/ops/pallas/hints_kernel.py rasterize_hints_pallas
// (body _raster_kernel), which replays the live hints over (tile, S) slabs
// with predicated overwrites.
//
// What bounds it on an H100: bytes. At the main path's shape (S = 256, a
// few to a few hundred live hints) the function writes S*S*3 f32 (786 KB)
// and reads 24 B per live hint and the count: ~0.24 us at 3.35 TB/s. At
// that size the launch itself (a few us) dominates; CUDA-graph capture of
// the whole click is the tool for that, not this kernel.
//
// Design: cull per tile, then scan. A block owns an 8 x 64 tile of the
// output, 128 threads of four consecutive pixels of a row each.
// - Cull: the block tests every live slot's box against the tile's
//   rectangle and compacts the slots that touch it, in slot order, into
//   shared memory with their values (a warp ballot and popc give each hit
//   its place; per-warp counts give each warp its offset). With boxes of
//   radius <= 12, a tile sees about ten of 200 live hints.
// - Scan: each thread scans only that list, from its end, and stops when
//   all four of its pixels are covered. The first cover from the end is the
//   last covering live slot: the value the plain version's reversed argmax
//   selects, so the two are bit-exact. Box tests are plain int compares
//   against the inclusive corners, with no clipping, so boxes with negative
//   corners or corners past S behave as in the JAX compare.
// - Store: one float4 to each of the three planes when S is a multiple of 4
//   (every group then starts on 16 bytes); other sizes store the four
//   pixels one by one in the same kernel.
// Output is planar f32, (3, S, S): planes 0 and 1 are ab, plane 2 the mask,
// the channel order the U-Net input concatenates (ab, mask).
//
// Two entries share that body. The first takes the live count by value and
// sizes the culled list's shared memory from it. The second, the batched
// entry, takes N tables and N counts that lie in device memory, with the
// table on the grid's z axis: (N, M, 4) boxes, (N, M, 2) values and (N,)
// counts give (N, 3, S, S) in one launch. It reads each count where the
// kernel runs (clamped to [0, M]) and sizes shared memory for all M slots
// (256 x 24 B), so one captured CUDA graph serves every count, as the
// Pallas kernel takes the count as a traced scalar. With N = 1 it is the
// captured clicks' rasterizer; with N > 1 the batch engine's.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kTileRows = 8;
constexpr int kTileCols = 64;
constexpr int kGroupsPerRow = kTileCols / 4;
constexpr int kThreads = kTileRows * kGroupsPerRow;  // 128
constexpr int kWarps = kThreads / 32;

// One table into one (3, size, size) output. capacity >= count is the
// number of slots the dynamic shared memory was sized for.
__device__ __forceinline__ void raster_tile(const int4* __restrict__ boxes,
                                            const float2* __restrict__ values,
                                            int count, int capacity, int size,
                                            float* __restrict__ out) {
  extern __shared__ int4 smem[];
  int4* s_box = smem;                                          // x 16 B
  float2* s_val = reinterpret_cast<float2*>(smem + capacity);  // x 8 B
  __shared__ int s_hits[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty0 = blockIdx.y * kTileRows, tx0 = blockIdx.x * kTileCols;
  const int ty1 = min(ty0 + kTileRows, size) - 1;
  const int tx1 = min(tx0 + kTileCols, size) - 1;

  // cull: the slots whose box touches the tile, compacted in slot order
  int n = 0;
  for (int base = 0; base < count; base += kThreads) {
    const int k = base + tid;
    int4 bx = make_int4(0, 0, -1, -1);
    bool hit = false;
    if (k < count) {
      bx = boxes[k];  // [y1, x1, y2, x2] inclusive
      hit = bx.x <= ty1 && bx.z >= ty0 && bx.y <= tx1 && bx.w >= tx0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_hits[warp] = __popc(ballot);
    __syncthreads();
    int at = n, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? s_hits[w] : 0;
      total += s_hits[w];
    }
    if (hit) {
      at += __popc(ballot & ((1u << lane) - 1u));
      s_box[at] = bx;
      s_val[at] = values[k];
    }
    n += total;
    __syncthreads();  // the list is complete; s_hits is free again
  }

  // scan: last covering slot of the list for each of four pixels
  const int y = ty0 + tid / kGroupsPerRow;
  const int x0 = tx0 + 4 * (tid % kGroupsPerRow);
  if (y >= size || x0 >= size) return;
  float a[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f},
        m[4] = {0.f, 0.f, 0.f, 0.f};
  unsigned todo = size - x0 >= 4 ? 0xfu : (1u << (size - x0)) - 1u;
  for (int k = n - 1; k >= 0 && todo; --k) {
    const int4 bx = s_box[k];
    if (y < bx.x || y > bx.z) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((todo >> j & 1u) && x0 + j >= bx.y && x0 + j <= bx.w) {
        const float2 v = s_val[k];
        a[j] = v.x;
        b[j] = v.y;
        m[j] = 1.f;
        todo &= ~(1u << j);
      }
    }
  }

  const int plane = size * size;
  const int p = y * size + x0;
  if ((size & 3) == 0) {
    *reinterpret_cast<float4*>(out + p) = make_float4(a[0], a[1], a[2], a[3]);
    *reinterpret_cast<float4*>(out + plane + p) =
        make_float4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<float4*>(out + 2 * plane + p) =
        make_float4(m[0], m[1], m[2], m[3]);
    return;
  }
  for (int j = 0; j < 4 && x0 + j < size; ++j) {
    out[p + j] = a[j];
    out[plane + p + j] = b[j];
    out[2 * plane + p + j] = m[j];
  }
}

__global__ void __launch_bounds__(kThreads)
    raster_kernel(const int4* __restrict__ boxes,
                  const float2* __restrict__ values, int count, int size,
                  float* __restrict__ out) {
  raster_tile(boxes, values, count, count, size, out);
}

__global__ void __launch_bounds__(kThreads)
    raster_batch_kernel(const int4* __restrict__ boxes,
                        const float2* __restrict__ values,
                        const int* __restrict__ counts, int slots, int size,
                        float* __restrict__ out) {
  const int n = blockIdx.z;
  const int count = min(max(counts[n], 0), slots);
  raster_tile(boxes + static_cast<size_t>(n) * slots,
              values + static_cast<size_t>(n) * slots, count, slots, size,
              out + static_cast<size_t>(n) * 3 * size * size);
}

}  // namespace

// boxes: (count, 4) int32, 16-byte aligned; values: (count, 2) f32, 8-byte
// aligned; count already clamped to [0, M] by the caller; out: (3, size,
// size) f32, 16-byte aligned, 3 * size * size < 2^31. Returns
// cudaGetLastError() after the launch.
extern "C" int ideepcolor_rasterize_hints(const void* boxes,
                                          const void* values, int count,
                                          int size, void* out,
                                          void* stream) {
  const dim3 grid((size + kTileCols - 1) / kTileCols,
                  (size + kTileRows - 1) / kTileRows);
  const size_t smem =
      static_cast<size_t>(count) * (sizeof(int4) + sizeof(float2));
  raster_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(boxes), static_cast<const float2*>(values),
      count, size, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The batched, device-count entry. boxes: (n, slots, 4) int32, 16-byte
// aligned; values: (n, slots, 2) f32, 8-byte aligned; counts: (n,) int32 in
// device memory, read by the kernel and clamped to [0, slots]; out: (n, 3,
// size, size) f32, 16-byte aligned, 3 * size * size < 2^31, n <= 65535,
// slots * 24 B within a block's 48 KB. Returns cudaGetLastError().
extern "C" int ideepcolor_rasterize_hints_batch(const void* boxes,
                                                const void* values,
                                                const void* counts, int n,
                                                int slots, int size,
                                                void* out, void* stream) {
  const dim3 grid((size + kTileCols - 1) / kTileCols,
                  (size + kTileRows - 1) / kTileRows, n);
  const size_t smem =
      static_cast<size_t>(slots) * (sizeof(int4) + sizeof(float2));
  raster_batch_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(boxes), static_cast<const float2*>(values),
      static_cast<const int*>(counts), slots, size, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
