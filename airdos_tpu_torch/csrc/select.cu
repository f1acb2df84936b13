// Keypoint selection of every pyramid level of one image in one launch,
// for sm_90a: the per-cell best corner and the spatially fair top-quota.
//
// Replaces airdos_tpu/features/orb.py:74 _select_level_keypoints, the
// shape-static form of the reference's DistributeOctTree (a reshape into
// cells, argmax, a per-block argsort and lax.top_k).  The port's plain
// version is ops/select.py select_level_ref, ~30 torch launches a level.
// For level l, with detection map s (ops/fast.fast_nms: thresholded and
// non-max suppressed), quota q and cell size c:
//
//   sel       = s + 1000 where s > ini_th, else s (the high-threshold boost);
//   best[cell], at[cell] = the largest sel of each c x c cell (the level
//               zero-padded to whole cells) and the first position of it
//               in the cell's row-major order (torch.max(dim), jnp.argmax);
//   rank[cell] = its place among the 16 cells of its 4 x 4-cell block by
//               best descending, ties to the earlier cell (a stable sort),
//               or 16 where best = 0 (empty cells last);
//   key       = best - rank * 2000;
//   the first min(q, cells) cells by key descending, ties to the lower
//               cell index (a stable sort), each giving x, y = its corner's
//               position and response = remainder(best, 1000) (0 for an
//               empty cell); slots past the cells are 0.
//
// One block of 1024 threads a level (its map is at most a few hundred
// thousand pixels and its cells a few thousand):
// - a warp a cell scans the cell's pixels in row-major order, each lane
//   keeping its first maximum, then a shuffle tree keeps the larger value
//   and, on a tie, the lower position;
// - a thread a cell counts its rank over its block's 16 cells;
// - the keys, made unique by the cell index, are sorted in shared memory
//   by a bitonic network over 64-bit words: the key's bits mapped so that
//   the unsigned order is the float order, complemented (descending), in
//   the high half, the cell index in the low half (ascending on ties).
//   Distinct words make the network's order the stable sort's.
//
// Exact: the boost and the key are the plain version's float32 sum and
// difference (written with __fadd_rn / __fsub_rn / __fmul_rn), every other
// step is a comparison, and remainder(best, 1000) is fmodf with torch's
// sign fix-up (torch.remainder on float32 is fmod-based, and fmod is exact;
// for 0 <= best < 2000 it equals best - 1000 * floor(best / 1000) too).
// So xs, ys and the responses are bit-equal to the plain version's.
//
// What bounds it on an H100.  Bytes: the maps read once (4 bytes a pixel,
// 0.92 MB at 640 x 360 over 8 levels), 20 bytes a slot written; ~0.3 us.
// Operations: a comparison a pixel and the sort's ~(log2 P)^2 / 2 * P / 2
// comparisons for P cells rounded up to a power of two: negligible.  The
// grid is one block a level, so the level-0 block's scan (one SM reading
// ~230 k pixels) and the sort's barriers set the time.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 4;                 // cells a block edge
constexpr float kBoost = 1000.0f;         // ops/select.py INI_BOOST

struct Levels {
  const float* s[kMaxLevels];
  int h[kMaxLevels], w[kMaxLevels];
  int quota[kMaxLevels], cell[kMaxLevels], offset[kMaxLevels];
};

// float -> uint32 whose unsigned order is the float order (no NaN here)
__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t b = __float_as_uint(__fadd_rn(f, 0.0f));  // -0 -> +0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
select_kernel(Levels lv, float ini_th, int64_t* __restrict__ xs,
              int64_t* __restrict__ ys, float* __restrict__ resp) {
  extern __shared__ unsigned long long smem[];
  const int l = blockIdx.x;
  const int h = lv.h[l], w = lv.w[l], q = lv.quota[l], c = lv.cell[l];
  const int ncy = (h + c - 1) / c, ncx = (w + c - 1) / c;
  const int n = ncy * ncx;
  int p = 1;
  while (p < n) p <<= 1;
  unsigned long long* keys = smem;                         // [p]
  float* best = reinterpret_cast<float*>(smem + p);        // [n]
  int* at = reinterpret_cast<int*>(best + n);              // [n]
  const float* __restrict__ s = lv.s[l];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int cell = warp; cell < n; cell += kWarps) {
    const int cy = cell / ncx, cx = cell - (cell / ncx) * ncx;
    float v = -1.0f;
    int i = 0;
    for (int j = lane; j < c * c; j += 32) {
      const int y = cy * c + j / c, x = cx * c + j % c;
      float t = 0.0f;                     // the zero padding to whole cells
      if (y < h && x < w) {
        t = s[static_cast<int64_t>(y) * w + x];
        t = t > ini_th ? __fadd_rn(t, kBoost) : t;
      }
      if (t > v) { v = t; i = j; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
    }
    if (lane == 0) { best[cell] = v; at[cell] = i; }
  }
  __syncthreads();

  for (int cell = tid; cell < p; cell += kThreads) {
    unsigned long long word = ~0ull;      // past the cells: sorted last
    if (cell < n) {
      const int cy = cell / ncx, cx = cell - (cell / ncx) * ncx;
      const float b = best[cell];
      int rank = kBlock * kBlock;
      if (b > 0.0f) {
        const int by = cy - cy % kBlock, bx = cx - cx % kBlock;
        const int me = (cy - by) * kBlock + (cx - bx);
        rank = 0;
        for (int k = 0; k < kBlock * kBlock; ++k) {
          const int y = by + k / kBlock, x = bx + k % kBlock;
          if (y >= ncy || x >= ncx) continue;        // padded cells are 0
          const float o = best[y * ncx + x];
          rank += (o > b || (o == b && k < me)) ? 1 : 0;
        }
      }
      const float key = __fsub_rn(b, __fmul_rn(static_cast<float>(rank),
                                               2.0f * kBoost));
      word = (static_cast<unsigned long long>(~ordered(key)) << 32) |
             static_cast<unsigned int>(cell);
    }
    keys[cell] = word;
  }
  __syncthreads();

  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < p; i += kThreads) {
        const int o = i ^ j;
        if (o > i) {
          const unsigned long long a = keys[i], b = keys[o];
          if ((a > b) == ((i & k) == 0)) { keys[i] = b; keys[o] = a; }
        }
      }
      __syncthreads();
    }
  }

  const int k = min(q, n);
  for (int i = tid; i < q; i += kThreads) {
    const int64_t slot = lv.offset[l] + i;
    int64_t x = 0, y = 0;
    float r = 0.0f;
    if (i < k) {
      const int cell = static_cast<int>(keys[i] & 0xffffffffu);
      const int cy = cell / ncx, cx = cell - (cell / ncx) * ncx;
      y = static_cast<int64_t>(cy) * c + at[cell] / c;
      x = static_cast<int64_t>(cx) * c + at[cell] % c;
      const float b = best[cell];
      if (b > 0.0f) {
        r = fmodf(b, kBoost);             // b > 0: no sign fix-up
      }
    }
    xs[slot] = x;
    ys[slot] = y;
    resp[slot] = r;
  }
}

}  // namespace

// maps: n_levels host pointers to device [h, w] float32 row-major
// detection maps; h, w, quota, cell, offset: n_levels host ints (offset:
// the level's first slot); xs, ys: int64 and resp: float32 device outputs
// of sum(quota) slots; smem: the dynamic shared memory of the level with the
// most cells, n: 8 bytes a sort word (n rounded up to a power of two) and 8
// a cell for its best value and position (ops/select.py smem_bytes).
extern "C" int airdos_select(const int64_t* maps, const int* h, const int* w,
                             const int* quota, const int* cell,
                             const int* offset, int n_levels, float ini_th,
                             void* xs, void* ys, void* resp, int smem,
                             void* stream) {
  if (n_levels <= 0 || n_levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  for (int i = 0; i < n_levels; ++i) {
    lv.s[i] = reinterpret_cast<const float*>(maps[i]);
    lv.h[i] = h[i];
    lv.w[i] = w[i];
    lv.quota[i] = quota[i];
    lv.cell[i] = cell[i];
    lv.offset[i] = offset[i];
  }
  cudaError_t err = cudaFuncSetAttribute(
      select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  select_kernel<<<n_levels, kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      lv, ini_th, static_cast<int64_t*>(xs), static_cast<int64_t*>(ys),
      static_cast<float*>(resp));
  return static_cast<int>(cudaGetLastError());
}
