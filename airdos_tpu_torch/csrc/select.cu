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
// A thread block cluster of kCluster blocks of kThreads threads a level
// (the cluster is the kernel's __cluster_dims__, so the launch is an
// ordinary <<<>>> of n_levels * kCluster blocks):
// - the scan is spread over the cluster's SMs: global warp g of the
//   cluster (rank * 16 + warp) takes cells g, g + 128, ... (ops/select.py
//   scan_cells), kCells at a time; a lane issues all its loads of those
//   cells (kLoads a cell, at positions computed once a level) before its
//   compares, keeping its first maximum in row-major order, and a shuffle
//   tree keeps the larger value and, on a tie, the lower position.  A
//   block keeps best and at in its shared memory, then stores its cells'
//   into the leader block's (rank 0) through distributed shared memory,
//   after the wait of a cluster barrier whose arrive was the block's first
//   instruction (so every block has started); a second cluster barrier
//   hands them over, and the other blocks exit;
// - the leader's threads write each cell's sort word: the key's bits
//   mapped so that the unsigned order is the float order, complemented
//   (descending), in the high half, the cell index in the low half
//   (ascending on ties), the rank counted over the cell's 4 x 4-cell block;
// - a bitonic network sorts the words.  Distinct words make its order the
//   stable sort's.  A thread holds kSortWords consecutive words in
//   registers: of each k's stages (k, j), those with j < kSortWords swap
//   within the thread, those with j < 32 kSortWords between the lanes of a
//   warp by shuffles, and only the rest go through shared memory, a block
//   barrier each: 16 barriers at 1024 words (ops/select.py sort_barriers)
//   against the 56 of a network run wholly in shared memory.  Past
//   kSortWords * kThreads words (levels the main paths do not have) the
//   network runs in shared memory alone.
// A grid over all cells whose last block to finish sorts its level (an
// arrival counter) was the alternative; the cluster needs no counter in
// device memory to reset and no fence, and keeps best / at on chip.
//
// Exact: the boost and the key are the plain version's float32 sum and
// difference (written with __fadd_rn / __fsub_rn / __fmul_rn), every other
// step is a comparison, and remainder(best, 1000) is fmodf with torch's
// sign fix-up (torch.remainder on float32 is fmod-based, and fmod is exact;
// for 0 <= best < 2000 it equals best - 1000 * floor(best / 1000) too).
// So xs, ys and the responses are bit-equal to the plain version's.
//
// What bounds it on an H100.  Bytes: the maps read once (4 bytes a pixel,
// 2.86 MB over 8 levels at 640 x 360), 20 bytes a slot written; ~0.86 us.
// Operations: a comparison a pixel and the sort's ~(log2 P)^2 / 2 * P / 2
// comparisons for P cells rounded up to a power of two: negligible.  What
// sets the time is level 0's chain on its cluster (836 cells of 17 x 17 at
// 640 x 360): the earlier design scanned them on one SM and sorted with 56
// block barriers, 145.8 us.  Here level 0's leader spends 23,481 cycles in
// the scan with its two cluster barriers, 3,236 on the ranks, 14,065 on the
// sort (55 stages, ~250 cycles each whatever their kind) and 1,513 on the
// slots (clock64() stamps of tools/kernel_split.py, PERF.md section 6).
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLevels = 16;
constexpr int kCluster = 8;               // blocks a level (portable size)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 10;                // loads a lane issues a cell
constexpr int kCells = 2;                 // cells a warp scans at a time
constexpr int kSortWords = 2;             // sort words a thread, up to 1024
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

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// j / c for any j < 2^32 and c >= 1: the estimate from ceil(2^32 / c) is
// at most one too large
__device__ __forceinline__ uint32_t div_by(uint32_t j, uint32_t c,
                                           uint64_t magic) {
  uint32_t q = static_cast<uint32_t>((j * magic) >> 32);
  return q * c > j ? q - 1 : q;
}

// The compare-exchange of bitonic stage (k, j) for word i: the lower of
// the pair keeps the smaller word in an ascending run, the larger in a
// descending one.
__device__ __forceinline__ unsigned long long exchange(
    unsigned long long mine, unsigned long long other, int i, int k, int j) {
  const bool keep_min = ((i & j) == 0) == ((i & k) == 0);
  return keep_min ? (mine < other ? mine : other)
                  : (mine < other ? other : mine);
}

// The sort words a sorting thread holds for p words (ops/select.py
// sort_words): kSortWords consecutive words on p / kSortWords threads (at
// least a warp); 0 past kSortWords * kThreads, where the network runs in
// shared memory alone.
__device__ __forceinline__ int sort_words(int p) {
  if (p <= 32) return 1;
  if (p <= kSortWords * kThreads) return min(kSortWords, p / 32);
  return 0;
}

// Bitonic stage (k, j) over keys[0, p) in shared memory: the lower of each
// pair keeps the smaller word in an ascending run, the larger in a
// descending one.  A block barrier follows.
__device__ __forceinline__ void shared_stage(unsigned long long* keys, int p,
                                             int k, int j) {
  for (int i = threadIdx.x; i < p; i += kThreads) {
    const int o = i ^ j;
    if (o > i) {
      const unsigned long long a = keys[i], b = keys[o];
      if ((a > b) == ((i & k) == 0)) { keys[i] = b; keys[o] = a; }
    }
  }
  __syncthreads();
}

// Sorts keys[0, p) ascending by the bitonic network in shared memory alone:
// the levels of more than kSortWords * kThreads cells, which the main
// paths do not have.
__device__ void sort_keys_shared(unsigned long long* keys, int p) {
  for (int k = 2; k <= p; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) shared_stage(keys, p, k, j);
}

// Bitonic stage (k, kJ) between a thread's own words r and r + kJ.
template <int kWords, int kJ>
__device__ __forceinline__ void thread_stage(unsigned long long (&wd)[kWords],
                                             int i0, int k) {
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    if (r & kJ) continue;                 // r is the lower of its pair
    const unsigned long long a = wd[r], b = wd[r + kJ];
    wd[r] = exchange(a, b, i0 + r, k, kJ);
    wd[r + kJ] = exchange(b, a, i0 + r + kJ, k, kJ);
  }
}

// Sorts keys[0, p) ascending: a thread holds the words tid * kWords + r,
// r < kWords, in registers.  Of each k's stages (k, j), those with
// j >= 32 kWords run in shared memory behind a block barrier each, those
// with kWords <= j < 32 kWords exchange words between the lanes of a warp
// by shuffles, and those with j < kWords between a thread's own words.
template <int kWords>
__device__ __forceinline__ void sort_keys(unsigned long long* keys, int p) {
  static_assert(kWords <= 4, "thread stages are written for j < 4");
  const int tid = threadIdx.x, lane = tid & 31;
  const int ts = p / kWords;              // sorting threads (p < 32: a warp)
  const bool on = tid < (ts < 32 ? 32 : ts);
  const int i0 = tid * kWords;
  unsigned long long wd[kWords];
#pragma unroll
  for (int r = 0; r < kWords; ++r)
    wd[r] = (on && i0 + r < p) ? keys[i0 + r] : ~0ull;
  for (int k = 2; k <= p; k <<= 1) {
    int j = k >> 1;
    if (j >= 32 * kWords) {
#pragma unroll
      for (int r = 0; r < kWords; ++r)
        if (on && i0 + r < p) keys[i0 + r] = wd[r];
      __syncthreads();
      for (; j >= 32 * kWords; j >>= 1) shared_stage(keys, p, k, j);
#pragma unroll
      for (int r = 0; r < kWords; ++r)
        if (on && i0 + r < p) wd[r] = keys[i0 + r];
    }
    if (!on) continue;
    for (; j >= kWords; j >>= 1) {
#pragma unroll
      for (int r = 0; r < kWords; ++r) {
        const unsigned long long o =
            __shfl_xor_sync(0xffffffffu, wd[r], j / kWords);
        wd[r] = exchange(wd[r], o, i0 + r, k, j);
      }
    }
    for (; j > 0; j >>= 1) {
      if constexpr (kWords > 2) if (j == 2) thread_stage<kWords, 2>(wd, i0, k);
      if constexpr (kWords > 1) if (j == 1) thread_stage<kWords, 1>(wd, i0, k);
    }
  }
#pragma unroll
  for (int r = 0; r < kWords; ++r)
    if (on && i0 + r < p) keys[i0 + r] = wd[r];
  __syncthreads();
}

// The sort word of a cell: its key (best - rank * 2000, rank its place in
// its 4 x 4-cell block) mapped to descending unsigned order in the high
// half, the cell index in the low half.
__device__ __forceinline__ unsigned long long sort_word(const float* best,
                                                        int cell, int ncx,
                                                        int ncy) {
  const int cy = cell / ncx, cx = cell - (cell / ncx) * ncx;
  const float b = best[cell];
  int rk = kBlock * kBlock;
  if (b > 0.0f) {
    const int by = cy - cy % kBlock, bx = cx - cx % kBlock;
    const int me = (cy - by) * kBlock + (cx - bx);
    rk = 0;
#pragma unroll
    for (int k = 0; k < kBlock * kBlock; ++k) {
      const int y = by + k / kBlock, x = bx + k % kBlock;
      const bool in = y < ncy && x < ncx;         // padded cells are 0
      const float o = in ? best[min(y, ncy - 1) * ncx + min(x, ncx - 1)]
                         : 0.0f;
      rk += (o > b || (o == b && k < me)) ? 1 : 0;
    }
  }
  const float key = __fsub_rn(b, __fmul_rn(static_cast<float>(rk),
                                           2.0f * kBoost));
  return (static_cast<unsigned long long>(~ordered(key)) << 32) |
         static_cast<unsigned int>(cell);
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
select_kernel(Levels lv, float ini_th, int64_t* __restrict__ xs,
              int64_t* __restrict__ ys, float* __restrict__ resp) {
  extern __shared__ unsigned long long smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();               // this block has started
  const int l = blockIdx.x / kCluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = lv.h[l], w = lv.w[l], q = lv.quota[l], c = lv.cell[l];
  const int ncy = (h + c - 1) / c, ncx = (w + c - 1) / c;
  const int n = ncy * ncx;
  int p = 1;
  while (p < n) p <<= 1;
  unsigned long long* keys = smem;                         // [p]
  float* best = reinterpret_cast<float*>(smem + p);        // [n]
  int* at = reinterpret_cast<int*>(best + n);              // [n]
  float* lead_best = cluster.map_shared_rank(best, 0);
  int* lead_at = cluster.map_shared_rank(at, 0);
  const float* __restrict__ s = lv.s[l];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const uint32_t cc = static_cast<uint32_t>(c) * static_cast<uint32_t>(c);
  const uint64_t magic = ((1ull << 32) + c - 1) / c;
  // the lane's positions in a cell for j = 32 r + lane, the same in every
  // cell of the level; a later chunk of the cell shifts them
  int py[kLoads], px[kLoads];
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const uint32_t j = 32 * r + lane;
    py[r] = static_cast<int>(div_by(j, c, magic));
    px[r] = static_cast<int>(j) - py[r] * c;
  }
  // a warp scans kCells of its cells at a time, all their loads in flight
  const int stride = kCluster * kWarps;
  for (int first = rank * kWarps + warp; first < n;
       first += kCells * stride) {
    const float* __restrict__ corner[kCells];
    int hy[kCells], wx[kCells];
    float v[kCells];
    int at_j[kCells];
#pragma unroll
    for (int q = 0; q < kCells; ++q) {
      const int cell = first + q * stride;
      const int cy = cell / ncx, cx = cell - (cell / ncx) * ncx;
      const int y0 = cy * c, x0 = cx * c;
      // the map's rows and columns left from the cell's corner (none past n)
      hy[q] = cell < n ? h - y0 : 0;
      wx[q] = cell < n ? w - x0 : 0;
      corner[q] = s + (cell < n ? static_cast<int64_t>(y0) * w + x0 : 0);
      v[q] = -1.0f;
      at_j[q] = 0;
    }
    for (uint32_t base = 0; base < cc; base += 32 * kLoads) {
      const int by = static_cast<int>(div_by(base, c, magic));
      const int bx = static_cast<int>(base) - by * c;
      float t[kCells][kLoads];
      uint32_t inside[kCells];            // bit r: load r is a pixel
#pragma unroll
      for (int q = 0; q < kCells; ++q) {
        inside[q] = 0;
#pragma unroll
        for (int r = 0; r < kLoads; ++r) {
          int yy = py[r] + by, xx = px[r] + bx;
          if (xx >= c) { xx -= c; ++yy; }
          t[q][r] = 0.0f;                 // the zero padding to whole cells
          if (base + 32 * r + lane < cc && yy < hy[q] && xx < wx[q]) {
            t[q][r] = __ldg(corner[q] + yy * w + xx);
            inside[q] |= 1u << r;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kCells; ++q)
#pragma unroll
        for (int r = 0; r < kLoads; ++r) {
          const uint32_t j = base + 32 * r + lane;
          float u = t[q][r];
          if ((inside[q] >> r & 1u) && u > ini_th) u = __fadd_rn(u, kBoost);
          if (j < cc && u > v[q]) { v[q] = u; at_j[q] = static_cast<int>(j); }
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < kCells; ++q) {
        const float ov = __shfl_down_sync(0xffffffffu, v[q], off);
        const int oi = __shfl_down_sync(0xffffffffu, at_j[q], off);
        if (ov > v[q] || (ov == v[q] && oi < at_j[q])) {
          v[q] = ov;
          at_j[q] = oi;
        }
      }
#pragma unroll
    for (int q = 0; q < kCells; ++q) {
      const int cell = first + q * stride;
      if (lane == 0 && cell < n) { best[cell] = v[q]; at[cell] = at_j[q]; }
    }
  }
  // the block's cells to the leader, all stores in flight at once
  __syncthreads();
  cluster_wait();                         // every block has started
  for (int m = tid; m < n; m += kThreads) {
    const int g = m % (kCluster * kWarps);  // the global warp that scanned m
    if (g / kWarps != rank || rank == 0) continue;
    lead_best[m] = best[m];
    lead_at[m] = at[m];
  }
  cluster.sync();                         // best and at are in the leader
  if (rank != 0) return;

  for (int cell = tid; cell < p; cell += kThreads)
    keys[cell] = cell < n ? sort_word(best, cell, ncx, ncy)
                          : ~0ull;        // past the cells: sorted last
  __syncthreads();
  static_assert(kSortWords == 2, "one case a word count");
  switch (sort_words(p)) {
    case 1: sort_keys<1>(keys, p); break;
    case 2: sort_keys<2>(keys, p); break;
    default: sort_keys_shared(keys, p);
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
// a cell for its best value and position (ops/select.py smem_bytes).  The
// grid is n_levels clusters of kCluster blocks (ops/select.py CLUSTER).
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
  select_kernel<<<n_levels * kCluster, kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      lv, ini_th, static_cast<int64_t*>(xs), static_cast<int64_t*>(ys),
      static_cast<float*>(resp));
  return static_cast<int>(cudaGetLastError());
}
