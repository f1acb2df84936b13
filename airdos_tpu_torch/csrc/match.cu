// The matchers' gate, best / second-best reduction and uniqueness
// resolution, for sm_90a: one kernel, match_rows, one launch a matcher
// call, in six modes (motion, local, stereo, bow, fuse and epipolar).
//
// Replaces the epilogues around the Pallas kernel
// airdos_tpu/ops/pallas_kernels.py:36 hamming_matrix_pallas (the call at
// :43, dispatched by :59 hamming_matrix_auto) in the four matchers of the
// tracking path: matching/stereo.py:88 stereo_match (gate, best, mutual,
// far-u second), matching/projection.py:81 match_last_frame and :130
// match_local_points (window, octave band, right-u gate; best, second and
// level ratio; :61 _rotation_consistency and :41 _resolve_unique) and
// matching/bow_match.py:31 match_by_bow (node gate, best, second,
// rotation, uniqueness), in the loop's matching/sim3_match.py:31
// _directional (motion mode's gate and best), in the mapping's duplicate
// fusion, matching/fuse.py:27 fuse_candidates (window, octave band,
// chi-square, best), and in triangulation's epipolar search,
// matching/epipolar.py:36 triangulate_pair (:63-84: the distance to the
// epipolar line, best), the last two of which airdos_tpu vmaps over a
// batch of target keyframes.  On the TPU each is the Pallas tile kernel
// writing the dense [P, N] (fusion, triangulation: [B, P, N]) distance
// matrix plus XLA fusions of the gate, argmins and
// scatter-mins.  Here the distances of the pairs that pass the gate are
// computed where they are reduced, and no such matrix reaches device
// memory.  The port's plain versions are ops/match_kernels.py
// match_rows_ref and match_resolve_ref.
//
// For row p (a point or a left keypoint) and column j (a feature or a
// right keypoint) the gate of the mode holds or not:
//   motion, local (projection): |x_j - u_p| < r_p and |y_j - v_p| < r_p,
//     key_j in [key_p + lo, key_p + hi] (either end may be open), and
//     |ur_p - w_j| < r_p where w_j > 0;
//   stereo: |v_p - y_j| <= w_j (the row band 2 scale[oct_j]),
//     |key_p - key_j| <= 1, and 0 <= u_p - x_j <= max_d;
//   bow: key_p == key_j, both >= 0;
//   fuse (row p of target b, the columns of target b): the window as in
//     motion, key_j in [key_p - 1, key_p + 1], and the chi-square test
//     (e2 + der^2) / sigma2[key_j] <= 7.8 where w_j >= 0, else
//     e2 / sigma2[key_j] <= 5.99, e2 = du^2 + dv^2, der = w_j - ur_p;
//   epipolar (row p's line (l0, l1, l2) in target b's image, the columns
//     of target b, w_j = sigma2[octave_j]): dn = l0 x_j + l1 y_j + l2,
//     dn^2 / max(l0^2 + l1^2, 1e-12) < 3.84 w_j;
// and in every mode row p and column j are valid (a column not taken).
// D[p, j] = popc(desc_p ^ desc_j) over the 8 words where the gate holds,
// else BIG = 1024 (above any distance, 256 at most).  Per row:
//   best = argmin_j D[p, j] and its distance (ties to the lower index;
//     a row with no gated pair gives index 0 and BIG, as argmin does);
//   second = argmin over j != best (motion, local, bow), or over the
//     columns with |x_j - x_best| > 1.5 (stereo), BIG and index 0 where
//     none is left; fuse and epipolar have none;
//   has = dist <= th and the mode's ratio test: local rejects where the
//     two share an octave, dist > ratio * second and second < BIG;
//     stereo keeps dist < ratio * min(second, 256); bow keeps
//     dist < ratio * second; motion, fuse and epipolar have none.
//     Stereo also needs the mutual check: the best row of column best is
//     p.
// Stereo writes each column's argmin row too (index 0 for a column with
// no gated pair); fuse and epipolar write feat_idx = best where has, else
// -1.
//
// The resolve (motion, local and bow, where asked): the 30-bin rotation
// histogram of the rows that have a match (bin = rint(((a_ref - a_cur)
// mod 360) * float32(30 / 360)), 30 -> 0, clamped to 0..29), its three
// largest bins (ties to the lower bin) with the 0.1 * max cut, and the
// uniqueness resolution: each column keeps the claiming row of least
// distance, ties to the lower row -> feat_idx [P], point_of_feat [N], n.
//
// Semantics and exactness.  A (distance, index) pair is one 32-bit key,
// distance << 21 | index: the minimum key is the minimum distance with
// ties to the lower index, whatever order the keys are met in, so the
// warp's __reduce_min_sync and the column minima's atomics are
// deterministic, and so is a walk over the columns in any order.  The
// column keys are kept complemented (atomicMax of ~key) so that a zeroed
// scratch (cudaMemsetAsync) means "no gated pair".  Uniqueness is one
// shared atomicMin of a (distance, row) key of the same form (a row whose
// distance exceeds BIG never wins, as in the plain version).  Every gate
// comparison is one float32 subtraction (__fsub_rn, no contraction),
// fabsf and compare on the operands the plain version uses; fuse's
// chi-square and epipolar's distance are torch's float32 steps, each
// rounded (__fmul_rn, __fadd_rn, __fdiv_rn; nvcc would contract a product
// and a sum into an FMA); the ratio a float32 product (__fmul_rn) of the ratio
// rounded to float32 (torch's rounding of a Python scalar) and the
// distance; so every output is the plain version's, bit for bit.
//
// Design.  A block of 8 warps takes rows of one call (fuse, epipolar: of
// one target, blockIdx.y).  It first sorts the valid columns of the call into a grid
// of cells in shared memory (ORB-SLAM's Frame::GetFeaturesInArea), a
// counting sort: each thread's columns loaded together (kPer a thread,
// every load issued before any is used), the grid's extent from their
// coordinates (a block reduction, which also finds stereo's widest band
// or epipolar's largest sigma2, w_max), a histogram of cells with each
// column's rank, its prefix sum
// and a scatter of each column's index, x, y, w, key (and angle, for the
// rotation filter) into its cell's slots.  The columns of one row of
// cells are then contiguous, so a row's window is one contiguous range
// of slots a row of cells:
//   motion, local, fuse: x in [u - r, u + r], y in [v - r, v + r];
//   stereo: x in [u - max_d, u], y in [v - w_max, v + w_max];
//   epipolar: the band |l0 x + l1 y + l2| <= h about the row's line, a
//     range of cells in each row of cells: the x where some y of the row
//     of cells, widened by a cell above and below, puts the line within
//     h, clipped to the columns' extent.  h = sqrt(3.84 w_max den) (den
//     the clamped l0^2 + l1^2) raised by 1e-3 of itself and by 1e-5 of
//     |l0| max|x| + |l1| max|y| + |l2| over the extent: the gate's three
//     roundings of dn are within 2^-22 of that sum, so a gated pair lies
//     inside h with room for this bound's own float32 steps.  A line or
//     h that is not finite, or a valid column of finite coordinates past
//     2^20 px, takes every cell;
//   bow: the cells are buckets of a hash of the key, and a row's window
//     is its key's bucket (a grid of one cell is the full scan).
// A window's cell range is widened by one cell on each side, and a cell
// is at least a pixel, so the float rounding of a window's ends cannot
// drop a pair; a column outside the extent goes to the nearest border
// cell (a non-finite one to cell 0), and a window that is not finite or
// reaches past 2^20 px takes its whole axis.  The exact gate is then
// evaluated at every candidate.  A warp takes a row (its first row's
// values loaded while the block stages): its lanes walk the concatenated
// ranges (a candidate a lane, the range of a candidate by a binary search
// of the ranges' prefix offsets by shuffles) and gate them; the gated
// columns are compacted into a per-warp list (a ballot), and each 32 of
// them get their distances at once, a column a lane (two 16-byte loads of
// its descriptor, from L2, and the popcount), so a wide window with few
// gated pairs costs few descriptor round trips; each lane keeps its two
// smallest keys, and two __reduce_min_sync give best and second.  Stereo
// keeps each gated pair's key and x in a per-warp list in shared memory
// as it walks, so its far-u second comes from the list once best is
// known, not from a second walk (a row with more gated pairs than the
// list holds walks its window again).  Stereo's column minima are global
// atomics of the gated pairs.  With the resolve, lane 0 of each row
// computes the row's rotation bin once (its best column's angle from the
// table), adds it to a global histogram and leaves it in the scratch.
// Where stereo or the resolve needs all rows, the last block to finish
// (a counter after a __threadfence) decodes the column minima and
// applies the mutual check, or runs the resolve: the top 3 bins by three
// warp max-reductions of (count << 5 | 31 - bin), then the uniqueness,
// 32-bit keys (distance << 21 | row) atomicMin-ed in shared memory, the
// winners counted by warp sums; so a matcher call is one launch.
//
// What bounds it on an H100.  Bytes: both descriptor sets and the row
// and column vectors read once (32 + ~21 bytes a row or column), the
// outputs (~25 bytes a row) written once: ~0.1 MB at 2048 x 1536, 0.03
// us at 3.35 TB/s; fuse at B = 9 x 2048 x 1536 ~1 MB.  Operations: the
// work a row and a column (binning, window) and the gate and the
// 256-bit XOR-popcount at the gated pairs only: well under a
// microsecond.  So the launch, the staging's round trips and barriers,
// a row's two round trips (its values, the gated descriptors) and the
// last block's epilogue are what a call costs.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

// The parameter block stands outside the unnamed namespace, so that the
// C entry point that takes it keeps external linkage.

// a strided vector (element and batch strides), null where the mode
// reads none
struct Vec {
  const void* p;
  long long s, sb;
};

// the layout of ops/match_kernels.py _PARAMS
struct RowsParams {
  long long mode, n_rows, n_cols, n_batch;
  const uint4* row_desc;   // [P] descriptors (shared by the batch)
  const uint4* col_desc;   // [B, N] descriptors
  long long col_desc_sb;   // descriptors from one target's columns to the next
  Vec row_x, row_y, row_ur, row_r, row_key, row_ok;  // epipolar: the
                           // line's l0, l1, l2 as row_x, row_y, row_ur
  Vec col_x, col_y, col_w, col_key, col_ok, col_taken;
  Vec ang_ref, ang_tab;    // the resolve's rotation filter (null: off)
  const float* sigma2;     // fuse: [n_levels]
  long long n_levels;
  long long band_lo, band_hi, band_open, th;
  long long resolve;       // motion, local, bow: run the resolve
  long long grid_x, grid_y;  // cells of the grid (bow: buckets, grid_y 1)
  long long blocks;        // blocks a target
  long long* idx;          // best [BP], second [P] (fuse: feat_idx [BP]),
                           // stereo's column argmin [N], the resolve's
                           // feat_idx [P], point_of_feat [N], n [1]
  int* dist;               // best [BP], second [P] (not fuse)
  unsigned char* has;      // [BP]
  unsigned* scratch;       // stereo: [N] complemented column keys and
                           // the last block's counter; the resolve: the
                           // counter, the histogram [32], the rows' bins [P]
  float ratio, max_d, bin_scale, unused;
};

namespace {

constexpr int kMotion = 0;
constexpr int kLocal = 1;
constexpr int kStereo = 2;
constexpr int kBow = 3;
constexpr int kFuse = 4;
constexpr int kEpi = 5;

constexpr unsigned kBig = 1u << 10;
constexpr int kIndexBits = 21;
constexpr unsigned kIndexMask = (1u << kIndexBits) - 1;
constexpr unsigned kNone = kBig << kIndexBits;   // (BIG, index 0)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 6;                         // columns or rows a thread loads at once
constexpr int kChunk = kThreads * kPer;
constexpr int kBins = 30;
constexpr unsigned kNoBin = 31;                 // a row that claims nothing
constexpr int kList = 64;                       // stereo: gated pairs a warp lists
constexpr int kPend = 64;                       // gated columns a warp holds
constexpr unsigned kFull = 0xffffffffu;
constexpr float kReach = 1048576.f;             // 2^20 px: binned exactly
constexpr float kChiStereo = 7.8f;
constexpr float kChiMono = 5.99f;
constexpr float kFarU = 1.5f;
constexpr float kEpiChi2 = 3.84f;
constexpr float kEpiMinNorm2 = 1e-12f;
// the resolve's scratch: the counter, then the histogram, then the bins
constexpr int kHist = 1;
constexpr int kRowBins = kHist + 32;

// modes whose rows and columns come a batch of targets
__host__ __device__ constexpr bool batched(int mode) {
  return mode == kFuse || mode == kEpi;
}

template <typename T>
__device__ __forceinline__ T at(const Vec& v, long long b, long long i) {
  return static_cast<const T*>(v.p)[b * v.sb + i * v.s];
}

__device__ __forceinline__ unsigned hamming(const uint4& a0, const uint4& a1,
                                            const uint4* __restrict__ c,
                                            int j) {
  const uint4 b0 = __ldg(c + 2 * j);
  const uint4 b1 = __ldg(c + 2 * j + 1);
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

// one axis of the grid: cell(z) = clamp(floor((z - lo) * inv), 0, n - 1),
// monotone in z; inv <= 1 (a cell is at least a pixel); NaN -> 0
struct Axis {
  float lo, inv;
  int n;
};

__device__ __forceinline__ int cell_of(const Axis& a, float z) {
  float f = floorf(__fmul_rn(__fsub_rn(z, a.lo), a.inv));
  f = fminf(fmaxf(f, 0.f), static_cast<float>(a.n - 1));
  return static_cast<int>(f);
}

// the cells of [lo, hi] on an axis, widened by one on each side; the
// whole axis where an end is not finite or reaches past kReach
__device__ __forceinline__ void cell_range(const Axis& a, float lo, float hi,
                                           int& c0, int& c1) {
  if (!(fabsf(lo) < kReach && fabsf(hi) < kReach)) {
    c0 = 0;
    c1 = a.n - 1;
    return;
  }
  c0 = max(cell_of(a, lo) - 1, 0);
  c1 = min(cell_of(a, hi) + 1, a.n - 1);
}

__device__ __forceinline__ int bucket(long long key, int n) {
  return static_cast<int>(
      (static_cast<unsigned long long>(key) * 0x9E3779B97F4A7C15ull >> 32) %
      static_cast<unsigned long long>(n));
}

// the sorted column table in shared memory
struct Table {
  long long* key;      // [N] by slot
  int* start;          // [cells + 1]: the first slot of each cell
  int* col;            // [N]: the column of each slot
  float* x;
  float* y;
  float* w;
  float* ang;          // the column's angle (the rotation filter)
  int* slot;           // [N]: each column's rank in its cell, then its slot
};

// the grid a block built, shared by its warps; the extent's upper ends
// and magnitudes, the cells' height and whether a valid column lies past
// kReach (epipolar's band)
struct Grid {
  Axis ax, ay;
  float w_max;
  float x_hi, y_hi, x_mag, y_mag, cell_y;
  bool wide;
};

// one row's gate values
struct Row {
  float x, y, ur, r;
  long long key;
};

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// the dynamic shared memory of a block: the table
__host__ __device__ __forceinline__ size_t table_bytes(long long n,
                                                       long long cells) {
  return align16(static_cast<size_t>(n) * 8) +
         align16(static_cast<size_t>(cells + 1) * 4) +
         6 * align16(static_cast<size_t>(n) * 4);
}

__device__ __forceinline__ Table carve(unsigned char* smem, long long n,
                                      long long cells) {
  Table t;
  const size_t vec = align16(static_cast<size_t>(n) * 4);
  t.key = reinterpret_cast<long long*>(smem);
  unsigned char* q = smem + align16(static_cast<size_t>(n) * 8);
  t.start = reinterpret_cast<int*>(q);
  q += align16(static_cast<size_t>(cells + 1) * 4);
  t.col = reinterpret_cast<int*>(q);
  t.x = reinterpret_cast<float*>(q + vec);
  t.y = reinterpret_cast<float*>(q + 2 * vec);
  t.w = reinterpret_cast<float*>(q + 3 * vec);
  t.ang = reinterpret_cast<float*>(q + 4 * vec);
  t.slot = reinterpret_cast<int*>(q + 5 * vec);
  return t;
}

// a thread's columns j = c0 + threadIdx.x + k kThreads, k < kPer, loaded
// together (every load issued before any is used)
struct Chunk {
  float x[kPer], y[kPer], w[kPer], ang[kPer];
  long long key[kPer];
  bool ok[kPer];
};

template <int MODE>
__device__ __forceinline__ void load_chunk(const RowsParams& q, long long b,
                                           int c0, bool angles, Chunk& c) {
  const int N = static_cast<int>(q.n_cols);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = c0 + static_cast<int>(threadIdx.x) + k * kThreads;
    const int jj = j < N ? j : 0;
    const unsigned char ok = at<unsigned char>(q.col_ok, b, jj);
    const unsigned char taken =
        q.col_taken.p != nullptr ? at<unsigned char>(q.col_taken, b, jj) : 0;
    c.key[k] = at<long long>(q.col_key, b, jj);
    if (MODE != kBow) {
      c.x[k] = at<float>(q.col_x, b, jj);
      c.y[k] = at<float>(q.col_y, b, jj);
      c.w[k] = at<float>(q.col_w, b, jj);
    }
    c.ang[k] = angles ? at<float>(q.ang_tab, 0, jj) : 0.f;
    c.ok[k] = j < N && ok != 0 && taken == 0 &&
              (MODE != kBow || c.key[k] >= 0);
  }
}

template <int MODE>
__device__ __forceinline__ int chunk_cell(const RowsParams& q, const Grid& g,
                                          const Chunk& c, int k) {
  if (MODE == kBow) return bucket(c.key[k], static_cast<int>(q.grid_x));
  return cell_of(g.ay, c.y[k]) * static_cast<int>(q.grid_x) +
         cell_of(g.ax, c.x[k]);
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// one axis from the valid columns' extent (coordinates within kReach);
// cells of at least a pixel; no extent: one cell wide
__device__ __forceinline__ Axis make_axis(float lo, float hi, int n) {
  Axis a{0.f, 0.f, n};
  if (lo <= hi) {
    a.lo = lo;
    const float span = __fsub_rn(hi, lo);
    a.inv = span > static_cast<float>(n)
                ? __fdiv_rn(static_cast<float>(n), span) : 1.f;
  }
  return a;
}

// Sort the valid columns of target b into the grid of cells: the extent
// (geometric modes), a histogram of cells with each column's rank in its
// cell, the prefix sum, and the scatter into the slots.  Up to kChunk
// columns a thread's loads are issued once, together; more are loaded
// again in each pass.  Ends with a barrier.
template <int MODE>
__device__ void build_table(const RowsParams& q, long long b, const Table& t,
                            bool angles, Grid& g) {
  __shared__ float red[5][kWarps];
  __shared__ int warp_sum[kWarps];
  const int N = static_cast<int>(q.n_cols);
  const int gx = static_cast<int>(q.grid_x), gy = static_cast<int>(q.grid_y);
  const int cells = gx * gy;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool once = N <= kChunk;
  Chunk c;
  if (once) load_chunk<MODE>(q, b, 0, angles, c);
  for (int i = threadIdx.x; i <= cells; i += kThreads) t.start[i] = 0;
  if (MODE != kBow) {
    float x0 = INFINITY, x1 = -INFINITY, y0 = INFINITY, y1 = -INFINITY;
    float wm = -INFINITY;
    bool wide = false;
    for (int c0 = 0; c0 < N; c0 += kChunk) {
      if (!once) load_chunk<MODE>(q, b, c0, angles, c);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (!c.ok[k]) continue;
        if (fabsf(c.x[k]) < kReach) {
          x0 = fminf(x0, c.x[k]);
          x1 = fmaxf(x1, c.x[k]);
        }
        if (fabsf(c.y[k]) < kReach) {
          y0 = fminf(y0, c.y[k]);
          y1 = fmaxf(y1, c.y[k]);
        }
        if (MODE == kStereo || MODE == kEpi) wm = fmaxf(wm, c.w[k]);
        if (MODE == kEpi && isfinite(c.x[k]) && isfinite(c.y[k]) &&
            !(fabsf(c.x[k]) < kReach && fabsf(c.y[k]) < kReach))
          wide = true;
      }
    }
    x0 = warp_min(x0);
    x1 = warp_max(x1);
    y0 = warp_min(y0);
    y1 = warp_max(y1);
    wm = warp_max(wm);
    if (lane == 0) {
      red[0][warp] = x0;
      red[1][warp] = x1;
      red[2][warp] = y0;
      red[3][warp] = y1;
      red[4][warp] = wm;
    }
    const bool any_wide = __syncthreads_or(wide) != 0;
    if (threadIdx.x == 0) {
      for (int k = 1; k < kWarps; ++k) {
        x0 = fminf(x0, red[0][k]);
        x1 = fmaxf(x1, red[1][k]);
        y0 = fminf(y0, red[2][k]);
        y1 = fmaxf(y1, red[3][k]);
        wm = fmaxf(wm, red[4][k]);
      }
      g.ax = make_axis(x0, x1, gx);
      g.ay = make_axis(y0, y1, gy);
      g.w_max = wm;
      g.x_hi = x1;
      g.y_hi = y1;
      g.x_mag = fmaxf(fabsf(x0), fabsf(x1));
      g.y_mag = fmaxf(fabsf(y0), fabsf(y1));
      g.cell_y = g.ay.inv > 0.f ? __fdiv_rn(1.f, g.ay.inv) : 1.f;
      g.wide = any_wide;
    }
  }
  __syncthreads();
  // the histogram, each column's rank in its cell
  for (int c0 = 0; c0 < N; c0 += kChunk) {
    if (!once) load_chunk<MODE>(q, b, c0, angles, c);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = c0 + static_cast<int>(threadIdx.x) + k * kThreads;
      if (c.ok[k]) t.slot[j] = atomicAdd(t.start + chunk_cell<MODE>(q, g, c, k), 1);
    }
  }
  __syncthreads();
  // exclusive prefix sum of the counts: each thread a run of cells
  const int per = (cells + kThreads) / kThreads;     // cells + 1 entries
  const int i0 = threadIdx.x * per;
  const int i1 = min(i0 + per, cells + 1);
  int run = 0;
  for (int i = i0; i < i1; ++i) run += t.start[i];
  int incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int base = incl - run;
  for (int k = 0; k < warp; ++k) base += warp_sum[k];
  for (int i = i0; i < i1; ++i) {
    const int n = t.start[i];
    t.start[i] = base;
    base += n;
  }
  __syncthreads();
  // the scatter; each column's slot kept for lookups by column
  for (int c0 = 0; c0 < N; c0 += kChunk) {
    if (!once) load_chunk<MODE>(q, b, c0, angles, c);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = c0 + static_cast<int>(threadIdx.x) + k * kThreads;
      if (!c.ok[k]) continue;
      const int s = t.start[chunk_cell<MODE>(q, g, c, k)] + t.slot[j];
      t.slot[j] = s;
      t.col[s] = j;
      t.key[s] = c.key[k];
      if (MODE != kBow) {
        t.x[s] = c.x[k];
        t.y[s] = c.y[k];
        t.w[s] = c.w[k];
      }
      if (angles) t.ang[s] = c.ang[k];
    }
  }
  __syncthreads();
}

template <int MODE>
__device__ __forceinline__ bool gate(const RowsParams& q, const Row& a,
                                     float cx, float cy, float cw,
                                     long long ck) {
  if (MODE == kBow) return ck == a.key;    // both >= 0 where walked
  if (MODE == kEpi) {                      // a.r: the clamped l0^2 + l1^2
    const float dn = __fadd_rn(
        __fadd_rn(__fmul_rn(a.x, cx), __fmul_rn(a.y, cy)), a.ur);
    return __fdiv_rn(__fmul_rn(dn, dn), a.r) < __fmul_rn(kEpiChi2, cw);
  }
  if (MODE == kStereo) {
    if (!(fabsf(__fsub_rn(a.y, cy)) <= cw)) return false;
    const long long dk = a.key - ck;
    if (dk > 1 || dk < -1) return false;
    const float disp = __fsub_rn(a.x, cx);
    return disp >= 0.f && disp <= q.max_d;
  }
  const float du = __fsub_rn(cx, a.x), dv = __fsub_rn(cy, a.y);
  if (!(fabsf(du) < a.r && fabsf(dv) < a.r)) return false;
  if (MODE == kFuse) {
    if (ck < a.key - 1 || ck > a.key + 1) return false;
    const long long lv = ck < 0 ? 0 : (ck >= q.n_levels ? q.n_levels - 1 : ck);
    const float s2 = __ldg(q.sigma2 + lv);
    const float e2 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
    if (cw >= 0.f) {
      const float der = __fsub_rn(cw, a.ur);
      return __fdiv_rn(__fadd_rn(e2, __fmul_rn(der, der)), s2) <= kChiStereo;
    }
    return __fdiv_rn(e2, s2) <= kChiMono;
  }
  if (!(q.band_open & 1) && ck < a.key + q.band_lo) return false;
  if (!(q.band_open & 2) && ck > a.key + q.band_hi) return false;
  return !(cw > 0.f) || fabsf(__fsub_rn(a.ur, cw)) < a.r;
}

// a row's window: the rows of cells [cy0, cy0 + n_ranges), each the
// slots of cells [cx0, cx1], or (band, epipolar) the cells of each row
// that the band of half-width h about the row's line reaches
struct Window {
  int cx0, cx1, cy0, n_ranges;
  bool band;
  float h;
};

// epipolar: l0^2 + l1^2 clamped below at 1e-12 (a NaN kept), torch's steps
__device__ __forceinline__ float epi_norm2(float l0, float l1) {
  const float d = __fadd_rn(__fmul_rn(l0, l0), __fmul_rn(l1, l1));
  return d < kEpiMinNorm2 ? kEpiMinNorm2 : d;
}

// epipolar: the band's half-width h in line units, over the columns'
// largest sigma2 (the header says why it holds every gated pair); not
// finite where the line, the norm or w_max is not
__device__ __forceinline__ float band_half_width(const Grid& g, const Row& a) {
  const float reach = __fadd_rn(
      __fadd_rn(__fmul_rn(fabsf(a.x), g.x_mag), __fmul_rn(fabsf(a.y), g.y_mag)),
      fabsf(a.ur));
  return __fadd_rn(__fmul_rn(sqrtf(__fmul_rn(__fmul_rn(kEpiChi2, g.w_max), a.r)),
                             1.001f),
                   __fmul_rn(1e-5f, reach));
}

// epipolar: the cells [c0, c1] of row of cells cy that the band reaches
// (c1 < c0: none): the x of the extent where some y in the row, widened
// by a cell above and below, puts |l0 x + l1 y + l2| within h, widened by
// a cell each side; every cell where the bound is NaN
__device__ __forceinline__ void band_cells(const Grid& g, const Row& a,
                                           float h, int cy, int& c0,
                                           int& c1) {
  const float ya =
      __fadd_rn(g.ay.lo, __fmul_rn(static_cast<float>(cy - 1), g.cell_y));
  const float yb =
      __fadd_rn(g.ay.lo, __fmul_rn(static_cast<float>(cy + 2), g.cell_y));
  const float p = __fmul_rn(a.y, ya), r = __fmul_rn(a.y, yb);
  // l0 x must lie in [lo_v, hi_v] for some y of the row
  const float lo_v = __fsub_rn(__fsub_rn(-h, a.ur), fmaxf(p, r));
  const float hi_v = __fsub_rn(__fsub_rn(h, a.ur), fminf(p, r));
  float xl, xh;
  if (a.x > 0.f) {
    xl = __fdiv_rn(lo_v, a.x);
    xh = __fdiv_rn(hi_v, a.x);
  } else if (a.x < 0.f) {
    xl = __fdiv_rn(hi_v, a.x);
    xh = __fdiv_rn(lo_v, a.x);
  } else {                                 // a horizontal line: all or none
    xl = lo_v <= 0.f && hi_v >= 0.f ? -INFINITY : INFINITY;
    xh = -xl;
  }
  if (isnan(xl) || isnan(xh)) {
    c0 = 0;
    c1 = g.ax.n - 1;
    return;
  }
  if (xh < g.ax.lo || xl > g.x_hi) {
    c0 = 0;
    c1 = -1;
    return;
  }
  c0 = max(cell_of(g.ax, fmaxf(xl, g.ax.lo)) - 1, 0);
  c1 = min(cell_of(g.ax, fminf(xh, g.x_hi)) + 1, g.ax.n - 1);
}

// A warp's lists in shared memory: the gated columns waiting for their
// distances (and their x, for stereo's list), and stereo's gated pairs.
struct WarpLists {
  int* pend;            // [kPend] gated columns, their distances pending
  float* pend_x;        // [kPend]
  unsigned* list_key;   // [kList] stereo: every gated pair's key
  float* list_x;        // [kList] and its x
};

// The distances of the first `count` pending gated columns, one a lane:
// the lane's two smallest keys (FAR: the smallest in k1); stereo (not
// FAR) also lists each pair and updates the column minima.
template <int MODE, bool FAR>
__device__ __forceinline__ void flush(const RowsParams& q, const WarpLists& w,
                                      int count, const uint4& a0,
                                      const uint4& a1, const uint4* cdesc,
                                      unsigned p, unsigned& k1, unsigned& k2,
                                      int& n_list) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  if (lane < count) {
    const int j = w.pend[lane];
    const unsigned d = hamming(a0, a1, cdesc, j);
    const unsigned key = d << kIndexBits | static_cast<unsigned>(j);
    if (FAR) {
      k1 = min(k1, key);
    } else {
      if (key < k1) {
        k2 = k1;
        k1 = key;
      } else if (key < k2) {
        k2 = key;
      }
      if (MODE == kStereo) {
        atomicMax(q.scratch + j, ~(d << kIndexBits | p));
        if (n_list + lane < kList) {
          w.list_key[n_list + lane] = key;
          w.list_x[n_list + lane] = w.pend_x[lane];
        }
      }
    }
  }
  if (MODE == kStereo && !FAR) n_list += count;
  __syncwarp();
}

// Walk a row's window, a candidate a lane: the gate at each candidate
// (FAR, stereo's second where the list overflowed: and more than 1.5 px
// from xb), the gated columns compacted into the warp's pending list, and
// their distances 32 at a time (flush), so that a window of many
// candidates and few gated pairs costs few descriptor loads.  A
// candidate's range of cells is found by a binary search of the ranges'
// prefix offsets.
template <int MODE, bool FAR>
__device__ __forceinline__ void walk(const RowsParams& q, const Table& t,
                                     const Grid& g, const Window& wd,
                                     const Row& a,
                                     const uint4& a0, const uint4& a1,
                                     const uint4* cdesc, unsigned p,
                                     float xb, unsigned& k1, unsigned& k2,
                                     const WarpLists& w, int& n_list) {
  const int lane = threadIdx.x & 31;
  const int gx = static_cast<int>(q.grid_x);
  int n_pend = 0;
  for (int r0 = 0; r0 < wd.n_ranges; r0 += 32) {
    const int nr = min(32, wd.n_ranges - r0);
    int s = 0, len = 0;
    if (lane < nr) {
      const int cy = wd.cy0 + r0 + lane;
      int cx0 = wd.cx0, cx1 = wd.cx1;
      if (MODE == kEpi && wd.band) band_cells(g, a, wd.h, cy, cx0, cx1);
      if (cx1 >= cx0) {
        s = t.start[cy * gx + cx0];
        len = t.start[cy * gx + cx1 + 1] - s;
      }
    }
    int off = len;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, off, o);
      if (lane >= o) off += v;
    }
    const int total = __shfl_sync(kFull, off, 31);
    off -= len;
    for (int t0 = 0; t0 < total; t0 += 32) {
      const int i = t0 + lane;
      int rr = 0;                 // the last range starting at or before i
      for (int step = 16; step; step >>= 1) {
        const int o = __shfl_sync(kFull, off, rr + step);
        if (rr + step < nr && o <= i) rr += step;
      }
      const int slot =
          __shfl_sync(kFull, s, rr) + i - __shfl_sync(kFull, off, rr);
      bool pass = false;
      int j = 0;
      float cx = 0.f;
      if (i < total) {
        j = t.col[slot];
        cx = MODE == kBow ? 0.f : t.x[slot];
        pass = gate<MODE>(q, a, cx, MODE == kBow ? 0.f : t.y[slot],
                          MODE == kBow ? 0.f : t.w[slot], t.key[slot]);
        if (FAR) pass = pass && fabsf(__fsub_rn(cx, xb)) > kFarU;
      }
      const unsigned m = __ballot_sync(kFull, pass);
      if (pass) {
        const int k = n_pend + __popc(m & ((1u << lane) - 1));
        w.pend[k] = j;
        w.pend_x[k] = cx;
      }
      n_pend += __popc(m);
      if (n_pend >= 32) {
        flush<MODE, FAR>(q, w, 32, a0, a1, cdesc, p, k1, k2, n_list);
        if (lane < n_pend - 32) {   // the rest to the front
          w.pend[lane] = w.pend[32 + lane];
          w.pend_x[lane] = w.pend_x[32 + lane];
        }
        n_pend -= 32;
        __syncwarp();
      }
    }
  }
  if (n_pend > 0)
    flush<MODE, FAR>(q, w, n_pend, a0, a1, cdesc, p, k1, k2, n_list);
}

__device__ __forceinline__ unsigned column_argmin(unsigned stored) {
  return stored == 0 ? 0u : (~stored & kIndexMask);
}

// the rotation bin of a row: its angle against its best column's
__device__ __forceinline__ unsigned rotation_bin(float a_ref, float a_cur,
                                                 float scale) {
  float rot = __fsub_rn(a_ref, a_cur);
  if (rot < 0.f) rot = __fadd_rn(rot, 360.f);
  const float binf = rintf(__fmul_rn(rot, scale));
  const int bin = binf == static_cast<float>(kBins) ? 0 : static_cast<int>(binf);
  return static_cast<unsigned>(min(max(bin, 0), kBins - 1));
}

// The resolve over every row, by the last block, from the histogram and
// each row's bin its warp left in the scratch: the top 3 bins, then the
// uniqueness -> feat_idx [P], point_of_feat [N], n after the rows'
// outputs in idx.  A thread's kPer rows are loaded together (once, where
// P <= kChunk); the histogram meanwhile.  The uniqueness key of a row is
// distance << 21 | row: 32 bits (a claiming distance is at most BIG), its
// minimum the least distance, ties to the lower row.
__device__ void resolve_rows(const RowsParams& q, unsigned char* smem,
                             bool rotation) {
  __shared__ bool keep[32];
  __shared__ unsigned n_final;
  const long long P = q.n_rows, N = q.n_cols;
  unsigned* seg = reinterpret_cast<unsigned*>(smem);          // [N] keys
  const unsigned* bins = q.scratch + kRowBins;
  long long* out = q.idx + 2 * P;
  const bool once = P <= kChunk;
  const int lane = threadIdx.x & 31;
  long long best[kPer];
  int dist[kPer];
  unsigned bin[kPer];
  auto load = [&](long long p0) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long p = p0 + threadIdx.x + k * kThreads;
      const long long pp = p < P ? p : 0;
      best[k] = __ldcg(q.idx + pp);
      dist[k] = __ldcg(q.dist + pp);
      bin[k] = p < P ? __ldcg(bins + pp) : kNoBin;
    }
  };
  if (once) load(0);
  for (long long f = threadIdx.x; f < N; f += kThreads) seg[f] = 0xffffffffu;
  if (threadIdx.x == 0) n_final = 0;
  if (threadIdx.x < 32) {
    // the three largest bins, ties to the lower bin: the largest of
    // count << 5 | (31 - bin) over the bins not yet taken, three times;
    // then the 0.1 * max cut
    const int v = rotation && lane < kBins
                      ? static_cast<int>(__ldcg(q.scratch + kHist + lane)) : -1;
    bool taken = false;
    int count = 0;
    float cut = 0.f;
    for (int k = 0; k < 3; ++k) {
      const int mine = v >= 0 && !taken ? (v << 5 | (31 - lane)) : -1;
      const int top = __reduce_max_sync(kFull, mine);
      if (k == 0) cut = __fmul_rn(0.1f, __int2float_rn(top >> 5));
      if (lane == 31 - (top & 31)) {
        taken = true;
        count = top >> 5;
      }
    }
    keep[lane] = !rotation || (taken && __int2float_rn(count) >= cut);
  }
  __syncthreads();
  for (int pass = 0; pass < 2; ++pass) {
    unsigned won_here = 0;
    for (long long p0 = 0; p0 < P; p0 += kChunk) {
      if (!once) load(p0);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const long long p = p0 + threadIdx.x + k * kThreads;
        // a row farther than BIG never wins, as under the plain version's
        // segment minimum starting at BIG (the kernel's rows never are)
        const bool kept = bin[k] != kNoBin && keep[bin[k]] &&
                          dist[k] <= static_cast<int>(kBig);
        const unsigned key = static_cast<unsigned>(dist[k]) << kIndexBits |
                             static_cast<unsigned>(p);
        if (pass == 0) {
          if (kept) atomicMin(seg + best[k], key);
        } else if (p < P) {
          const bool won = kept && seg[best[k]] == key;
          out[p] = won ? best[k] : -1;
          won_here += won;
        }
      }
    }
    if (pass == 1) {
      won_here = __reduce_add_sync(kFull, won_here);
      if (lane == 0 && won_here) atomicAdd(&n_final, won_here);
    }
    __syncthreads();
  }
  for (long long f = threadIdx.x; f < N; f += kThreads)
    out[P + f] = seg[f] == 0xffffffffu
                     ? -1LL : static_cast<long long>(seg[f] & kIndexMask);
  if (threadIdx.x == 0) out[P + N] = static_cast<long long>(n_final);
}

// Stereo's last block: each column's argmin row, and the mutual check of
// every row; a thread's kPer columns or rows loaded together.
__device__ void mutual_rows(const RowsParams& q) {
  const long long P = q.n_rows;
  const int N = static_cast<int>(q.n_cols);
  for (int j0 = 0; j0 < N; j0 += kChunk) {
    unsigned stored[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = j0 + threadIdx.x + k * kThreads;
      stored[k] = __ldcg(q.scratch + (j < N ? j : 0));
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = j0 + threadIdx.x + k * kThreads;
      if (j < N) q.idx[2 * P + j] = column_argmin(stored[k]);
    }
  }
  for (long long p0 = 0; p0 < P; p0 += kChunk) {
    long long best[kPer];
    unsigned char has[kPer];
    unsigned stored[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long p = p0 + threadIdx.x + k * kThreads;
      const long long pp = p < P ? p : 0;
      best[k] = __ldcg(q.idx + pp);
      has[k] = __ldcg(q.has + pp);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) stored[k] = __ldcg(q.scratch + best[k]);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long p = p0 + threadIdx.x + k * kThreads;
      if (p < P) q.has[p] = has[k] != 0 && column_argmin(stored[k]) == p;
    }
  }
}

// a row's values and descriptor, loaded together
struct RowLoad {
  Row a;
  unsigned char ok;
  float a_ref;
  uint4 d0, d1;
};

template <int MODE>
__device__ __forceinline__ RowLoad load_row(const RowsParams& q, long long b,
                                            long long p, bool rotation) {
  RowLoad l;
  l.a = Row{0.f, 0.f, 0.f, 0.f, at<long long>(q.row_key, b, p)};
  l.ok = at<unsigned char>(q.row_ok, b, p);
  if (MODE != kBow) {
    l.a.x = at<float>(q.row_x, b, p);
    l.a.y = at<float>(q.row_y, b, p);
  }
  if (MODE != kBow && MODE != kStereo) l.a.ur = at<float>(q.row_ur, b, p);
  if (MODE != kBow && MODE != kStereo && MODE != kEpi)
    l.a.r = at<float>(q.row_r, b, p);
  l.a_ref = rotation ? at<float>(q.ang_ref, 0, p) : 0.f;
  l.d0 = __ldg(q.row_desc + 2 * p);
  l.d1 = __ldg(q.row_desc + 2 * p + 1);
  return l;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
match_rows_kernel(const RowsParams q) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Grid sgrid;
  __shared__ int pend[kWarps * kPend];
  __shared__ float pend_x[kWarps * kPend];
  __shared__ unsigned list_key[MODE == kStereo ? kWarps * kList : 1];
  __shared__ float list_x[MODE == kStereo ? kWarps * kList : 1];
  const long long P = q.n_rows;
  const long long b = blockIdx.y;
  const bool resolve = MODE != kStereo && !batched(MODE) && q.resolve;
  const bool rotation = resolve && q.ang_ref.p != nullptr;
  const int cells = static_cast<int>(q.grid_x * q.grid_y);
  const Table t = carve(smem, q.n_cols, cells);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p_first = static_cast<long long>(blockIdx.x) * kWarps + warp;
  // the warp's first row, loaded while the block stages the columns
  RowLoad next = load_row<MODE>(q, b, p_first < P ? p_first : 0, rotation);
  build_table<MODE>(q, b, t, rotation, sgrid);
  const Grid g = sgrid;

  const uint4* cdesc = q.col_desc + 2 * b * q.col_desc_sb;
  for (long long p = p_first; p < P;
       p += static_cast<long long>(gridDim.x) * kWarps) {
    if (p != p_first) next = load_row<MODE>(q, b, p, rotation);
    Row a = next.a;
    if (MODE == kEpi) a.r = epi_norm2(a.x, a.y);
    const unsigned char ok = next.ok;
    const float a_ref = next.a_ref;
    const uint4 a0 = next.d0, a1 = next.d1;
    Window wd{0, 0, 0, 0, false, 0.f};
    if (MODE == kBow) {
      if (ok != 0 && a.key >= 0) {
        const int c = bucket(a.key, static_cast<int>(q.grid_x));
        wd = Window{c, c, 0, 1, false, 0.f};
      }
    } else if (MODE == kEpi) {
      if (ok != 0) {                       // every cell, or the band's
        wd = Window{0, g.ax.n - 1, 0, g.ay.n, false, 0.f};
        const float h = band_half_width(g, a);
        if (!g.wide && isfinite(h)) {
          wd.band = true;
          wd.h = h;
        }
      }
    } else if (ok != 0) {
      float x_lo, x_hi, y_lo, y_hi;
      if (MODE == kStereo) {
        x_lo = __fsub_rn(a.x, q.max_d);
        x_hi = a.x;
        y_lo = __fsub_rn(a.y, g.w_max);
        y_hi = __fadd_rn(a.y, g.w_max);
      } else {
        x_lo = __fsub_rn(a.x, a.r);
        x_hi = __fadd_rn(a.x, a.r);
        y_lo = __fsub_rn(a.y, a.r);
        y_hi = __fadd_rn(a.y, a.r);
      }
      int cy0, cy1;
      cell_range(g.ax, x_lo, x_hi, wd.cx0, wd.cx1);
      cell_range(g.ay, y_lo, y_hi, cy0, cy1);
      wd.cy0 = cy0;
      wd.n_ranges = wd.cx1 >= wd.cx0 ? max(cy1 - cy0 + 1, 0) : 0;
    }
    unsigned k1 = kNone, k2 = kNone;
    int n_list = 0;
    const WarpLists wl{pend + warp * kPend, pend_x + warp * kPend,
                       list_key + (MODE == kStereo ? warp * kList : 0),
                       list_x + (MODE == kStereo ? warp * kList : 0)};
    walk<MODE, false>(q, t, g, wd, a, a0, a1, cdesc,
                      static_cast<unsigned>(p), 0.f, k1, k2, wl, n_list);
    const unsigned best = __reduce_min_sync(kFull, k1);
    unsigned cand = k1 == best ? k2 : k1;
    if (MODE == kStereo) {
      cand = kNone;
      if (best != kNone) {
        // best is a gated, so staged, column
        const float xb = t.x[t.slot[best & kIndexMask]];
        if (n_list <= kList) {
          for (int i = lane; i < n_list; i += 32)
            if (fabsf(__fsub_rn(wl.list_x[i], xb)) > kFarU)
              cand = min(cand, wl.list_key[i]);
        } else {
          unsigned unused = kNone;
          walk<MODE, true>(q, t, g, wd, a, a0, a1, cdesc,
                           static_cast<unsigned>(p), xb, cand, unused, wl,
                           n_list);
        }
      }
    }
    const unsigned second =
        batched(MODE) ? kNone : __reduce_min_sync(kFull, cand);
    __syncwarp();                      // the lists are reused by the next row
    if (lane == 0) {
      const unsigned bd = best >> kIndexBits, bi = best & kIndexMask;
      const unsigned sd = second >> kIndexBits, si = second & kIndexMask;
      bool h = static_cast<long long>(bd) <= q.th;
      if (batched(MODE)) {
        const long long o = b * P + p;
        q.idx[o] = bi;
        q.idx[q.n_batch * P + o] = h ? static_cast<long long>(bi) : -1;
        q.dist[o] = static_cast<int>(bd);
        q.has[o] = h;
      } else {
        q.idx[p] = bi;
        q.idx[P + p] = si;
        q.dist[p] = static_cast<int>(bd);
        q.dist[P + p] = static_cast<int>(sd);
        const float fb = __uint2float_rn(bd);
        // where h holds best is gated; where sd < BIG second is too: both
        // staged, so their keys are read from the table
        if (MODE == kLocal)
          h = h && !(sd < kBig && t.key[t.slot[bi]] == t.key[t.slot[si]] &&
                     fb > __fmul_rn(q.ratio, __uint2float_rn(sd)));
        else if (MODE == kStereo)
          h = h && fb < __fmul_rn(q.ratio, __uint2float_rn(min(sd, 256u)));
        else if (MODE == kBow)
          h = h && fb < __fmul_rn(q.ratio, __uint2float_rn(sd));
        q.has[p] = h;
        if (resolve) {
          // the row's bin, once; the histogram of the rows that claim
          unsigned bin = h ? 0u : kNoBin;
          if (h && rotation) {
            bin = rotation_bin(a_ref, t.ang[t.slot[bi]], q.bin_scale);
            atomicAdd(q.scratch + kHist + bin, 1u);
          }
          q.scratch[kRowBins + p] = bin;
        }
      }
    }
  }
  if (batched(MODE) || (MODE != kStereo && !resolve)) return;

  // the last block to finish applies the mutual check to every row
  // (stereo) or runs the resolve
  __shared__ bool last;
  unsigned* counter =
      q.scratch + (MODE == kStereo ? static_cast<int>(q.n_cols) : 0);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counter, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (MODE == kStereo)
    mutual_rows(q);
  else
    resolve_rows(q, smem, rotation);
}

template <int MODE>
int launch(const RowsParams& q, size_t smem, cudaStream_t s) {
  static bool sized = false;          // the largest dynamic size, once
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        match_rows_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        200 * 1024);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const dim3 grid(static_cast<unsigned>(q.blocks),
                  static_cast<unsigned>(q.n_batch));
  match_rows_kernel<MODE><<<grid, kThreads, smem, s>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the dynamic shared memory of a call (bytes): the column table (which
// also holds the resolve's [N] keys)
extern "C" long long airdos_match_smem(long long n_cols, long long cells) {
  return static_cast<long long>(table_bytes(n_cols, cells));
}

// the scratch words of a call (uint32): stereo's column keys and counter,
// or the resolve's counter, histogram and row bins
extern "C" long long airdos_match_scratch(long long mode, long long n_rows,
                                          long long n_cols,
                                          long long resolve) {
  if (mode == kStereo) return n_cols + 1;
  if (resolve && !batched(static_cast<int>(mode))) return kRowBins + n_rows;
  return 0;
}

extern "C" int airdos_match_rows(const RowsParams* params, long long smem,
                                 void* stream) {
  const RowsParams& q = *params;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q.n_rows <= 0 || q.n_cols <= 0 || q.n_batch <= 0)
    return static_cast<int>(cudaGetLastError());
  // zero the column keys and the counter (stereo) or the counter and
  // the histogram (the resolve)
  const size_t words =
      q.mode == kStereo ? q.n_cols + 1
      : (q.resolve && !batched(static_cast<int>(q.mode))) ? kRowBins : 0;
  if (words) {
    const cudaError_t err =
        cudaMemsetAsync(q.scratch, 0, words * sizeof(unsigned), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t bytes = static_cast<size_t>(smem);
  switch (q.mode) {
    case kMotion: return launch<kMotion>(q, bytes, s);
    case kLocal: return launch<kLocal>(q, bytes, s);
    case kStereo: return launch<kStereo>(q, bytes, s);
    case kBow: return launch<kBow>(q, bytes, s);
    case kFuse: return launch<kFuse>(q, bytes, s);
    case kEpi: return launch<kEpi>(q, bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
