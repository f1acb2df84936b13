// The ORB scale pyramid of one image, for sm_90a: every level's image, its
// usable-pixel mask and its 7x7 Gaussian blur, all the levels in one
// cooperative launch (and one level in one plain launch, the one-level
// case).
//
// Replaces airdos_tpu/ops/pyramid.py:39 build_pyramid with the filters it
// runs: airdos_tpu/ops/filters.py:107 resize_bilinear (XLA gathers), :71
// erode (reduce_window) and :51 gaussian_blur7, the shift-and-add the TPU
// needs because a one-channel convolution does not tile onto the MXU.  The
// port's plain version is ops/pyramid.py pyramid_level_ref, a level at a
// time: ~80 torch launches a level for the resizes and the threshold, ~28
// for the blur.  Here, for level l >= 1 of size h x w, from level l - 1 of
// size hs x ws:
//
//   img[y, x]  = bilinear(src, y, x), cv2's pixel-centre alignment:
//                src row (y + 0.5) * sy - 0.5 clamped to [0, hs - 1],
//                sy = float32(hs / h), likewise the column;
//   mask[y, x] = 1 if bilinear(src_mask, y, x) > 0.999 else 0;
//   blur       = the separable 7x7 sigma-2 Gaussian of img, rows first,
//                BORDER_REFLECT_101 (torch's "reflect" pad);
//
// and for level 0 the image is the input itself, the mask the k x k
// erosion of the input mask (cv2.erode, anchor (k / 2, k / 2), pixels
// outside read as 1; all ones where there is no mask; k = 10 on the path,
// up to 16), and the blur as above.
//
// One block computes a 32 x 32 output tile.  The resized pixels of the
// tile and of a 3 px halo go to shared memory; a halo pixel outside the
// level is the pixel its reflection names, recomputed from level l - 1
// (not read back from another block), so every block sees the values the
// plain version blurs.  The source rows and weights of the tile's 38 rows
// and 38 columns are computed once a tile, and a thread's loads (its
// resized values and its outputs' resized mask) are all issued before
// any is used.  Then the rows' horizontal sums over the tile's columns,
// then the vertical sums.  The erosion is separable too: the tile's mask
// with a k / 2, k - 1 - k / 2 px halo (5 / 4 at k = 10), the row minima,
// the column minima.
//
// A level is resized from the level before it, so the levels form a
// chain.  The all-levels kernel is persistent: its grid is no larger than
// what can be resident at once (level 0's tiles, at most the wrapper's
// blocks an SM), it is launched cooperatively, and phase l computes level
// l, each block striding over the level's tiles, with a grid barrier
// (cooperative_groups' grid.sync(), which orders the phase's writes
// before the next phase's reads) between phases: n_levels - 1 barriers
// in place of n_levels - 1 launches.  A level this launch wrote is read
// with plain loads, which the grid barrier's fence orders after the
// phase's writes, never through the read-only (non-coherent) path, which
// could return a line from before the barrier.
//
// Exact: every rounding is the plain version's.  The index and weight
// arithmetic is torch's step by step (arange + 0.5, * sy, - 0.5, clamp,
// floor, ys - y0, 1 - wy); each bilinear value is four products and three
// sums, each blur output seven products and six sums in the plain
// version's order.  Each product and sum is written with __fmul_rn /
// __fadd_rn / __fsub_rn, which nvcc does not contract into a multiply-add:
// eager torch rounds every product, so a contracted one would move values
// by an ulp.  So the three outputs are bit-equal to the plain version's,
// in either launch.
//
// What bounds it on an H100.  Bytes: the input image and its mask read
// once, every level's outputs written once (12 bytes a pixel, 8 at level
// 0): at 640 x 360 over 8 levels ~8.8 MB, ~2.6 us at 3.35 TB/s.
// Operations: ~19 float32 operations a resized pixel (image and mask) and
// 26 for the blur, of the same order.  The tile's source footprint is
// read through L1 and L2 (neighbouring blocks share its edge rows), the
// blur's 49 taps read shared memory only.  A level is small (0.02-0.23
// Mpixel), so the chain of dependent levels, not either rate, sets the
// time: each phase waits for one tile's loads and sums and for the grid
// barrier, as a launch a level waited for one tile and the launch.
//
// The C entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return the launch's error.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLevels = 16;            // the all-levels launch's table
constexpr int kTile = 32;                 // output tile edge
constexpr int kHalo = 3;                  // the blur's half width
constexpr int kExt = kTile + 2 * kHalo;   // 38: resized tile with halo
constexpr int kMaxErode = 16;             // the erosion's largest window
constexpr int kMExt = kTile + kMaxErode - 1;  // 47: mask tile with halo
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kRows = kTile / kThreadsY;  // 4: output rows a thread
constexpr int kExtPer = (kExt * kExt + kThreads - 1) / kThreads;     // 6
constexpr int kMExtPer = (kMExt * kMExt + kThreads - 1) / kThreads;  // 9

enum MaskKind { kNoMask = 0, kMaskU8 = 1, kMaskF32 = 2 };

struct Taps {
  float k[7];
};

// One level's work: its source (level l - 1; at level 0 the image itself)
// with the source's mask, and its three outputs.
struct Level {
  const float* src;
  const void* src_mask;
  int mask_kind, hs, ws;
  float* img;
  float* mask;
  float* blur;
  int h, w;
  float sy, sx;
  bool level0;
};

struct Axis {
  int i0, i1;
  float w0, w1;
};

struct Smem {
  Axis ay[kExt], ax[kExt];         // levels >= 1: the tile's rows' and
                                   // columns' source axes, halo included
  float sr[kExt][kExt + 1];        // resized, with the halo
  float sh[kExt][kTile + 1];       // rows' horizontal sums
  float sm[kMExt][kMExt + 1];      // level 0: mask + halo
  float smr[kMExt][kTile + 1];     // level 0: row minima
};

// A float of a level's source: in the all-levels launch (kCoherent) a
// level another block may have written before the last grid barrier,
// read with a plain (coherent) load, which the barrier's fence orders
// after those writes; in the one-level launch an input no block writes,
// read through the read-only path.
template <bool kCoherent>
__device__ __forceinline__ float load(const float* p) {
  if constexpr (kCoherent) return *p;
  else return __ldg(p);
}

// BORDER_REFLECT_101 of index i into [0, n), n >= 4, for i in [-3, n + 2];
// indices beyond (a tile past the level's edge, whose values no output
// reads) are clamped so that every read stays inside.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// One axis of resize_bilinear's index arithmetic: destination index d,
// source size n, scale s (float32(n / out)).  axis() returns the two
// source indices and the weights (1 - f, f).
__device__ __forceinline__ Axis axis(int d, int n, float s) {
  float c = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(d), 0.5f), s),
                      0.5f);
  c = fminf(fmaxf(c, 0.0f), static_cast<float>(n - 1));
  Axis a;
  a.i0 = static_cast<int>(floorf(c));
  a.i1 = min(a.i0 + 1, n - 1);
  a.w1 = __fsub_rn(c, static_cast<float>(a.i0));
  a.w0 = __fsub_rn(1.0f, a.w1);
  return a;
}

// top = p00 * (1 - wx) + p01 * wx, bot likewise, top * (1 - wy) + bot * wy
template <bool kCoherent>
__device__ __forceinline__ float bilinear(const float* src, int ws,
                                          const Axis& ay, const Axis& ax) {
  const float* r0 = src + static_cast<int64_t>(ay.i0) * ws;
  const float* r1 = src + static_cast<int64_t>(ay.i1) * ws;
  const float top = __fadd_rn(__fmul_rn(load<kCoherent>(r0 + ax.i0), ax.w0),
                              __fmul_rn(load<kCoherent>(r0 + ax.i1), ax.w1));
  const float bot = __fadd_rn(__fmul_rn(load<kCoherent>(r1 + ax.i0), ax.w0),
                              __fmul_rn(load<kCoherent>(r1 + ax.i1), ax.w1));
  return __fadd_rn(__fmul_rn(top, ay.w0), __fmul_rn(bot, ay.w1));
}

// The 32 x 32 tile at (y0, x0) of one level: its image (levels >= 1), mask
// and blur.  Every thread of the block calls it; it leaves the shared
// tiles in use (the caller syncs before reusing them).  The source axes
// of the tile's 38 rows and 38 columns are computed once; each loop over
// a thread's values is unrolled, loads from clamped addresses without a
// branch and stores after it has loaded them all, and the resized mask
// is loaded with the image, so that a thread's global loads are in flight
// together: the tile then waits one round trip to L2 or HBM, not one a
// value.
template <bool kCoherent>
__device__ void pyramid_tile(const Level& L, const Taps& taps, int erode_k,
                             int x0, int y0, Smem& s) {
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  // the erosion window: rows y - lo .. y + k - 1 - lo, likewise columns
  const int erode_lo = erode_k / 2;
  const int mext = kTile + erode_k - 1;
  const bool erode = L.level0 && L.mask_kind != kNoMask;
  const int h = L.h, w = L.w;

  // levels >= 1: the source axes of the tile's rows and columns with
  // the halo's (a halo index outside the level reflected), computed once
  // a tile instead of once a value
  if (!L.level0) {
    if (tid < kExt) {
      s.ay[tid] = axis(reflect101(y0 - kHalo + tid, h), L.hs, L.sy);
    } else if (tid < 2 * kExt) {
      const int j = tid - kExt;
      s.ax[j] = axis(reflect101(x0 - kHalo + j, w), L.ws, L.sx);
    }
    __syncthreads();
  }
  // the resized tile and its halo (level 0: the input image, which no
  // block writes); a thread past the tile's values loads the last one
  // again and does not store it, so that no load is behind a branch
  float v[kExtPer];
#pragma unroll
  for (int r = 0; r < kExtPer; ++r) {
    const int i = min(tid + r * kThreads, kExt * kExt - 1);
    const int ly = i / kExt, lx = i - (i / kExt) * kExt;
    v[r] = L.level0
        ? __ldg(L.src + static_cast<int64_t>(reflect101(y0 - kHalo + ly, h)) *
                            L.ws + reflect101(x0 - kHalo + lx, w))
        : bilinear<kCoherent>(L.src, L.ws, s.ay[ly], s.ax[lx]);
  }
  // levels >= 1: the resized mask's threshold at this thread's outputs,
  // its loads in flight with the image's (at an output past the level,
  // which is not stored, the reflected axis)
  const int cx = threadIdx.x;                 // this thread's column
  const int gx = x0 + cx;
  float m[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = 1.0f;
    if (!L.level0) {
      const float q = bilinear<kCoherent>(
          static_cast<const float*>(L.src_mask), L.ws,
          s.ay[threadIdx.y + r * kThreadsY + kHalo], s.ax[cx + kHalo]);
      m[r] = q > 0.999f ? 1.0f : 0.0f;
    }
  }
#pragma unroll
  for (int r = 0; r < kExtPer; ++r) {
    const int i = tid + r * kThreads;
    if (i < kExt * kExt) s.sr[i / kExt][i - (i / kExt) * kExt] = v[r];
  }
  // level 0: the input mask's tile and its halo, 1 outside the image
  // (cv2.erode's border), loaded from a clamped address and then chosen
  if (erode) {
    float mt[kMExtPer];
#pragma unroll
    for (int r = 0; r < kMExtPer; ++r) {
      const int i = min(tid + r * kThreads, mext * mext - 1);
      const int ly = i / mext, lx = i - (i / mext) * mext;
      const int qy = y0 - erode_lo + ly, qx = x0 - erode_lo + lx;
      const int64_t at = static_cast<int64_t>(min(max(qy, 0), h - 1)) * L.ws +
                         min(max(qx, 0), w - 1);
      const float q = L.mask_kind == kMaskU8
          ? static_cast<float>(
                __ldg(static_cast<const uint8_t*>(L.src_mask) + at))
          : __ldg(static_cast<const float*>(L.src_mask) + at);
      mt[r] = qy >= 0 && qy < h && qx >= 0 && qx < w ? q : 1.0f;
    }
#pragma unroll
    for (int r = 0; r < kMExtPer; ++r) {
      const int i = tid + r * kThreads;
      if (i < mext * mext) s.sm[i / mext][i - (i / mext) * mext] = mt[r];
    }
  }
  __syncthreads();

  // the blur's horizontal sums
  for (int i = tid; i < kExt * kTile; i += kThreads) {
    const int ly = i / kTile, lx = i - (i / kTile) * kTile;
    float acc = __fmul_rn(taps.k[0], s.sr[ly][lx]);
#pragma unroll
    for (int t = 1; t < 7; ++t)
      acc = __fadd_rn(acc, __fmul_rn(taps.k[t], s.sr[ly][lx + t]));
    s.sh[ly][lx] = acc;
  }
  // the erosion's row minima
  if (erode) {
    for (int i = tid; i < mext * kTile; i += kThreads) {
      const int ly = i / kTile, lx = i - (i / kTile) * kTile;
      float q = s.sm[ly][lx];
      for (int t = 1; t < erode_k; ++t) q = fminf(q, s.sm[ly][lx + t]);
      s.smr[ly][lx] = q;
    }
  }
  __syncthreads();

  // the blur's vertical sums, and the level's image
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ly = threadIdx.y + r * kThreadsY;
    const int gy = y0 + ly;
    if (gy >= h || gx >= w) continue;
    const int64_t at = static_cast<int64_t>(gy) * w + gx;
    float acc = __fmul_rn(taps.k[0], s.sh[ly][cx]);
#pragma unroll
    for (int t = 1; t < 7; ++t)
      acc = __fadd_rn(acc, __fmul_rn(taps.k[t], s.sh[ly + t][cx]));
    L.blur[at] = acc;
    if (!L.level0) L.img[at] = s.sr[ly + kHalo][cx + kHalo];
  }
  // the mask: at level 0 the erosion's column minima (all ones without a
  // mask), after it the threshold computed above
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ly = threadIdx.y + r * kThreadsY;
    if (erode) {
      m[r] = s.smr[ly][cx];
      for (int t = 1; t < erode_k; ++t) m[r] = fminf(m[r], s.smr[ly + t][cx]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int gy = y0 + threadIdx.y + r * kThreadsY;
    if (gy < h && gx < w) L.mask[static_cast<int64_t>(gy) * w + gx] = m[r];
  }
}

// One level, a block a tile.
__global__ void __launch_bounds__(kThreads)
pyramid_level_kernel(const Level L, Taps taps, int erode_k) {
  __shared__ Smem s;
  pyramid_tile<false>(L, taps, erode_k, blockIdx.x * kTile,
                      blockIdx.y * kTile, s);
}

// An image's levels: img[0] the input image (never written), img[l] level
// l's image for l >= 1, each level's mask and blur, the level sizes and
// the float32 scales from the level before.
struct Pyr {
  float* img[kMaxLevels];
  float* mask[kMaxLevels];
  float* blur[kMaxLevels];
  int h[kMaxLevels], w[kMaxLevels];
  float sy[kMaxLevels], sx[kMaxLevels];
  const void* mask0;
  int mask_kind, n_levels, erode_k;
};

// Every level of one image, launched cooperatively: phase l is level l,
// a grid barrier between phases.  At least two blocks an SM, so that
// level 0's tiles fit the card at once.
__global__ void __launch_bounds__(kThreads, 2)
pyramid_levels_kernel(const Pyr p, Taps taps) {
  __shared__ Smem s;
  cg::grid_group grid = cg::this_grid();
  for (int l = 0; l < p.n_levels; ++l) {
    const int from = l > 0 ? l - 1 : 0;
    Level L;
    L.src = p.img[from];
    L.src_mask = l > 0 ? p.mask[from] : p.mask0;
    L.mask_kind = l > 0 ? kMaskF32 : p.mask_kind;
    L.hs = p.h[from];
    L.ws = p.w[from];
    L.img = p.img[l];
    L.mask = p.mask[l];
    L.blur = p.blur[l];
    L.h = p.h[l];
    L.w = p.w[l];
    L.sy = p.sy[l];
    L.sx = p.sx[l];
    L.level0 = l == 0;
    const int tiles_x = (L.w + kTile - 1) / kTile;
    const int tiles = tiles_x * ((L.h + kTile - 1) / kTile);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      pyramid_tile<true>(L, taps, p.erode_k, (t % tiles_x) * kTile,
                         (t / tiles_x) * kTile, s);
      __syncthreads();          // the next tile reuses the shared tiles
    }
    if (l + 1 < p.n_levels) grid.sync();   // level l whole before l + 1
  }
}

Taps taps_of(const float* taps) {
  Taps t;
  for (int i = 0; i < 7; ++i) t.k[i] = taps[i];
  return t;
}

}  // namespace

// Level 0 (level0 = 1): src [h, w] float32 is the level's image; src_mask
// [h, w] uint8 (mask_kind 1) or float32 (2), or none (0, all ones); img is
// not written.  Level l >= 1 (level0 = 0): src, src_mask [hs, ws] float32
// are level l - 1's image and mask; sy, sx the float32 scales hs / h and
// ws / w.  img, mask, blur: [h, w] float32 row-major, h, w >= 4.  taps: 7
// float32 Gaussian taps in host memory.  erode_k: level 0's erosion window,
// 1 to 16.
extern "C" int airdos_pyramid_level(const void* src, const void* src_mask,
                                    int mask_kind, int hs, int ws, void* img,
                                    void* mask, void* blur, int h, int w,
                                    float sy, float sx, const float* taps,
                                    int level0, int erode_k, void* stream) {
  if (h <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  if (erode_k < 1 || erode_k > kMaxErode)
    return static_cast<int>(cudaErrorInvalidValue);
  Level L;
  L.src = static_cast<const float*>(src);
  L.src_mask = src_mask;
  L.mask_kind = mask_kind;
  L.hs = hs;
  L.ws = ws;
  L.img = static_cast<float*>(img);
  L.mask = static_cast<float*>(mask);
  L.blur = static_cast<float*>(blur);
  L.h = h;
  L.w = w;
  L.sy = sy;
  L.sx = sx;
  L.level0 = level0 != 0;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  const dim3 block(kThreadsX, kThreadsY);
  pyramid_level_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      L, taps_of(taps), erode_k);
  return static_cast<int>(cudaGetLastError());
}

// What the all-levels launch needs of the current device: out[0] its
// cudaDevAttrCooperativeLaunch, out[1] its SMs, out[2] the blocks of
// pyramid_levels_kernel an SM can hold at once.
extern "C" int airdos_pyramid_residency(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[0], cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], pyramid_levels_kernel, kThreads, 0);
  return static_cast<int>(e);
}

// Every level of one image in one cooperative launch of `grid` blocks
// (at most what can be resident at once).  img: [h[0], w[0]] float32, the
// input image; mask: [h[0], w[0]] uint8 (mask_kind 1), float32 (2) or
// none (0).  imgs (entries 1..n_levels - 1), masks, blurs: n_levels host
// pointers to device [h[l], w[l]] float32 outputs, h, w >= 4; sy, sx: the
// float32 scales of level l from level l - 1 (entry 0 unused).  taps: 7
// float32 Gaussian taps in host memory; erode_k 1 to 16; n_levels 1 to 16
// (cudaErrorInvalidValue otherwise).
extern "C" int airdos_pyramid_levels(const void* img, const void* mask,
                                     int mask_kind, const int64_t* imgs,
                                     const int64_t* masks,
                                     const int64_t* blurs, const int* h,
                                     const int* w, const float* sy,
                                     const float* sx, int n_levels,
                                     int erode_k, const float* taps,
                                     int grid, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || erode_k < 1 ||
      erode_k > kMaxErode || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Pyr p{};
  for (int l = 0; l < n_levels; ++l) {
    p.img[l] = l == 0 ? const_cast<float*>(static_cast<const float*>(img))
                      : reinterpret_cast<float*>(imgs[l]);
    p.mask[l] = reinterpret_cast<float*>(masks[l]);
    p.blur[l] = reinterpret_cast<float*>(blurs[l]);
    p.h[l] = h[l];
    p.w[l] = w[l];
    p.sy[l] = sy[l];
    p.sx[l] = sx[l];
  }
  p.mask0 = mask;
  p.mask_kind = mask_kind;
  p.n_levels = n_levels;
  p.erode_k = erode_k;
  cudaLaunchAttribute coop = {};
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreadsX, kThreadsY);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &coop;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, pyramid_levels_kernel, p, taps_of(taps));
  const cudaError_t last = cudaGetLastError();   // and clear it
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// The name of a cudaError_t the entry points returned.
extern "C" const char* airdos_pyramid_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}
