// FAST-9/16 scores with the extractor's masking, threshold and strict 3x3
// non-max suppression, every pyramid level of an image in one launch, for
// sm_90a.
//
// Replaces airdos_tpu/ops/fast.py:32 fast_score_map (16 rolls of the
// image, then 16 x 9 minimum / maximum maps) and :70 nms_strict (8 rolls),
// with the caller's steps between them (airdos_tpu/features/orb.py: the
// multiply by the mask, the zeroed MIN_BORDER frame and the score >
// min_th threshold).  The port's plain version is ops/fast.py fast_nms_ref,
// ~40 full-image torch launches a level.  Here, at each level:
//
//   out[y, x] = t(y, x) if t(y, x) > max over its 8 neighbours of t else 0,
//   t = s * mask where (y, x) lies in [border, h - border) x [border, w -
//   border) and s * mask > min_th, else 0,
//
// s the FAST score (the largest threshold at which 9 contiguous circle
// pixels are all brighter or all darker than the centre).
//
// One block computes a 32 x 32 output tile of one level.  The launch's
// blocks cover the levels' tiles one level after another, and a block
// finds its level from the level table's first tiles (passed by value, at
// most 16 levels), so the small levels run beside the large ones instead
// of each paying a launch.  The image tile with a 4 px halo (3 for the
// circle, 1 for the NMS ring) and the mask tile with a 1 px ring go to
// shared memory, with pixels outside the image read as 0, loaded 16 bytes
// a thread where the level's rows are 16-byte aligned (a width that is a
// multiple of 4); then the thresholded scores of the tile and a 1 px ring,
// then the NMS.  The plain version's rolls wrap around the image, but only
// inside a frame that the border zeroes, so reading outside as 0 gives the
// same output.
//
// Exact: every value is a difference of two floats, a minimum or maximum,
// or the one product s * mask, each computed as the plain version computes
// it, so the output is bit-equal.  No product feeds a sum, so nvcc has no
// multiply-add to contract.
//
// What bounds it on an H100.  Bytes: the image and the mask read once and
// the output written once, 12 bytes a pixel (2.8 MB at 640 x 360, 8.6 MB
// over its 8 levels: 2.6 us at 3.35 TB/s).  Operations: ~300 float32
// operations a pixel of the interior as the plain version counts them (16
// differences, 2 x 16 x 8 arc minima and maxima), of the same order at the
// float32 peak; the kernel does ~140 of them (the arcs' extrema from
// prefix and suffix extrema).  The tiles
// are read from HBM once and every circle and mask read comes from shared
// memory.  A level of 100 x 179 is 24 blocks: alone on the card it paid a
// launch and a chain of dependent loads for a few microseconds of work,
// which is what one launch over the levels removes.
//
// The C entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 16;         // the level table's rows
constexpr int kTile = 32;              // output tile edge
constexpr int kHalo = 4;
constexpr int kImg = kTile + 2 * kHalo;  // 40: image tile edge
constexpr int kSc = kTile + 2;           // 34: score tile edge (1 px ring)
constexpr int kQuads = kImg / 4;         // 10: 16-byte loads a tile row
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;

// OpenCV's Bresenham circle of radius 3, clockwise from (0, -3)
__constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                  0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                  3, 3, 2, 1, 0, -1, -2, -3};

// An image's levels: each level's image, mask and output ([h, w] float32
// row-major), its tiles across, and its first tile in the launch's order
// (first[n_levels] = every tile).
struct Levels {
  const float* img[kMaxLevels];
  const float* mask[kMaxLevels];
  float* out[kMaxLevels];
  int h[kMaxLevels], w[kMaxLevels], tiles_x[kMaxLevels];
  int first[kMaxLevels + 1];
  int n_levels;
};

// Rows [y_lo, y_lo + rows) and columns [x_lo, x_lo + kImg) of src into
// dst, 0 outside the image.  x_lo is a multiple of 4, so where w is too and
// src is 16-byte aligned every 4 columns load as one float4 that lies
// wholly inside or wholly outside the image.
__device__ __forceinline__ void load_tile(float (*dst)[kImg + 1],
                                          const float* __restrict__ src,
                                          int rows, int y_lo, int x_lo, int h,
                                          int w, int tid) {
  const bool quads = (w & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (quads) {
    for (int i = tid; i < rows * kQuads; i += kThreads) {
      const int ly = i / kQuads, q = i - (i / kQuads) * kQuads;
      const int gy = y_lo + ly, gx = x_lo + 4 * q;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gy >= 0 && gy < h && gx >= 0 && gx < w)
        v = __ldg(reinterpret_cast<const float4*>(
            src + static_cast<int64_t>(gy) * w + gx));
      dst[ly][4 * q] = v.x;
      dst[ly][4 * q + 1] = v.y;
      dst[ly][4 * q + 2] = v.z;
      dst[ly][4 * q + 3] = v.w;
    }
  } else {
    for (int i = tid; i < rows * kImg; i += kThreads) {
      const int ly = i / kImg, lx = i - (i / kImg) * kImg;
      const int gy = y_lo + ly, gx = x_lo + lx;
      dst[ly][lx] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                        ? __ldg(src + static_cast<int64_t>(gy) * w + gx)
                        : 0.0f;
    }
  }
}

// The FAST-9/16 score at image tile position (ly, lx) (>= 3 from its edge).
// Arc s spans e[s..s + 8] of the differences e repeated (e[k + 16] =
// e[k]); its minimum (lo) and maximum (hi) are those of its suffix within
// its block of 9 ([0, 9), [9, 18), [18, 27)) and of its prefix within the
// next (van Herk / Gil-Werman): ~45 minima and as many maxima for the 16
// arcs instead of 128 each.  A minimum or maximum is exact in any order,
// so the score is the plain version's bit for bit.
__device__ __forceinline__ float fast_score(const float (*img)[kImg + 1],
                                            int ly, int lx) {
  const float p = img[ly][lx];
  float e[24];
#pragma unroll
  for (int k = 0; k < 16; ++k) e[k] = img[ly + kCircleDy[k]][lx + kCircleDx[k]] - p;
#pragma unroll
  for (int k = 16; k < 24; ++k) e[k] = e[k - 16];
  // suffix extrema: e[k..8] for k <= 8, e[k..17] for 9 <= k <= 15
  float slo[16], shi[16];
  slo[8] = shi[8] = e[8];
#pragma unroll
  for (int k = 7; k >= 0; --k) {
    slo[k] = fminf(e[k], slo[k + 1]);
    shi[k] = fmaxf(e[k], shi[k + 1]);
  }
  float lo = e[17], hi = e[17];
#pragma unroll
  for (int k = 16; k >= 9; --k) {
    lo = fminf(e[k], lo);
    hi = fmaxf(e[k], hi);
    if (k <= 15) {
      slo[k] = lo;
      shi[k] = hi;
    }
  }
  // prefix extrema: e[0..8] at 8, e[9..k] for 9 <= k <= 17, e[18..k] after
  float plo[24], phi[24];
  plo[8] = slo[0];
  phi[8] = shi[0];
  plo[9] = phi[9] = e[9];
  plo[18] = phi[18] = e[18];
#pragma unroll
  for (int k = 10; k < 24; ++k) {
    if (k == 18) continue;
    plo[k] = fminf(plo[k - 1], e[k]);
    phi[k] = fmaxf(phi[k - 1], e[k]);
  }
  // bright = max over s of lo, dark = -(min over s of hi)
  float bright = 0.0f, dark_min = 0.0f;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const float arc_lo = fminf(slo[s], plo[s + 8]);
    const float arc_hi = fmaxf(shi[s], phi[s + 8]);
    bright = s == 0 ? arc_lo : fmaxf(bright, arc_lo);
    dark_min = s == 0 ? arc_hi : fminf(dark_min, arc_hi);
  }
  return fmaxf(fmaxf(bright, -dark_min), 0.0f);
}

__global__ void __launch_bounds__(kThreads)
fast_nms_levels_kernel(const Levels lv, float min_th, int border) {
  __shared__ float simg[kImg][kImg + 1];
  __shared__ float smask[kSc][kImg + 1];   // rows y0 - 1.., columns x0 - 4..
  __shared__ float ssc[kSc][kSc + 1];
  // this block's level: the last whose first tile is at most blockIdx.x
  // (a level without tiles shares its first tile with the next)
  const int b = blockIdx.x;
  int l = 0;
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i < lv.n_levels && b >= lv.first[i]) l = i;
  const int h = lv.h[l], w = lv.w[l], tiles_x = lv.tiles_x[l];
  const int tile = b - lv.first[l];
  const int y0 = (tile / tiles_x) * kTile;
  const int x0 = (tile - (tile / tiles_x) * tiles_x) * kTile;
  float* __restrict__ out = lv.out[l];
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  load_tile(simg, lv.img[l], kImg, y0 - kHalo, x0 - kHalo, h, w, tid);
  load_tile(smask, lv.mask[l], kSc, y0 - 1, x0 - kHalo, h, w, tid);
  __syncthreads();
  for (int i = tid; i < kSc * kSc; i += kThreads) {
    const int ly = i / kSc, lx = i - (i / kSc) * kSc;
    const int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
    float t = 0.0f;
    if (gy >= border && gy < h - border && gx >= border && gx < w - border) {
      const float s = fast_score(simg, ly + kHalo - 1, lx + kHalo - 1) *
                      smask[ly][lx + kHalo - 1];
      t = s > min_th ? s : 0.0f;
    }
    ssc[ly][lx] = t;
  }
  __syncthreads();
  const int lx = threadIdx.x;
  const int gx = x0 + lx;
  for (int ly = threadIdx.y; ly < kTile; ly += kThreadsY) {
    const int gy = y0 + ly;
    if (gy >= h || gx >= w) continue;
    const float c = ssc[ly + 1][lx + 1];
    float m = ssc[ly][lx];
    m = fmaxf(m, ssc[ly][lx + 1]);
    m = fmaxf(m, ssc[ly][lx + 2]);
    m = fmaxf(m, ssc[ly + 1][lx]);
    m = fmaxf(m, ssc[ly + 1][lx + 2]);
    m = fmaxf(m, ssc[ly + 2][lx]);
    m = fmaxf(m, ssc[ly + 2][lx + 1]);
    m = fmaxf(m, ssc[ly + 2][lx + 2]);
    out[static_cast<int64_t>(gy) * w + gx] = c > m ? c : 0.0f;
  }
}

cudaError_t launch(const Levels& lv, float min_th, int border, void* stream) {
  const int blocks = lv.first[lv.n_levels];
  if (blocks <= 0) return cudaGetLastError();
  fast_nms_levels_kernel<<<blocks, dim3(kThreadsX, kThreadsY), 0,
                           static_cast<cudaStream_t>(stream)>>>(lv, min_th,
                                                                border);
  return cudaGetLastError();
}

}  // namespace

// The levels of one image: imgs, masks, outs: n_levels host pointers to
// device [h, w] float32 row-major levels, their masks and their outputs;
// h, w: n_levels host ints; border >= 3.  n_levels is 1 to 16
// (cudaErrorInvalidValue otherwise).
extern "C" int airdos_fast_nms_levels(const int64_t* imgs,
                                      const int64_t* masks,
                                      const int64_t* outs, const int* h,
                                      const int* w, int n_levels,
                                      float min_th, int border,
                                      void* stream) {
  if (n_levels <= 0 || n_levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv{};
  int first = 0;
  for (int i = 0; i < n_levels; ++i) {
    lv.img[i] = reinterpret_cast<const float*>(imgs[i]);
    lv.mask[i] = reinterpret_cast<const float*>(masks[i]);
    lv.out[i] = reinterpret_cast<float*>(outs[i]);
    lv.h[i] = h[i];
    lv.w[i] = w[i];
    lv.tiles_x[i] = w[i] > 0 ? (w[i] + kTile - 1) / kTile : 0;
    lv.first[i] = first;
    if (h[i] > 0 && w[i] > 0) first += lv.tiles_x[i] * ((h[i] + kTile - 1) / kTile);
  }
  lv.first[n_levels] = first;
  lv.n_levels = n_levels;
  return static_cast<int>(launch(lv, min_th, border, stream));
}

// One level: img, mask, out: [h, w] float32 row-major; border >= 3.  The
// one-level case of the same kernel.
extern "C" int airdos_fast_nms(const void* img, const void* mask, void* out,
                               int h, int w, float min_th, int border,
                               void* stream) {
  const int64_t imgs[1] = {reinterpret_cast<int64_t>(img)};
  const int64_t masks[1] = {reinterpret_cast<int64_t>(mask)};
  const int64_t outs[1] = {reinterpret_cast<int64_t>(out)};
  return airdos_fast_nms_levels(imgs, masks, outs, &h, &w, 1, min_th, border,
                                stream);
}
