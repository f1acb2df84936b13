// One level of the ORB scale pyramid of one image in one launch, for
// sm_90a: the level's image, its usable-pixel mask and its 7x7 Gaussian
// blur.
//
// Replaces airdos_tpu/ops/pyramid.py:39 build_pyramid with the filters it
// runs: airdos_tpu/ops/filters.py:107 resize_bilinear (XLA gathers), :71
// erode (reduce_window) and :51 gaussian_blur7, the shift-and-add the TPU
// needs because a one-channel convolution does not tile onto the MXU.  The
// port's plain version is ops/pyramid.py pyramid_level_ref: ~80 torch
// launches a level for the resizes and the threshold, ~28 for the blur.
// Here, for level l >= 1 of size h x w, from level l - 1 of size hs x ws:
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
// plain version blurs.  Then the rows' horizontal sums over the tile's
// columns, then the vertical sums.  The erosion is separable too: the
// tile's mask with a k / 2, k - 1 - k / 2 px halo (5 / 4 at k = 10), the
// row minima, the column minima.
//
// Exact: every rounding is the plain version's.  The index and weight
// arithmetic is torch's step by step (arange + 0.5, * sy, - 0.5, clamp,
// floor, ys - y0, 1 - wy); each bilinear value is four products and three
// sums, each blur output seven products and six sums in the plain
// version's order.  Each product and sum is written with __fmul_rn /
// __fadd_rn / __fsub_rn, which nvcc does not contract into a multiply-add:
// eager torch rounds every product, so a contracted one would move values
// by an ulp.  So the three outputs are bit-equal to the plain version's.
//
// What bounds it on an H100.  Bytes: level l - 1's image and mask read
// once (8 bytes a pixel), three outputs written (12 bytes a pixel): for
// level 1 at 640 x 360, 1.8 + 1.9 MB, ~1.1 us at 3.35 TB/s.  Operations:
// ~26 float32 operations a bilinear value (two a pixel) and 26 for the
// blur, ~80 a pixel, of the same order.  The tile's source footprint is
// read through L1 and L2 (neighbouring blocks share its edge rows), the
// blur's 49 taps read shared memory only.  A level is small (0.02-0.23
// Mpixel), so the launch and its dependence on the level before it, not
// either rate, set its time.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                 // output tile edge
constexpr int kHalo = 3;                  // the blur's half width
constexpr int kExt = kTile + 2 * kHalo;   // 38: resized tile with halo
constexpr int kMaxErode = 16;             // the erosion's largest window
constexpr int kMExt = kTile + kMaxErode - 1;  // 47: mask tile with halo
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;

enum MaskKind { kNoMask = 0, kMaskU8 = 1, kMaskF32 = 2 };

struct Taps {
  float k[7];
};

// BORDER_REFLECT_101 of index i into [0, n), n >= 4, for i in [-3, n + 2];
// indices beyond (a tile past the level's edge, whose values no output
// reads) are clamped so that every read stays inside.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// One axis of resize_bilinear's index arithmetic: destination index d,
// source size n, scale s (float32(n / out)).  Returns the two source
// indices and the weights (1 - f, f).
struct Axis {
  int i0, i1;
  float w0, w1;
};

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
__device__ __forceinline__ float bilinear(const float* __restrict__ src,
                                          int ws, const Axis& ay,
                                          const Axis& ax) {
  const float* r0 = src + static_cast<int64_t>(ay.i0) * ws;
  const float* r1 = src + static_cast<int64_t>(ay.i1) * ws;
  const float top = __fadd_rn(__fmul_rn(r0[ax.i0], ax.w0),
                              __fmul_rn(r0[ax.i1], ax.w1));
  const float bot = __fadd_rn(__fmul_rn(r1[ax.i0], ax.w0),
                              __fmul_rn(r1[ax.i1], ax.w1));
  return __fadd_rn(__fmul_rn(top, ay.w0), __fmul_rn(bot, ay.w1));
}

__global__ void __launch_bounds__(kThreads)
pyramid_level_kernel(const float* __restrict__ src,
                     const void* __restrict__ src_mask, int mask_kind,
                     int hs, int ws, float* __restrict__ img,
                     float* __restrict__ mask, float* __restrict__ blur,
                     int h, int w, float sy, float sx, Taps taps,
                     int level0, int erode_k) {
  __shared__ float sr[kExt][kExt + 1];        // resized, with the halo
  __shared__ float sh[kExt][kTile + 1];       // rows' horizontal sums
  __shared__ float sm[kMExt][kMExt + 1];      // level 0: mask + halo
  __shared__ float smr[kMExt][kTile + 1];     // level 0: row minima
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  // the erosion window: rows y - lo .. y + k - 1 - lo, likewise columns
  const int erode_lo = erode_k / 2;
  const int mext = kTile + erode_k - 1;

  for (int i = tid; i < kExt * kExt; i += kThreads) {
    const int ly = i / kExt, lx = i - (i / kExt) * kExt;
    const int gy = reflect101(y0 - kHalo + ly, h);
    const int gx = reflect101(x0 - kHalo + lx, w);
    sr[ly][lx] = level0 ? src[static_cast<int64_t>(gy) * ws + gx]
                        : bilinear(src, ws, axis(gy, hs, sy),
                                   axis(gx, ws, sx));
  }
  if (level0 && mask_kind != kNoMask) {
    for (int i = tid; i < mext * mext; i += kThreads) {
      const int ly = i / mext, lx = i - (i / mext) * mext;
      const int gy = y0 - erode_lo + ly, gx = x0 - erode_lo + lx;
      float v = 1.0f;                           // cv2.erode's border
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        const int64_t at = static_cast<int64_t>(gy) * ws + gx;
        v = mask_kind == kMaskU8
                ? static_cast<float>(static_cast<const uint8_t*>(src_mask)[at])
                : static_cast<const float*>(src_mask)[at];
      }
      sm[ly][lx] = v;
    }
  }
  __syncthreads();

  for (int i = tid; i < kExt * kTile; i += kThreads) {
    const int ly = i / kTile, lx = i - (i / kTile) * kTile;
    float acc = __fmul_rn(taps.k[0], sr[ly][lx]);
#pragma unroll
    for (int t = 1; t < 7; ++t)
      acc = __fadd_rn(acc, __fmul_rn(taps.k[t], sr[ly][lx + t]));
    sh[ly][lx] = acc;
  }
  if (level0 && mask_kind != kNoMask) {
    for (int i = tid; i < mext * kTile; i += kThreads) {
      const int ly = i / kTile, lx = i - (i / kTile) * kTile;
      float m = sm[ly][lx];
      for (int t = 1; t < erode_k; ++t) m = fminf(m, sm[ly][lx + t]);
      smr[ly][lx] = m;
    }
  }
  __syncthreads();

  const int lx = threadIdx.x;
  const int gx = x0 + lx;
  for (int ly = threadIdx.y; ly < kTile; ly += kThreadsY) {
    const int gy = y0 + ly;
    if (gy >= h || gx >= w) continue;
    const int64_t at = static_cast<int64_t>(gy) * w + gx;
    float acc = __fmul_rn(taps.k[0], sh[ly][lx]);
#pragma unroll
    for (int t = 1; t < 7; ++t)
      acc = __fadd_rn(acc, __fmul_rn(taps.k[t], sh[ly + t][lx]));
    blur[at] = acc;
    float m;
    if (level0) {
      m = 1.0f;
      if (mask_kind != kNoMask) {
        m = smr[ly][lx];
        for (int t = 1; t < erode_k; ++t) m = fminf(m, smr[ly + t][lx]);
      }
    } else {
      img[at] = sr[ly + kHalo][lx + kHalo];
      const float r = bilinear(static_cast<const float*>(src_mask), ws,
                               axis(gy, hs, sy), axis(gx, ws, sx));
      m = r > 0.999f ? 1.0f : 0.0f;
    }
    mask[at] = m;
  }
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
  Taps t;
  for (int i = 0; i < 7; ++i) t.k[i] = taps[i];
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  const dim3 block(kThreadsX, kThreadsY);
  pyramid_level_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), src_mask, mask_kind, hs, ws,
      static_cast<float*>(img), static_cast<float*>(mask),
      static_cast<float*>(blur), h, w, sy, sx, t, level0, erode_k);
  return static_cast<int>(cudaGetLastError());
}
