// FAST-9/16 scores with the extractor's masking, threshold and strict 3x3
// non-max suppression, one pyramid level in one launch, for sm_90a.
//
// Replaces airdos_tpu/ops/fast.py:32 fast_score_map (16 rolls of the
// image, then 16 x 9 minimum / maximum maps) and :70 nms_strict (8 rolls),
// with the caller's steps between them (airdos_tpu/features/orb.py: the
// multiply by the mask, the zeroed MIN_BORDER frame and the score >
// min_th threshold).  The port's plain version is ops/fast.py fast_nms_ref,
// ~40 full-image torch launches a level.  Here:
//
//   out[y, x] = t(y, x) if t(y, x) > max over its 8 neighbours of t else 0,
//   t = s * mask where (y, x) lies in [border, h - border) x [border, w -
//   border) and s * mask > min_th, else 0,
//
// s the FAST score (the largest threshold at which 9 contiguous circle
// pixels are all brighter or all darker than the centre).
//
// One block computes a 32 x 32 output tile.  The image tile with a 4 px
// halo (3 for the circle, 1 for the NMS ring) goes to shared memory, with
// pixels outside the image read as 0; then the thresholded scores of the
// tile and a 1 px ring, then the NMS.  The plain version's rolls wrap
// around the image, but only inside a frame that the border zeroes, so
// reading outside as 0 gives the same output.
//
// Exact: every value is a difference of two floats, a minimum or maximum,
// or the one product s * mask, each computed as the plain version computes
// it, so the output is bit-equal.  No product feeds a sum, so nvcc has no
// multiply-add to contract.
//
// What bounds it on an H100.  Bytes: the image and the mask read once and
// the output written once, 12 bytes a pixel (2.8 MB at 640 x 360: 0.8 us at
// 3.35 TB/s).  Operations: ~300 float32 operations a pixel of the interior
// (16 differences, 2 x 16 x 8 arc minima and maxima), about the same time
// at the float32 peak.  The tile is read from HBM once and every circle
// read comes from shared memory.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;              // output tile edge
constexpr int kHalo = 4;
constexpr int kImg = kTile + 2 * kHalo;  // 40: image tile edge
constexpr int kSc = kTile + 2;           // 34: score tile edge (1 px ring)
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;

// OpenCV's Bresenham circle of radius 3, clockwise from (0, -3)
__constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                  0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                  3, 3, 2, 1, 0, -1, -2, -3};

// The FAST-9/16 score at image tile position (ly, lx) (>= 3 from its edge).
__device__ __forceinline__ float fast_score(const float (*img)[kImg + 1],
                                            int ly, int lx) {
  const float p = img[ly][lx];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = img[ly + kCircleDy[k]][lx + kCircleDx[k]] - p;
  // per arc start s: the minimum (lo) and maximum (hi) over its 9 pixels;
  // bright = max over s of lo, dark = -(min over s of hi)
  float bright = 0.0f, dark_min = 0.0f;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    float lo = d[s], hi = d[s];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      lo = fminf(lo, d[(s + j) & 15]);
      hi = fmaxf(hi, d[(s + j) & 15]);
    }
    bright = s == 0 ? lo : fmaxf(bright, lo);
    dark_min = s == 0 ? hi : fminf(dark_min, hi);
  }
  return fmaxf(fmaxf(bright, -dark_min), 0.0f);
}

__global__ void __launch_bounds__(kThreads)
fast_nms_kernel(const float* __restrict__ img, const float* __restrict__ mask,
                float* __restrict__ out, int h, int w, float min_th,
                int border) {
  __shared__ float simg[kImg][kImg + 1];
  __shared__ float ssc[kSc][kSc + 1];
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  for (int i = tid; i < kImg * kImg; i += kThreads) {
    const int ly = i / kImg, lx = i - (i / kImg) * kImg;
    const int gy = y0 - kHalo + ly, gx = x0 - kHalo + lx;
    simg[ly][lx] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                       ? img[static_cast<int64_t>(gy) * w + gx]
                       : 0.0f;
  }
  __syncthreads();
  for (int i = tid; i < kSc * kSc; i += kThreads) {
    const int ly = i / kSc, lx = i - (i / kSc) * kSc;
    const int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
    float t = 0.0f;
    if (gy >= border && gy < h - border && gx >= border && gx < w - border) {
      const float s = fast_score(simg, ly + kHalo - 1, lx + kHalo - 1) *
                      mask[static_cast<int64_t>(gy) * w + gx];
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

}  // namespace

// img, mask, out: [h, w] float32 row-major; border >= 3.
extern "C" int airdos_fast_nms(const void* img, const void* mask, void* out,
                               int h, int w, float min_th, int border,
                               void* stream) {
  if (h <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  const dim3 block(kThreadsX, kThreadsY);
  fast_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(mask),
      static_cast<float*>(out), h, w, min_th, border);
  return static_cast<int>(cudaGetLastError());
}
