// Stereo disparity at the human layer's torso probes in one launch, for
// sm_90a: SAD block matching of an 11 x 11 window over 48 disparities at
// each requested left pixel, with the parabola refinement.
//
// Replaces airdos_tpu/ops/disparity.py:27 patch_disparity (a [N, D, B, B]
// gather of the right image, then a sum).  The port's plain version is
// ops/disparity.py patch_disparity_ref.  For probe (u, v) = round(px)
// (half to even), B = 11 and D = 48:
//
//   patchL = the left image at rows v - 5..v + 5, columns u - 5..u + 5,
//            each clamped into the image;
//   sad[d] = sum |patchL - the right image at the same rows, columns
//            u - d - 5..u - d + 5 clamped|, + 1e8 where u - d - 5 < 0 (the
//            window is not covered);
//   d*     = the first minimum; the parabola delta = (sad[d*-1] -
//            sad[d*+1]) / 2 / (sad[d*-1] + sad[d*+1] - 2 sad[d*]) (0 where
//            the denominator is within 1e-6 of 0), clamped to +-0.5;
//   out    = d* + delta where (u, v) lies in the image, 0 < d* < D - 1
//            and sad[d*] < 1e7, else -1.
//
// One block a probe: the left patch and the right strip (B x (D + B - 1),
// 11 x 58) go to shared memory; thread d forms sad[d] as a float64 sum of
// its 121 float32 differences and rounds it once; thread 0 takes the first
// minimum and fits the parabola.
//
// Exact: on the 8-bit images of the path every difference is an integer
// and every SAD an integer under 2^15, exact in any order.  The float64 sum
// is exact in any order for any pixels that are multiples of 2^-31 under
// 2^11 in magnitude (0 or at least 2^-8), and the plain version sums in
// float64 too and rounds once; the coverage penalty and the parabola are
// torch's float32 steps (__fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn).
// So the output is bit-equal to the plain version's under that condition.
//
// What bounds it on an H100.  Bytes: each probe's 121 + 638 pixels (~3 kB,
// 0.12 MB for the path's 40 probes) and 4 bytes out: ~0.04 us.
// Operations: 48 x 121 differences, absolute values and sums a probe, 0.7
// MFLOP for 40 probes: ~0.02 us at the float64 rate.  40 blocks on 132
// SMs: the launch and each block's chain of reads and its serial argmin
// set the time.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDisp = 64;
constexpr int kMaxBlock = 15;
constexpr int kThreads = 64;

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads)
patch_disparity_kernel(const float* __restrict__ left,
                       const float* __restrict__ right, int h, int w,
                       const float* __restrict__ px, int num_disp, int block,
                       float* __restrict__ out) {
  __shared__ float patch[kMaxBlock * kMaxBlock];
  __shared__ float strip[kMaxBlock * (kMaxDisp + kMaxBlock - 1)];
  __shared__ float sad[kMaxDisp];
  const int i = blockIdx.x, t = threadIdx.x;
  const int half = block / 2;
  const int span = num_disp + block - 1;     // strip columns
  const int64_t u = static_cast<int64_t>(rintf(px[2 * i]));
  const int64_t v = static_cast<int64_t>(rintf(px[2 * i + 1]));

  for (int j = t; j < block * span; j += kThreads) {
    const int r = j / span, c = j - (j / span) * span;
    const int64_t y = clamp64(v + r - half, h - 1);
    // strip column c is right-image column u - (num_disp - 1) - half + c
    strip[j] = right[y * w + clamp64(u - (num_disp - 1) - half + c, w - 1)];
    if (c < block)
      patch[r * block + c] = left[y * w + clamp64(u + c - half, w - 1)];
  }
  __syncthreads();

  if (t < num_disp) {
    const int c0 = num_disp - 1 - t;         // disparity t's first column
    double acc = 0.0;
    for (int r = 0; r < block; ++r)
      for (int c = 0; c < block; ++c)
        acc += static_cast<double>(
            fabsf(__fsub_rn(patch[r * block + c], strip[r * span + c0 + c])));
    const bool covered = u - t - half >= 0;
    sad[t] = __fadd_rn(__double2float_rn(acc), covered ? 0.0f : 1e8f);
  }
  __syncthreads();

  if (t == 0) {
    int best = 0;
    for (int d = 1; d < num_disp; ++d)
      if (sad[d] < sad[best]) best = d;
    const float cm = sad[best > 0 ? best - 1 : 0];
    const float c0 = sad[best];
    const float cp = sad[best < num_disp - 1 ? best + 1 : num_disp - 1];
    const float denom = __fsub_rn(__fadd_rn(cm, cp), __fmul_rn(2.0f, c0));
    const float delta =
        fabsf(denom) > 1e-6f
            ? __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(cm, cp)), denom)
            : 0.0f;
    const bool valid = u >= 0 && u < w && v >= 0 && v < h && best > 0 &&
                       best < num_disp - 1 && c0 < 1e7f;
    out[i] = valid ? __fadd_rn(static_cast<float>(best),
                               fminf(fmaxf(delta, -0.5f), 0.5f))
                   : -1.0f;
  }
}

}  // namespace

// left, right: [h, w] float32 row-major; px: [n, 2] float32 (u, v); out
// [n] float32; num_disp <= 64, block odd <= 15.
extern "C" int airdos_patch_disparity(const void* left, const void* right,
                                      int h, int w, const void* px, int n,
                                      int num_disp, int block, void* out,
                                      void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (num_disp < 1 || num_disp > kMaxDisp || block < 1 || block > kMaxBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  patch_disparity_kernel<<<n, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(left), static_cast<const float*>(right), h, w,
      static_cast<const float*>(px), num_disp, block,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
