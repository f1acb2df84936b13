// Intensity-centroid angle and steered BRIEF (rBRIEF) descriptor of one
// pyramid level's keypoints in one launch, for sm_90a.
//
// Replaces airdos_tpu/ops/orientation.py:115 _angles_onehot and
// airdos_tpu/ops/brief.py:88 _samples_onehot, the TPU lowerings that cut
// each keypoint's patch out of the level with one-hot matrix products on
// the MXU.  The port's plain versions are ops/orientation.py
// keypoint_angles (a 31 x 31 gather and an einsum), ops/brief.py
// compute_descriptors and pack_u32.
//
// One warp a keypoint:
// - lane l holds column dx = l - 15 of the radius-15 disc and walks its 31
//   rows, adding dx * I and dy * I where |dx| <= umax[|dy|], at the same
//   edge-clamped coordinates as the plain gather.  The sums are float64:
//   each product of a float32 pixel and a small integer is exact there, and
//   so is the sum (under 2^22 in magnitude, in 2^-31 steps for pixels of at
//   least 2^-8), in any order; the plain version contracts in float64 too,
//   so the rounded float32 moments agree bit for bit with it whatever order
//   either reduction takes.  A disc that holds a nonzero pixel under 2^-8
//   (a bilinear level beside zero pixels) can make the float64 sums round, each
//   order its own way, by up to ~700 float64 ulps of the largest partial
//   sum; the float32 moments then differ only where a sum lies that close
//   to a float32 rounding boundary, and ops/orb_kernels.py says how such a
//   level is held.  A shuffle-down tree reduces the sums and lane 0's
//   result is broadcast;
// - every lane computes the angle as torch does: atan2f, the multiply by
//   the float32 of 180 / pi, + 360 below 0; then the multiply by the
//   float32 of pi / 180, cosf and sinf;
// - for word j of the descriptor, lane i rotates the pair 32 j + i's two
//   pattern points, rounds them half to even (rintf, cvRound), clamps them
//   to the level and compares the blurred level there; __ballot_sync packs
//   the 32 comparisons into word j, bit i: pack_u32's little-endian words,
//   since byte b, bit k of the descriptor is pair 8 b + k.
// The rotation is written with __fmul_rn / __fadd_rn / __fsub_rn: torch
// rounds each product and the difference, and a contracted FMA would move
// a rotated sample across a .5 and flip a bit.  The source is built with
// nvcc's default -fmad (as torch's own cosf, sinf and atan2f are), not
// --fmad=false, so that the transcendentals are compiled as torch's are.
// The pattern (512 points) is read through the read-only cache, lane i
// reading point 32 j + i (a coalesced 128-byte line); constant memory would
// serialise 32 different addresses.  umax (16 values, the same address
// across the warp) is in constant memory.
//
// What bounds it on an H100.  Neither rate: a keypoint reads ~709 disc
// pixels and 512 samples (~5 KB, from L2 or L1) and does ~5,000 operations;
// a level's 90-330 keypoints are under 2 MB and 2 MFLOP (well under a
// microsecond either way).  The time is the launch and one warp's chain of
// dependent reads, reductions and transcendentals.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHalfPatch = 15;
constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;
// the float32 values torch multiplies by in rad2deg and deg2rad
constexpr float kRadToDeg =
    static_cast<float>(57.295779513082320876798154814105170332405472466564);
constexpr float kDegToRad =
    static_cast<float>(0.017453292519943295769236907684886127134428718885417);

// The disc's half-width per row |dy| (ORBextractor.cc:456-471; the port's
// ops/orientation.py _umax, which the tests hold this table to).
__constant__ int kUmax[kHalfPatch + 1] = {15, 15, 15, 15, 14, 14, 14, 13,
                                          13, 12, 11, 10, 9, 8, 6, 3};

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// The blurred level at the keypoint (x, y) plus the pattern point
// (px, py) rotated by (ca, sa).
__device__ __forceinline__ float sample(const float* __restrict__ blur,
                                        int64_t x, int64_t y, float px,
                                        float py, float ca, float sa, int h,
                                        int w) {
  const float rx = rintf(__fsub_rn(__fmul_rn(px, ca), __fmul_rn(py, sa)));
  const float ry = rintf(__fadd_rn(__fmul_rn(px, sa), __fmul_rn(py, ca)));
  const int64_t gx = clamp64(x + static_cast<int64_t>(rx), w - 1);
  const int64_t gy = clamp64(y + static_cast<int64_t>(ry), h - 1);
  return __ldg(blur + gy * w + gx);
}

__global__ void __launch_bounds__(kThreads)
orb_desc_kernel(const float* __restrict__ img, const float* __restrict__ blur,
                const int64_t* __restrict__ xs, const int64_t* __restrict__ ys,
                const float* __restrict__ pattern, int n, int h, int w,
                float* __restrict__ angle, int32_t* __restrict__ desc) {
  const int kp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (kp >= n) return;  // the whole warp
  const int64_t x = xs[kp];
  const int64_t y = ys[kp];

  double m10 = 0.0, m01 = 0.0;
  const int dx = lane - kHalfPatch;
  if (lane <= 2 * kHalfPatch) {
    const int adx = dx < 0 ? -dx : dx;
    const int64_t gx = clamp64(x + dx, w - 1);
    for (int dy = -kHalfPatch; dy <= kHalfPatch; ++dy) {
      if (adx > kUmax[dy < 0 ? -dy : dy]) continue;
      const double v = static_cast<double>(
          __ldg(img + clamp64(y + dy, h - 1) * w + gx));
      m10 += static_cast<double>(dx) * v;
      m01 += static_cast<double>(dy) * v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_down_sync(0xffffffffu, m10, off);
    m01 += __shfl_down_sync(0xffffffffu, m01, off);
  }
  m10 = __shfl_sync(0xffffffffu, m10, 0);
  m01 = __shfl_sync(0xffffffffu, m01, 0);

  float a = __fmul_rn(atan2f(__double2float_rn(m01), __double2float_rn(m10)),
                      kRadToDeg);
  if (a < 0.0f) a = __fadd_rn(a, 360.0f);
  if (lane == 0) angle[kp] = a;
  const float r = __fmul_rn(a, kDegToRad);
  const float ca = cosf(r);
  const float sa = sinf(r);

  // pattern: [2][512], x then y; pair p compares point p with 256 + p
  for (int j = 0; j < 8; ++j) {
    const int p = 32 * j + lane;
    const float v0 = sample(blur, x, y, __ldg(pattern + p),
                            __ldg(pattern + 512 + p), ca, sa, h, w);
    const float v1 = sample(blur, x, y, __ldg(pattern + 256 + p),
                            __ldg(pattern + 768 + p), ca, sa, h, w);
    const unsigned bits = __ballot_sync(0xffffffffu, v0 < v1);
    if (lane == j) desc[static_cast<int64_t>(kp) * 8 + j] = static_cast<int32_t>(bits);
  }
}

}  // namespace

// img, blur: [h, w] float32; xs, ys: [n] int64; pattern: [2, 512] float32
// (the x and the y of the 512 pattern points); angle: [n] float32; desc:
// [n, 8] int32.
extern "C" int airdos_orb_desc(const void* img, const void* blur,
                               const void* xs, const void* ys,
                               const void* pattern, int n, int h, int w,
                               void* angle, void* desc, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  orb_desc_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(blur),
      static_cast<const int64_t*>(xs), static_cast<const int64_t*>(ys),
      static_cast<const float*>(pattern), n, h, w,
      static_cast<float*>(angle), static_cast<int32_t*>(desc));
  return static_cast<int>(cudaGetLastError());
}
