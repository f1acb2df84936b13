// Intensity-centroid angle and steered BRIEF (rBRIEF) descriptor of every
// keypoint slot of an image's pyramid levels in one launch, for sm_90a.
//
// Replaces airdos_tpu/ops/orientation.py:115 _angles_onehot and
// airdos_tpu/ops/brief.py:88 _samples_onehot, the TPU lowerings that cut
// each keypoint's patch out of the level with one-hot matrix products on
// the MXU.  The port's plain versions are ops/orientation.py
// keypoint_angles (a 31 x 31 gather and an einsum), ops/brief.py
// compute_descriptors and pack_u32.
//
// The levels' slots are concatenated, level after level (the selection's
// xs / ys); the level table (the level's image and blur, h, w, first slot)
// comes by value, at most kMaxLevels levels.  One warp a slot: global warp
// k takes slot k and finds its level as the last one whose first slot is
// at most k (a level with no slot is passed over).  In the warp:
// - the lane's 32 pattern points (x and y of both points of pairs
//   32 j + lane, j < 8) are loaded first, through the read-only cache;
// - lane l holds column dx = l - 15 of the radius-15 disc and loads all 31
//   of its rows at once (edge-clamped, as the plain gather), then adds
//   dx * I and dy * I in row order where |dx| <= umax[|dy|] (a predicate,
//   compile-time per row: an out-of-disc pixel adds nothing, as it was
//   skipped before).  The sums are float64: each product of a float32
//   pixel and a small integer is exact there, and so is the sum (under
//   2^22 in magnitude, in 2^-31 steps for pixels of at least 2^-8), in any
//   order; the plain version contracts in float64 too, so the rounded
//   float32 moments agree bit for bit with it whatever order either
//   reduction takes.  A disc that holds a nonzero pixel under 2^-8 (a
//   bilinear level beside zero pixels) can make the float64 sums round,
//   each order its own way, by up to ~700 float64 ulps of the largest
//   partial sum; the float32 moments then differ only where a sum lies
//   that close to a float32 rounding boundary, and ops/orb_kernels.py says
//   how such a level is held.  A shuffle-down tree reduces the sums and
//   lane 0's result is broadcast: the lane order of PR 9's kernel, whose
//   words and angles this one equals;
// - every lane computes the angle as torch does: atan2f, the multiply by
//   the float32 of 180 / pi, + 360 below 0; then the multiply by the
//   float32 of pi / 180, cosf and sinf;
// - lane i rotates its 16 pattern points, rounds them half to even
//   (rintf, cvRound), clamps them to the level and loads the blurred level
//   there, all 16 loads before the first ballot; then __ballot_sync packs
//   the 32 comparisons of word j into word j, bit i: pack_u32's
//   little-endian words, since byte b, bit k of the descriptor is pair
//   8 b + k.
// The rotation is written with __fmul_rn / __fadd_rn / __fsub_rn: torch
// rounds each product and the difference, and a contracted FMA would move
// a rotated sample across a .5 and flip a bit.  The source is built with
// nvcc's default -fmad (as torch's own cosf, sinf and atan2f are), not
// --fmad=false, so that the transcendentals are compiled as torch's are.
//
// What bounds it on an H100.  Neither rate: a keypoint reads ~709 disc
// pixels and 512 samples (~5 KB, from L2 or L1) and does ~5,000 operations;
// an image's 1,500 slots over 8 levels are under 8 MB and 8 MFLOP (a few
// microseconds at the worst).  PR 9's kernel took a launch a level (16 a
// stereo frame), each one warp's chain of 31 dependent row loads, the
// reduction, the transcendentals and 8 rounds of two dependent samples
// and a ballot: ~12-19 us a launch.  Here one launch covers an image's
// levels, and each warp has its disc rows and then its samples in flight
// together, so the chain is three memory round trips and the
// transcendentals.
//
// The C entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHalfPatch = 15;
constexpr int kRows = 2 * kHalfPatch + 1;
constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kMaxLevels = 16;
// the float32 values torch multiplies by in rad2deg and deg2rad
constexpr float kRadToDeg =
    static_cast<float>(57.295779513082320876798154814105170332405472466564);
constexpr float kDegToRad =
    static_cast<float>(0.017453292519943295769236907684886127134428718885417);

// The disc's half-width at row |dy| (ORBextractor.cc:456-471; the port's
// ops/orientation.py _umax, which the tests hold this table to); a
// constant once the rows are unrolled.
__device__ __forceinline__ int umax(int ady) {
  constexpr int kUmax[kHalfPatch + 1] = {15, 15, 15, 15, 14, 14, 14, 13,
                                         13, 12, 11, 10, 9, 8, 6, 3};
  return kUmax[ady];
}

// An image's levels: the level's image and its 7x7 blur ([h, w] float32),
// and its first slot in xs / ys; total slots over the levels.
struct Levels {
  const float* img[kMaxLevels];
  const float* blur[kMaxLevels];
  int h[kMaxLevels], w[kMaxLevels], first[kMaxLevels];
  int n_levels, total;
};

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// The address in the blurred level of the keypoint (x, y) plus the pattern
// point (px, py) rotated by (ca, sa).
__device__ __forceinline__ const float* sample_at(
    const float* __restrict__ blur, int64_t x, int64_t y, float px, float py,
    float ca, float sa, int h, int w) {
  const float rx = rintf(__fsub_rn(__fmul_rn(px, ca), __fmul_rn(py, sa)));
  const float ry = rintf(__fadd_rn(__fmul_rn(px, sa), __fmul_rn(py, ca)));
  const int64_t gx = clamp64(x + static_cast<int64_t>(rx), w - 1);
  const int64_t gy = clamp64(y + static_cast<int64_t>(ry), h - 1);
  return blur + gy * w + gx;
}

__global__ void __launch_bounds__(kThreads)
orb_desc_levels_kernel(const Levels lv, const int64_t* __restrict__ xs,
                       const int64_t* __restrict__ ys,
                       const float* __restrict__ pattern,
                       float* __restrict__ angle, int32_t* __restrict__ desc) {
  const int kp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (kp >= lv.total) return;  // the whole warp
  // pattern: [2][512], x then y; pair p compares point p with 256 + p
  float p0x[8], p0y[8], p1x[8], p1y[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = 32 * j + lane;
    p0x[j] = __ldg(pattern + p);
    p0y[j] = __ldg(pattern + 512 + p);
    p1x[j] = __ldg(pattern + 256 + p);
    p1y[j] = __ldg(pattern + 768 + p);
  }
  int l = 0;
  while (l + 1 < lv.n_levels && kp >= lv.first[l + 1]) ++l;
  const float* __restrict__ img = lv.img[l];
  const float* __restrict__ blur = lv.blur[l];
  const int h = lv.h[l], w = lv.w[l];
  const int64_t x = xs[kp];
  const int64_t y = ys[kp];

  // the lane's disc column, every row in flight at once
  const int dx = lane - kHalfPatch;
  const int adx = dx < 0 ? -dx : dx;
  const float* __restrict__ col = img + clamp64(x + dx, w - 1);
  float v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    v[r] = __ldg(col + clamp64(y + r - kHalfPatch, h - 1) * w);
  double m10 = 0.0, m01 = 0.0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int dy = r - kHalfPatch;
    if (adx <= umax(dy < 0 ? -dy : dy)) {    // lane 31 (dx 16) never
      const double pv = static_cast<double>(v[r]);
      m10 += static_cast<double>(dx) * pv;
      m01 += static_cast<double>(dy) * pv;
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

  // the 16 samples in flight, then the 8 ballots
  float s0[8], s1[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s0[j] = __ldg(sample_at(blur, x, y, p0x[j], p0y[j], ca, sa, h, w));
    s1[j] = __ldg(sample_at(blur, x, y, p1x[j], p1y[j], ca, sa, h, w));
  }
  int32_t word = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned bits = __ballot_sync(0xffffffffu, s0[j] < s1[j]);
    if (lane == j) word = static_cast<int32_t>(bits);
  }
  if (lane < 8) desc[static_cast<int64_t>(kp) * 8 + lane] = word;
}

cudaError_t launch(const Levels& lv, const void* xs, const void* ys,
                   const void* pattern, void* angle, void* desc,
                   void* stream) {
  const int blocks = (lv.total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  orb_desc_levels_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const int64_t*>(xs), static_cast<const int64_t*>(ys),
      static_cast<const float*>(pattern), static_cast<float*>(angle),
      static_cast<int32_t*>(desc));
  return cudaGetLastError();
}

}  // namespace

// The levels of one image: imgs, blurs: n_levels host pointers to device
// [h, w] float32 row-major levels and their blurs; h, w, quota: n_levels
// host ints (the level's slots, in order); xs, ys: [sum(quota)] int64;
// pattern: [2, 512] float32 (the x and the y of the 512 pattern points);
// angle: [sum(quota)] float32; desc: [sum(quota), 8] int32.
// n_levels is 1 to 16 (cudaErrorInvalidValue otherwise).
extern "C" int airdos_orb_desc_levels(const int64_t* imgs,
                                      const int64_t* blurs, const int* h,
                                      const int* w, const int* quota,
                                      int n_levels, const void* xs,
                                      const void* ys, const void* pattern,
                                      void* angle, void* desc,
                                      void* stream) {
  if (n_levels <= 0 || n_levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv{};
  int first = 0;
  for (int i = 0; i < n_levels; ++i) {
    lv.img[i] = reinterpret_cast<const float*>(imgs[i]);
    lv.blur[i] = reinterpret_cast<const float*>(blurs[i]);
    lv.h[i] = h[i];
    lv.w[i] = w[i];
    lv.first[i] = first;
    first += quota[i];
  }
  lv.n_levels = n_levels;
  lv.total = first;
  if (first <= 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(launch(lv, xs, ys, pattern, angle, desc, stream));
}

// One level: img, blur: [h, w] float32; xs, ys: [n] int64; the rest as
// above.  The one-level case of the same kernel.
extern "C" int airdos_orb_desc(const void* img, const void* blur,
                               const void* xs, const void* ys,
                               const void* pattern, int n, int h, int w,
                               void* angle, void* desc, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  Levels lv{};
  lv.img[0] = static_cast<const float*>(img);
  lv.blur[0] = static_cast<const float*>(blur);
  lv.h[0] = h;
  lv.w[0] = w;
  lv.first[0] = 0;
  lv.n_levels = 1;
  lv.total = n;
  return static_cast<int>(launch(lv, xs, ys, pattern, angle, desc, stream));
}
