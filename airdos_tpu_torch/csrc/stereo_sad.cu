// Stereo sub-pixel refinement of every left keypoint in one launch, for
// sm_90a: the 11 SADs of an 11 x 11 window slid +-5 px along the right
// image's row, the parabola through the best and its neighbours, and the
// tests that accept the match.
//
// Replaces airdos_tpu/matching/stereo.py:53 _sad_windows_onehot (one
// one-hot MXU matmul for the window rows, then per-slot one-hot
// contractions) and its CPU form :45 _sad_windows_gather.  The port's
// plain version is ops/stereo_sad.py stereo_sad_ref (the refinement of
// matching/stereo.py stereo_match: the [L, H0, W0] level stacks, two
// gathers, 11 window sums, the parabola; ~170 torch launches).  For left
// keypoint i at level o (scale s = scales[o]), matched to right keypoint
// best_r[i]:
//
//   (su, sv), su_r = round((uL, vL) / s), round(uR[best_r[i]] / s)
//                    (1 / s is torch's reciprocal, rounding half to even);
//   patch  = level o of the left image at rows sv - 5..sv + 5, columns
//            su - 5..su + 5; strip = the right image's level at the same
//            rows, columns su_r - 10..su_r + 10; every row clamped to
//            [0, H0 - 1] and column to [0, W0 - 1] of level 0's size, and a
//            pixel outside level o's own extent read as 0 (the zero-padded
//            stack the plain version gathers from);
//   sad[k] = sum |(patch - patch centre) - (window k - window k's centre)|,
//            window k = strip columns k..k + 10, k = 0..10;
//   the first minimum k*, the parabola delta = (sad[k*-1] - sad[k*+1]) /
//   (2 (sad[k*-1] + sad[k*+1] - 2 sad[k*])) (2 where the denominator is
//   within 1e-6 of 0), u_r = s (su_r + k* - 5 + delta), the disparity
//   uL - u_r (0.01, and u_r = uL - 0.01, where it is <= 0);
//   accept = cand_ok & valid & su_r >= 0 & su_r + 11 < width[o] & 0 < k* <
//   10 & |delta| <= 1 & 0 <= disparity < max_d (before the tiny fix).
//
// The median cut over the accepted SADs (a sort), the Hamming gating and
// the argmins before it stay eager torch in matching/stereo.py.
//
// Half a warp a keypoint (two a warp, four a block of 64 threads); the
// levels are read where they lie (a pointer a level), so the plain
// version's zero-padded stacks are never built.  Three dependent rounds
// of loads, each issued at once: (1) the keypoint's header, and the
// scales and widths of every level, one a lane, taken by shuffle from
// lane o; (2) the right keypoint's u and the patch, column c in lane c
// (11 rows); (3) the strip, columns c and c + 16 in lane c.  The lanes
// store the centred patch (each pixel minus the patch centre, float32)
// and the strip in shared memory; then lane k < 11 sums SAD k's 121
// terms in float64 over two accumulators, the warp's two keypoints on
// other banks; the SADs go to every lane by shuffles, the first minimum
// and its neighbours are found in registers, and lane 0 runs the
// parabola and the tests and writes.
//
// Exact: each term is the float32 difference the plain version takes; the
// sums are float64, where 121 float32 terms that are multiples of 2^-31
// and under 2^11 (every pixel 0 or at least 2^-8 in magnitude, as in an
// 8-bit image and its bilinear levels away from zero pixels) add exactly in
// any order; the plain version sums in float64 too and rounds once to
// float32, so the SADs are bit-equal under that condition, and with them
// k*, the parabola (__fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn, torch's
// rounding step by step, nothing contracted) and every output.  A pixel
// under 2^-8 beside zero pixels can make the float64 sums round, each
// order its own way.
//
// What bounds it on an H100.  Bytes: each keypoint's 121 + 231 window
// pixels (1.4 kB, ~2 MB for 1536 keypoints, mostly from L2) and 24 bytes
// of outputs; ~0.6 us.  Operations: 1331 differences, absolute values and
// float64 sums a keypoint, ~6 MFLOP for 1536: ~0.1 us at the float64 rate.
// The three rounds of loads and the launch set its time.  The earlier
// design took a warp a keypoint: its staging loop kept one round of loads
// in flight at a time, and each of the 11 SADs ended in a 5-step shuffle
// tree of doubles.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kW = 5;                     // half window
constexpr int kL = 5;                     // slide range
constexpr int kWin = 2 * kW + 1;          // 11
constexpr int kSlide = 2 * kL + 1;        // 11
constexpr int kStrip = kWin + 2 * kL;     // 21
constexpr int kHalf = 16;                 // lanes a keypoint
constexpr int kWarps = 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kPoints = kThreads / kHalf; // keypoints a block
// floats a keypoint in shared memory: the centred patch (121) and the
// strip (231), padded to 16 mod 32 so that a warp's two keypoints read
// other banks
constexpr int kStride = 368;
static_assert(kStride >= kWin * kWin + kWin * kStrip && kStride % 32 == 16,
              "a keypoint's windows, its half-warp's banks");
static_assert(kMaxLevels <= kHalf, "a level's scale and width a lane");

struct Levels {
  const float* left[kMaxLevels];
  const float* right[kMaxLevels];
  int h[kMaxLevels], w[kMaxLevels];
};

__device__ __forceinline__ int clamp_to(int64_t v, int hi) {
  return static_cast<int>(v < 0 ? 0 : (v > hi ? hi : v));
}

// pixel (y, x) of a level of size h x w inside the stack's h0 x w0 extent
__device__ __forceinline__ float stacked(const float* __restrict__ im,
                                         int h, int w, int y, int x) {
  return (y < h && x < w) ? im[y * w + x] : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
stereo_sad_kernel(const __grid_constant__ Levels lv, int n_levels, int n,
                  int h0, int w0,
                  const float* __restrict__ xy_l,
                  const int64_t* __restrict__ oct_l,
                  const uint8_t* __restrict__ valid_l,
                  const float* __restrict__ xy_r,
                  const int64_t* __restrict__ best_r,
                  const uint8_t* __restrict__ cand_ok,
                  const int64_t* __restrict__ widths,
                  const float* __restrict__ scales, float max_d,
                  float* __restrict__ best_sad, float* __restrict__ u_r,
                  float* __restrict__ disparity, uint8_t* __restrict__ accept) {
  __shared__ __align__(16) float win[kPoints][kStride];
  constexpr unsigned kAll = 0xffffffffu;
  const int slot = threadIdx.x / kHalf;
  const int lane = threadIdx.x % kHalf;
  const int base = threadIdx.x & 16;       // the half's first lane in its warp
  const int i = blockIdx.x * kPoints + slot;
  const bool live = i < n;
  const int ik = live ? i : n - 1;         // a spare half works, writes nothing

  // (1) the header, and every level's scale and width
  const int o = static_cast<int>(oct_l[ik]);
  const float uL = xy_l[2 * ik], vL = xy_l[2 * ik + 1];
  const int64_t br = best_r[ik];
  const bool gated = (cand_ok[ik] != 0) & (valid_l[ik] != 0);
  const float s_lane = lane < n_levels ? scales[lane] : 1.0f;
  const int64_t w_lane = lane < n_levels ? widths[lane] : 0;
  const float s = __shfl_sync(kAll, s_lane, base + o);
  const int64_t width = __shfl_sync(kAll, w_lane, base + o);
  const float inv = __fdiv_rn(1.0f, s);
  const int64_t su = static_cast<int64_t>(rintf(__fmul_rn(uL, inv)));
  const int64_t sv = static_cast<int64_t>(rintf(__fmul_rn(vL, inv)));
  const float* __restrict__ left = lv.left[o];
  const float* __restrict__ right = lv.right[o];
  const int h = lv.h[o], w = lv.w[o];
  int gy[kWin];
#pragma unroll
  for (int r = 0; r < kWin; ++r) gy[r] = clamp_to(sv + r - kW, h0 - 1);

  // (2) the right keypoint's u and the patch's column `lane`
  const float uR0 = xy_r[2 * br];
  const int xp = clamp_to(su + lane - kW, w0 - 1);
  float pv[kWin];
#pragma unroll
  for (int r = 0; r < kWin; ++r)
    pv[r] = lane < kWin ? stacked(left, h, w, gy[r], xp) : 0.0f;

  // (3) the strip's columns `lane` and `lane` + 16
  const int64_t sur = static_cast<int64_t>(rintf(__fmul_rn(uR0, inv)));
  const int xa = clamp_to(sur + lane - kW - kL, w0 - 1);
  const int xb = clamp_to(sur + lane + kHalf - kW - kL, w0 - 1);
  float sa[kWin], sb[kWin];
#pragma unroll
  for (int r = 0; r < kWin; ++r) {
    sa[r] = stacked(right, h, w, gy[r], xa);
    sb[r] = lane + kHalf < kStrip ? stacked(right, h, w, gy[r], xb) : 0.0f;
  }

  float* patch = win[slot];                // centred, [kWin][kWin]
  float* strip = win[slot] + kWin * kWin;  // [kWin][kStrip]
  const float pc = __shfl_sync(kAll, pv[kW], base + kW);
#pragma unroll
  for (int r = 0; r < kWin; ++r) {
    if (lane < kWin) patch[r * kWin + lane] = __fsub_rn(pv[r], pc);
    strip[r * kStrip + lane] = sa[r];
    if (lane + kHalf < kStrip) strip[r * kStrip + lane + kHalf] = sb[r];
  }
  __syncwarp();

  // SAD k on lane k (the lanes past 10 repeat SAD 10)
  const int k = min(lane, kSlide - 1);
  const float wc = strip[kW * kStrip + kW + k];
  double acc[2] = {0.0, 0.0};
#pragma unroll
  for (int r = 0; r < kWin; ++r) {
#pragma unroll
    for (int c = 0; c < kWin; ++c) {
      const float b = __fsub_rn(strip[r * kStrip + c + k], wc);
      const float d = fabsf(__fsub_rn(patch[r * kWin + c], b));
      acc[(r * kWin + c) & 1] = __dadd_rn(acc[(r * kWin + c) & 1],
                                          static_cast<double>(d));
    }
  }
  const float sad = __double2float_rn(__dadd_rn(acc[0], acc[1]));

  // the first minimum and its neighbours
  int kb = 0;
  float best = __shfl_sync(kAll, sad, base);
#pragma unroll
  for (int m = 1; m < kSlide; ++m) {
    const float v = __shfl_sync(kAll, sad, base + m);
    if (v < best) {
      best = v;
      kb = m;
    }
  }
  const float im1 = __shfl_sync(kAll, sad, base + (kb > 0 ? kb - 1 : 0));
  const float ip1 = __shfl_sync(kAll, sad,
                                base + (kb < kSlide - 1 ? kb + 1 : kSlide - 1));
  if (!live || lane != 0) return;
  const float denom = __fmul_rn(
      2.0f, __fsub_rn(__fadd_rn(im1, ip1), __fmul_rn(2.0f, best)));
  const float delta = fabsf(denom) > 1e-6f
                          ? __fdiv_rn(__fsub_rn(im1, ip1), denom)
                          : 2.0f;
  float ur = __fmul_rn(
      s, __fadd_rn(__fadd_rn(static_cast<float>(sur),
                             static_cast<float>(kb - kL)),
                   delta));
  float disp = __fsub_rn(uL, ur);
  const bool in_range = disp >= 0.0f && disp < max_d;
  if (disp <= 0.0f) {
    disp = 0.01f;
    ur = __fsub_rn(uL, 0.01f);
  }
  const bool ok = gated && sur >= 0 && sur + kWin < width && kb > 0 &&
                  kb < kSlide - 1 && delta >= -1.0f && delta <= 1.0f &&
                  in_range;
  best_sad[i] = best;
  u_r[i] = ur;
  disparity[i] = disp;
  accept[i] = ok ? 1 : 0;
}

}  // namespace

// left, right: n_levels host pointers to the device levels [h, w] float32
// row-major of the two images; h0, w0: level 0's size; xy_l [n, 2],
// xy_r [m, 2] float32; oct_l, best_r [n] int64; valid_l, cand_ok [n]
// bool; widths [L] int64, scales [L] float32 (device); outputs [n]:
// best_sad, u_r, disparity float32, accept bool.
extern "C" int airdos_stereo_sad(const int64_t* left, const int64_t* right,
                                 const int* h, const int* w, int n_levels,
                                 int h0, int w0, int n, const void* xy_l,
                                 const void* oct_l, const void* valid_l,
                                 const void* xy_r, const void* best_r,
                                 const void* cand_ok, const void* widths,
                                 const void* scales, float max_d,
                                 void* best_sad, void* u_r, void* disparity,
                                 void* accept, void* stream) {
  if (n_levels <= 0 || n_levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  Levels lv;
  for (int i = 0; i < n_levels; ++i) {
    lv.left[i] = reinterpret_cast<const float*>(left[i]);
    lv.right[i] = reinterpret_cast<const float*>(right[i]);
    lv.h[i] = h[i];
    lv.w[i] = w[i];
  }
  const int blocks = (n + kPoints - 1) / kPoints;
  stereo_sad_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      lv, n_levels, n, h0, w0, static_cast<const float*>(xy_l),
      static_cast<const int64_t*>(oct_l),
      static_cast<const uint8_t*>(valid_l), static_cast<const float*>(xy_r),
      static_cast<const int64_t*>(best_r),
      static_cast<const uint8_t*>(cand_ok),
      static_cast<const int64_t*>(widths), static_cast<const float*>(scales),
      max_d, static_cast<float*>(best_sad), static_cast<float*>(u_r),
      static_cast<float*>(disparity), static_cast<uint8_t*>(accept));
  return static_cast<int>(cudaGetLastError());
}
