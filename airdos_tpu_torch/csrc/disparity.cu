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
// One block of four warps a probe, in three steps:
// (1) loads: thread c < D + B - 1 takes column c of the right strip (B x
//     (D + B - 1), 11 x 58), thread D + B - 1 + c column c of the left
//     patch; each issues its B row loads (an unrolled row loop, addresses
//     from the thread index, no division) before its first shared store,
//     so a probe's pixels take one round trip;
// (2) sums: threads 2d and 2d + 1 take disparity d, the even and the odd
//     window columns, each a sum of its terms over two accumulators; one
//     shuffle adds the pair, and the sum is rounded once.  The sums are
//     float32 where every staged pixel is an integer of magnitude <=
//     2^15 (the block learns it at its barrier), else float64: a term's
//     conversion to float64 and its add both take one SM's float64 pipe;
// (3) the first minimum: warp 0 reduces the (sad, d) pairs by shuffles,
//     the smaller sad first and ties to the lower d, an order-free rule
//     that gives argmin's first minimum; the lanes hold sad[l] and
//     sad[l + 32], so sad[d* - 1] and sad[d* + 1] come by shuffle, and
//     lane 0 fits the parabola and writes.
//
// Exact: on the 8-bit images of the path every difference is an integer
// and every SAD an integer under 2^15, exact in any order.  Where every
// pixel is an integer of magnitude <= 2^15, a term is an integer <= 2^16
// and a SAD of at most 15 x 15 terms under 2^24: exact in float32 in any
// order, so the float32 sums are the float64 sum's bits.  The float64 sum
// is exact in any order for any pixels that are multiples of 2^-31 under
// 2^11 in magnitude (0 or at least 2^-8), and the plain version sums in
// float64 too and rounds once; the coverage penalty and the parabola are
// torch's float32 steps (__fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn).
// So the output is bit-equal to the plain version's under that condition.
// Pixels are finite (a NaN SAD has no place in the order above).
//
// What bounds it on an H100.  Bytes: each probe's 121 + 638 pixels (~3 kB,
// 0.12 MB for the path's 40 probes) and 4 bytes out: ~0.04 us.
// Operations: 48 x 121 differences, absolute values and sums a probe, 0.7
// MFLOP for 40 probes: ~0.02 us at the float64 rate.  40 blocks on 132
// SMs: the launch, two dependent round trips of loads (the probe's pixel,
// then its window) and a probe's sums on one SM set the time.  The
// earlier design (a block of 64 threads a probe) staged the pixels in ~12
// dependent rounds of loads, summed each SAD in one thread's chain of 121
// float64 terms and took the minimum serially in one thread.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDisp = 64;
constexpr int kMaxBlock = 15;
constexpr int kParts = 2;                          // threads a disparity
constexpr int kThreads = kParts * kMaxDisp;        // four warps
constexpr int kMaxSpan = kMaxDisp + kMaxBlock - 1;  // strip columns

constexpr float kMaxInt = 32768.0f;      // integer pixels summed in float32

static_assert(kMaxSpan + kMaxBlock <= kThreads, "a column a thread");
static_assert(kMaxDisp <= 64, "warp 0 holds two SADs a lane");
static_assert(kMaxBlock * kMaxBlock * 2 * kMaxInt < 16777216.0f,
              "an integer SAD is exact in float32");

__device__ __forceinline__ int clamp_to(int64_t v, int hi) {
  return static_cast<int>(v < 0 ? 0 : (v > hi ? hi : v));
}

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// A thread's terms of a SAD: window columns part, part + kParts, ... of
// every row, over two accumulators of type Acc (exact, so in any order).
template <typename Acc>
__device__ __forceinline__ Acc window_sum(const float* p, const float* s,
                                          int block, int span, int part) {
  Acc acc[2] = {Acc(0), Acc(0)};
  for (int r = 0; r < block; ++r) {
#pragma unroll
    for (int c = 0; c < kMaxBlock; c += kParts)
      if (c + part < block) {
        Acc& a = acc[(c / kParts) & 1];
        a = add_rn(a, static_cast<Acc>(fabsf(__fsub_rn(p[r * block + c],
                                                      s[r * span + c]))));
      }
  }
  return add_rn(acc[0], acc[1]);
}

__global__ void __launch_bounds__(kThreads)
patch_disparity_kernel(const float* __restrict__ left,
                       const float* __restrict__ right, int h, int w,
                       const float* __restrict__ px, int num_disp, int block,
                       float* __restrict__ out) {
  __shared__ float strip[kMaxBlock * kMaxSpan];
  __shared__ float patch[kMaxBlock * kMaxBlock];
  __shared__ float sad_s[kMaxDisp];
  const int i = blockIdx.x, t = threadIdx.x, lane = t & 31;
  const int half = block / 2;
  const int span = num_disp + block - 1;
  const int64_t u = static_cast<int64_t>(rintf(px[2 * i]));
  const int64_t v = static_cast<int64_t>(rintf(px[2 * i + 1]));

  // (1) a column a thread, every row's load issued before any store;
  // strip column c is right-image column u - (num_disp - 1) - half + c
  bool ints = true;
  if (t < span + block) {
    const bool in_strip = t < span;
    const float* src = in_strip ? right : left;
    const int x = clamp_to(in_strip ? u - (num_disp - 1) - half + t
                                    : u + (t - span) - half, w - 1);
    float col[kMaxBlock];
#pragma unroll
    for (int r = 0; r < kMaxBlock; ++r)
      if (r < block) col[r] = __ldg(src + clamp_to(v + r - half, h - 1) * w
                                    + x);
    float* dst = in_strip ? strip + t : patch + (t - span);
    const int stride = in_strip ? span : block;
#pragma unroll
    for (int r = 0; r < kMaxBlock; ++r)
      if (r < block) {
        dst[r * stride] = col[r];
        ints = ints && col[r] == rintf(col[r]) && fabsf(col[r]) <= kMaxInt;
      }
  }
  const bool int_sums = __syncthreads_and(ints);

  // (2) disparity d's terms over threads 2d (even columns) and 2d + 1
  const int d = t / kParts, part = t % kParts;
  double sum = 0.0;
  if (d < num_disp) {
    const float* s = strip + (num_disp - 1 - d) + part;
    const float* p = patch + part;
    sum = int_sums ? static_cast<double>(
                         window_sum<float>(p, s, block, span, part))
                   : window_sum<double>(p, s, block, span, part);
  }
  sum = __dadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
  if (part == 0 && d < num_disp) {
    const bool covered = u - d - half >= 0;
    sad_s[d] = __fadd_rn(__double2float_rn(sum), covered ? 0.0f : 1e8f);
  }
  __syncthreads();
  if (t >= 32) return;

  // (3) the first minimum of the (sad, d) pairs over warp 0
  const float lo = lane < num_disp ? sad_s[lane] : INFINITY;
  const float hi = lane + 32 < num_disp ? sad_s[lane + 32] : INFINITY;
  float best_sad = lo;
  int best = lane;
  if (hi < lo) {
    best_sad = hi;
    best = lane + 32;
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float os = __shfl_xor_sync(0xffffffffu, best_sad, off);
    const int od = __shfl_xor_sync(0xffffffffu, best, off);
    if (os < best_sad || (os == best_sad && od < best)) {
      best_sad = os;
      best = od;
    }
  }
  const int dm = best > 0 ? best - 1 : 0;
  const int dp = best < num_disp - 1 ? best + 1 : num_disp - 1;
  const float cm = __shfl_sync(0xffffffffu, dm < 32 ? lo : hi, dm & 31);
  const float cp = __shfl_sync(0xffffffffu, dp < 32 ? lo : hi, dp & 31);
  if (lane != 0) return;
  const float c0 = best_sad;
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
