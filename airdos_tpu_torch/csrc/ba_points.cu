// The landmark half of the BAs' Schur complement, for sm_90a: two entry
// points, the reduction and the back-substitution of one Gauss-Newton
// step.
//
// Replaces airdos_tpu/solvers/local_ba.py:130-143 (the damped inv3x3 of
// every landmark block, the valid mask and Aagg = Wagg Hpp^-1) and
// :164-167 (dx_p = Hpp^-1 (bp - sum_c Wagg_pc^T dx_c)), which the human
// BA's static half shares (airdos_tpu/solvers/human_ba.py:271-280): XLA
// fusions and einsums.  The port's plain versions are ops/ba_points.py
// landmark_reduce_ref and landmark_backsub_ref.  Inputs: the step's
// segment sums pt_sums [P, 12] (Hpp row-major | bp) and Wagg [P, C, 6, 3],
// that is P 6 C rows of 3 floats.
//
// Reduce:
//   tr = (h00 + h11) + h22; damp = lam max(tr / 3, 1e-3);
//   h_ii <- (h_ii + damp) + 1e-6 (float32);  in float64: Hpp^-1 = adj /
//   det (smallmat.inv3x3: cofactors as two products and a difference, det
//   = (a A + b B) + c C, 1 / det correctly rounded, each entry adj * (1 /
//   det)), 0 where the point is invalid, and Aagg[p, c, k, m] = (W_k0
//   Hi_0m + W_k1 Hi_1m) + W_k2 Hi_2m, each output rounded to float32 once
//   (ops/ba_points.py says why).
// Back-substitute, in float64 (the products of two float32 inputs are
// exact) rounded to float32 once (ops/ba_points.py says why):
//   lane j of a point's warp sums t_c = sum_k (W_pc[k, :] dx_c[k]) (k =
//   0..5 in order) over cameras c = j, j + 32, ... in sequence; the lanes
//   are added in a halving tree (lane j + lane j + 16, then 8, 4, 2, 1);
//   lane 0 forms r = bp - that sum and dx_p[l] = float32((Hi_l0 r0 + Hi_l1
//   r1) + Hi_l2 r2) x valid.
//
// Exact: every product and sum is an __fmul_rn / __fadd_rn / __fsub_rn
// (__dmul_rn / __dadd_rn / __dsub_rn in float64), which nvcc does not
// contract into a multiply-add, the division the correctly rounded
// __fdiv_rn and 1 / det __drcp_rn, in the plain versions' order (torch
// rounds each eager op alike; the plain back-substitution pads the
// cameras to a multiple of 32 with zeros, which add exactly).  So both
// outputs are bit-equal to the plain versions'.  No atomics: two launches
// are bit-equal.
//
// What bounds it on an H100.  Bytes: Wagg is the bulk, 3.5 MB at P x C =
// 2048 x 24, 14 MB at 4096 x 48.  Reduce reads it and writes Aagg of the
// same size (7-28 MB, 2-8 us at 3.35 TB/s); back-substitute reads it once
// (1-4 us).  Operations: an inverse a point (~53 float64 operations) and
// 15 a row of Aagg; 36 a camera in back-substitution.  Both are
// bytes-bound, and at the paths' sizes (P 2048, C 24-48) a launch is one
// wave near the card's launch floor (~2 us, PERF.md), so what counts is the
// chain of dependent memory round trips inside a block:
//
// Reduce, a block a range of kRowsABlock consecutive rows, kRowsAThread
// rows (48 bytes) a thread.  The block's first threads compute the
// damped inverse once for each point its range touches (at most
// kMaxPoints, at C = 1) into shared memory; the block that holds a
// point's first row writes its Hpp^-1, so each point is written once (a
// point that straddles two blocks is inverted in both, with the same
// bits).  After one barrier each thread loads its rows (three 16-byte
// loads; the wrapper hands Wagg over on 16 bytes), finds their points
// with one 32-bit division (4 rows cross at most one point boundary, a
// point having 6 C >= 6 rows) and stores its 12 outputs, 16 bytes at a
// time.  The rows are loaded after the barrier on purpose: issued
// before the inverses they queue ahead of the inverses' pt_sums loads,
// which then wait for them (tools/kernel_split.py times both orders).
//
// Back-substitute, a block kBacksubWarps points, a warp a point, in
// passes of kLanes cameras: lane j loads camera c0 + j's 18 floats as 9
// float2 into registers, the block stages the pass's dx_c once as
// float64 in shared memory (kDxStride doubles a camera: no bank
// conflicts), and after the barrier each lane sums its camera.  The
// finish's inputs (Hpp^-1, bp, valid) are loaded first, so their latency
// hides under the rows' and lane 0's finish makes no round trip of its
// own.
//
// The launch plan (rows a thread, threads a block, the points a block's
// range touches, which block writes a point's Hpp^-1, the points a
// back-substitution block and its camera passes) is
// ops/ba_points.py's, which the CPU tests emulate; the constants below
// are its.
//
// The C entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return cudaGetLastError() (cudaErrorInvalidValue
// for a Wagg or Aagg off 16 bytes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kReduceThreads = 256;
constexpr int kRowsAThread = 4;
constexpr int kRowsABlock = 1024;
constexpr int kMaxPoints = 172;           // points a block's rows touch, at most
constexpr int kBacksubWarps = 8;
constexpr int kLanes = 32;
constexpr int kDxStride = 7;              // doubles a camera's dx_c takes in shared memory
static_assert(kRowsABlock == kReduceThreads * kRowsAThread, "rows a block");
static_assert(kMaxPoints == (kRowsABlock - 1) / 6 + 2, "points a block, C = 1");
static_assert(kMaxPoints <= kReduceThreads, "a thread a point's inverse");
static_assert(6 * kLanes <= kBacksubWarps * kLanes, "a thread a dx_c entry");

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ double dmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double dadd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dsub(double a, double b) { return __dsub_rn(a, b); }

// The damped, inverted block of point p (0 where invalid), row-major, in
// float64.
__device__ __forceinline__ void damped_inverse(const float* __restrict__ h,
                                               bool valid, float lam,
                                               double* __restrict__ out) {
  const float tr = add(add(h[0], h[4]), h[8]);
  float c = __fdiv_rn(tr, 3.0f);
  c = c < 1e-3f ? 1e-3f : c;                 // torch.clamp: NaN stays NaN
  const float damp = mul(lam, c);
  const double a = add(add(h[0], damp), 1e-6f), b = h[1], cc = h[2];
  const double d = h[3], e = add(add(h[4], damp), 1e-6f), f = h[5];
  const double g = h[6], hh = h[7], i = add(add(h[8], damp), 1e-6f);
  const double A = dsub(dmul(e, i), dmul(f, hh));
  const double B = -dsub(dmul(d, i), dmul(f, g));
  const double C = dsub(dmul(d, hh), dmul(e, g));
  const double D = -dsub(dmul(b, i), dmul(cc, hh));
  const double E = dsub(dmul(a, i), dmul(cc, g));
  const double F = -dsub(dmul(a, hh), dmul(b, g));
  const double G = dsub(dmul(b, f), dmul(cc, e));
  const double H = -dsub(dmul(a, f), dmul(cc, d));
  const double I = dsub(dmul(a, e), dmul(b, d));
  const double det = dadd(dadd(dmul(a, A), dmul(b, B)), dmul(cc, C));
  const double r = __drcp_rn(det);
  const double adj[9] = {A, D, G, B, E, H, C, F, I};
#pragma unroll
  for (int j = 0; j < 9; ++j) out[j] = valid ? dmul(adj[j], r) : 0.0;
}

__global__ void __launch_bounds__(kReduceThreads)
landmark_reduce_kernel(const float* __restrict__ pt_sums,
                       const float* __restrict__ wagg,
                       const bool* __restrict__ valid,
                       const float* __restrict__ lam, int P, int C,
                       float* __restrict__ hinv, float* __restrict__ aagg) {
  __shared__ double hi_s[kMaxPoints][9];
  const int six_c = 6 * C;
  const int n_rows = P * six_c;
  const int row_lo = blockIdx.x * kRowsABlock;
  const int row_hi = min(n_rows, row_lo + kRowsABlock);
  const int p_lo = row_lo / six_c;
  const int n_pts = (row_hi - 1) / six_c - p_lo + 1;
  const int r0 = row_lo + kRowsAThread * static_cast<int>(threadIdx.x);
  const int nr = min(kRowsAThread, n_rows - r0);   // this thread's rows
  constexpr int kF = 3 * kRowsAThread;
  if (static_cast<int>(threadIdx.x) < n_pts) {
    const int p = p_lo + threadIdx.x;
    double hi[9];
    damped_inverse(pt_sums + 12 * p, valid[p], __ldg(lam), hi);
#pragma unroll
    for (int j = 0; j < 9; ++j) hi_s[threadIdx.x][j] = hi[j];
    if (p * six_c >= row_lo) {               // the point's first row is ours
#pragma unroll
      for (int j = 0; j < 9; ++j) hinv[9 * p + j] = __double2float_rn(hi[j]);
    }
  }
  __syncthreads();
  if (nr <= 0) return;
  float w[kF];
  if (nr == kRowsAThread) {                  // after the inverses: see above
#pragma unroll
    for (int j = 0; j < kF; j += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(wagg + 3 * r0 + j));
      w[j] = v.x; w[j + 1] = v.y; w[j + 2] = v.z; w[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kF; ++j) w[j] = j < 3 * nr ? __ldg(wagg + 3 * r0 + j) : 0.0f;
  }
  const int p0 = r0 / six_c;
  const int k0 = r0 - p0 * six_c;            // r0's row within its point
  float a[kF];
#pragma unroll
  for (int i = 0; i < kRowsAThread; ++i) {
    if (i < nr) {
      const double* hi = hi_s[p0 - p_lo + (k0 + i >= six_c ? 1 : 0)];
      const double w0 = w[3 * i], w1 = w[3 * i + 1], w2 = w[3 * i + 2];
#pragma unroll
      for (int m = 0; m < 3; ++m)
        a[3 * i + m] = __double2float_rn(dadd(
            dadd(dmul(w0, hi[m]), dmul(w1, hi[3 + m])), dmul(w2, hi[6 + m])));
    }
  }
  if (nr == kRowsAThread) {
#pragma unroll
    for (int j = 0; j < kF; j += 4)
      *reinterpret_cast<float4*>(aagg + 3 * r0 + j) =
          make_float4(a[j], a[j + 1], a[j + 2], a[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kF; ++j)
      if (j < 3 * nr) aagg[3 * r0 + j] = a[j];
  }
}

__global__ void __launch_bounds__(kBacksubWarps * kLanes)
landmark_backsub_kernel(const float* __restrict__ hinv,
                        const float* __restrict__ pt_sums,
                        const float* __restrict__ wagg,
                        const float* __restrict__ dx_c,
                        const bool* __restrict__ valid, int P, int C,
                        float* __restrict__ dx_p) {
  __shared__ double dx_s[kLanes * kDxStride];
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int p = blockIdx.x * kBacksubWarps + warp;
  const bool live = p < P;                   // a whole warp
  float hi[9], bp[3];
  bool ok = false;
  if (live && lane == 0) {                   // the finish's inputs, first
#pragma unroll
    for (int j = 0; j < 9; ++j) hi[j] = __ldg(hinv + 9 * p + j);
#pragma unroll
    for (int l = 0; l < 3; ++l) bp[l] = __ldg(pt_sums + 12 * p + 9 + l);
    ok = valid[p];
  }
  double acc[3] = {0.0, 0.0, 0.0};
  const float* wp = wagg + static_cast<int64_t>(p) * C * 18;
  const int tid = threadIdx.x;               // 6 cams <= 192 < the block
  for (int c0 = 0; c0 < C; c0 += kLanes) {
    const int cams = min(kLanes, C - c0);
    const bool mine = live && lane < cams;   // camera c0 + lane
    float w[18];                             // its Wagg_pc, in flight
    if (mine) {
      const float2* src = reinterpret_cast<const float2*>(wp + 18 * (c0 + lane));
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        const float2 v = __ldg(src + q);
        w[2 * q] = v.x;
        w[2 * q + 1] = v.y;
      }
    }
    const float dx_t = tid < 6 * cams ? __ldg(dx_c + 6 * c0 + tid) : 0.0f;
    if (c0) __syncthreads();                 // the pass before is summed
    if (tid < 6 * cams) dx_s[kDxStride * (tid / 6) + tid % 6] = dx_t;
    __syncthreads();
    if (mine) {
      const double* dx = dx_s + kDxStride * lane;
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        double t = dmul(w[l], dx[0]);
#pragma unroll
        for (int k = 1; k < 6; ++k)
          t = dadd(t, dmul(w[3 * k + l], dx[k]));
        acc[l] = dadd(acc[l], t);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
#pragma unroll
    for (int l = 0; l < 3; ++l)
      acc[l] = dadd(acc[l], __shfl_down_sync(0xffffffffu, acc[l], off));
  if (live && lane == 0) {
    const double r0 = dsub(bp[0], acc[0]), r1 = dsub(bp[1], acc[1]),
                 r2 = dsub(bp[2], acc[2]);
    const float v = ok ? 1.0f : 0.0f;
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      const double d = dadd(
          dadd(dmul(hi[3 * l], r0), dmul(hi[3 * l + 1], r1)),
          dmul(hi[3 * l + 2], r2));
      dx_p[3 * p + l] = mul(__double2float_rn(d), v);
    }
  }
}

bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// pt_sums [P, 12], wagg [P, C, 6, 3] float32; valid [P] bool; lam: one
// float32 on the device; out hinv [P, 3, 3], aagg [P, C, 6, 3] float32;
// wagg and aagg on 16 bytes.
extern "C" int airdos_landmark_reduce(const void* pt_sums, const void* wagg,
                                      const void* valid, const void* lam,
                                      int P, int C, void* hinv, void* aagg,
                                      void* stream) {
  const int64_t n = static_cast<int64_t>(P) * C * 6;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (!aligned(wagg) || !aligned(aagg))
    return static_cast<int>(cudaErrorInvalidValue);
  landmark_reduce_kernel<<<static_cast<unsigned>((n + kRowsABlock - 1) / kRowsABlock),
                           kReduceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pt_sums), static_cast<const float*>(wagg),
      static_cast<const bool*>(valid), static_cast<const float*>(lam), P, C,
      static_cast<float*>(hinv), static_cast<float*>(aagg));
  return static_cast<int>(cudaGetLastError());
}

// hinv [P, 3, 3], pt_sums [P, 12], wagg [P, C, 6, 3], dx_c [C, 6] float32;
// valid [P] bool; out dx_p [P, 3] float32; wagg on 16 bytes.
extern "C" int airdos_landmark_backsub(const void* hinv, const void* pt_sums,
                                       const void* wagg, const void* dx_c,
                                       const void* valid, int P, int C,
                                       void* dx_p, void* stream) {
  if (P <= 0) return static_cast<int>(cudaGetLastError());
  if (!aligned(wagg)) return static_cast<int>(cudaErrorInvalidValue);
  landmark_backsub_kernel<<<(P + kBacksubWarps - 1) / kBacksubWarps,
                            kBacksubWarps * kLanes, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hinv), static_cast<const float*>(pt_sums),
      static_cast<const float*>(wagg), static_cast<const float*>(dx_c),
      static_cast<const bool*>(valid), P, C, static_cast<float*>(dx_p));
  return static_cast<int>(cudaGetLastError());
}
