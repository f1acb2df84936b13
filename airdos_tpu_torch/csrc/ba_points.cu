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
// segment sums pt_sums [P, 12] (Hpp row-major | bp) and Wagg [P, C, 6, 3].
//
// Reduce, one thread a (point, camera, row k of Wagg_pc):
//   tr = (h00 + h11) + h22; damp = lam max(tr / 3, 1e-3);
//   h_ii <- (h_ii + damp) + 1e-6 (float32);  in float64: Hpp^-1 = adj /
//   det (smallmat.inv3x3: cofactors as two products and a difference, det
//   = (a A + b B) + c C, 1 / det correctly rounded, each entry adj * (1 /
//   det)), 0 where the point is invalid, and Aagg[p, c, k, m] = (W_k0
//   Hi_0m + W_k1 Hi_1m) + W_k2 Hi_2m, each output rounded to float32 once
//   (ops/ba_points.py says why).
//   Each thread recomputes its point's inverse (~60 operations, the same
//   bits everywhere); the threads of camera 0 write it.
// Back-substitute, one warp a point, in float64 (the products of two
// float32 inputs are exact) rounded to float32 once (ops/ba_points.py says
// why):
//   lane j sums t_c = sum_k (W_pc[k, :] dx_c[k]) (k = 0..5 in order) over
//   cameras c = j, j + 32, ... in sequence; the lanes are added in a
//   halving tree (lane j + lane j + 16, then 8, 4, 2, 1); lane 0 forms r =
//   bp - that sum and dx_p[l] = float32((Hi_l0 r0 + Hi_l1 r1) + Hi_l2 r2)
//   x valid.
//
// Exact: every product and sum is an __fmul_rn / __fadd_rn / __fsub_rn
// (__dmul_rn / __dadd_rn / __dsub_rn in float64), which nvcc does not
// contract into a multiply-add, the division the correctly rounded
// __fdiv_rn and 1 / det __drcp_rn, in the plain versions' order (torch
// rounds each eager op alike; the plain back-substitution pads the
// cameras to a multiple of 32 with zeros, which add exactly).  So both
// outputs are bit-equal to the plain versions'.
//
// What bounds it on an H100.  Bytes: Wagg is the bulk, [P, C, 6, 3]
// float32: 3.5 MB at P x C = 2048 x 24, 14 MB at 4096 x 48.  Reduce reads
// it and writes Aagg of the same size (7-28 MB, 2-8 us at 3.35 TB/s);
// back-substitute reads it once (1-4 us).  Operations: ~70 float64
// operations a reduce thread (~83 MFLOP at 4096 x 48, ~2.4 us at the
// card's 34 TFLOP/s of float64 outside the tensor cores, the inverse
// recomputed by all 6 C threads of a point); 36 a camera in back-
// substitution (~7 MFLOP, ~0.2 us).
// Bytes bound both; threads read Wagg's rows in order, so the loads of a
// warp fall on neighbouring addresses.
//
// The C entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

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

__global__ void __launch_bounds__(kThreads)
landmark_reduce_kernel(const float* __restrict__ pt_sums,
                       const float* __restrict__ wagg,
                       const bool* __restrict__ valid,
                       const float* __restrict__ lam, int P, int C,
                       float* __restrict__ hinv, float* __restrict__ aagg) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<int64_t>(P) * C * 6) return;
  const int p = static_cast<int>(idx / (6 * C));
  const int rest = static_cast<int>(idx - static_cast<int64_t>(p) * 6 * C);
  double hi[9];
  damped_inverse(pt_sums + 12 * static_cast<int64_t>(p), valid[p], *lam, hi);
  if (rest < 3) {                            // camera 0, rows 0-2: Hpp^-1
#pragma unroll
    for (int m = 0; m < 3; ++m)
      hinv[9 * static_cast<int64_t>(p) + 3 * rest + m] =
          __double2float_rn(hi[3 * rest + m]);
  }
  const float* w = wagg + 3 * idx;
  float* a = aagg + 3 * idx;
  const double w0 = w[0], w1 = w[1], w2 = w[2];
#pragma unroll
  for (int m = 0; m < 3; ++m)
    a[m] = __double2float_rn(
        dadd(dadd(dmul(w0, hi[m]), dmul(w1, hi[3 + m])), dmul(w2, hi[6 + m])));
}

__global__ void __launch_bounds__(kThreads)
landmark_backsub_kernel(const float* __restrict__ hinv,
                        const float* __restrict__ pt_sums,
                        const float* __restrict__ wagg,
                        const float* __restrict__ dx_c,
                        const bool* __restrict__ valid, int P, int C,
                        float* __restrict__ dx_p) {
  const int p = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (p >= P) return;                        // the whole warp leaves
  double acc[3] = {0.0, 0.0, 0.0};
  const float* wp = wagg + static_cast<int64_t>(p) * C * 18;
  for (int c = lane; c < C; c += 32) {
    const float* w = wp + 18 * c;            // Wagg_pc [6, 3]
    const float* dx = dx_c + 6 * c;
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      double t = dmul(w[l], dx[0]);
#pragma unroll
      for (int k = 1; k < 6; ++k)
        t = dadd(t, dmul(w[3 * k + l], dx[k]));
      acc[l] = dadd(acc[l], t);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
#pragma unroll
    for (int l = 0; l < 3; ++l)
      acc[l] = dadd(acc[l], __shfl_down_sync(0xffffffffu, acc[l], off));
  if (lane == 0) {
    const float* bp = pt_sums + 12 * static_cast<int64_t>(p) + 9;
    const double r0 = dsub(bp[0], acc[0]), r1 = dsub(bp[1], acc[1]),
                 r2 = dsub(bp[2], acc[2]);
    const float* hi = hinv + 9 * static_cast<int64_t>(p);
    const float v = valid[p] ? 1.0f : 0.0f;
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      const double d = dadd(
          dadd(dmul(hi[3 * l], r0), dmul(hi[3 * l + 1], r1)),
          dmul(hi[3 * l + 2], r2));
      dx_p[3 * static_cast<int64_t>(p) + l] = mul(__double2float_rn(d), v);
    }
  }
}

}  // namespace

// pt_sums [P, 12], wagg [P, C, 6, 3] float32; valid [P] bool; lam: one
// float32 on the device; out hinv [P, 3, 3], aagg [P, C, 6, 3] float32.
extern "C" int airdos_landmark_reduce(const void* pt_sums, const void* wagg,
                                      const void* valid, const void* lam,
                                      int P, int C, void* hinv, void* aagg,
                                      void* stream) {
  const int64_t n = static_cast<int64_t>(P) * C * 6;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  landmark_reduce_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                           kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pt_sums), static_cast<const float*>(wagg),
      static_cast<const bool*>(valid), static_cast<const float*>(lam), P, C,
      static_cast<float*>(hinv), static_cast<float*>(aagg));
  return static_cast<int>(cudaGetLastError());
}

// hinv [P, 3, 3], pt_sums [P, 12], wagg [P, C, 6, 3], dx_c [C, 6] float32;
// valid [P] bool; out dx_p [P, 3] float32.
extern "C" int airdos_landmark_backsub(const void* hinv, const void* pt_sums,
                                       const void* wagg, const void* dx_c,
                                       const void* valid, int P, int C,
                                       void* dx_p, void* stream) {
  if (P <= 0) return static_cast<int>(cudaGetLastError());
  landmark_backsub_kernel<<<(P + kWarps - 1) / kWarps, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hinv), static_cast<const float*>(pt_sums),
      static_cast<const float*>(wagg), static_cast<const float*>(dx_c),
      static_cast<const bool*>(valid), P, C, static_cast<float*>(dx_p));
  return static_cast<int>(cudaGetLastError());
}
