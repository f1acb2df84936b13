// The stereo / mono projection edge of the bundle adjustments, for
// sm_90a: shared by csrc/ba_static.cu (the static edges) and
// csrc/ba_human.cu (the human joints' projections), whose plain versions
// share ops/ba_static.py project_ref.
//
// For camera (R, t), world point X and observation (u, v, uR), uR < 0 mono:
//
//   xc = R X + t, each row ((R_k0 X0 + R_k1 X1) + R_k2 X2) + t_k;
//   zs = z, or 1e-6 where |z| < 1e-6; iz = 1 / zs; iz2 = iz iz;
//   u' = (fx x) iz + cx, v' = (fy y) iz + cy, uR' = u' - bf iz;
//   e  = (u - u', v - v', uR - uR'), the third row 0 on a mono edge;
//   with a = fx iz, b = fy iz, p = (-fx x) iz2, q = (-fy y) iz2,
//   s = (-fx x + bf) iz2 (d (u', v', uR') / d xc = [[a 0 p] [0 b q] [a 0 s]]):
//   Jc = -dproj [I | -[xc]x] and Jp = -dproj R, written out term by term,
//   the third rows 0 on a mono edge.
//
// Every product and sum is an __fmul_rn / __fadd_rn / __fsub_rn, which
// nvcc does not contract into a multiply-add (eager torch rounds each
// one), and 1 / zs is the correctly rounded __frcp_rn (torch's
// reciprocal), so the results are bit-equal to project_ref's.
#pragma once

#include <cuda_runtime.h>

namespace ba {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// (v0 v0 + v1 v1) + v2 v2
__device__ __forceinline__ float sqnorm3(const float* v) {
  return add(add(mul(v[0], v[0]), mul(v[1], v[1])), mul(v[2], v[2]));
}

struct Intrinsics {
  float fx, fy, cx, cy, bf;
};

struct Projection {
  float e[3];
  float Jc[3][6];
  float Jp[3][3];
  float z;
  bool stereo;
};

// R row-major [3, 3], t [3], X [3], obs [3]
__device__ __forceinline__ void project(const float* __restrict__ R,
                                        const float* __restrict__ t,
                                        const float* __restrict__ X,
                                        const float* __restrict__ obs,
                                        const Intrinsics& k, Projection& o) {
  float xc[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    xc[r] = add(add(add(mul(R[3 * r], X[0]), mul(R[3 * r + 1], X[1])),
                    mul(R[3 * r + 2], X[2])),
                t[r]);
  const float x = xc[0], y = xc[1], z = xc[2];
  const float zs = fabsf(z) < 1e-6f ? 1e-6f : z;
  const float iz = __frcp_rn(zs);
  const float iz2 = mul(iz, iz);
  const float u = add(mul(mul(k.fx, x), iz), k.cx);
  const float v = add(mul(mul(k.fy, y), iz), k.cy);
  const float ur = sub(u, mul(k.bf, iz));
  o.stereo = obs[2] >= 0.0f;
  o.z = z;
  o.e[0] = sub(obs[0], u);
  o.e[1] = sub(obs[1], v);
  o.e[2] = o.stereo ? sub(obs[2], ur) : 0.0f;

  const float a = mul(k.fx, iz);
  const float b = mul(k.fy, iz);
  const float nfx = mul(-k.fx, x);
  const float p = mul(nfx, iz2);
  const float q = mul(mul(-k.fy, y), iz2);
  const float s = mul(add(nfx, k.bf), iz2);

  o.Jc[0][0] = -a;
  o.Jc[0][1] = 0.0f;
  o.Jc[0][2] = -p;
  o.Jc[0][3] = -mul(p, y);
  o.Jc[0][4] = sub(mul(p, x), mul(a, z));
  o.Jc[0][5] = mul(a, y);
  o.Jc[1][0] = 0.0f;
  o.Jc[1][1] = -b;
  o.Jc[1][2] = -q;
  o.Jc[1][3] = sub(mul(b, z), mul(q, y));
  o.Jc[1][4] = mul(q, x);
  o.Jc[1][5] = -mul(b, x);
  o.Jc[2][0] = -a;
  o.Jc[2][1] = 0.0f;
  o.Jc[2][2] = -s;
  o.Jc[2][3] = -mul(s, y);
  o.Jc[2][4] = sub(mul(s, x), mul(a, z));
  o.Jc[2][5] = mul(a, y);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    o.Jp[0][j] = -add(mul(a, R[j]), mul(p, R[6 + j]));
    o.Jp[1][j] = -add(mul(b, R[3 + j]), mul(q, R[6 + j]));
    o.Jp[2][j] = -add(mul(a, R[j]), mul(s, R[6 + j]));
  }
  if (!o.stereo) {
#pragma unroll
    for (int j = 0; j < 6; ++j) o.Jc[2][j] = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) o.Jp[2][j] = 0.0f;
  }
}

// The Huber weight factor delta / sq (1 within delta) and the cost
// 2 delta sq - delta^2 (chi2 within delta), sq = sqrt(max(chi2, 1e-12)):
// ops/ba_static.py huber_ref.
__device__ __forceinline__ void huber(float chi2, float delta, float* weight,
                                      float* rho) {
  const float sq = __fsqrt_rn(clamp_min(chi2, 1e-12f));
  const bool past = sq > delta;
  *weight = past ? __fdiv_rn(delta, sq) : 1.0f;
  *rho = past ? sub(mul(mul(2.0f, delta), sq), mul(delta, delta)) : chi2;
}

// J^T w X [Q, K] (row-major) of one edge's R x Q Jacobian J, weight w and
// R x K matrix X, in float64 rounded to float32 once: the products
// (w J) X ((w J) exact in float64), summed over the R rows in order.
// ops/ba_static.py normal_rows's contract.
template <int R, int Q, int K>
__device__ __forceinline__ void weighted_cross(const float (&J)[R][Q], float w,
                                               const float (&X)[R][K],
                                               float* __restrict__ out) {
  double wJ[R][Q];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int q = 0; q < Q; ++q) wJ[i][q] = __dmul_rn(w, J[i][q]);
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int p = 0; p < K; ++p) {
      double acc = __dmul_rn(wJ[0][q], X[0][p]);
#pragma unroll
      for (int i = 1; i < R; ++i)
        acc = __dadd_rn(acc, __dmul_rn(wJ[i][q], X[i][p]));
      out[q * K + p] = __double2float_rn(acc);
    }
}

// J^T w J [Q, Q] (row-major) and -J^T w e [Q] of one edge's R x Q
// Jacobian J, weight w and residual e, each entry in float64 rounded to
// float32 once (weighted_cross): ops/ba_static.py normal_rows.
template <int R, int Q>
__device__ __forceinline__ void normal_rows(const float (&J)[R][Q], float w,
                                            const float (&e)[R],
                                            float* __restrict__ H,
                                            float* __restrict__ b) {
  weighted_cross<R, Q, Q>(J, w, J, H);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    double acc = __dmul_rn(__dmul_rn(w, J[0][q]), e[0]);
#pragma unroll
    for (int i = 1; i < R; ++i)
      acc = __dadd_rn(acc, __dmul_rn(__dmul_rn(w, J[i][q]), e[i]));
    b[q] = __double2float_rn(-acc);
  }
}

}  // namespace ba
