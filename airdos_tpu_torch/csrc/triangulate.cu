// Two-view triangulation of matched rows, for sm_90a: one kernel,
// triangulate, one launch a keyframe's triangulation.
//
// Replaces the epilogue after the argmin of triangulation's epipolar
// search, airdos_tpu/matching/epipolar.py:86-178 (triangulate_pair,
// vmapped over the new keyframe's neighbours; the search itself reached
// the Pallas kernel airdos_tpu/ops/pallas_kernels.py:36
// hamming_matrix_pallas, whose port here is match_rows' epipolar mode).
// On the TPU it is ~150 XLA elementwise ops on [B, N1] rows; the port's
// plain version is ops/triangulate_kernels.py triangulate_rows_ref.
//
// For row n of the new keyframe (KF1) and neighbour b (KF2), with j =
// best[b, n] its matched feature and xn = ((x - cx) / fx, (y - cy) / fy,
// 1) the normalized rays:
//   the parallax: cos_par = (R1^T xn1) . (R2^T xn2) / max(|.| |.|, 1e-12);
//   the stereo parallax of each view: cos(2 atan2(bf / fx / 2, depth))
//     where depth > 0, else 2;
//   the DLT rows x P[2] - P[0], y P[2] - P[1] of P = [R | t] for both
//     views, A = [Bm | c]; M = Bm^T Bm damped by 1e-7 trace + 1e-12 on
//     its diagonal, rhs = -Bm^T c, X = adj(M) / det(M) rhs (the
//     closed-form inverse of solvers/smallmat.py inv3x3);
//   where the parallax is not in (0, 0.9998) or above the stereo
//     parallax, the stereo point of the view with the larger stereo
//     parallax (R^T (xn depth) + C), if its depth is positive;
//   both views: positive depth and reprojection chi-square (with the
//     right u where ur >= 0) under 7.8 / 5.991;
//   the ratio of the two distances to the camera centres within 1.5
//     scale of the ratio of the octaves' scales, both distances > 1e-6;
// valid = dist < th and all the above; idx2 = j where valid, else -1.
//
// Exactness.  Every step is one float32 operation of the plain version,
// in its order: products, sums and quotients rounded once each
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: nvcc would contract a
// product and a sum into an FMA), sqrtf correctly rounded (no fast-math
// in the build), the reciprocal 1 / z a correctly rounded division, as
// torch's reciprocal is, and the divisors fx, fy true divisions (the
// plain version divides by a tensor, not a Python scalar, which torch's
// CUDA division would turn into a product with a reciprocal).  atan2f,
// cosf and expf are CUDA's libdevice functions, which torch's CUDA
// elementwise ops call for float32; so the outputs are the plain
// version's on the card bit for bit where the two libdevices agree.
// minimum keeps a NaN as torch.minimum does.
//
// Design.  A thread a row of a target; each reads its row of KF1, its
// match's feature of KF2, the two poses (from L1: a block's rows share a
// target) and the scale tables, and writes idx2, the point and the three
// flags.  What bounds it on an H100: 36 bytes read and 23 written a row
// of a target, 24 read a keyframe row (0.40 MB at B x N1 = 4 x 1536, 0.12
// us at 3.35 TB/s) and ~450 float32 operations a row (2.8 MFLOP, 0.04 us
// at 67 TFLOP/s): the launch and a thread's chain of dependent loads and
// divisions are what a call costs.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

// the layout of ops/triangulate_kernels.py _PARAMS
struct TriParams {
  long long n_batch, n1, n2, n_levels, th;
  const long long* best;     // [B, N1]
  const int* dist;           // [B, N1]
  const float* xy1;          // [N1, 2]
  const long long* oct1;     // [N1]
  const float* ur1;          // [N1]
  const float* depth1;       // [N1]
  const float* xy2;          // [B, N2, 2]
  const long long* oct2;     // [B, N2]
  const float* ur2;          // [B, N2]
  const float* depth2;       // [B, N2]
  const float* R1;           // [3, 3]
  const float* t1;           // [3]
  const float* R2;           // [B, 3, 3]
  const float* t2;           // [B, 3]
  const float* C1w;          // [3]
  const float* C2w;          // [B, 3]
  const float* scale_factors;  // [n_levels]
  const float* sigma2;       // [n_levels]
  long long* idx2;           // [B, N1]
  float* points;             // [B, N1, 3]
  unsigned char* valid;      // [B, N1]
  unsigned char* from_stereo1;
  unsigned char* from_stereo2;
  float fx, fy, cx, cy, bf;
  float half_base;           // float32(bf / fx / 2)
  float log_scale, unused;
};

namespace {

constexpr int kThreads = 128;
constexpr float kMaxCosParallax = 0.9998f;
constexpr float kChi2Stereo = 7.8f;
constexpr float kChi2Mono = 5.991f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// a . b, left to right
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]));
}

// torch.minimum: a NaN wins
__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// torch.clamp(v, min=lo): a NaN kept
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

__device__ __forceinline__ float cos_stereo(float half_base, float depth) {
  return depth > 0.f ? cosf(mul(2.f, atan2f(half_base, depth))) : 2.f;
}

__device__ __forceinline__ int level(long long o, long long n) {
  return static_cast<int>(o < 0 ? 0 : (o >= n ? n - 1 : o));
}

// positive depth and the reprojection chi-square of X in a view (R, t)
__device__ __forceinline__ bool check_view(const TriParams& q, const float* R,
                                           const float* t, float u_obs,
                                           float v_obs, float s2, float ur,
                                           const float* X) {
  float xc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    xc[k] = add(add(add(mul(X[0], R[3 * k]), mul(X[1], R[3 * k + 1])),
                    mul(X[2], R[3 * k + 2])),
                t[k]);
  const float z = xc[2];
  const float iz = dvd(1.f, fabsf(z) < 1e-9f ? 1e-9f : z);
  const float u = add(mul(mul(q.fx, xc[0]), iz), q.cx);
  const float v = add(mul(mul(q.fy, xc[1]), iz), q.cy);
  const float urp = sub(u, mul(q.bf, iz));
  const float eu = sub(u, u_obs), ev = sub(v, v_obs);
  const float err2 = add(mul(eu, eu), mul(ev, ev));
  const bool has_r = ur >= 0.f;
  const float er = sub(urp, ur);
  const float chi = has_r ? dvd(add(err2, mul(er, er)), s2) : dvd(err2, s2);
  return z > 0.f && chi < (has_r ? kChi2Stereo : kChi2Mono);
}

__global__ void __launch_bounds__(kThreads) triangulate_kernel(const TriParams q) {
  const long long N1 = q.n1;
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= q.n_batch * N1) return;
  const long long b = row / N1, n = row - b * N1;
  // the row's inputs, every load issued before any is used
  const long long j = q.best[row];
  const int dist = q.dist[row];
  const float x1 = q.xy1[2 * n], y1 = q.xy1[2 * n + 1];
  const long long o1 = q.oct1[n];
  const float ur1 = q.ur1[n], depth1 = q.depth1[n];
  const long long f2 = b * q.n2 + j;
  const float x2 = q.xy2[2 * f2], y2 = q.xy2[2 * f2 + 1];
  const long long o2 = q.oct2[f2];
  const float ur2 = q.ur2[f2], depth2 = q.depth2[f2];
  float R1[9], R2[9], t1[3], t2[3], C1[3], C2[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    R1[k] = q.R1[k];
    R2[k] = q.R2[9 * b + k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    t1[k] = q.t1[k];
    t2[k] = q.t2[3 * b + k];
    C1[k] = q.C1w[k];
    C2[k] = q.C2w[3 * b + k];
  }
  const int l1 = level(o1, q.n_levels), l2 = level(o2, q.n_levels);
  const float s2_1 = q.sigma2[l1], s2_2 = q.sigma2[l2];
  const float sc1 = q.scale_factors[l1], sc2 = q.scale_factors[l2];

  // normalized rays (the third coordinate 1) and their parallax
  const float u1n = dvd(sub(x1, q.cx), q.fx), v1n = dvd(sub(y1, q.cy), q.fy);
  const float u2n = dvd(sub(x2, q.cx), q.fx), v2n = dvd(sub(y2, q.cy), q.fy);
  float ray1[3], ray2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ray1[k] = add(add(mul(u1n, R1[k]), mul(v1n, R1[3 + k])), R1[6 + k]);
    ray2[k] = add(add(mul(u2n, R2[k]), mul(v2n, R2[3 + k])), R2[6 + k]);
  }
  const float norm1 = sqrtf(dot3(ray1, ray1));
  const float norm2 = sqrtf(dot3(ray2, ray2));
  const float cos_par = dvd(dot3(ray1, ray2), clamp_min(mul(norm1, norm2), 1e-12f));
  const float cos_s1 = cos_stereo(q.half_base, depth1);
  const float cos_s2 = cos_stereo(q.half_base, depth2);
  const float cos_st = min_nan(cos_s1, cos_s2);

  // the DLT rows A[r] = [Bm | c] and the damped normal equations
  float A[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float p1_0 = k < 3 ? R1[k] : t1[0], p1_1 = k < 3 ? R1[3 + k] : t1[1];
    const float p1_2 = k < 3 ? R1[6 + k] : t1[2];
    const float p2_0 = k < 3 ? R2[k] : t2[0], p2_1 = k < 3 ? R2[3 + k] : t2[1];
    const float p2_2 = k < 3 ? R2[6 + k] : t2[2];
    A[0][k] = sub(mul(u1n, p1_2), p1_0);
    A[1][k] = sub(mul(v1n, p1_2), p1_1);
    A[2][k] = sub(mul(u2n, p2_2), p2_0);
    A[3][k] = sub(mul(v2n, p2_2), p2_1);
  }
  float M[3][3], rhs[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = i; k < 4; ++k) {
      const float s = add(add(add(mul(A[0][i], A[0][k]), mul(A[1][i], A[1][k])),
                              mul(A[2][i], A[2][k])),
                          mul(A[3][i], A[3][k]));
      if (k < 3) {
        M[i][k] = s;
        M[k][i] = s;
      } else {
        rhs[i] = -s;
      }
    }
  }
  const float damp = add(mul(1e-7f, add(add(M[0][0], M[1][1]), M[2][2])), 1e-12f);
  const float a = add(M[0][0], damp), bb = M[0][1], c = M[0][2];
  const float d = M[1][0], e = add(M[1][1], damp), f = M[1][2];
  const float g = M[2][0], h = M[2][1], i = add(M[2][2], damp);
  const float cA = sub(mul(e, i), mul(f, h));
  const float cB = -sub(mul(d, i), mul(f, g));
  const float cC = sub(mul(d, h), mul(e, g));
  const float cD = -sub(mul(bb, i), mul(c, h));
  const float cE = sub(mul(a, i), mul(c, g));
  const float cF = -sub(mul(a, h), mul(bb, g));
  const float cG = sub(mul(bb, f), mul(c, e));
  const float cH = -sub(mul(a, f), mul(c, d));
  const float cI = sub(mul(a, e), mul(bb, d));
  const float inv_det = dvd(1.f, add(add(mul(a, cA), mul(bb, cB)), mul(c, cC)));
  const float adj[3][3] = {{cA, cD, cG}, {cB, cE, cH}, {cC, cF, cI}};
  float Xtri[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    Xtri[r] = add(add(mul(mul(adj[r][0], inv_det), rhs[0]),
                      mul(mul(adj[r][1], inv_det), rhs[1])),
                  mul(mul(adj[r][2], inv_det), rhs[2]));

  const bool good_tri = cos_par > 0.f && cos_par < kMaxCosParallax && cos_par < cos_st;
  const bool use_s1 = !good_tri && cos_s1 < cos_s2 && depth1 > 0.f;
  const bool use_s2 = !good_tri && !use_s1 && depth2 > 0.f;
  float X[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (use_s1)
      X[k] = add(add(add(mul(mul(u1n, depth1), R1[k]), mul(mul(v1n, depth1), R1[3 + k])),
                     mul(depth1, R1[6 + k])),
                 C1[k]);
    else if (use_s2)
      X[k] = add(add(add(mul(mul(u2n, depth2), R2[k]), mul(mul(v2n, depth2), R2[3 + k])),
                     mul(depth2, R2[6 + k])),
                 C2[k]);
    else
      X[k] = Xtri[k];
  }
  const bool usable = good_tri || use_s1 || use_s2;
  const bool ok1 = check_view(q, R1, t1, x1, y1, s2_1, ur1, X);
  const bool ok2 = check_view(q, R2, t2, x2, y2, s2_2, ur2, X);

  // scale consistency
  float e1[3], e2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e1[k] = sub(X[k], C1[k]);
    e2[k] = sub(X[k], C2[k]);
  }
  const float d1 = sqrtf(dot3(e1, e1)), d2 = sqrtf(dot3(e2, e2));
  const float ratio_dist = dvd(d2, clamp_min(d1, 1e-9f));
  const float ratio_oct = dvd(sc1, sc2);
  const float ratio_factor = mul(1.5f, expf(q.log_scale));
  const bool scale_ok = mul(ratio_dist, ratio_factor) > ratio_oct &&
                        ratio_dist < mul(ratio_oct, ratio_factor) &&
                        d1 > 1e-6f && d2 > 1e-6f;

  const bool valid = dist < q.th && usable && ok1 && ok2 && scale_ok;
  q.idx2[row] = valid ? j : -1;
#pragma unroll
  for (int k = 0; k < 3; ++k) q.points[3 * row + k] = X[k];
  q.valid[row] = valid;
  q.from_stereo1[row] = use_s1 && valid;
  q.from_stereo2[row] = use_s2 && valid;
}

}  // namespace

extern "C" int airdos_triangulate(const TriParams* params, void* stream) {
  const TriParams& q = *params;
  const long long rows = q.n_batch * q.n1;
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((rows + kThreads - 1) / kThreads);
  triangulate_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}
