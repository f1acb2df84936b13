// RANSAC hypotheses and their refinement for relocalization's EPnP and
// loop closing's Sim3 (Horn), for sm_90a: two kernels, epnp_kernel and
// horn_kernel, each in two modes.
//
// Replaces the vmapped lowerings of airdos_tpu/solvers/epnp.py:147
// epnp_ransac (one_hyp :167, epnp_pose :90 with its eigh calls :30 and
// :98, the refine :171-185) and airdos_tpu/solvers/sim3.py:33 sim3_ransac
// (one_hyp :65, horn_align airdos_tpu/solvers/align.py:16 with its eigh
// :47, the refine :70).  On the TPU each is one vmapped program of small
// eigen-decompositions; the port's plain versions (solvers/epnp.py
// epnp_hypotheses_ref / epnp_refine_ref, solvers/sim3.py
// sim3_hypotheses_ref / sim3_refine_ref) run them as batched eager torch:
// a batched eigh, solve_ex and ~200 small ops a RANSAC.
//
// EPnP: a warp a hypothesis (hypotheses mode: H warps, four a block, over
// sample_idx [H, 4]) or one warp over all n points (refine mode, weights
// inl_b + 1e-6 in float32).  The sums over the warp's points (the
// sample's 4 or all n) are fixed-order warp sums (small_eig.cuh
// warp_sum); the dense work runs in float64: the 3 x 3 PCA and the 4 x 4
// inverse on lane 0, M^T M's and the canonical basis's eigenvectors on the
// whole warp (small_eig.cuh warp_jacobi_eigh, a round-robin order), the
// two candidates (Gauss-Newton on the betas, Horn's 4 x 4 Jacobi) on
// lanes 0 and 1 side by side; the pose is rounded once to float32, and
// the warp's lanes run the inlier test of all n points in float32 and
// count the inliers by a warp sum.
// Horn: a block a hypothesis (H blocks over sample_idx [H, 3]) or one
// block over all n points (refine mode); the sums are fixed-order block
// sums (small_eig.cuh block_sum), the dense work float64 on thread 0
// (small_eig.cuh: cyclic Jacobi), the inlier test by the block.
//
// EPnP (solvers/epnp.py epnp_pose):
//   c0 = sum w P / sum w; C = sum wn (P - c0)(P - c0)^T; its 3 x 3 Jacobi
//   gives the control points c0 + sqrt(max(lam, 1e-12)) e (the largest
//   axis first, each e's largest component positive); A = [cps^T; 1] +
//   1e-9 I inverted by Gauss (the plain
//   version solves A alpha = [P; 1] for every point: here alpha = A^-1
//   [P; 1]); M^T M's 78 entries from 40 sums over the points, sum w
//   alpha_j alpha_k {1, du, dv, du^2 + dv^2} (du = cx - u, dv = cy - v),
//   where the plain version forms M [2n, 12] and multiplies; its 12 x 12
//   Jacobi, the four smallest eigenvectors (for a minimal sample, whose
//   null space they span with no preferred basis, turned into the
//   principal axes of diag(1, ..., 12) within it); G and rho; the two case-1
//   starts with 6 Gauss-Newton steps each (4 x 4 solves); each
//   candidate's camera-frame points are alpha x, so their centroid and
//   Horn's M come from 16 more sums taken once (sum wn alpha_j and sum wn
//   (P - c0) alpha_j^T, with sum wn (P - c0) = 0 taken as exact), and the
//   positive-depth flip negates both; Horn's R, t; the weighted
//   reprojection error of each candidate over the points (a warp sum),
//   and the pick err0 <= err1.  Inliers: err2 < max_err2 and z > 0 (z
//   the guarded depth).
// Horn (solvers/align.py horn_align): c1, c2 = sum w x / sum w; M = sum
//   wn (x2 - c2)(x1 - c1)^T and sum wn |x2 - c2|^2; N's top eigenvector
//   by a 4 x 4 Jacobi -> R; s = 1 with fix_scale, else sum_ij R_ij M_ji /
//   max(den, 1e-12); t = c1 - s R c2.  Inliers: the mutual reprojection
//   test (x2 into camera 1 through S12 under max_err1, x1 into camera 2
//   through S21 under max_err2) where valid.
// Degenerate samples: a sample that repeats an index (or holds one
// outside [0, n)) gives a NaN pose and no inliers, as the plain versions
// give it; so does any non-finite matrix (Jacobi) or zero pivot (Gauss).
// Refine mode keeps its result when it has at least as many inliers as
// the hypothesis it refines (R_b, t_b, s_b, inl_b), else the hypothesis.
//
// The eigensolver's free choices are fixed by rule, as the plain version
// fixes them with canonical=True: EPnP's pose moves with the signs of the
// PCA axes at the noise level, and a minimal sample's with the basis of
// its null space (Horn's quaternion absorbs its sign).  Where the order
// differs from the plain version's: float64 inside with one rounding of
// the pose; alpha by A^-1; M^T M and Horn's M from sums of products of
// the points' alphas instead of from M and pc; the eigensolver (Jacobi
// here, LAPACK or cuSOLVER there), which matters only where an
// eigenvalue repeats (a degenerate sample).  So poses agree to float32
// rounding on well-posed samples, and inlier flags where a point is not
// at its gate.
//
// What bounds it on an H100.  Not the card's rates: a hypothesis reads
// its m points and all n points once (20 or 24 bytes a point, 5 KB at n
// 200) and writes n flags; its float64 work is ~1e5 operations in the
// 12 x 12 Jacobi (EPnP) or ~3e3 (Horn), 2.6e7 for 256 EPnP hypotheses,
// 0.8 us at 34 TFLOP/s.  A launch costs one hypothesis's chain of
// dependent float64 operations, the hypotheses side by side.  Horn's is
// short, on thread 0.  EPnP's was ~0.5 ms on thread 0 (its 12 x 12
// Jacobi's ~400 rotations one after another, each ~60 dependent updates
// through shared memory); on a warp a step's six rotations and their
// ~100 updates run at once, 11 steps a sweep, so the chain is a step's:
// a rotation's hypot, division and reciprocal square root, then a
// lane's share of the updates (~1,300 cycles a step on the card, ~110
// steps; tools/kernel_split.py).  The candidates' chains run side by side,
// and the sums keep 14 partial sums a lane at a time where thread 0 kept
// 56.
//
// The C entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "small_eig.cuh"

// the layout of ops/ransac_kernels.py _PARAMS
struct RansacParams {
  long long n;               // points
  long long n_hyp;           // hypotheses, or 1 in refine mode
  long long refine;          // 0: hypotheses mode, 1: refine mode
  long long fix_scale;       // Horn: s = 1
  const float* a;            // EPnP: pw [n, 3]; Horn: x1 [n, 3]
  const float* b;            // EPnP: uv [n, 2]; Horn: x2 [n, 3]
  const unsigned char* valid;  // [n]
  const float* gate1;        // EPnP: max_err2 [n]; Horn: max_err1 [n]
  const float* gate2;        // Horn: max_err2 [n]
  const int* samples;        // [H, m] (hypotheses mode)
  const float* R_b;          // [3, 3] (refine mode)
  const float* t_b;          // [3]
  const float* s_b;          // [] (Horn)
  const unsigned char* inl_b;  // [n]
  float* R;                  // [H, 3, 3]
  float* t;                  // [H, 3]
  float* s;                  // [H] (Horn)
  unsigned char* inliers;    // [H, n]
  long long* counts;         // [H]
  float fx, fy, cx, cy;
};

namespace {

constexpr int kThreads = 128;            // Horn: a block's threads
constexpr int kWarps = kThreads / 32;
constexpr int kHornSums = 10;

// Horn's block sums and what thread 0 hands to the other threads
struct Shared {
  double scratch[kHornSums * kWarps];
  double out[kHornSums];
  float Rf[9], tf[3], sf;    // the block's pose, rounded
  int bad;                   // a degenerate sample
};

__device__ __forceinline__ double guard(double z) {
  return fabs(z) < 1e-9 ? 1e-9 : z;
}

__device__ __forceinline__ float guardf(float z) {
  return fabsf(z) < 1e-9f ? 1e-9f : z;
}

// point j of hypothesis h's set: the sample's j-th index, or j itself
__device__ __forceinline__ long long point_of(const RansacParams& q, int m,
                                              long long j, long long h) {
  return q.refine ? j : static_cast<long long>(q.samples[h * m + j]);
}

// the weight of point gi: 1 for a sample, inl_b + 1e-6 (float32) in refine
__device__ __forceinline__ double weight_of(const RansacParams& q,
                                            long long gi) {
  return q.refine ? static_cast<double>((q.inl_b[gi] ? 1.0f : 0.0f) + 1e-6f)
                  : 1.0;
}

// does hypothesis h's sample repeat an index or leave [0, n)?
__device__ __forceinline__ bool degenerate(const RansacParams& q, int m,
                                           long long h) {
  if (q.refine) return false;
  const int* idx = q.samples + h * m;
  for (int i = 0; i < m; ++i) {
    if (idx[i] < 0 || idx[i] >= q.n) return true;
    for (int j = 0; j < i; ++j)
      if (idx[j] == idx[i]) return true;
  }
  return false;
}

__device__ __forceinline__ void round_pose(float (&Rf)[9], float (&tf)[3],
                                           const double (&R)[3][3],
                                           const double (&t)[3]) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) Rf[3 * i + j] = static_cast<float>(R[i][j]);
    tf[i] = static_cast<float>(t[i]);
  }
}

__device__ __forceinline__ void nan_pose(float (&Rf)[9], float (&tf)[3]) {
  const float nan = nanf("");
  for (int i = 0; i < 9; ++i) Rf[i] = nan;
  for (int i = 0; i < 3; ++i) tf[i] = nan;
}

// ------------------------------------------------------------------ EPnP

constexpr int kLanes = small::kLanes;    // a warp's lanes (1 in a host build)
constexpr int kHypsPerBlock = 4;         // hypotheses mode: a warp each
constexpr int kSums = 56;                // M^T M's 40, sum wn alpha 4, Horn's M 12
constexpr int kChunk = 14;               // sums a pass over the points
static_assert(kSums == 4 * kChunk, "epnp_warp sums four chunks");

// a hypothesis's state, in shared memory, one a warp
struct EpnpWarp {
  double A[12][12];          // M^T M (the solver's scratch)
  double V[12][12];          // its eigenvectors, ascending
  double w[12];
  double rot[2][6];          // the solver's rotations of a step
  double B[4][4], Q[4][4], ev[4], rot4[2][2];   // the canonical basis
  double G[6][4][4], rho[6]; // the control-point distance system
  double sums[kSums];
  double cps[4][3];          // the control points
  double Ainv[4][4];         // the barycentric system's inverse
  double Rc[2][3][3], tc[2][3];   // the two candidates
  float Rf[9], tf[3];        // the warp's pose, rounded
};

// pair pr < 10 of the control points a <= c: (0,0) (0,1) ... (3,3)
__device__ __forceinline__ void pair_le(int pr, int& a, int& c) {
  a = pr < 4 ? 0 : pr < 7 ? 1 : pr < 9 ? 2 : 3;
  c = a + pr - (4 * a - a * (a - 1) / 2);
}

// pair pr < 6 of the control points i < j: (0,1) (0,2) (0,3) (1,2) (1,3) (2,3)
__device__ __forceinline__ void pair_lt(int pr, int& i, int& j) {
  i = pr < 3 ? 0 : pr < 5 ? 1 : 2;
  j = i + 1 + pr - (3 * i - i * (i - 1) / 2);
}

// sum k of a point: w alpha_a alpha_c {1, du, dv, du^2 + dv^2} for the 10
// pairs a <= c (k < 40), wn alpha_a (40-43), wn (P - c0)_r alpha_a (44-55)
__device__ __forceinline__ double point_sum(int k, double w, double wn,
                                            const double (&al)[4],
                                            const double (&e)[3], double du,
                                            double dv, double dd) {
  if (k < 40) {
    int a, c;
    pair_le(k / 4, a, c);
    const double waa = w * al[a] * al[c];
    const int part = k % 4;
    return part == 0 ? waa : part == 1 ? waa * du : part == 2 ? waa * dv : waa * dd;
  }
  if (k < 44) return wn * al[k - 40];
  return wn * e[(k - 44) / 4] * al[(k - 44) % 4];
}

// Gauss-Newton on f_p(b) = b^T G_p b - rho_p from b (solvers/epnp.py
// _betas_gn): 6 steps, each a damped 4 x 4 solve
__device__ void betas_gn(const double (&G)[6][4][4], const double (&rho)[6],
                         double (&b)[4]) {
  for (int it = 0; it < 6; ++it) {
    double f[6], J[6][4];
    for (int p = 0; p < 6; ++p) {
      double gb[4];
      for (int k = 0; k < 4; ++k) {
        gb[k] = 0.0;
        for (int l = 0; l < 4; ++l) gb[k] += G[p][k][l] * b[l];
      }
      double bgb = 0.0;
      for (int k = 0; k < 4; ++k) bgb += b[k] * gb[k];
      f[p] = bgb - rho[p];
      for (int k = 0; k < 4; ++k) J[p][k] = 2.0 * gb[k];
    }
    double H[4][4], g[4][1];
    for (int k = 0; k < 4; ++k) {
      for (int l = 0; l < 4; ++l) {
        double s = 0.0;
        for (int p = 0; p < 6; ++p) s += J[p][k] * J[p][l];
        H[k][l] = s + (k == l ? 1e-9 : 0.0);
      }
      double s = 0.0;
      for (int p = 0; p < 6; ++p) s += J[p][k] * f[p];
      g[k][0] = s;
    }
    small::gauss_solve<4, 1>(H, g);
    for (int k = 0; k < 4; ++k) b[k] -= g[k][0];
  }
}

// one lane: candidate cand's R, t into s.Rc, s.tc (solvers/epnp.py
// epnp_pose after the null space: the case-1 start on basis cand, the
// betas, the camera-frame points' centroid and Horn's M from the sums,
// the positive-depth flip, Horn's R).  Not inlined, as control_points:
// its one-lane arrays take their own registers, not the warp code's.
__device__ __noinline__ void epnp_candidate(EpnpWarp& s, const double (&c0)[3],
                                            int cand) {
  double num = 0.0, den = 0.0;
  for (int p = 0; p < 6; ++p) {
    num += s.rho[p] * s.G[p][cand][cand];
    den += s.G[p][cand][cand] * s.G[p][cand][cand];
  }
  double b[4] = {0.0, 0.0, 0.0, 0.0};
  b[cand] = sqrt(num / fmax(den, 1e-12));
  betas_gn(s.G, s.rho, b);
  double x[4][3];                         // camera-frame control points
  for (int j = 0; j < 4; ++j)
    for (int c = 0; c < 3; ++c) {
      double v = 0.0;
      for (int k = 0; k < 4; ++k) v += s.V[3 * j + c][k] * b[k];
      x[j][c] = v;
    }
  const double* Am = s.sums + 40;         // sum wn alpha_j
  const double* Bm = s.sums + 44;         // sum wn (P - c0)_r alpha_j: [r][j]
  double c1[3], M[3][3];
  for (int c = 0; c < 3; ++c) {
    double v = 0.0;
    for (int j = 0; j < 4; ++j) v += Am[j] * x[j][c];
    c1[c] = v;
  }
  // positive depth: sum w pc_z = sum w * c1_z; the flip negates pc
  const double sgn = c1[2] < 0.0 ? -1.0 : 1.0;
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      double v = 0.0;
      for (int j = 0; j < 4; ++j) v += Bm[4 * r + j] * x[j][c];
      M[r][c] = sgn * v;
    }
  for (int c = 0; c < 3; ++c) c1[c] *= sgn;
  double R[3][3];
  small::horn_rotation(M, R);
  for (int i = 0; i < 3; ++i) {
    for (int c = 0; c < 3; ++c) s.Rc[cand][i][c] = R[i][c];
    s.tc[cand][i] = c1[i] - (R[i][0] * c0[0] + R[i][1] * c0[1] + R[i][2] * c0[2]);
  }
}

// one lane: the control points c0 + sqrt(lambda) e by PCA of the points'
// covariance s6 (each axis's largest component positive), and the
// barycentric system's inverse, into s.cps and s.Ainv
__device__ __noinline__ void control_points(EpnpWarp& s, const double (&s6)[6],
                                            const double (&c0)[3]) {
  double C[3][3] = {{s6[0], s6[1], s6[2]},
                    {s6[1], s6[3], s6[4]},
                    {s6[2], s6[4], s6[5]}};
  double E[3][3], lam[3];
  small::jacobi_eigh<3>(C, E, lam);
  for (int i = 0; i < 3; ++i) {   // each axis's largest component > 0
    int r = 0;
    for (int k = 1; k < 3; ++k)
      if (fabs(E[k][i]) > fabs(E[r][i])) r = k;
    if (E[r][i] < 0.0)
      for (int k = 0; k < 3; ++k) E[k][i] = -E[k][i];
  }
  for (int c = 0; c < 3; ++c) s.cps[0][c] = c0[c];
  for (int i = 0; i < 3; ++i) {
    const double l = sqrt(fmax(lam[2 - i], 1e-12));
    for (int c = 0; c < 3; ++c) s.cps[1 + i][c] = c0[c] + l * E[c][2 - i];
  }
  double A[4][4], I[4][4];
  for (int r = 0; r < 4; ++r)
    for (int j = 0; j < 4; ++j) {
      A[r][j] = (r < 3 ? s.cps[j][r] : 1.0) + (r == j ? 1e-9 : 0.0);
      I[r][j] = r == j ? 1.0 : 0.0;
    }
  small::gauss_solve<4, 4>(A, I);
  for (int r = 0; r < 4; ++r)
    for (int j = 0; j < 4; ++j) s.Ainv[r][j] = I[r][j];
}

// sums [C kChunk, (C + 1) kChunk) over the warp's points: each lane its
// points in turn, then a warp sum of each, into s.sums (lane 0); a chunk
// at a time, so that its partial sums are all that a lane keeps in
// registers.
template <int C>
__device__ __forceinline__ void sums_chunk(const RansacParams& q, EpnpWarp& s,
                                        const double (&c0)[3], double wsum,
                                        long long m, int mi, long long h,
                                        int lane, int span) {
  double Ai[4][4];
  for (int r = 0; r < 4; ++r)
    for (int j = 0; j < 4; ++j) Ai[r][j] = s.Ainv[r][j];
  double acc[kChunk];
#pragma unroll
  for (int i = 0; i < kChunk; ++i) acc[i] = 0.0;
  for (long long j = lane; j < m; j += kLanes) {
    const long long gi = point_of(q, mi, j, h);
    const double w = weight_of(q, gi), wn = w / wsum;
    const double P[4] = {__ldg(q.a + 3 * gi), __ldg(q.a + 3 * gi + 1),
                         __ldg(q.a + 3 * gi + 2), 1.0};
    double al[4];
    for (int r = 0; r < 4; ++r)
      al[r] = Ai[r][0] * P[0] + Ai[r][1] * P[1] + Ai[r][2] * P[2] + Ai[r][3] * P[3];
    const double e[3] = {P[0] - c0[0], P[1] - c0[1], P[2] - c0[2]};
    const double du = static_cast<double>(q.cx) - __ldg(q.b + 2 * gi);
    const double dv = static_cast<double>(q.cy) - __ldg(q.b + 2 * gi + 1);
    const double dd = du * du + dv * dv;
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      acc[i] += point_sum(C * kChunk + i, w, wn, al, e, du, dv, dd);
  }
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const double t = small::warp_sum(acc[i], span);
    if (lane == 0) s.sums[C * kChunk + i] = t;
  }
}

// the warp's EPnP of hypothesis h over its m points, rounded into s.Rf,
// s.tf (solvers/epnp.py epnp_pose)
__device__ void epnp_warp(const RansacParams& q, EpnpWarp& s, long long m,
                          long long h, int lane) {
  const int mi = static_cast<int>(q.refine ? 0 : m);
  int span = 1;                           // lanes that hold a point
  while (span < m && span < kLanes) span *= 2;
  // centroid
  double s4[4] = {0.0, 0.0, 0.0, 0.0};
  for (long long j = lane; j < m; j += kLanes) {
    const long long gi = point_of(q, mi, j, h);
    const double w = weight_of(q, gi);
    s4[0] += w;
    for (int c = 0; c < 3; ++c) s4[1 + c] += w * __ldg(q.a + 3 * gi + c);
  }
  for (int k = 0; k < 4; ++k) s4[k] = small::warp_sum(s4[k], span);
  const double wsum = fmax(s4[0], 1e-12);
  const double c0[3] = {s4[1] / wsum, s4[2] / wsum, s4[3] / wsum};
  // the points' covariance
  double s6[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (long long j = lane; j < m; j += kLanes) {
    const long long gi = point_of(q, mi, j, h);
    const double wn = weight_of(q, gi) / wsum;
    double e[3];
    for (int c = 0; c < 3; ++c) e[c] = __ldg(q.a + 3 * gi + c) - c0[c];
    s6[0] += wn * e[0] * e[0];
    s6[1] += wn * e[0] * e[1];
    s6[2] += wn * e[0] * e[2];
    s6[3] += wn * e[1] * e[1];
    s6[4] += wn * e[1] * e[2];
    s6[5] += wn * e[2] * e[2];
  }
  for (int k = 0; k < 6; ++k) s6[k] = small::warp_sum(s6[k], span);
  // lane 0: control points by PCA and the barycentric system
  if (lane == 0) control_points(s, s6, c0);
  __syncwarp();
  // the 56 sums, kChunk a pass over the warp's points
  sums_chunk<0>(q, s, c0, wsum, m, mi, h, lane, span);
  sums_chunk<1>(q, s, c0, wsum, m, mi, h, lane, span);
  sums_chunk<2>(q, s, c0, wsum, m, mi, h, lane, span);
  sums_chunk<3>(q, s, c0, wsum, m, mi, h, lane, span);
  __syncwarp();
  // M^T M from the 10 pairs j <= k of 4 sums each: a 3 x 3 block a pair,
  // {{fx^2 S0, 0, fx S1}, {0, fy^2 S0, fy S2}, {fx S1, fy S2, S3}}
  const double fx = q.fx, fy = q.fy;
  for (int e = lane; e < 144; e += kLanes) {
    const int row = e / 12, col = e % 12;
    const int j = row / 3, a = row % 3, k = col / 3, c = col % 3;
    const int lo = j < k ? j : k, hi = j < k ? k : j;
    const double* S = s.sums + 4 * (4 * lo - lo * (lo - 1) / 2 + hi - lo);
    double v = 0.0;
    if (a == c)
      v = a == 0 ? fx * fx * S[0] : a == 1 ? fy * fy * S[0] : S[3];
    else if (a + c == 2)
      v = fx * S[1];
    else if (a + c == 3)
      v = fy * S[2];
    s.A[row][col] = v;
  }
  __syncwarp();
  small::warp_jacobi_eigh<12>(s.A, s.V, s.w, s.rot, lane);
  if (!q.refine || q.n == 4) {
    // a minimal sample: the null space's own basis, the principal axes of
    // diag(1, ..., 12) restricted to it (solvers/epnp.py
    // canonical_null_basis), so that the hypothesis does not depend on
    // which eigenvectors the solver picked in it
    for (int e = lane; e < 16; e += kLanes) {
      const int a = e / 4, b = e % 4;
      if (a > b) continue;
      double v = 0.0;
      for (int r = 0; r < 12; ++r) v += s.V[r][a] * (r + 1.0) * s.V[r][b];
      s.B[a][b] = s.B[b][a] = v;
    }
    __syncwarp();
    small::warp_jacobi_eigh<4>(s.B, s.Q, s.ev, s.rot4, lane);
    constexpr int kRows = (48 + kLanes - 1) / kLanes;
    double row[kRows];
#pragma unroll
    for (int n = 0; n < kRows; ++n) {
      const int e = lane + n * kLanes, r = e / 4, b = e % 4;
      if (e < 48)
        row[n] = s.V[r][0] * s.Q[0][b] + s.V[r][1] * s.Q[1][b] +
                 s.V[r][2] * s.Q[2][b] + s.V[r][3] * s.Q[3][b];
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < kRows; ++n) {
      const int e = lane + n * kLanes;
      if (e < 48) s.V[e / 4][e % 4] = row[n];
    }
    __syncwarp();
  }
  // the null-space basis v[k][cp][c] = V[3 cp + c][k], k < 4: G and rho
  for (int e = lane; e < 102; e += kLanes) {
    if (e < 96) {
      const int p = e / 16, k = e / 4 % 4, l = e % 4;
      int i, j;
      pair_lt(p, i, j);
      double dk[3], dl[3];
      for (int c = 0; c < 3; ++c) {
        dk[c] = s.V[3 * i + c][k] - s.V[3 * j + c][k];
        dl[c] = s.V[3 * i + c][l] - s.V[3 * j + c][l];
      }
      s.G[p][k][l] = dk[0] * dl[0] + dk[1] * dl[1] + dk[2] * dl[2];
    } else {
      int i, j;
      pair_lt(e - 96, i, j);
      double r = 0.0;
      for (int c = 0; c < 3; ++c) {
        const double d = s.cps[i][c] - s.cps[j][c];
        r += d * d;
      }
      s.rho[e - 96] = r;
    }
  }
  __syncwarp();
  // the two candidates side by side, a lane each
  for (int cand = lane; cand < 2; cand += kLanes) epnp_candidate(s, c0, cand);
  __syncwarp();
  // each candidate's weighted reprojection error over the points
  double e2[2] = {0.0, 0.0};
  for (long long j = lane; j < m; j += kLanes) {
    const long long gi = point_of(q, mi, j, h);
    const double w = weight_of(q, gi);
    const double P[3] = {__ldg(q.a + 3 * gi), __ldg(q.a + 3 * gi + 1),
                         __ldg(q.a + 3 * gi + 2)};
    for (int cand = 0; cand < 2; ++cand) {
      double xc[3];
      for (int i = 0; i < 3; ++i)
        xc[i] = s.Rc[cand][i][0] * P[0] + s.Rc[cand][i][1] * P[1] +
                s.Rc[cand][i][2] * P[2] + s.tc[cand][i];
      const double z = guard(xc[2]);
      const double u = q.fx * xc[0] / z + q.cx - __ldg(q.b + 2 * gi);
      const double v = q.fy * xc[1] / z + q.cy - __ldg(q.b + 2 * gi + 1);
      e2[cand] += w * (u * u + v * v);
    }
  }
  e2[0] = small::warp_sum(e2[0], span);
  e2[1] = small::warp_sum(e2[1], span);
  if (lane == 0) {
    const int k = e2[0] <= e2[1] ? 0 : 1;
    round_pose(s.Rf, s.tf, s.Rc[k], s.tc[k]);
  }
  __syncwarp();
}

// the warp's inlier test of all n points against its pose (float32):
// flags into out_inl; the count (and, in refine mode, inl_b's as cnt_b)
// on every lane
__device__ double epnp_inliers(const RansacParams& q, const EpnpWarp& s,
                               unsigned char* out_inl, int lane,
                               double& cnt_b) {
  double cnt = 0.0, cb = 0.0;
  const float* R = s.Rf;
  const float* t = s.tf;
  float Rr[9], tr[3];                   // the pose in registers
  for (int k = 0; k < 9; ++k) Rr[k] = R[k];
  for (int k = 0; k < 3; ++k) tr[k] = t[k];
  constexpr int kBatch = 4;             // points a lane loads at once
  for (long long i0 = lane; i0 < q.n; i0 += kBatch * kLanes) {
    float pt[kBatch][6], gate[kBatch];
    bool ok[kBatch], was[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {  // the batch's loads first
      const long long i = i0 + u * kLanes;
      const bool in = i < q.n;
      for (int c = 0; c < 3; ++c) pt[u][c] = in ? __ldg(q.a + 3 * i + c) : 0.f;
      for (int c = 0; c < 2; ++c) pt[u][3 + c] = in ? __ldg(q.b + 2 * i + c) : 0.f;
      gate[u] = in ? __ldg(q.gate1 + i) : 0.f;
      ok[u] = in && __ldg(q.valid + i);
      was[u] = in && q.refine && __ldg(q.inl_b + i);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long i = i0 + u * kLanes;
      if (i >= q.n) break;
      const float p0 = pt[u][0], p1 = pt[u][1], p2 = pt[u][2];
      const float x = Rr[0] * p0 + Rr[1] * p1 + Rr[2] * p2 + tr[0];
      const float y = Rr[3] * p0 + Rr[4] * p1 + Rr[5] * p2 + tr[1];
      const float z = guardf(Rr[6] * p0 + Rr[7] * p1 + Rr[8] * p2 + tr[2]);
      const float du = q.fx * x / z + q.cx - pt[u][3];
      const float dv = q.fy * y / z + q.cy - pt[u][4];
      const float err2 = du * du + dv * dv;
      const bool inl = ok[u] && err2 < gate[u] && z > 0.f;
      out_inl[i] = inl;
      cnt += inl ? 1.0 : 0.0;
      cb += was[u] ? 1.0 : 0.0;
    }
  }
  cnt_b = small::warp_sum(cb);
  return small::warp_sum(cnt);
}

// ------------------------------------------------------------------ Horn

__device__ void horn_block(const RansacParams& q, Shared& sh, long long m) {
  const int tid = threadIdx.x;
  double s7[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (long long j = tid; j < m; j += blockDim.x) {
    const long long gi = point_of(q, static_cast<int>(m), j, blockIdx.x);
    const double w = weight_of(q, gi);
    s7[0] += w;
    for (int c = 0; c < 3; ++c) {
      s7[1 + c] += w * q.a[3 * gi + c];
      s7[4 + c] += w * q.b[3 * gi + c];
    }
  }
  small::block_sum<7>(s7, sh.scratch, sh.out);
  const double wsum = fmax(s7[0], 1e-12);
  const double c1[3] = {s7[1] / wsum, s7[2] / wsum, s7[3] / wsum};
  const double c2[3] = {s7[4] / wsum, s7[5] / wsum, s7[6] / wsum};
  double s10[10];
  for (int k = 0; k < 10; ++k) s10[k] = 0.0;
  for (long long j = tid; j < m; j += blockDim.x) {
    const long long gi = point_of(q, static_cast<int>(m), j, blockIdx.x);
    const double wn = weight_of(q, gi) / wsum;
    double q1[3], q2[3];
    for (int c = 0; c < 3; ++c) {
      q1[c] = q.a[3 * gi + c] - c1[c];
      q2[c] = q.b[3 * gi + c] - c2[c];
    }
    for (int i = 0; i < 3; ++i)
      for (int c = 0; c < 3; ++c) s10[3 * i + c] += wn * q2[i] * q1[c];
    s10[9] += wn * (q2[0] * q2[0] + q2[1] * q2[1] + q2[2] * q2[2]);
  }
  small::block_sum<10>(s10, sh.scratch, sh.out);
  if (tid == 0) {
    double M[3][3], R[3][3];
    for (int i = 0; i < 3; ++i)
      for (int c = 0; c < 3; ++c) M[i][c] = s10[3 * i + c];
    small::horn_rotation(M, R);
    double s = 1.0;
    if (!q.fix_scale) {
      double num = 0.0;
      for (int i = 0; i < 3; ++i)
        for (int c = 0; c < 3; ++c) num += R[i][c] * M[c][i];
      s = num / fmax(s10[9], 1e-12);
    }
    double t[3];
    for (int i = 0; i < 3; ++i)
      t[i] = c1[i] - s * (R[i][0] * c2[0] + R[i][1] * c2[1] + R[i][2] * c2[2]);
    round_pose(sh.Rf, sh.tf, R, t);
    sh.sf = static_cast<float>(s);
  }
  __syncthreads();
}

__device__ double horn_inliers(const RansacParams& q, Shared& sh,
                               unsigned char* out_inl, double& cnt_b) {
  double cnt[2] = {0.0, 0.0};
  const float* R = sh.Rf;
  const float* t = sh.tf;
  const float s = sh.sf, si = 1.0f / sh.sf;
  for (long long i = threadIdx.x; i < q.n; i += blockDim.x) {
    const float* x1 = q.a + 3 * i;
    const float* x2 = q.b + 3 * i;
    const float z1o = guardf(x1[2]), z2o = guardf(x2[2]);
    const float u1 = q.fx * x1[0] / z1o + q.cx, v1 = q.fy * x1[1] / z1o + q.cy;
    const float u2 = q.fx * x2[0] / z2o + q.cx, v2 = q.fy * x2[1] / z2o + q.cy;
    float p1[3], p2[3];
    for (int k = 0; k < 3; ++k)
      p1[k] = s * (R[3 * k] * x2[0] + R[3 * k + 1] * x2[1] + R[3 * k + 2] * x2[2]) + t[k];
    const float d0 = x1[0] - t[0], d1 = x1[1] - t[1], d2 = x1[2] - t[2];
    for (int k = 0; k < 3; ++k)
      p2[k] = si * (d0 * R[k] + d1 * R[3 + k] + d2 * R[6 + k]);
    const float z1 = guardf(p1[2]), z2 = guardf(p2[2]);
    const float a1 = q.fx * p1[0] / z1 + q.cx - u1, b1 = q.fy * p1[1] / z1 + q.cy - v1;
    const float a2 = q.fx * p2[0] / z2 + q.cx - u2, b2 = q.fy * p2[1] / z2 + q.cy - v2;
    const float e1 = a1 * a1 + b1 * b1, e2 = a2 * a2 + b2 * b2;
    const bool inl = q.valid[i] && e1 < q.gate1[i] && e2 < q.gate2[i];
    out_inl[i] = inl;
    cnt[0] += inl ? 1.0 : 0.0;
    if (q.refine) cnt[1] += q.inl_b[i] ? 1.0 : 0.0;
  }
  small::block_sum<2>(cnt, sh.scratch, sh.out);
  cnt_b = cnt[1];
  return cnt[0];
}

// ---------------------------------------------------------- the kernels

// Horn's block outputs: a hypothesis's, or refine's keep-if-no-worse
__device__ void finish(const RansacParams& q, Shared& sh, double cnt,
                       double cnt_b, unsigned char* out_inl) {
  const long long h = blockIdx.x;
  const bool keep = !q.refine || cnt >= cnt_b;
  if (!keep)
    for (long long i = threadIdx.x; i < q.n; i += blockDim.x) out_inl[i] = q.inl_b[i];
  if (threadIdx.x == 0) {
    for (int k = 0; k < 9; ++k) q.R[9 * h + k] = keep ? sh.Rf[k] : q.R_b[k];
    for (int k = 0; k < 3; ++k) q.t[3 * h + k] = keep ? sh.tf[k] : q.t_b[k];
    if (q.s != nullptr) q.s[h] = keep ? sh.sf : *q.s_b;
    q.counts[h] = static_cast<long long>(keep ? cnt : cnt_b);
  }
}

// a warp a hypothesis: kHypsPerBlock a block of hypotheses mode, one in
// refine mode
__global__ void __launch_bounds__(kHypsPerBlock * 32) epnp_kernel(const RansacParams q) {
  __shared__ EpnpWarp ws[kHypsPerBlock];
  const int lane = static_cast<int>(threadIdx.x) % kLanes;
  const int warp = static_cast<int>(threadIdx.x) / kLanes;
  const long long h = static_cast<long long>(blockIdx.x) * (blockDim.x / kLanes) + warp;
  if (h >= q.n_hyp) return;                // the whole warp
  EpnpWarp& s = ws[warp];
  if (degenerate(q, 4, h)) {
    if (lane == 0) nan_pose(s.Rf, s.tf);
    __syncwarp();
  } else {
    epnp_warp(q, s, q.refine ? q.n : 4, h, lane);
  }
  unsigned char* out_inl = q.inliers + h * q.n;
  double cnt_b = 0.0;
  const double cnt = epnp_inliers(q, s, out_inl, lane, cnt_b);
  const bool keep = !q.refine || cnt >= cnt_b;
  if (!keep)
    for (long long i = lane; i < q.n; i += kLanes) out_inl[i] = q.inl_b[i];
  if (lane == 0) {
    for (int k = 0; k < 9; ++k) q.R[9 * h + k] = keep ? s.Rf[k] : q.R_b[k];
    for (int k = 0; k < 3; ++k) q.t[3 * h + k] = keep ? s.tf[k] : q.t_b[k];
    q.counts[h] = static_cast<long long>(keep ? cnt : cnt_b);
  }
}

__global__ void __launch_bounds__(kThreads) horn_kernel(const RansacParams q) {
  __shared__ Shared sh;
  const long long m = q.refine ? q.n : 3;
  if (threadIdx.x == 0) sh.bad = degenerate(q, 3, blockIdx.x);
  __syncthreads();
  if (sh.bad) {
    if (threadIdx.x == 0) {
      nan_pose(sh.Rf, sh.tf);
      sh.sf = nanf("");
    }
    __syncthreads();
  } else {
    horn_block(q, sh, m);
  }
  unsigned char* out_inl = q.inliers + blockIdx.x * q.n;
  double cnt_b = 0.0;
  const double cnt = horn_inliers(q, sh, out_inl, cnt_b);
  finish(q, sh, cnt, cnt_b, out_inl);
}

}  // namespace

// ---- launch

extern "C" int airdos_ransac_epnp(const RansacParams* params, void* stream) {
  const RansacParams& q = *params;
  if (q.n <= 0 || q.n_hyp <= 0) return static_cast<int>(cudaGetLastError());
  const long long per_block = q.refine ? 1 : kHypsPerBlock;
  const unsigned blocks = static_cast<unsigned>((q.n_hyp + per_block - 1) / per_block);
  epnp_kernel<<<blocks, static_cast<unsigned>(32 * per_block), 0,
                static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int airdos_ransac_horn(const RansacParams* params, void* stream) {
  const RansacParams& q = *params;
  if (q.n <= 0 || q.n_hyp <= 0) return static_cast<int>(cudaGetLastError());
  horn_kernel<<<static_cast<unsigned>(q.n_hyp), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}
