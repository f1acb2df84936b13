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
// A block a hypothesis (hypotheses mode: H blocks over sample_idx [H, m])
// or one block over all n points (refine mode, weights inl_b + 1e-6 in
// float32).  The sums over the block's points (the sample's m or all n)
// are fixed-order block sums (small_eig.cuh block_sum); the dense work
// runs in float64 on thread 0 (small_eig.cuh: cyclic Jacobi, Gaussian
// elimination); the pose is rounded once to float32, and the block's
// threads run the inlier test of all n points in float32 and count the
// inliers by a block sum.
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
//   reprojection error of each candidate over the points (a block sum),
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
// 0.8 us at 34 TFLOP/s.  The chain of dependent float64 operations on
// thread 0 (the Jacobi sweeps) is what a launch costs, with the block's
// other threads idle meanwhile: the hypotheses run side by side, one
// block each, so the launch takes one hypothesis's chain.
//
// The C entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "small_eig.cuh"

// the layout of ops/ransac_kernels.py _PARAMS
struct RansacParams {
  long long n;               // points
  long long n_hyp;           // blocks: hypotheses, or 1 in refine mode
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

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSums = 56;

// the block's sums and what thread 0 hands to the other threads
struct Shared {
  double scratch[kMaxSums * kWarps];
  double out[kMaxSums];
  double cps[4][3];          // EPnP: the control points
  double Ainv[4][4];         // EPnP: the barycentric system's inverse
  double Rc[2][3][3];        // EPnP: the two candidates
  double tc[2][3];
  float Rf[9], tf[3], sf;    // the block's pose, rounded
  int bad;                   // a degenerate sample
};

// thread 0's dense work (shared memory: one block's, not one thread's
// local memory on every thread)
struct Dense {
  double A[12][12];
  double V[12][12];
  double w[12];
};

__device__ __forceinline__ double guard(double z) {
  return fabs(z) < 1e-9 ? 1e-9 : z;
}

__device__ __forceinline__ float guardf(float z) {
  return fabsf(z) < 1e-9f ? 1e-9f : z;
}

// point j of the block's set: the sample's j-th index, or j itself
__device__ __forceinline__ long long point_of(const RansacParams& q, int m,
                                              long long j) {
  return q.refine ? j : static_cast<long long>(q.samples[blockIdx.x * m + j]);
}

// the weight of point gi: 1 for a sample, inl_b + 1e-6 (float32) in refine
__device__ __forceinline__ double weight_of(const RansacParams& q,
                                            long long gi) {
  return q.refine ? static_cast<double>((q.inl_b[gi] ? 1.0f : 0.0f) + 1e-6f)
                  : 1.0;
}

// thread 0: does the sample repeat an index or leave [0, n)?
__device__ __forceinline__ bool degenerate(const RansacParams& q, int m) {
  if (q.refine) return false;
  const int* idx = q.samples + blockIdx.x * m;
  for (int i = 0; i < m; ++i) {
    if (idx[i] < 0 || idx[i] >= q.n) return true;
    for (int j = 0; j < i; ++j)
      if (idx[j] == idx[i]) return true;
  }
  return false;
}

__device__ __forceinline__ void round_pose(Shared& sh, const double (&R)[3][3],
                                           const double (&t)[3], double s) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) sh.Rf[3 * i + j] = static_cast<float>(R[i][j]);
    sh.tf[i] = static_cast<float>(t[i]);
  }
  sh.sf = static_cast<float>(s);
}

__device__ __forceinline__ void nan_pose(Shared& sh) {
  const float nan = nanf("");
  for (int i = 0; i < 9; ++i) sh.Rf[i] = nan;
  for (int i = 0; i < 3; ++i) sh.tf[i] = nan;
  sh.sf = nan;
}

// ------------------------------------------------------------------ EPnP

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

// thread 0: from M^T M's sums and the control points, the two candidates'
// R, t into sh.Rc, sh.tc (solvers/epnp.py epnp_pose after _build_M)
__device__ void epnp_candidates(const RansacParams& q, Shared& sh, Dense& d,
                                const double (&sums)[kMaxSums],
                                const double (&cps)[4][3],
                                const double (&c0)[3]) {
  const double fx = q.fx, fy = q.fy;
  // M^T M from the 10 pairs j <= k of 4 sums each
  int pair = 0;
  for (int j = 0; j < 4; ++j)
    for (int k = j; k < 4; ++k, ++pair) {
      const double* S = sums + 4 * pair;
      const double blk[3][3] = {{fx * fx * S[0], 0.0, fx * S[1]},
                                {0.0, fy * fy * S[0], fy * S[2]},
                                {fx * S[1], fy * S[2], S[3]}};
      for (int a = 0; a < 3; ++a)
        for (int c = 0; c < 3; ++c) {
          d.A[3 * j + a][3 * k + c] = blk[a][c];
          d.A[3 * k + c][3 * j + a] = blk[a][c];
        }
    }
  small::jacobi_eigh<12>(d.A, d.V, d.w);
  if (!q.refine || q.n == 4) {
    // a minimal sample: the null space's own basis, the principal axes of
    // diag(1, ..., 12) restricted to it (solvers/epnp.py
    // canonical_null_basis), so that the hypothesis does not depend on
    // which eigenvectors the solver picked in it
    double B[4][4], Q[4][4], ev[4];
    for (int a = 0; a < 4; ++a)
      for (int b = 0; b < 4; ++b) {
        double v = 0.0;
        for (int r = 0; r < 12; ++r) v += d.V[r][a] * (r + 1.0) * d.V[r][b];
        B[a][b] = v;
      }
    small::jacobi_eigh<4>(B, Q, ev);
    for (int r = 0; r < 12; ++r) {
      double row[4];
      for (int b = 0; b < 4; ++b)
        row[b] = d.V[r][0] * Q[0][b] + d.V[r][1] * Q[1][b] + d.V[r][2] * Q[2][b] +
                 d.V[r][3] * Q[3][b];
      for (int b = 0; b < 4; ++b) d.V[r][b] = row[b];
    }
  }
  // the null-space basis: v[k][cp][c] = V[3 cp + c][k], k < 4
  const int pairs[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};
  double G[6][4][4], rho[6];
  for (int p = 0; p < 6; ++p) {
    const int i = pairs[p][0], j = pairs[p][1];
    double dv[4][3];
    for (int k = 0; k < 4; ++k)
      for (int c = 0; c < 3; ++c) dv[k][c] = d.V[3 * i + c][k] - d.V[3 * j + c][k];
    for (int k = 0; k < 4; ++k)
      for (int l = 0; l < 4; ++l)
        G[p][k][l] = dv[k][0] * dv[l][0] + dv[k][1] * dv[l][1] + dv[k][2] * dv[l][2];
    double r = 0.0;
    for (int c = 0; c < 3; ++c) {
      const double e = cps[i][c] - cps[j][c];
      r += e * e;
    }
    rho[p] = r;
  }
  const double* Am = sums + 40;           // sum wn alpha_j
  const double* Bm = sums + 44;           // sum wn (P - c0)_r alpha_j: [r][j]
  for (int cand = 0; cand < 2; ++cand) {
    double num = 0.0, den = 0.0;
    for (int p = 0; p < 6; ++p) {
      num += rho[p] * G[p][cand][cand];
      den += G[p][cand][cand] * G[p][cand][cand];
    }
    double b[4] = {0.0, 0.0, 0.0, 0.0};
    b[cand] = sqrt(num / fmax(den, 1e-12));
    betas_gn(G, rho, b);
    double x[4][3];                       // camera-frame control points
    for (int j = 0; j < 4; ++j)
      for (int c = 0; c < 3; ++c) {
        double v = 0.0;
        for (int k = 0; k < 4; ++k) v += d.V[3 * j + c][k] * b[k];
        x[j][c] = v;
      }
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
      for (int c = 0; c < 3; ++c) sh.Rc[cand][i][c] = R[i][c];
      sh.tc[cand][i] = c1[i] - (R[i][0] * c0[0] + R[i][1] * c0[1] + R[i][2] * c0[2]);
    }
  }
}

// the block's EPnP over its m points, rounded into sh.Rf, sh.tf
__device__ void epnp_block(const RansacParams& q, Shared& sh, Dense& d,
                           long long m) {
  const int tid = threadIdx.x;
  // centroid
  double s4[4] = {0.0, 0.0, 0.0, 0.0};
  for (long long j = tid; j < m; j += blockDim.x) {
    const long long gi = point_of(q, static_cast<int>(m), j);
    const double w = weight_of(q, gi);
    s4[0] += w;
    for (int c = 0; c < 3; ++c) s4[1 + c] += w * q.a[3 * gi + c];
  }
  small::block_sum<4>(s4, sh.scratch, sh.out);
  const double wsum = fmax(s4[0], 1e-12);
  const double c0[3] = {s4[1] / wsum, s4[2] / wsum, s4[3] / wsum};
  // the points' covariance
  double s6[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (long long j = tid; j < m; j += blockDim.x) {
    const long long gi = point_of(q, static_cast<int>(m), j);
    const double wn = weight_of(q, gi) / wsum;
    double e[3];
    for (int c = 0; c < 3; ++c) e[c] = q.a[3 * gi + c] - c0[c];
    s6[0] += wn * e[0] * e[0];
    s6[1] += wn * e[0] * e[1];
    s6[2] += wn * e[0] * e[2];
    s6[3] += wn * e[1] * e[1];
    s6[4] += wn * e[1] * e[2];
    s6[5] += wn * e[2] * e[2];
  }
  small::block_sum<6>(s6, sh.scratch, sh.out);
  // thread 0: control points by PCA and the barycentric system
  if (tid == 0) {
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
    for (int c = 0; c < 3; ++c) sh.cps[0][c] = c0[c];
    for (int i = 0; i < 3; ++i) {
      const double l = sqrt(fmax(lam[2 - i], 1e-12));
      for (int c = 0; c < 3; ++c) sh.cps[1 + i][c] = c0[c] + l * E[c][2 - i];
    }
    double A[4][4], I[4][4];
    for (int r = 0; r < 4; ++r)
      for (int j = 0; j < 4; ++j) {
        A[r][j] = (r < 3 ? sh.cps[j][r] : 1.0) + (r == j ? 1e-9 : 0.0);
        I[r][j] = r == j ? 1.0 : 0.0;
      }
    small::gauss_solve<4, 4>(A, I);
    for (int r = 0; r < 4; ++r)
      for (int j = 0; j < 4; ++j) sh.Ainv[r][j] = I[r][j];
  }
  __syncthreads();
  // M^T M's 40 sums, sum wn alpha (4) and sum wn (P - c0) alpha^T (12)
  double s[kMaxSums];
  for (int k = 0; k < kMaxSums; ++k) s[k] = 0.0;
  for (long long j = tid; j < m; j += blockDim.x) {
    const long long gi = point_of(q, static_cast<int>(m), j);
    const double w = weight_of(q, gi), wn = w / wsum;
    const double P[4] = {q.a[3 * gi], q.a[3 * gi + 1], q.a[3 * gi + 2], 1.0};
    double al[4];
    for (int r = 0; r < 4; ++r)
      al[r] = sh.Ainv[r][0] * P[0] + sh.Ainv[r][1] * P[1] +
              sh.Ainv[r][2] * P[2] + sh.Ainv[r][3] * P[3];
    const double du = static_cast<double>(q.cx) - q.b[2 * gi];
    const double dv = static_cast<double>(q.cy) - q.b[2 * gi + 1];
    const double dd = du * du + dv * dv;
    int pair = 0;
    for (int a = 0; a < 4; ++a)
      for (int c = a; c < 4; ++c, ++pair) {
        const double waa = w * al[a] * al[c];
        s[4 * pair] += waa;
        s[4 * pair + 1] += waa * du;
        s[4 * pair + 2] += waa * dv;
        s[4 * pair + 3] += waa * dd;
      }
    for (int a = 0; a < 4; ++a) {
      s[40 + a] += wn * al[a];
      for (int r = 0; r < 3; ++r) s[44 + 4 * r + a] += wn * (P[r] - c0[r]) * al[a];
    }
  }
  small::block_sum<kMaxSums>(s, sh.scratch, sh.out);
  if (tid == 0) epnp_candidates(q, sh, d, s, sh.cps, c0);
  __syncthreads();
  // each candidate's weighted reprojection error over the points
  double e2[2] = {0.0, 0.0};
  for (long long j = tid; j < m; j += blockDim.x) {
    const long long gi = point_of(q, static_cast<int>(m), j);
    const double w = weight_of(q, gi);
    const double P[3] = {q.a[3 * gi], q.a[3 * gi + 1], q.a[3 * gi + 2]};
    for (int cand = 0; cand < 2; ++cand) {
      double xc[3];
      for (int i = 0; i < 3; ++i)
        xc[i] = sh.Rc[cand][i][0] * P[0] + sh.Rc[cand][i][1] * P[1] +
                sh.Rc[cand][i][2] * P[2] + sh.tc[cand][i];
      const double z = guard(xc[2]);
      const double u = q.fx * xc[0] / z + q.cx - q.b[2 * gi];
      const double v = q.fy * xc[1] / z + q.cy - q.b[2 * gi + 1];
      e2[cand] += w * (u * u + v * v);
    }
  }
  small::block_sum<2>(e2, sh.scratch, sh.out);
  if (tid == 0) {
    const int k = e2[0] <= e2[1] ? 0 : 1;
    double R[3][3], t[3];
    for (int i = 0; i < 3; ++i) {
      for (int c = 0; c < 3; ++c) R[i][c] = sh.Rc[k][i][c];
      t[i] = sh.tc[k][i];
    }
    round_pose(sh, R, t, 1.0);
  }
  __syncthreads();
}

// the inlier test of all n points against the block's pose (float32):
// flags into out_inl, the count returned to every thread (and, in refine
// mode, the count of inl_b as cnt_b)
__device__ double epnp_inliers(const RansacParams& q, Shared& sh,
                               unsigned char* out_inl, double& cnt_b) {
  double cnt[2] = {0.0, 0.0};
  const float* R = sh.Rf;
  const float* t = sh.tf;
  for (long long i = threadIdx.x; i < q.n; i += blockDim.x) {
    const float p0 = q.a[3 * i], p1 = q.a[3 * i + 1], p2 = q.a[3 * i + 2];
    const float x = R[0] * p0 + R[1] * p1 + R[2] * p2 + t[0];
    const float y = R[3] * p0 + R[4] * p1 + R[5] * p2 + t[1];
    const float z = guardf(R[6] * p0 + R[7] * p1 + R[8] * p2 + t[2]);
    const float du = q.fx * x / z + q.cx - q.b[2 * i];
    const float dv = q.fy * y / z + q.cy - q.b[2 * i + 1];
    const float err2 = du * du + dv * dv;
    const bool inl = q.valid[i] && err2 < q.gate1[i] && z > 0.f;
    out_inl[i] = inl;
    cnt[0] += inl ? 1.0 : 0.0;
    if (q.refine) cnt[1] += q.inl_b[i] ? 1.0 : 0.0;
  }
  small::block_sum<2>(cnt, sh.scratch, sh.out);
  cnt_b = cnt[1];
  return cnt[0];
}

// ------------------------------------------------------------------ Horn

__device__ void horn_block(const RansacParams& q, Shared& sh, long long m) {
  const int tid = threadIdx.x;
  double s7[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (long long j = tid; j < m; j += blockDim.x) {
    const long long gi = point_of(q, static_cast<int>(m), j);
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
    const long long gi = point_of(q, static_cast<int>(m), j);
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
    round_pose(sh, R, t, s);
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

// ---------------------------------------------------------- both kernels

// the block's outputs: a hypothesis's, or refine's keep-if-no-worse
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

__global__ void __launch_bounds__(kThreads) epnp_kernel(const RansacParams q) {
  __shared__ Shared sh;
  __shared__ Dense d;
  const long long m = q.refine ? q.n : 4;
  if (threadIdx.x == 0) sh.bad = degenerate(q, 4);
  __syncthreads();
  if (sh.bad) {
    if (threadIdx.x == 0) nan_pose(sh);
    __syncthreads();
  } else {
    epnp_block(q, sh, d, m);
  }
  unsigned char* out_inl = q.inliers + blockIdx.x * q.n;
  double cnt_b = 0.0;
  const double cnt = epnp_inliers(q, sh, out_inl, cnt_b);
  finish(q, sh, cnt, cnt_b, out_inl);
}

__global__ void __launch_bounds__(kThreads) horn_kernel(const RansacParams q) {
  __shared__ Shared sh;
  const long long m = q.refine ? q.n : 3;
  if (threadIdx.x == 0) sh.bad = degenerate(q, 3);
  __syncthreads();
  if (sh.bad) {
    if (threadIdx.x == 0) nan_pose(sh);
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
  epnp_kernel<<<static_cast<unsigned>(q.n_hyp), kThreads, 0,
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
