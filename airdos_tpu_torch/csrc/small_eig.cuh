// Small dense linear algebra in float64 on one thread, and a fixed-order
// block sum, for the loop solvers' kernels (csrc/ransac.cu, csrc/sim3_opt.cu).
//
// - jacobi_eigh<N>: the eigen-decomposition of a symmetric N x N matrix by
//   cyclic Jacobi rotations (p < q, row by row, a fixed order), at most
//   kMaxSweeps sweeps, stopping once every off-diagonal entry is zero (an
//   entry too small to change either diagonal entry is set to zero after
//   the fourth sweep, Numerical Recipes' rule).  Eigenvalues ascending,
//   as torch.linalg.eigh and jnp.linalg.eigh sort them; ties keep the
//   lower column.  A non-finite matrix gives NaN eigenvalues and vectors,
//   as solvers/align.py eigh_finite gives them.
// - gauss_solve<N, M>: A X = B by Gaussian elimination with partial
//   pivoting (the first largest pivot); a zero or NaN pivot makes X NaN,
//   as torch.linalg.solve_ex's info and jnp.linalg.solve give it.
// - horn_rotation: the rotation of Horn's closed form from M = sum w q2
//   q1^T (solvers/align.py horn_align): the top eigenvector of the 4 x 4
//   N matrix, as a quaternion (w, x, y, z), normalised, to R
//   (geometry/se3.py quat_to_rot).
// - block_sum<K>: K doubles summed over a block in a fixed order: a tree
//   of shuffles in each warp (lane + 16, + 8, ..., + 1 onto lane 0), then
//   the warps in order on thread 0; every thread gets the totals.  No
//   atomics, so two launches on the same inputs are bit-equal.
//
// Every function here is plain C++ on doubles, and the block sum the only
// one that needs more than one thread.

#pragma once

#include <cmath>

namespace small {

constexpr int kMaxSweeps = 50;

__device__ __forceinline__ double qnan() { return nan(""); }

template <int N>
__device__ void jacobi_eigh(double (&A)[N][N], double (&V)[N][N],
                            double (&w)[N]) {
  bool finite = true;
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) finite = finite && isfinite(A[i][j]);
  if (!finite) {
    for (int i = 0; i < N; ++i) {
      w[i] = qnan();
      for (int j = 0; j < N; ++j) V[i][j] = qnan();
    }
    return;
  }
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) V[i][j] = i == j ? 1.0 : 0.0;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    double off = 0.0;
    for (int p = 0; p < N - 1; ++p)
      for (int q = p + 1; q < N; ++q) off += fabs(A[p][q]);
    if (off == 0.0) break;
    for (int p = 0; p < N - 1; ++p) {
      for (int q = p + 1; q < N; ++q) {
        const double apq = A[p][q];
        const double g = 100.0 * fabs(apq);
        const double app = A[p][p], aqq = A[q][q];
        if (sweep > 3 && fabs(app) + g == fabs(app) &&
            fabs(aqq) + g == fabs(aqq)) {
          A[p][q] = A[q][p] = 0.0;
          continue;
        }
        if (apq == 0.0) continue;
        const double h = aqq - app;
        double t;
        if (fabs(h) + g == fabs(h)) {
          t = apq / h;
        } else {
          const double theta = 0.5 * h / apq;
          t = 1.0 / (fabs(theta) + sqrt(1.0 + theta * theta));
          if (theta < 0.0) t = -t;
        }
        const double c = 1.0 / sqrt(1.0 + t * t), s = t * c;
        for (int k = 0; k < N; ++k) {          // A J
          const double akp = A[k][p], akq = A[k][q];
          A[k][p] = c * akp - s * akq;
          A[k][q] = s * akp + c * akq;
        }
        for (int k = 0; k < N; ++k) {          // J^T (A J)
          const double apk = A[p][k], aqk = A[q][k];
          A[p][k] = c * apk - s * aqk;
          A[q][k] = s * apk + c * aqk;
        }
        A[p][q] = A[q][p] = 0.0;
        for (int k = 0; k < N; ++k) {          // V J
          const double vkp = V[k][p], vkq = V[k][q];
          V[k][p] = c * vkp - s * vkq;
          V[k][q] = s * vkp + c * vkq;
        }
      }
    }
  }
  for (int i = 0; i < N; ++i) w[i] = A[i][i];
  for (int i = 0; i < N - 1; ++i) {            // ascending, first on ties
    int m = i;
    for (int j = i + 1; j < N; ++j)
      if (w[j] < w[m]) m = j;
    if (m != i) {
      const double tw = w[i];
      w[i] = w[m];
      w[m] = tw;
      for (int k = 0; k < N; ++k) {
        const double tv = V[k][i];
        V[k][i] = V[k][m];
        V[k][m] = tv;
      }
    }
  }
}

// A X = B in place (A destroyed, B becomes X); false and X NaN where a
// pivot is zero or NaN
template <int N, int M>
__device__ bool gauss_solve(double (&A)[N][N], double (&B)[N][M]) {
  for (int col = 0; col < N; ++col) {
    int piv = col;
    double best = fabs(A[col][col]);
    for (int r = col + 1; r < N; ++r)
      if (fabs(A[r][col]) > best) {
        best = fabs(A[r][col]);
        piv = r;
      }
    if (!(best > 0.0)) {
      for (int r = 0; r < N; ++r)
        for (int m = 0; m < M; ++m) B[r][m] = qnan();
      return false;
    }
    if (piv != col) {
      for (int k = 0; k < N; ++k) {
        const double ta = A[col][k];
        A[col][k] = A[piv][k];
        A[piv][k] = ta;
      }
      for (int m = 0; m < M; ++m) {
        const double tb = B[col][m];
        B[col][m] = B[piv][m];
        B[piv][m] = tb;
      }
    }
    for (int r = col + 1; r < N; ++r) {
      const double f = A[r][col] / A[col][col];
      for (int k = col + 1; k < N; ++k) A[r][k] -= f * A[col][k];
      for (int m = 0; m < M; ++m) B[r][m] -= f * B[col][m];
    }
  }
  for (int r = N - 1; r >= 0; --r)
    for (int m = 0; m < M; ++m) {
      double v = B[r][m];
      for (int k = r + 1; k < N; ++k) v -= A[r][k] * B[k][m];
      B[r][m] = v / A[r][r];
    }
  return true;
}

// R (row-major) of the unit quaternion (x, y, z, w), geometry/se3.py
// quat_to_rot: q normalised by max(|q|, 1e-12)
__device__ __forceinline__ void quat_to_rot(double x, double y, double z,
                                            double w, double (&R)[3][3]) {
  const double nrm = fmax(sqrt(x * x + y * y + z * z + w * w), 1e-12);
  x /= nrm;
  y /= nrm;
  z /= nrm;
  w /= nrm;
  R[0][0] = 1.0 - 2.0 * (y * y + z * z);
  R[0][1] = 2.0 * (x * y - z * w);
  R[0][2] = 2.0 * (x * z + y * w);
  R[1][0] = 2.0 * (x * y + z * w);
  R[1][1] = 1.0 - 2.0 * (x * x + z * z);
  R[1][2] = 2.0 * (y * z - x * w);
  R[2][0] = 2.0 * (x * z - y * w);
  R[2][1] = 2.0 * (y * z + x * w);
  R[2][2] = 1.0 - 2.0 * (x * x + y * y);
}

// Horn's rotation from M[i][j] = sum w q2_i q1_j (R maps frame 2 into
// frame 1): N's top eigenvector (w, x, y, z) -> R
__device__ __forceinline__ void horn_rotation(const double (&M)[3][3],
                                              double (&R)[3][3]) {
  const double Sxx = M[0][0], Sxy = M[0][1], Sxz = M[0][2];
  const double Syx = M[1][0], Syy = M[1][1], Syz = M[1][2];
  const double Szx = M[2][0], Szy = M[2][1], Szz = M[2][2];
  double N[4][4] = {
      {Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx},
      {Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz},
      {Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy},
      {Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz}};
  double V[4][4], ev[4];
  jacobi_eigh<4>(N, V, ev);
  quat_to_rot(V[1][3], V[2][3], V[3][3], V[0][3], R);
}

constexpr unsigned kFullMask = 0xffffffffu;

// sum each of v's K values over the block (whole warps, at most 32);
// scratch holds K * warps doubles, out K, both shared
template <int K>
__device__ void block_sum(double (&v)[K], double* scratch, double* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(kFullMask, v[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) scratch[warp * K + k] = v[k];
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < K; ++k) {
      double s = 0.0;
      for (int j = 0; j < warps; ++j) s += scratch[j * K + k];
      out[k] = s;
    }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = out[k];
  __syncthreads();        // out and scratch free for the next sum
}

}  // namespace small
