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
// - warp_jacobi_eigh<N>: jacobi_eigh's decomposition (N even) by the lanes
//   of a warp together, in a parallel order: each step rotates N / 2
//   disjoint pairs (p, q) of a round-robin tournament, N - 1 steps a
//   sweep, every pair once.  N / 2 lanes compute the step's rotations,
//   then the lanes share its updates of A (a 2 x 2 block of a pair of
//   pairs each, the lower block mirrored, so A stays exactly symmetric)
//   and of V.  The rules are jacobi_eigh's: the off-diagonal checked
//   before each sweep, Numerical Recipes' zeroing from the fifth sweep,
//   at most kMaxSweeps sweeps, eigenvalues ascending with the lower column
//   first on ties, NaN for a non-finite matrix; each rotation is
//   jacobi_eigh's, from a hypot, a division and a reciprocal square root
//   (jacobi_rotation).  The order is the algorithm and the lanes
//   only share it out: a warp of one lane (a host build, kLanes 1) takes
//   the same steps.  A, V, w and the step's rotations live in shared
//   memory, one set a warp.
// - warp_sum: a double summed over the lanes of a warp in a fixed tree,
//   the total on every lane.
//
// Every function here is plain C++ on doubles; the block and warp
// functions need their block's or warp's threads together.

#pragma once

#include <cmath>

#ifndef AIRDOS_LANES
#define AIRDOS_LANES 32
#endif

namespace small {

constexpr int kMaxSweeps = 50;
constexpr int kLanes = AIRDOS_LANES;   // a warp's lanes (1 in a host build)

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

// the rotation (c, s) that zeroes A[p][q] in sweep `sweep`: jacobi_eigh's
// rotation (the smaller angle, t = s / c = sign(h) 2 apq / (|h| + r), h =
// aqq - app, r = hypot(h, 2 apq), which neither overflows nor underflows;
// t = apq / h where apq is too small to change h) from a hypot, a
// division and a reciprocal square root, c = rsqrt(1 + t^2), where
// jacobi_eigh's formulas take three divisions and two square roots; none
// (1, 0) where A[p][q] is zero or, from the fifth sweep, too small to
// change either diagonal entry (then zeroed by the caller), as there
__device__ __forceinline__ void jacobi_rotation(double app, double aqq,
                                                double apq, int sweep,
                                                double& c, double& s) {
  const double g = 100.0 * fabs(apq);
  c = 1.0;
  s = 0.0;
  if ((sweep > 3 && fabs(app) + g == fabs(app) && fabs(aqq) + g == fabs(aqq)) ||
      apq == 0.0)
    return;
  const double h = aqq - app;
  double t;
  if (fabs(h) + g == fabs(h)) {
    t = apq / h;
  } else {
    const double a2 = apq + apq;
    t = (h < 0.0 ? -a2 : a2) / (fabs(h) + hypot(h, a2));
  }
  c = rsqrt(1.0 + t * t);
  s = t * c;
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

// a double over the kLanes lanes of a warp: lane + 16, + 8, ..., + 1 onto
// lane 0, then lane 0's total to every lane.  Where only the first `span`
// lanes (a power of two) can hold anything but +0, the steps from lanes
// past them are left out: the same sums.
__device__ __forceinline__ double warp_sum(double v, int span = kLanes) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    if (off < span) v += __shfl_down_sync(kFullMask, v, off);
  return __shfl_sync(kFullMask, v, 0);
}

// pair P of step r of the round-robin tournament of N (even) indices:
// (r, N - 1) and (r + P, r - P) mod N - 1, the lower index first
__device__ __forceinline__ void round_robin(int N, int r, int P, int& p, int& q) {
  int a = r, b = N - 1;
  if (P > 0) {
    a = r + P;
    if (a >= N - 1) a -= N - 1;
    b = r - P;
    if (b < 0) b += N - 1;
  }
  p = a < b ? a : b;
  q = a < b ? b : a;
}

// block it of the (N / 2) (N / 2 + 1) / 2 pairs of pairs P <= Q
template <int H>
__device__ __forceinline__ void pair_of_pairs(int it, int& P, int& Q) {
  P = 0;
  while (it >= H - P) {
    it -= H - P;
    ++P;
  }
  Q = P + it;
}

// jacobi_eigh on the warp's lanes (see the header); A is destroyed.  Call
// with every lane of the warp; returns the sweeps taken on every lane.
// Each lane's share of a step is fixed for the whole solve: item it
// (lane, lane + kLanes, ...) is block it of A (a pair of pairs P <= Q)
// and row it / G of V with a run of N / 2 / G pairs; a lane loads all of
// its item, then computes and stores it, so that its loads' latencies
// overlap.
template <int N>
__device__ int warp_jacobi_eigh(double (&A)[N][N], double (&V)[N][N],
                                double (&w)[N], double (&rot)[2][N / 2],
                                int lane) {
  static_assert(N % 2 == 0, "a round-robin order needs an even N");
  constexpr int H = N / 2, NB = H * (H + 1) / 2, W = kLanes;
  constexpr int G = W / N < 1 ? 1 : W / N < H ? W / N : H;   // runs a row
  constexpr int RUN = (H + G - 1) / G;                        // pairs a run
  constexpr int ITEMS = NB > N * G ? NB : N * G;
  constexpr int KI = (ITEMS + W - 1) / W;                     // items a lane
  bool bad = false;
  for (int e = lane; e < N * N; e += W) bad = bad || !isfinite(A[e / N][e % N]);
  if (__any_sync(kFullMask, bad)) {
    for (int e = lane; e < N * N; e += W) V[e / N][e % N] = qnan();
    for (int i = lane; i < N; i += W) w[i] = qnan();
    __syncwarp();
    return 0;
  }
  for (int e = lane; e < N * N; e += W) V[e / N][e % N] = e / N == e % N ? 1.0 : 0.0;
  int bP[KI], bQ[KI];                      // the lane's blocks, fixed
#pragma unroll
  for (int n = 0; n < KI; ++n) pair_of_pairs<H>(lane + n * W < NB ? lane + n * W : 0, bP[n], bQ[n]);
  __syncwarp();
  int sweep = 0;
  for (; sweep < kMaxSweeps; ++sweep) {   // a sweep
    bool off = false;                      // a nonzero above the diagonal
    for (int e = lane; e < N * N; e += W)
      off = off || (e / N < e % N && A[e / N][e % N] != 0.0);
    if (!__any_sync(kFullMask, off)) break;
    for (int r = 0; r < N - 1; ++r) {   // a step
      for (int P = lane; P < H; P += W) {  // the step's rotations
        int p, q;
        round_robin(N, r, P, p, q);
        double c, s;
        jacobi_rotation(A[p][p], A[q][q], A[p][q], sweep, c, s);
        rot[0][P] = c;
        rot[1][P] = s;
      }
      __syncwarp();
#pragma unroll
      for (int n = 0; n < KI; ++n) {
        const int it = lane + n * W;
        const bool blk = it < NB, run = it < N * G;
        // the block's loads: J_P^T A_PQ J_Q
        const int P = bP[n], Q = bQ[n];
        int p1, q1, p2, q2;
        round_robin(N, r, P, p1, q1);
        round_robin(N, r, Q, p2, q2);
        double c1 = 1.0, s1 = 0.0, c2 = 1.0, s2 = 0.0;
        double a = 0.0, b = 0.0, cc = 0.0, d = 0.0;
        if (blk) {
          c1 = rot[0][P], s1 = rot[1][P], c2 = rot[0][Q], s2 = rot[1][Q];
          a = A[p1][p2], b = A[p1][q2], cc = A[q1][p2], d = A[q1][q2];
        }
        // the run's loads: V J on row k, pairs P0 ...
        const int k = run ? it / G : 0, P0 = run ? it % G * RUN : 0;
        double vp[RUN], vq[RUN], cs[RUN], sn[RUN];
        int pp[RUN], qq[RUN];
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          const bool on = run && P0 + j < H;
          round_robin(N, r, on ? P0 + j : 0, pp[j], qq[j]);
          cs[j] = on ? rot[0][P0 + j] : 1.0;
          sn[j] = on ? rot[1][P0 + j] : 0.0;
          vp[j] = on ? V[k][pp[j]] : 0.0;
          vq[j] = on ? V[k][qq[j]] : 0.0;
        }
        if (blk && P == Q) {               // the pair's own block
          if (s1 != 0.0) {
            const double x0 = c1 * a - s1 * b, x1 = s1 * a + c1 * b;    // A J
            const double y0 = c1 * cc - s1 * d, y1 = s1 * cc + c1 * d;
            A[p1][p1] = c1 * x0 - s1 * y0;                               // J^T
            A[q1][q1] = s1 * x1 + c1 * y1;
          }
          A[p1][q1] = A[q1][p1] = 0.0;     // rotated, zeroed or zero
        } else if (blk && (s1 != 0.0 || s2 != 0.0)) {
          const double x0 = c2 * a - s2 * b, x1 = s2 * a + c2 * b;       // A J
          const double y0 = c2 * cc - s2 * d, y1 = s2 * cc + c2 * d;
          const double npp = c1 * x0 - s1 * y0, nqp = s1 * x0 + c1 * y0;  // J^T
          const double npq = c1 * x1 - s1 * y1, nqq = s1 * x1 + c1 * y1;
          A[p1][p2] = A[p2][p1] = npp;
          A[q1][p2] = A[p2][q1] = nqp;
          A[p1][q2] = A[q2][p1] = npq;
          A[q1][q2] = A[q2][q1] = nqq;
        }
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          if (sn[j] == 0.0) continue;      // off the run, or no rotation
          V[k][pp[j]] = cs[j] * vp[j] - sn[j] * vq[j];
          V[k][qq[j]] = sn[j] * vp[j] + cs[j] * vq[j];
        }
      }
      __syncwarp();
    }
  }
  // ascending, the lower column first on ties: each eigenvalue's rank,
  // then V's columns by rank through A
  constexpr int kMine = (N + W - 1) / W;
  int rank[kMine];
  double val[kMine];
#pragma unroll
  for (int n = 0; n < kMine; ++n) {
    const int j = lane + n * W;
    if (j >= N) continue;
    const double dj = A[j][j];
    int r = 0;
    for (int i = 0; i < N; ++i) r += A[i][i] < dj || (A[i][i] == dj && i < j);
    rank[n] = r;
    val[n] = dj;
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < kMine; ++n) {
    const int j = lane + n * W;
    if (j >= N) continue;
    w[rank[n]] = val[n];
    for (int k = 0; k < N; ++k) A[k][rank[n]] = V[k][j];
  }
  __syncwarp();
  for (int e = lane; e < N * N; e += W) V[e / N][e % N] = A[e / N][e % N];
  __syncwarp();
  return sweep;
}

}  // namespace small
