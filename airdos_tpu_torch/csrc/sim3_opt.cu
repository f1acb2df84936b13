// OptimizeSim3 (loop closing's Sim3 refinement) in one launch a call, for
// sm_90a: one kernel, sim3_opt.
//
// Replaces airdos_tpu/solvers/sim3.py:82 optimize_sim3, two
// lax.fori_loops of Gauss-Newton steps on the TPU (their 7 x 7 systems
// from jax.jacfwd); the port's plain version (ops/sim3_opt_kernels.py
// optimize_sim3_ref) runs each step as ~60-80 eager ops with closed-form
// Jacobians and a torch.linalg.solve, whose CUDA path checks its info on
// the host.  Here the whole schedule is one block of kThreads threads:
//
// - the parameters p = (w, u, sigma) of R = exp(w) R0, t = t0 + u,
//   s = s0 e^sigma live in shared memory; thread 0 turns them into the
//   pose a pass reads (R, t, s, exp(w), R0^T and the left Jacobians
//   J_l(w), J_l(-w), geometry/se3.py's formulas with their small-angle
//   branches);
// - a pass walks the n pairs, pair i always on thread i mod kThreads:
//   both residual families (S12 x2 against obs1, S12^-1 x1 against obs2,
//   the guarded depth of solvers/sim3.py's _safe_z), their closed-form
//   Jacobians [2, 7] (the plain version's, ops/sim3_opt_kernels.py), and
//   the 28 entries of H's upper triangle and the 7 of g weighted by act /
//   sigma^2, or the cost sum (min(chi2, 2 th2) of both families times
//   act); a fixed-order block sum (small_eig.cuh block_sum) adds them;
// - thread 0 pins the scale's row and column with fix_scale, damps H
//   (H + lam diag(H) + 1e-6 I), solves the 7 x 7 by Gaussian elimination
//   with partial pivoting, and after the trial pose's cost pass accepts
//   the step where the cost fell (lam * 0.3) or rejects it (lam * 8); a
//   singular or non-finite step gives a NaN cost, which is rejected, as
//   the plain version's comparison rejects a NaN;
// - the schedule: n_iters // 2 steps over valid, the inlier re-check
//   (both chi2 < th2) whose flags weight n_iters more steps, then the
//   final chi2 and inlier mask.  act lives in the inlier output, each
//   pair's byte written and read by its own thread.
// Everything inside is float64, from the float32 inputs; the outputs (R,
// t, s rounded once, the inlier mask and its count) are written on the
// device, and the host reads nothing during the call.
//
// Where the order differs from the plain version's: the plain version
// computes in float32 and sums H and g by two [2n, 7] matrix products;
// here every sum is float64 in the block sum's order.  So R, t and s agree
// to float32 rounding of a converged solve, and an inlier flag where a
// pair's chi2 is not at th2.
//
// What bounds it on an H100.  Not the card's rates: 3 n_iters / 2 + 2
// passes of ~300 float64 operations a pair (~1.4e6 operations at n 300,
// 0.04 us at 34 TFLOP/s) over 56 bytes a pair (17 KB).  The chain of
// dependent steps is: each a pass, a block sum of 35 values, the 7 x 7
// solve and the trial cost's pass on one SM.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "small_eig.cuh"

// the layout of ops/sim3_opt_kernels.py _PARAMS
struct Sim3OptParams {
  long long n;               // pairs
  long long n_iters;
  long long fix_scale;
  const float* R0;           // [3, 3]
  const float* t0;           // [3]
  const float* s0;           // []
  const float* x1;           // [n, 3] points in camera 1
  const float* obs1;         // [n, 2] their observations in camera 1
  const float* sig1;         // [n] sigma^2
  const float* x2;           // [n, 3] points in camera 2
  const float* obs2;         // [n, 2]
  const float* sig2;         // [n]
  const unsigned char* valid;  // [n]
  float* out;                // [13]: R row-major, t, s
  unsigned char* inliers;    // [n]
  long long* count;          // []
  float fx, fy, cx, cy, th2, unused;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSys = 35;           // H's upper triangle (28) and g (7)
constexpr double kEps = 1e-8;      // geometry/se3.py _EPS

// the pose a pass reads, from parameters p
struct Pose {
  double R[3][3];    // exp(w) R0
  double t[3];
  double s;
  double E[3][3];    // exp(w)
  double R0T[3][3];
  double Jl[3][3];   // J_l(w)
  double Jn[3][3];   // J_l(-w)
};

struct Shared {
  double scratch[kSys * kWarps];
  double out[kSys];
  double p[7], pn[7];
  double lam, f_prev;
  Pose pose;
};

// exp(w) and J_l(w) (geometry/se3.py so3_exp, _so3_left_jacobian)
__device__ void so3_exp_jl(const double (&w)[3], double (&E)[3][3],
                           double (&J)[3][3]) {
  const double theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const double theta = sqrt(theta2 + kEps * kEps);
  const bool small_angle = theta2 < 1e-8;
  const double a = small_angle ? 1.0 - theta2 / 6.0 : sin(theta) / theta;
  const double b = small_angle ? 0.5 - theta2 / 24.0
                               : (1.0 - cos(theta)) / (theta2 + kEps * kEps);
  const double c = small_angle ? 1.0 / 6.0 - theta2 / 120.0
                               : (theta - sin(theta)) / (theta2 * theta + kEps);
  const double W[3][3] = {{0.0, -w[2], w[1]}, {w[2], 0.0, -w[0]}, {-w[1], w[0], 0.0}};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const double w2 = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const double eye = i == j ? 1.0 : 0.0;
      E[i][j] = eye + a * W[i][j] + b * w2;
      J[i][j] = eye + b * W[i][j] + c * w2;
    }
}

// thread 0: the pose of parameters p
__device__ void prepare(const Sim3OptParams& q, const double* p, Pose& ps) {
  const double w[3] = {p[0], p[1], p[2]};
  const double wn[3] = {-p[0], -p[1], -p[2]};
  double En[3][3];
  so3_exp_jl(w, ps.E, ps.Jl);
  so3_exp_jl(wn, En, ps.Jn);
  double R0[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) R0[i][j] = q.R0[3 * i + j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      ps.R[i][j] = ps.E[i][0] * R0[0][j] + ps.E[i][1] * R0[1][j] + ps.E[i][2] * R0[2][j];
      ps.R0T[i][j] = R0[j][i];
    }
  for (int i = 0; i < 3; ++i) ps.t[i] = q.t0[i] + p[3 + i];
  ps.s = static_cast<double>(*q.s0) * exp(p[6]);
}

__device__ __forceinline__ double safe_z(double z) {
  return fabs(z) < 1e-9 ? 1e-9 : z;
}

// the pair's two families at the pose: residuals r [2][2] and, with jac,
// the Jacobians J [2][2][7]
template <bool kJac>
__device__ __forceinline__ void pair_terms(const Sim3OptParams& q,
                                           const Pose& ps, long long i,
                                           double (&r)[2][2],
                                           double (&J)[2][2][7]) {
  const double x1[3] = {q.x1[3 * i], q.x1[3 * i + 1], q.x1[3 * i + 2]};
  const double x2[3] = {q.x2[3 * i], q.x2[3 * i + 1], q.x2[3 * i + 2]};
  double Rx2[3], v[3], p[2][3];
  for (int k = 0; k < 3; ++k) v[k] = x1[k] - ps.t[k];
  for (int k = 0; k < 3; ++k) {
    Rx2[k] = ps.R[k][0] * x2[0] + ps.R[k][1] * x2[1] + ps.R[k][2] * x2[2];
    p[0][k] = ps.s * Rx2[k] + ps.t[k];
    p[1][k] = (ps.R[0][k] * v[0] + ps.R[1][k] * v[1] + ps.R[2][k] * v[2]) / ps.s;
  }
  const float* obs[2] = {q.obs1 + 2 * i, q.obs2 + 2 * i};
  double P[2][2][3];                   // d pi / d p, with the minus of r
  for (int f = 0; f < 2; ++f) {
    const double z = safe_z(p[f][2]);
    r[f][0] = obs[f][0] - (q.fx * p[f][0] / z + q.cx);
    r[f][1] = obs[f][1] - (q.fy * p[f][1] / z + q.cy);
    if (kJac) {
      const double iz = 1.0 / z;
      const double g = fabs(p[f][2]) >= 1e-9 ? 1.0 : 0.0;
      P[f][0][0] = -(q.fx * iz);
      P[f][0][1] = 0.0;
      P[f][0][2] = -(-q.fx * p[f][0] * iz * iz * g);
      P[f][1][0] = 0.0;
      P[f][1][1] = -(q.fy * iz);
      P[f][1][2] = -(-q.fy * p[f][1] * iz * iz * g);
    }
  }
  if (!kJac) return;
  // D1 = [-s [R x2]x J_l(w), I, s R x2]
  // D2 = [R0^T [exp(w)^T v]x J_l(-w) / s, -R^T / s, -p2]
  double D[2][3][7];
  {
    const double a[3] = {Rx2[0], Rx2[1], Rx2[2]};
    const double A[3][3] = {{0.0, -a[2], a[1]}, {a[2], 0.0, -a[0]}, {-a[1], a[0], 0.0}};
    for (int k = 0; k < 3; ++k)
      for (int j = 0; j < 3; ++j) {
        D[0][k][j] = -ps.s * (A[k][0] * ps.Jl[0][j] + A[k][1] * ps.Jl[1][j] +
                              A[k][2] * ps.Jl[2][j]);
        D[0][k][3 + j] = k == j ? 1.0 : 0.0;
      }
    for (int k = 0; k < 3; ++k) D[0][k][6] = ps.s * Rx2[k];
  }
  {
    double a[3];
    for (int k = 0; k < 3; ++k)
      a[k] = ps.E[0][k] * v[0] + ps.E[1][k] * v[1] + ps.E[2][k] * v[2];
    const double A[3][3] = {{0.0, -a[2], a[1]}, {a[2], 0.0, -a[0]}, {-a[1], a[0], 0.0}};
    double AJ[3][3];
    for (int k = 0; k < 3; ++k)
      for (int j = 0; j < 3; ++j)
        AJ[k][j] = A[k][0] * ps.Jn[0][j] + A[k][1] * ps.Jn[1][j] + A[k][2] * ps.Jn[2][j];
    for (int k = 0; k < 3; ++k) {
      for (int j = 0; j < 3; ++j) {
        D[1][k][j] = (ps.R0T[k][0] * AJ[0][j] + ps.R0T[k][1] * AJ[1][j] +
                      ps.R0T[k][2] * AJ[2][j]) / ps.s;
        D[1][k][3 + j] = -ps.R[j][k] / ps.s;
      }
      D[1][k][6] = -p[1][k];
    }
  }
  for (int f = 0; f < 2; ++f)
    for (int row = 0; row < 2; ++row)
      for (int c = 0; c < 7; ++c)
        J[f][row][c] = P[f][row][0] * D[f][0][c] + P[f][row][1] * D[f][1][c] +
                       P[f][row][2] * D[f][2][c];
}

__device__ __forceinline__ void chi2(const Sim3OptParams& q, const Pose& ps,
                                     long long i, double& c1, double& c2) {
  double r[2][2], J[2][2][7];
  pair_terms<false>(q, ps, i, r, J);
  c1 = (r[0][0] * r[0][0] + r[0][1] * r[0][1]) / q.sig1[i];
  c2 = (r[1][0] * r[1][0] + r[1][1] * r[1][1]) / q.sig2[i];
}

// min(c, cap) keeping a NaN, as torch.clamp(max=) does
__device__ __forceinline__ double cap(double c, double hi) {
  return c > hi ? hi : c;
}

// the cost at sh.pose over the pairs with act (the inlier bytes)
__device__ double cost_pass(const Sim3OptParams& q, Shared& sh) {
  double v[1] = {0.0};
  const double hi = 2.0 * static_cast<double>(q.th2);
  for (long long i = threadIdx.x; i < q.n; i += blockDim.x) {
    double c1, c2;
    chi2(q, sh.pose, i, c1, c2);
    v[0] += (cap(c1, hi) + cap(c2, hi)) * (q.inliers[i] ? 1.0 : 0.0);
  }
  small::block_sum<1>(v, sh.scratch, sh.out);
  return v[0];
}

// Gauss-Newton with LM damping from sh.p over the pairs with act
__device__ void gauss_newton(const Sim3OptParams& q, Shared& sh, long long iters) {
  const int tid = threadIdx.x;
  if (tid == 0) prepare(q, sh.p, sh.pose);
  __syncthreads();
  const double f0 = cost_pass(q, sh);
  if (tid == 0) {
    sh.f_prev = f0;
    sh.lam = 1e-4;
  }
  for (long long it = 0; it < iters; ++it) {
    double v[kSys];
    for (int k = 0; k < kSys; ++k) v[k] = 0.0;
    for (long long i = tid; i < q.n; i += blockDim.x) {
      const double act = q.inliers[i] ? 1.0 : 0.0;
      double r[2][2], J[2][2][7];
      pair_terms<true>(q, sh.pose, i, r, J);
      const double wf[2] = {act / q.sig1[i], act / q.sig2[i]};
      int e = 0;
      for (int a = 0; a < 7; ++a)
        for (int b = a; b < 7; ++b, ++e) {
          double h = 0.0;
          for (int f = 0; f < 2; ++f)
            h += wf[f] * (J[f][0][a] * J[f][0][b] + J[f][1][a] * J[f][1][b]);
          v[e] += h;
        }
      for (int a = 0; a < 7; ++a) {
        double g = 0.0;
        for (int f = 0; f < 2; ++f)
          g += wf[f] * (J[f][0][a] * r[f][0] + J[f][1][a] * r[f][1]);
        v[28 + a] -= g;
      }
    }
    small::block_sum<kSys>(v, sh.scratch, sh.out);
    if (tid == 0) {
      double H[7][7], g[7][1];
      int e = 0;
      for (int a = 0; a < 7; ++a)
        for (int b = a; b < 7; ++b, ++e) H[a][b] = H[b][a] = v[e];
      for (int a = 0; a < 7; ++a) g[a][0] = v[28 + a];
      if (q.fix_scale) {
        for (int a = 0; a < 7; ++a) H[6][a] = H[a][6] = 0.0;
        H[6][6] = 1.0;
        g[6][0] = 0.0;
      }
      for (int a = 0; a < 7; ++a) H[a][a] += sh.lam * H[a][a] + 1e-6;
      small::gauss_solve<7, 1>(H, g);
      for (int a = 0; a < 7; ++a) sh.pn[a] = sh.p[a] + g[a][0];
      prepare(q, sh.pn, sh.pose);
    }
    __syncthreads();
    const double f_new = cost_pass(q, sh);
    if (tid == 0) {
      if (f_new < sh.f_prev) {
        for (int a = 0; a < 7; ++a) sh.p[a] = sh.pn[a];
        sh.lam *= 0.3;
        sh.f_prev = f_new;
      } else {
        sh.lam *= 8.0;
      }
      prepare(q, sh.p, sh.pose);
    }
    __syncthreads();
  }
}

// the inlier flags at sh.p (valid, both chi2 < th2) into the inlier
// bytes; returns the count
__device__ double recheck(const Sim3OptParams& q, Shared& sh) {
  if (threadIdx.x == 0) prepare(q, sh.p, sh.pose);
  __syncthreads();
  double v[1] = {0.0};
  for (long long i = threadIdx.x; i < q.n; i += blockDim.x) {
    double c1, c2;
    chi2(q, sh.pose, i, c1, c2);
    const bool inl = q.valid[i] && c1 < q.th2 && c2 < q.th2;
    q.inliers[i] = inl;
    v[0] += inl ? 1.0 : 0.0;
  }
  small::block_sum<1>(v, sh.scratch, sh.out);
  return v[0];
}

__global__ void __launch_bounds__(kThreads) sim3_opt_kernel(const Sim3OptParams q) {
  __shared__ Shared sh;
  for (int a = threadIdx.x; a < 7; a += blockDim.x) sh.p[a] = 0.0;
  for (long long i = threadIdx.x; i < q.n; i += blockDim.x) q.inliers[i] = q.valid[i];
  __syncthreads();
  gauss_newton(q, sh, q.n_iters / 2);
  recheck(q, sh);
  gauss_newton(q, sh, q.n_iters);
  const double count = recheck(q, sh);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) q.out[3 * i + j] = static_cast<float>(sh.pose.R[i][j]);
      q.out[9 + i] = static_cast<float>(sh.pose.t[i]);
    }
    q.out[12] = static_cast<float>(sh.pose.s);
    *q.count = static_cast<long long>(count);
  }
}

}  // namespace

// ---- launch

extern "C" int airdos_sim3_opt(const Sim3OptParams* params, void* stream) {
  const Sim3OptParams& q = *params;
  if (q.n <= 0) return static_cast<int>(cudaGetLastError());
  sim3_opt_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}
