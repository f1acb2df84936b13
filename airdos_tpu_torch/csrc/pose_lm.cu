// Pose-only Levenberg-Marquardt (motion-only bundle adjustment) in one
// launch a call, for sm_90a.
//
// Replaces airdos_tpu/solvers/pose_opt.py:88 pose_optimize, whose 4 rounds
// of a lax.fori_loop of 10 LM iterations (:195) stay on the TPU inside one
// jit.  The port's plain version (solvers/pose_opt.py pose_optimize_ref)
// runs the same arithmetic as eager torch: thousands of small launches a
// call, ~100 ms of host time.  Here the whole protocol is one block:
//
// - the edges (xw, obs, inv_sigma2, valid: 32 bytes each, packed by the
//   wrapper) are strided over the block's threads, edge i always on
//   thread i % kThreads, and read through the read-only cache on every
//   pass (2048 edges are 64 KB: they stay in L1);
// - a pass over the edges accumulates, per thread and in edge order,
//   H's 21 upper-triangle terms, -b's 6, the robust cost and the count of
//   active edges in registers; the block then sums them in a fixed order
//   (a shuffle-down tree in each warp, then the warps in index order).  No
//   atomics: two launches on the same inputs are bit-equal;
// - thread 0 alone adds the SE3 prior (se3_log of the pose composed with
//   the inverse of the initial pose, with geometry/se3.py's small-angle
//   and near-pi branches), sets the trace-scaled damping floor, inverts
//   the damped 6x6 system by 3x3 Schur blocks (solvers/smallmat.py
//   inv6x6, the closed form the floor was tuned to), applies se3_exp,
//   composes and accepts or rejects the step; H and b are carried from the
//   accepted iteration, as the plain loop carries them;
// - Huber applies in rounds 0-1; between rounds a pass reclassifies the
//   edges (chi2 <= 5.991 mono / 7.815 stereo, depth > 0).  Per-edge flags
//   live in shared memory (one byte an edge).
// The host reads nothing during the call; the wrapper returns views of
// the output buffer.
//
// What bounds it on an H100.  Not the card's rates: 44 passes over 2048
// edges are ~20 MFLOP (0.3 us at the float32 peak) and 60 KB of input.
// The bound is the chain: 44 dependent steps, each a pass (a few edges a
// thread), a block reduction (two barriers) and a serial 6x6 solve with
// transcendentals on one thread, a few microseconds each.  The design
// keeps everything on chip and pays that chain once per call instead of a
// host launch per operation; spreading the solve over a cluster is later
// work.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSys = 28;           // 21 terms of H, 6 of -b, the cost
constexpr int kRed = kSys + 1;     // and the count of active edges
constexpr int kRounds = 4;
constexpr int kIters = 10;
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;

// per-edge flags
constexpr uint8_t kValid = 1;
constexpr uint8_t kDepthOk = 2;
constexpr uint8_t kInlier = 4;

struct Cam {
  float fx, fy, cx, cy, bf, delta_mono, delta_stereo, w_rot, w_trans;
};

// What thread 0 carries between passes (shared memory).
struct LmState {
  float R[9], t[3];     // the current pose
  float Rc[9], tc[3];   // the pose the block evaluates next
  float H[36], b[6], f; // the system and cost at the current pose
  float lam;
  float Ri0[9], ti0[3]; // the inverse of the initial pose (the prior)
  int work;             // active edges summed over the build passes
};

struct Edge {
  float x, y, z;        // world point
  float u, v, ur;       // observation; ur < 0: mono
  float inv_sigma2;
  bool valid;
};

__device__ __forceinline__ Edge load_edge(const float4* __restrict__ edges,
                                          int i) {
  const float4 a = __ldg(edges + 2 * i);
  const float4 b = __ldg(edges + 2 * i + 1);
  return Edge{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w > 0.0f};
}

// e = obs - h(R xw + t) with the mono third row zeroed, and the camera z.
// With jac, also J = de/dxi [3][6] (xi = [upsilon, omega], left update).
template <bool kJac>
__device__ __forceinline__ void residual(const float* R, const float* t,
                                         const Edge& ed, bool stereo,
                                         const Cam& c, float e[3],
                                         float J[3][6], float& zc) {
  const float x = R[0] * ed.x + R[1] * ed.y + R[2] * ed.z + t[0];
  const float y = R[3] * ed.x + R[4] * ed.y + R[5] * ed.z + t[1];
  const float z = R[6] * ed.x + R[7] * ed.y + R[8] * ed.z + t[2];
  zc = z;
  const float zs = fabsf(z) < 1e-6f ? 1e-6f : z;
  const float iz = 1.0f / zs;
  const float iz2 = iz * iz;
  const float u = c.fx * x * iz + c.cx;
  const float v = c.fy * y * iz + c.cy;
  e[0] = ed.u - u;
  e[1] = ed.v - v;
  e[2] = stereo ? ed.ur - (u - c.bf * iz) : 0.0f;
  if (!kJac) return;
  // J = -(d pred / d xc) [I | -hat(xc)]
  const float a0 = c.fx * iz;
  const float c0 = -c.fx * x * iz2;
  const float b1 = c.fy * iz;
  const float c1 = -c.fy * y * iz2;
  const float c2 = (-c.fx * x + c.bf) * iz2;
  J[0][0] = -a0;  J[0][1] = 0.0f;  J[0][2] = -c0;
  J[0][3] = -(c0 * y);  J[0][4] = -(a0 * z - c0 * x);  J[0][5] = a0 * y;
  J[1][0] = 0.0f;  J[1][1] = -b1;  J[1][2] = -c1;
  J[1][3] = -(c1 * y - b1 * z);  J[1][4] = c1 * x;  J[1][5] = -(b1 * x);
  if (stereo) {
    J[2][0] = -a0;  J[2][1] = 0.0f;  J[2][2] = -c2;
    J[2][3] = -(c2 * y);  J[2][4] = -(a0 * z - c2 * x);  J[2][5] = a0 * y;
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) J[2][k] = 0.0f;
  }
}

// Sums v[0..K) over the block in a fixed order; the sums land in tot[].
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red,
                                          float* tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    v[k] = x;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[w * K + threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// One pass building the normal equations at (R, t) over the active edges
// (inlier, valid, in front of the camera at the round's start).
__device__ void build_pass(const float4* __restrict__ edges, int n,
                           const uint8_t* state, const float* Rs,
                           const float* ts, const Cam& c, bool huber,
                           float* red, float* tot) {
  float R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = Rs[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = ts[k];
  float acc[kRed];
#pragma unroll
  for (int k = 0; k < kRed; ++k) acc[k] = 0.0f;
  constexpr uint8_t kActive = kValid | kDepthOk | kInlier;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if ((state[i] & kActive) != kActive) continue;
    const Edge ed = load_edge(edges, i);
    const bool stereo = ed.ur >= 0.0f;
    float e[3], J[3][6], z;
    residual<true>(R, t, ed, stereo, c, e, J, z);
    const float chi2 = (e[0] * e[0] + e[1] * e[1] + e[2] * e[2]) * ed.inv_sigma2;
    float wh = 1.0f, rho = chi2;
    if (huber) {
      const float delta = stereo ? c.delta_stereo : c.delta_mono;
      const float sq = sqrtf(fmaxf(chi2, 1e-12f));
      if (sq > delta) {
        wh = delta / sq;
        rho = 2.0f * delta * sq - delta * delta;
      }
    }
    if (!isfinite(rho)) rho = 1e30f;
    const float w = ed.inv_sigma2 * wh;
    float wJ[3][6];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int k = 0; k < 6; ++k) wJ[r][k] = J[r][k] * w;
    int idx = 0;
#pragma unroll
    for (int k = 0; k < 6; ++k)
#pragma unroll
      for (int j = k; j < 6; ++j)
        acc[idx++] += wJ[0][k] * J[0][j] + wJ[1][k] * J[1][j] +
                      wJ[2][k] * J[2][j];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      acc[21 + k] += wJ[0][k] * e[0] + wJ[1][k] * e[1] + wJ[2][k] * e[2];
    acc[27] += rho;
    acc[28] += 1.0f;
  }
  block_sum<kRed>(acc, red, tot);
}

// The reclassification pass at (R, t): depth_ok = z > 0 and, with
// reclassify, inlier = valid & chi2 <= th & depth_ok.  With last, the
// inlier flags are written out and counted into *count (thread 0).
__device__ void classify_pass(const float4* __restrict__ edges, int n,
                              uint8_t* state, const float* Rs,
                              const float* ts, const Cam& c, bool reclassify,
                              bool last, uint8_t* __restrict__ inlier_out,
                              int* red_i, int* count) {
  float R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = Rs[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = ts[k];
  int n_in = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const Edge ed = load_edge(edges, i);
    const bool stereo = ed.ur >= 0.0f;
    float e[3], z;
    residual<false>(R, t, ed, stereo, c, e, nullptr, z);
    uint8_t st = state[i] & kValid;
    if (z > 0.0f) st |= kDepthOk;
    if (reclassify) {
      const float chi2 =
          (e[0] * e[0] + e[1] * e[1] + e[2] * e[2]) * ed.inv_sigma2;
      const float th = stereo ? kChi2Stereo : kChi2Mono;
      if ((st & kValid) && (st & kDepthOk) && chi2 <= th) st |= kInlier;
    } else if (st & kValid) {
      st |= kInlier;
    }
    state[i] = st;
    if (last) {
      const bool in = (st & kInlier) != 0;
      inlier_out[i] = in ? 1 : 0;
      n_in += in ? 1 : 0;
    }
  }
  if (last) {
    n_in = __reduce_add_sync(0xffffffffu, n_in);
    if ((threadIdx.x & 31) == 0) red_i[threadIdx.x >> 5] = n_in;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += red_i[w];
    *count = s;
  }
}

// ------------------------------------------------ serial math (thread 0)

__device__ void matmul3(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                     A[3 * i + 2] * B[6 + j];
}

__device__ void matvec3(const float* A, const float* x, float* y) {
  for (int i = 0; i < 3; ++i)
    y[i] = A[3 * i] * x[0] + A[3 * i + 1] * x[1] + A[3 * i + 2] * x[2];
}

__device__ void hat(const float* w, float* W) {
  W[0] = 0.0f;  W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0.0f;  W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0.0f;
}

// I + a W + b W^2
__device__ void i_plus(const float* W, float a, float b, float* out) {
  float W2[9];
  matmul3(W, W, W2);
  for (int k = 0; k < 9; ++k)
    out[k] = ((k % 4 == 0) ? 1.0f : 0.0f) + a * W[k] + b * W2[k];
}

// geometry/se3.py se3_exp: (R, t) of the tangent [upsilon, omega].
__device__ void se3_exp(const float* xi, float* R, float* t) {
  const float* w = xi + 3;
  const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float theta = sqrtf(theta2 + 1e-16f);
  const bool small = theta2 < 1e-8f;
  const float s = sinf(theta), c = cosf(theta);
  const float a = small ? 1.0f - theta2 / 6.0f : s / theta;
  const float b = small ? 0.5f - theta2 / 24.0f : (1.0f - c) / (theta2 + 1e-16f);
  const float cj = small ? 1.0f / 6.0f - theta2 / 120.0f
                         : (theta - s) / (theta2 * theta + 1e-8f);
  float W[9], V[9];
  hat(w, W);
  i_plus(W, a, b, R);
  i_plus(W, b, cj, V);
  matvec3(V, xi, t);
}

// geometry/se3.py so3_log, with its small-angle and near-pi branches.
__device__ void so3_log(const float* R, float* w) {
  const float trace = R[0] + R[4] + R[8];
  const float cos_t = fminf(fmaxf((trace - 1.0f) * 0.5f, -1.0f), 1.0f);
  const float v[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};
  const float vv = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  const float sin_t_n = 0.5f * sqrtf(fmaxf(vv, 1e-12f));
  const float theta = atan2f(sin_t_n, cos_t);
  const float sin_t = sinf(theta);
  const bool small = fabsf(sin_t) < 1e-6f;
  if (!(cos_t < -0.999f)) {
    const float scale = small ? 0.5f + theta * theta / 12.0f
                              : theta / (2.0f * sin_t);
    for (int k = 0; k < 3; ++k) w[k] = scale * v[k];
    return;
  }
  // near theta = pi: the axis from the symmetric part's diagonal
  float axis[3], sign[3];
  const float den = fmaxf(1.0f - cos_t, 1e-12f);
  for (int k = 0; k < 3; ++k) {
    const float sq = fmaxf((R[4 * k] - cos_t) / den, 0.0f);
    axis[k] = sqrtf(fmaxf(sq, 1e-12f));
    sign[k] = v[k] >= 0.0f ? 1.0f : -1.0f;
  }
  int kmax = 0;
  for (int k = 1; k < 3; ++k)
    if (axis[k] > axis[kmax]) kmax = k;
  float nrm2 = 0.0f;
  for (int k = 0; k < 3; ++k) {
    axis[k] = axis[k] * sign[k] * sign[kmax];
    nrm2 += axis[k] * axis[k];
  }
  const float nrm = fmaxf(sqrtf(nrm2), 1e-12f);
  for (int k = 0; k < 3; ++k) w[k] = axis[k] / nrm * theta;
}

// geometry/se3.py se3_log: [J_l(w)^-1 t, w].
__device__ void se3_log(const float* R, const float* t, float* xi) {
  float* w = xi + 3;
  so3_log(R, w);
  const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float theta = sqrtf(theta2 + 1e-16f);
  const bool small = theta2 < 1e-8f;
  const float half = 0.5f * theta;
  const float sin_h = small ? 1.0f : sinf(half);
  const float cot = small ? 1.0f / 12.0f + theta2 / 720.0f
                          : (1.0f - half * cosf(half) / sin_h) /
                                (theta2 + 1e-16f);
  float W[9], Jinv[9];
  hat(w, W);
  i_plus(W, -0.5f, cot, Jinv);
  matvec3(Jinv, t, xi);
}

// solvers/smallmat.py inv3x3: adjugate over the determinant.
__device__ void inv3x3(const float* M, float* out) {
  const float a = M[0], b = M[1], c = M[2];
  const float d = M[3], e = M[4], f = M[5];
  const float g = M[6], h = M[7], i = M[8];
  const float A = e * i - f * h, B = -(d * i - f * g), C = d * h - e * g;
  const float D = -(b * i - c * h), E = a * i - c * g, F = -(a * h - b * g);
  const float G = b * f - c * e, H = -(a * f - c * d), I = a * e - b * d;
  const float inv_det = 1.0f / (a * A + b * B + c * C);
  const float adj[9] = {A, D, G, B, E, H, C, F, I};
  for (int k = 0; k < 9; ++k) out[k] = adj[k] * inv_det;
}

// solvers/smallmat.py inv6x6 (3x3 Schur blocks) of M [6][6], then M^-1 b.
__device__ void solve6(const float* M, const float* b, float* x) {
  float A[9], B[9], C[9], D[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      A[3 * i + j] = M[6 * i + j];
      B[3 * i + j] = M[6 * i + 3 + j];
      C[3 * i + j] = M[6 * (3 + i) + j];
      D[3 * i + j] = M[6 * (3 + i) + 3 + j];
    }
  float Ai[9], CAi[9], CAiB[9], S[9], Si[9], AiB[9], AiBSi[9], TL[9];
  inv3x3(A, Ai);
  matmul3(C, Ai, CAi);
  matmul3(CAi, B, CAiB);
  for (int k = 0; k < 9; ++k) S[k] = D[k] - CAiB[k];
  inv3x3(S, Si);
  matmul3(Ai, B, AiB);
  matmul3(AiB, Si, AiBSi);
  matmul3(AiBSi, CAi, TL);
  float inv[36];
  float SiCAi[9];
  matmul3(Si, CAi, SiCAi);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      inv[6 * i + j] = Ai[3 * i + j] + TL[3 * i + j];
      inv[6 * i + 3 + j] = -AiBSi[3 * i + j];
      inv[6 * (3 + i) + j] = -SiCAi[3 * i + j];
      inv[6 * (3 + i) + 3 + j] = Si[3 * i + j];
    }
  for (int i = 0; i < 6; ++i) {
    float s = 0.0f;
    for (int j = 0; j < 6; ++j) s += inv[6 * i + j] * b[j];
    x[i] = s;
  }
}

// The block's sums at the pose (R, t) as the system H [36], b [6] and
// cost, with the prior added when it is on.
__device__ void finish_system(const float* tot, const float* R,
                              const float* t, const LmState& s, const Cam& c,
                              float* H, float* b, float* f) {
  int idx = 0;
  for (int k = 0; k < 6; ++k)
    for (int j = k; j < 6; ++j) {
      H[6 * k + j] = tot[idx];
      H[6 * j + k] = tot[idx];
      ++idx;
    }
  for (int k = 0; k < 6; ++k) b[k] = -tot[21 + k];
  *f = tot[27];
  if (c.w_rot > 0.0f || c.w_trans > 0.0f) {
    float Rrel[9], trel[3], ep[6];
    matmul3(R, s.Ri0, Rrel);
    matvec3(R, s.ti0, trel);
    for (int k = 0; k < 3; ++k) trel[k] += t[k];
    se3_log(Rrel, trel, ep);
    float prior = 0.0f;
    for (int k = 0; k < 6; ++k) {
      const float wp = k < 3 ? c.w_trans : c.w_rot;
      H[7 * k] += wp;
      b[k] -= wp * ep[k];
      prior += wp * ep[k] * ep[k];
    }
    *f += prior;
  }
}

// The damped step from the current system, and the candidate pose.
__device__ void propose(LmState& s) {
  float trace = 0.0f;
  for (int k = 0; k < 6; ++k) trace += s.H[7 * k];
  const float floor = 1e-6f * trace / 6.0f + 1e-9f;
  float Hd[36];
  for (int k = 0; k < 36; ++k) Hd[k] = s.H[k];
  for (int k = 0; k < 6; ++k) Hd[7 * k] = s.H[7 * k] + s.lam * s.H[7 * k] + floor;
  float dx[6], dR[9], dt[3];
  solve6(Hd, s.b, dx);
  se3_exp(dx, dR, dt);
  matmul3(dR, s.R, s.Rc);
  matvec3(dR, s.t, s.tc);
  for (int k = 0; k < 3; ++k) s.tc[k] += dt[k];
}

__global__ void __launch_bounds__(kThreads, 1)
pose_lm_kernel(const float* __restrict__ pose0,
               const float4* __restrict__ edges, int n, Cam cam,
               float* __restrict__ out, uint8_t* __restrict__ inlier_out) {
  extern __shared__ uint8_t state[];      // [n] per-edge flags
  __shared__ float red[kWarps * kRed];
  __shared__ float tot[kRed];
  __shared__ int red_i[kWarps];
  __shared__ LmState s;
  const bool lead = threadIdx.x == 0;

  if (lead) {
    for (int k = 0; k < 9; ++k) s.R[k] = s.Rc[k] = pose0[k];
    for (int k = 0; k < 3; ++k) s.t[k] = s.tc[k] = pose0[9 + k];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) s.Ri0[3 * i + j] = s.R[3 * j + i];
    float r[3];
    matvec3(s.Ri0, s.t, r);
    for (int k = 0; k < 3; ++k) s.ti0[k] = -r[k];
    s.work = 0;
  }
  for (int i = threadIdx.x; i < n; i += kThreads)
    state[i] = load_edge(edges, i).valid ? kValid : 0;
  __syncthreads();
  // depth at the initial pose; every valid edge starts as an inlier
  classify_pass(edges, n, state, s.R, s.t, cam, false, false, inlier_out,
                red_i, nullptr);

  for (int rnd = 0; rnd < kRounds; ++rnd) {
    const bool huber = rnd < 2;
    build_pass(edges, n, state, s.R, s.t, cam, huber, red, tot);
    if (lead) {
      finish_system(tot, s.R, s.t, s, cam, s.H, s.b, &s.f);
      s.work += static_cast<int>(tot[kSys]);
      s.lam = 1e-5f;
      propose(s);
    }
    __syncthreads();
    for (int it = 0; it < kIters; ++it) {
      build_pass(edges, n, state, s.Rc, s.tc, cam, huber, red, tot);
      if (lead) {
        float Hn[36], bn[6], fn;
        finish_system(tot, s.Rc, s.tc, s, cam, Hn, bn, &fn);
        s.work += static_cast<int>(tot[kSys]);
        if (fn < s.f) {
          for (int k = 0; k < 9; ++k) s.R[k] = s.Rc[k];
          for (int k = 0; k < 3; ++k) s.t[k] = s.tc[k];
          for (int k = 0; k < 36; ++k) s.H[k] = Hn[k];
          for (int k = 0; k < 6; ++k) s.b[k] = bn[k];
          s.f = fn;
          s.lam *= 0.5f;
        } else {
          s.lam *= 4.0f;
        }
        if (it + 1 < kIters) propose(s);
      }
      __syncthreads();
    }
    classify_pass(edges, n, state, s.R, s.t, cam, true, rnd + 1 == kRounds,
                  inlier_out, red_i, reinterpret_cast<int*>(out) + 12);
  }
  if (lead) {
    for (int k = 0; k < 9; ++k) out[k] = s.R[k];
    for (int k = 0; k < 3; ++k) out[9 + k] = s.t[k];
    reinterpret_cast<int*>(out)[13] = s.work;
  }
}

}  // namespace

// pose0: [12] float32 (R0 row-major, t0); edges: [n, 8] float32 rows
// (xw, u, v, uR, inv_sigma2, valid as 1/0), 16-byte aligned; out: [16]
// float32 (R, t, then as int32: the inlier count and the active edges
// summed over the build passes); inlier: [n] bool.
extern "C" int airdos_pose_lm(const void* pose0, const void* edges, void* out,
                              void* inlier, int n, float fx, float fy,
                              float cx, float cy, float bf, float delta_mono,
                              float delta_stereo, float w_rot, float w_trans,
                              void* stream) {
  const Cam cam{fx, fy, cx, cy, bf, delta_mono, delta_stereo, w_rot, w_trans};
  pose_lm_kernel<<<1, kThreads, n > 0 ? n : 1,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pose0), static_cast<const float4*>(edges), n,
      cam, static_cast<float*>(out), static_cast<uint8_t*>(inlier));
  return static_cast<int>(cudaGetLastError());
}
