// Pose-only Levenberg-Marquardt (motion-only bundle adjustment) in one
// launch a call, for sm_90a.
//
// Replaces airdos_tpu/solvers/pose_opt.py:88 pose_optimize, whose 4 rounds
// of a lax.fori_loop of 10 LM iterations (:195) stay on the TPU inside one
// jit.  The port's plain version (solvers/pose_opt.py pose_optimize_ref)
// runs the same arithmetic as eager torch: thousands of small launches a
// call, ~100 ms of host time.  Here the whole protocol is one launch of a
// thread block cluster of kCluster blocks of kThreads threads:
//
// - the edges (xw, obs, inv_sigma2, valid: 32 bytes each, packed by the
//   wrapper) are cut into kCluster contiguous ranges, one a block (range
//   b is solvers/pose_opt.py cluster_edges(n, b)), strided over the
//   block's threads, edge i always on the same thread, and read through
//   the read-only cache on every pass (a block's edges stay in its L1);
// - a pass over the edges accumulates, per thread and in edge order,
//   H's 21 upper-triangle terms (the Jacobian's structural zeros left
//   out), -b's 6, the robust cost and the count of active edges in
//   registers; each warp sums its lanes by a transpose butterfly (31
//   shuffles, after which lane k holds the warp's sum of value k), warp 0
//   adds the block's warps in order, and sends lane k's sum to every block
//   of the cluster through distributed shared memory as one 64-bit word:
//   the value and the step's tag.  A reader that sees the tag sees the
//   value, so a step needs no fence and no cluster barrier (whose release
//   sm_90a compiles to a GPU-scope memory barrier), only a poll.  Each
//   block adds the blocks' sums in rank order.  No atomics: two launches
//   on the same inputs are bit-equal;
// - every block's warp 0 then runs the same LM step on the same sums, with
//   its state in registers, so every block holds the same pose and none
//   crosses the cluster: the SE3 prior (se3_log of the pose composed with
//   the inverse of the initial pose, with geometry/se3.py's small-angle
//   and near-pi branches), the trace-scaled damping floor, the damped 6x6
//   system inverted by 3x3 Schur blocks (solvers/smallmat.py inv6x6, the
//   closed form the floor was tuned to), se3_exp, the composition and the
//   accept or reject; H and b are carried from the accepted iteration, as
//   the plain loop carries them.  A block barrier hands the next pose to
//   the block's other warps;
// - Huber applies in rounds 0-1; between rounds a pass reclassifies the
//   edges (chi2 <= 5.991 mono / 7.815 stereo, depth > 0).  Per-edge flags
//   live in the block's shared memory (one byte an edge).
// The host reads nothing during the call; the wrapper returns views of
// the output buffer.
//
// What bounds it on an H100.  Not the card's rates: 44 passes over 2048
// edges are ~20 MFLOP (0.3 us at the float32 peak) and 60 KB of input.
// The bound is the chain of 44 dependent steps.  The earlier design ran
// each on one block of 512 threads, 8,920 cycles a step at N 1536: the
// pass 3,862 (issue-bound on one SM), the block reduction 3,281 (29
// shuffle trees a warp, two barriers, 29 threads adding 16 rows) and
// thread 0's tail 1,776.
// Here a step takes 3,636: the pass on 8 SMs 1,261, the exchange 685, the
// tail 1,541 (the 6x6 solve and se3_exp on one warp: a chain of divisions,
// a square root and a sincos) and the block barrier 147 (clock64() stamps
// of tools/kernel_split.py, PERF.md section 6).  The tail now leads.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;        // blocks; solvers/pose_opt.py CLUSTER
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSys = 28;           // 21 terms of H, 6 of -b, the cost
constexpr uint32_t kMaxSpins = 1u << 26;   // polls of a step's sums
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

// The camera point of an edge at the pose P (R row-major, then t).
struct Proj {
  float x, y, z, iz, u, v;
};

__device__ __forceinline__ Proj project(const float* P, const Edge& ed,
                                        const Cam& c) {
  Proj p;
  p.x = P[0] * ed.x + P[1] * ed.y + P[2] * ed.z + P[9];
  p.y = P[3] * ed.x + P[4] * ed.y + P[5] * ed.z + P[10];
  p.z = P[6] * ed.x + P[7] * ed.y + P[8] * ed.z + P[11];
  const float zs = fabsf(p.z) < 1e-6f ? 1e-6f : p.z;
  p.iz = __frcp_rn(zs);                 // 1 / zs, correctly rounded
  p.u = c.fx * p.x * p.iz + c.cx;
  p.v = c.fy * p.y * p.iz + c.cy;
  return p;
}

// c ? a : b, in a form the compiler cannot turn into an indexed load
// (which would move a register array to local memory).
__device__ __forceinline__ float pick(bool c, float a, float b) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %3, 0;\n\t"
      "selp.f32 %0, %1, %2, p;\n\t}"
      : "=f"(r) : "f"(a), "f"(b), "r"(static_cast<unsigned>(c)));
  return r;
}

// One stage of the transpose butterfly below: a lane keeps half of its
// values and sends the other half to the lane `kHalf` away.  A template, so
// the loop unrolls whole and v stays in registers.
template <int kHalf>
__device__ __forceinline__ void butterfly_stage(float (&v)[32], int lane) {
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const float send = pick(upper, v[k], v[k + kHalf]);
    const float keep = pick(upper, v[k + kHalf], v[k]);
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf);
  }
}

// Sums v[0..32) over the warp's lanes by a transpose butterfly: after
// 16 + 8 + 4 + 2 + 1 shuffles lane k holds the sum of value k.  The order
// of the additions is fixed.
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  butterfly_stage<16>(v, lane);
  butterfly_stage<8>(v, lane);
  butterfly_stage<4>(v, lane);
  butterfly_stage<2>(v, lane);
  butterfly_stage<1>(v, lane);
  return v[0];
}

// One pass building the normal equations at the pose P over the block's
// active edges (inlier, valid, in front of the camera at the round's
// start): the warp's row of 32 sums (H's upper triangle, -b, the cost,
// the count, 3 zeros), lane k holding value k.
__device__ __forceinline__ float build_pass(const float4* __restrict__ edges,
                                            int lo, int hi,
                                            const uint8_t* state,
                                            const float* Ps, const Cam& c,
                                            bool huber) {
  float P[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) P[k] = Ps[k];
  float acc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
  constexpr uint8_t kActive = kValid | kDepthOk | kInlier;
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    if ((state[i - lo] & kActive) != kActive) continue;
    const Edge ed = load_edge(edges, i);
    const bool stereo = ed.ur >= 0.0f;
    const Proj p = project(P, ed, c);
    const float e0 = ed.u - p.u, e1 = ed.v - p.v;
    const float e2 = stereo ? ed.ur - (p.u - c.bf * p.iz) : 0.0f;
    // J = -(d pred / d xc) [I | -hat(xc)]; J[0][1], J[1][0], J[2][1] are 0
    const float iz2 = p.iz * p.iz;
    const float a0 = c.fx * p.iz;
    const float c0 = -c.fx * p.x * iz2;
    const float b1 = c.fy * p.iz;
    const float c1 = -c.fy * p.y * iz2;
    const float c2 = (-c.fx * p.x + c.bf) * iz2;
    const float s2 = stereo ? 1.0f : 0.0f;
    const float J0[6] = {-a0, 0.0f, -c0, -(c0 * p.y),
                         -(a0 * p.z - c0 * p.x), a0 * p.y};
    const float J1[6] = {0.0f, -b1, -c1, -(c1 * p.y - b1 * p.z), c1 * p.x,
                         -(b1 * p.x)};
    const float J2[6] = {-a0 * s2, 0.0f, -c2 * s2, -(c2 * p.y) * s2,
                         -(a0 * p.z - c2 * p.x) * s2, a0 * p.y * s2};
    const float chi2 = (e0 * e0 + e1 * e1 + e2 * e2) * ed.inv_sigma2;
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
    float W0[6], W1[6], W2[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      W0[k] = J0[k] * w;
      W1[k] = J1[k] * w;
      W2[k] = J2[k] * w;
    }
    int idx = 0;
#pragma unroll
    for (int k = 0; k < 6; ++k)
#pragma unroll
      for (int j = k; j < 6; ++j) {
        // the terms whose factors are structural zeros are left out
        float t = 0.0f;
        if (k != 1 && j != 1) t += W0[k] * J0[j];
        if (k != 0 && j != 0) t += W1[k] * J1[j];
        if (k != 1 && j != 1) t += W2[k] * J2[j];
        acc[idx++] += t;
      }
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      float t = 0.0f;
      if (k != 1) t += W0[k] * e0;
      if (k != 0) t += W1[k] * e1;
      if (k != 1) t += W2[k] * e2;
      acc[21 + k] += t;
    }
    acc[27] += rho;
    acc[28] += 1.0f;
  }
  return warp_reduce_scatter(acc);
}

// The reclassification pass at the pose P: depth_ok = z > 0 and, with
// reclassify, inlier = valid & chi2 <= th & depth_ok.  With last, the
// inlier flags are written out; returns the thread's count of inliers.
__device__ __forceinline__ int classify_pass(
    const float4* __restrict__ edges, int lo, int hi, uint8_t* state,
    const float* Ps, const Cam& c, bool reclassify, bool last,
    uint8_t* __restrict__ inlier_out) {
  float P[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) P[k] = Ps[k];
  int n_in = 0;
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    const Edge ed = load_edge(edges, i);
    const bool stereo = ed.ur >= 0.0f;
    const Proj p = project(P, ed, c);
    const float e0 = ed.u - p.u, e1 = ed.v - p.v;
    const float e2 = stereo ? ed.ur - (p.u - c.bf * p.iz) : 0.0f;
    uint8_t st = state[i - lo] & kValid;
    if (p.z > 0.0f) st |= kDepthOk;
    if (reclassify) {
      const float chi2 = (e0 * e0 + e1 * e1 + e2 * e2) * ed.inv_sigma2;
      const float th = stereo ? kChi2Stereo : kChi2Mono;
      if ((st & kValid) && (st & kDepthOk) && chi2 <= th) st |= kInlier;
    } else if (st & kValid) {
      st |= kInlier;
    }
    state[i - lo] = st;
    if (last) {
      const bool in = (st & kInlier) != 0;
      inlier_out[i] = in ? 1 : 0;
      n_in += in ? 1 : 0;
    }
  }
  return n_in;
}

// ---------------------------------- the LM step's math (each block's warp 0)

__device__ __forceinline__ void matmul3(const float* A, const float* B,
                                        float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                     A[3 * i + 2] * B[6 + j];
}

__device__ __forceinline__ void matvec3(const float* A, const float* x,
                                        float* y) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y[i] = A[3 * i] * x[0] + A[3 * i + 1] * x[1] + A[3 * i + 2] * x[2];
}

__device__ __forceinline__ void hat(const float* w, float* W) {
  W[0] = 0.0f;  W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0.0f;  W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0.0f;
}

// I + a W + b W^2
__device__ __forceinline__ void i_plus(const float* W, float a, float b,
                                       float* out) {
  float W2[9];
  matmul3(W, W, W2);
#pragma unroll
  for (int k = 0; k < 9; ++k)
    out[k] = ((k % 4 == 0) ? 1.0f : 0.0f) + a * W[k] + b * W2[k];
}

// geometry/se3.py se3_exp: (R, t) of the tangent [upsilon, omega].
__device__ __forceinline__ void se3_exp(const float* xi, float* R, float* t) {
  const float* w = xi + 3;
  const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float theta = sqrtf(theta2 + 1e-16f);
  const bool small = theta2 < 1e-8f;
  float s, c;
  sincosf(theta, &s, &c);
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
__device__ __forceinline__ void so3_log(const float* R, float* w) {
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
#pragma unroll
    for (int k = 0; k < 3; ++k) w[k] = scale * v[k];
    return;
  }
  // near theta = pi: the axis from the symmetric part's diagonal
  float axis[3], sign[3];
  const float den = fmaxf(1.0f - cos_t, 1e-12f);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float sq = fmaxf((R[4 * k] - cos_t) / den, 0.0f);
    axis[k] = sqrtf(fmaxf(sq, 1e-12f));
    sign[k] = v[k] >= 0.0f ? 1.0f : -1.0f;
  }
  const int kmax = axis[1] > axis[0] ? (axis[2] > axis[1] ? 2 : 1)
                                     : (axis[2] > axis[0] ? 2 : 0);
  const float smax = kmax == 0 ? sign[0] : (kmax == 1 ? sign[1] : sign[2]);
  float nrm2 = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    axis[k] = axis[k] * sign[k] * smax;
    nrm2 += axis[k] * axis[k];
  }
  const float nrm = fmaxf(sqrtf(nrm2), 1e-12f);
#pragma unroll
  for (int k = 0; k < 3; ++k) w[k] = axis[k] / nrm * theta;
}

// geometry/se3.py se3_log: [J_l(w)^-1 t, w].
__device__ __forceinline__ void se3_log(const float* R, const float* t,
                                        float* xi) {
  float* w = xi + 3;
  so3_log(R, w);
  const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float theta = sqrtf(theta2 + 1e-16f);
  const bool small = theta2 < 1e-8f;
  const float half = 0.5f * theta;
  float sin_h = 1.0f, cos_h = 1.0f;
  if (!small) sincosf(half, &sin_h, &cos_h);
  const float cot = small ? 1.0f / 12.0f + theta2 / 720.0f
                          : (1.0f - half * cos_h / sin_h) /
                                (theta2 + 1e-16f);
  float W[9], Jinv[9];
  hat(w, W);
  i_plus(W, -0.5f, cot, Jinv);
  matvec3(Jinv, t, xi);
}

// solvers/smallmat.py inv3x3: adjugate over the determinant.
__device__ __forceinline__ void inv3x3(const float* M, float* out) {
  const float a = M[0], b = M[1], c = M[2];
  const float d = M[3], e = M[4], f = M[5];
  const float g = M[6], h = M[7], i = M[8];
  const float A = e * i - f * h, B = -(d * i - f * g), C = d * h - e * g;
  const float D = -(b * i - c * h), E = a * i - c * g, F = -(a * h - b * g);
  const float G = b * f - c * e, H = -(a * f - c * d), I = a * e - b * d;
  const float inv_det = 1.0f / (a * A + b * B + c * C);
  const float adj[9] = {A, D, G, B, E, H, C, F, I};
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k] = adj[k] * inv_det;
}

// solvers/smallmat.py inv6x6 (3x3 Schur blocks) of M [6][6], then M^-1 b.
__device__ __forceinline__ void solve6(const float* M, const float* b,
                                       float* x) {
  float A[9], B[9], C[9], D[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
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
#pragma unroll
  for (int k = 0; k < 9; ++k) S[k] = D[k] - CAiB[k];
  inv3x3(S, Si);
  matmul3(Ai, B, AiB);
  matmul3(AiB, Si, AiBSi);
  matmul3(AiBSi, CAi, TL);
  float inv[36];
  float SiCAi[9];
  matmul3(Si, CAi, SiCAi);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      inv[6 * i + j] = Ai[3 * i + j] + TL[3 * i + j];
      inv[6 * i + 3 + j] = -AiBSi[3 * i + j];
      inv[6 * (3 + i) + j] = -SiCAi[3 * i + j];
      inv[6 * (3 + i) + 3 + j] = Si[3 * i + j];
    }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) s += inv[6 * i + j] * b[j];
    x[i] = s;
  }
}

// What each block's warp 0 carries between steps, in registers.
struct LmState {
  float P[12];          // the current pose: R row-major, t
  float Pc[12];         // the pose the cluster evaluates next
  float H[36], b[6], f; // the system and cost at the current pose
  float lam;
  float Ri0[9], ti0[3]; // the inverse of the initial pose (the prior)
  int work;             // active edges summed over the build passes
};

// The cluster's sums at the pose P as the system H [36], b [6] and cost,
// with the prior added when it is on.
__device__ __forceinline__ void finish_system(const float* tot,
                                              const float* P,
                                              const LmState& s, const Cam& c,
                                              float* H, float* b, float* f) {
  int idx = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int j = k; j < 6; ++j) {
      H[6 * k + j] = tot[idx];
      H[6 * j + k] = tot[idx];
      ++idx;
    }
#pragma unroll
  for (int k = 0; k < 6; ++k) b[k] = -tot[21 + k];
  *f = tot[27];
  if (c.w_rot > 0.0f || c.w_trans > 0.0f) {
    float Rrel[9], trel[3], ep[6];
    matmul3(P, s.Ri0, Rrel);
    matvec3(P, s.ti0, trel);
#pragma unroll
    for (int k = 0; k < 3; ++k) trel[k] += P[9 + k];
    se3_log(Rrel, trel, ep);
    float prior = 0.0f;
#pragma unroll
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
__device__ __forceinline__ void propose(LmState& s) {
  float trace = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) trace += s.H[7 * k];
  const float floor = 1e-6f * trace / 6.0f + 1e-9f;
  float Hd[36];
#pragma unroll
  for (int k = 0; k < 36; ++k) Hd[k] = s.H[k];
#pragma unroll
  for (int k = 0; k < 6; ++k)
    Hd[7 * k] = s.H[7 * k] + s.lam * s.H[7 * k] + floor;
  float dx[6], dR[9], dt[3];
  solve6(Hd, s.b, dx);
  se3_exp(dx, dR, dt);
  matmul3(dR, s.P, s.Pc);
  matvec3(dR, s.P + 9, s.Pc + 9);
#pragma unroll
  for (int k = 0; k < 3; ++k) s.Pc[9 + k] += dt[k];
}

// One 64-bit word of the exchange between the cluster's blocks: a value
// and the step it belongs to.  A word is stored and loaded whole, so a
// reader that sees the step's tag sees the step's value: no fence and no
// cluster barrier a step.
__device__ __forceinline__ unsigned long long tagged(float v, uint32_t tag) {
  return (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(v);
}

__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kThreads, 1)
pose_lm_kernel(const float* __restrict__ pose0,
               const float4* __restrict__ edges, int n, Cam cam,
               float* __restrict__ out, uint8_t* __restrict__ inlier_out) {
  extern __shared__ uint8_t state[];      // the block's edges' flags
  __shared__ float rows[kWarps * 32];     // the warps' sums
  __shared__ float tot[32];               // the cluster's sums
  __shared__ float pose[12];              // the pose the block evaluates
  __shared__ unsigned long long xbuf[2][kCluster][32];  // by step parity
  __shared__ int counts[kCluster * kWarps];   // block 0: the warps' inliers
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (n + kCluster - 1) / kCluster;
  const int lo = min(n, rank * per), hi = min(n, lo + per);

  // Every block's warp 0 runs the same LM on the same sums, so each holds
  // the same state and no pose crosses the cluster.
  LmState s;
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 12; ++k) s.P[k] = s.Pc[k] = pose0[k];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) s.Ri0[3 * i + j] = s.P[3 * j + i];
    float r[3];
    matvec3(s.Ri0, s.P + 9, r);
#pragma unroll
    for (int k = 0; k < 3; ++k) s.ti0[k] = -r[k];
    s.work = 0;
  }
  if (threadIdx.x < 12) pose[threadIdx.x] = pose0[threadIdx.x];
  for (int i = threadIdx.x; i < 2 * kCluster * 32; i += kThreads)
    (&xbuf[0][0][0])[i] = 0ull;           // tag 0: no step
  for (int i = lo + threadIdx.x; i < hi; i += kThreads)
    state[i - lo] = load_edge(edges, i).valid ? kValid : 0;
  __syncthreads();
  // depth at the initial pose; every valid edge starts as an inlier
  classify_pass(edges, lo, hi, state, pose, cam, false, false, inlier_out);
  cluster.sync();       // every block has started and cleared its words

  uint32_t tag = 0;
  for (int rnd = 0; rnd < kRounds; ++rnd) {
    const bool huber = rnd < 2;
    for (int it = -1; it < kIters; ++it) {  // -1: the system at the pose
      ++tag;
      rows[warp * 32 + lane] =
          build_pass(edges, lo, hi, state, pose, cam, huber);
      __syncthreads();
      if (warp == 0) {
        // the block's sums in warp order, to every block of the cluster
        float v = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += rows[w * 32 + lane];
        const unsigned long long word = tagged(v, tag);
#pragma unroll
        for (int b = 0; b < kCluster; ++b)
          *reinterpret_cast<volatile unsigned long long*>(
              cluster.map_shared_rank(&xbuf[tag & 1][rank][lane], b)) = word;
        // the cluster's sums in rank order, once every block's has come
        unsigned long long got[kCluster];
        bool ready;
        uint32_t spins = 0;
        do {
          if (++spins == kMaxSpins) __trap();   // a block is lost: fail
          ready = true;
#pragma unroll
          for (int b = 0; b < kCluster; ++b) {
            got[b] = *reinterpret_cast<volatile unsigned long long*>(
                &xbuf[tag & 1][b][lane]);
            ready &= static_cast<uint32_t>(got[b] >> 32) == tag;
          }
        } while (!ready);
        float sum = 0.0f;
#pragma unroll
        for (int b = 0; b < kCluster; ++b)
          sum += __uint_as_float(static_cast<uint32_t>(got[b]));
        tot[lane] = sum;
        __syncwarp();
        float t[kSys];
#pragma unroll
        for (int k = 0; k < kSys; ++k) t[k] = tot[k];
        s.work += static_cast<int>(tot[kSys]);
        float Hn[36], bn[6], fn;
        finish_system(t, pose, s, cam, Hn, bn, &fn);  // at s.P or s.Pc
        if (it < 0) {
#pragma unroll
          for (int k = 0; k < 36; ++k) s.H[k] = Hn[k];
#pragma unroll
          for (int k = 0; k < 6; ++k) s.b[k] = bn[k];
          s.f = fn;
          s.lam = 1e-5f;
        } else if (fn < s.f) {
#pragma unroll
          for (int k = 0; k < 12; ++k) s.P[k] = s.Pc[k];
#pragma unroll
          for (int k = 0; k < 36; ++k) s.H[k] = Hn[k];
#pragma unroll
          for (int k = 0; k < 6; ++k) s.b[k] = bn[k];
          s.f = fn;
          s.lam *= 0.5f;
        } else {
          s.lam *= 4.0f;
        }
        const bool more = it + 1 < kIters;
        if (more) propose(s);
        __syncwarp();                     // every lane has read pose
        // the pose the block evaluates next: the candidate, or after the
        // round's last iteration the accepted pose (reclassified)
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < 12; ++k) pose[k] = more ? s.Pc[k] : s.P[k];
        }
      }
      __syncthreads();
    }
    const bool last = rnd + 1 == kRounds;
    const int n_in = classify_pass(edges, lo, hi, state, pose, cam, true,
                                   last, inlier_out);
    if (last) {
      const int w_in = __reduce_add_sync(0xffffffffu, n_in);
      if (lane == 0)
        cluster.map_shared_rank(counts, 0)[rank * kWarps + warp] = w_in;
    }
  }
  cluster.sync();                         // the counts are in block 0
  if (rank == 0 && threadIdx.x == 0) {
    int total = 0;
    for (int r = 0; r < kCluster * kWarps; ++r) total += counts[r];
#pragma unroll
    for (int k = 0; k < 12; ++k) out[k] = s.P[k];
    reinterpret_cast<int*>(out)[12] = total;
    reinterpret_cast<int*>(out)[13] = s.work;
  }
}

}  // namespace

// pose0: [12] float32 (R0 row-major, t0); edges: [n, 8] float32 rows
// (xw, u, v, uR, inv_sigma2, valid as 1/0), 16-byte aligned; out: [16]
// float32 (R, t, then as int32: the inlier count and the active edges
// summed over the build passes); inlier: [n] bool.  The grid is one
// cluster of kCluster blocks, each with a byte of dynamic shared memory
// an edge of its range.
extern "C" int airdos_pose_lm(const void* pose0, const void* edges, void* out,
                              void* inlier, int n, float fx, float fy,
                              float cx, float cy, float bf, float delta_mono,
                              float delta_stereo, float w_rot, float w_trans,
                              void* stream) {
  const Cam cam{fx, fy, cx, cy, bf, delta_mono, delta_stereo, w_rot, w_trans};
  const int per = (n + kCluster - 1) / kCluster;
  pose_lm_kernel<<<kCluster, kThreads, per > 0 ? per : 1,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pose0), static_cast<const float4*>(edges), n,
      cam, static_cast<float*>(out), static_cast<uint8_t*>(inlier));
  return static_cast<int>(cudaGetLastError());
}
