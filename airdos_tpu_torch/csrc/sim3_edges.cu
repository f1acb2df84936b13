// The essential graph's Sim(3) edge system, for sm_90a: one entry point,
// one launch a call, in two modes.
//
// Replaces airdos_tpu/solvers/pose_graph.py:27 _edge_residual and :59
// edge_system (jax.jacfwd under vmap, then the einsums of J^T W J and
// -J^T W e; no Pallas kernel), which the port ran as one reverse-mode
// autograd pass over 7E repeated rows, ~1,100 launches a step.  The plain
// version is ops/pose_graph_kernels.py sim3_edges_ref.
//
// Per edge: e = log_sim3(S_m S_i S_j^-1) (ops: sim3_inverse, sim3_compose
// twice, sim3_log = so3_log, log, the V matrix of geometry/se3.py _sim3_V
// and V v = t), a 7-vector, with each vertex perturbed at zero as
// solvers/pose_graph.py _perturb does: R <- exp(xi[3:6]) R, t <- t +
// xi[:3], s <- s exp(xi[6]).  At zero the perturbations' tangents are
// exact: dR = hat(e_a) R (a row permutation and negation of R), dt = e_a,
// ds = s.
//
// Gauss-Newton mode, 16 lanes an edge (8 edges a block of 128).  Lane d <
// 14 carries direction d (vertex i's 7, then vertex j's) as a dual number
// (value, tangent) through the whole residual: forward mode, as jacfwd.
// Every lane computes the same values with the same instructions, so all
// follow the branch the value takes: so3_log's generic, small-angle and
// near-pi branches (argmax and signs are piecewise constant; the clamps'
// and maxima's tangents pass where the value is inside, as torch's
// clamp), and the three regimes of V (sigma ~ 0: the SE(3) left
// Jacobian, which does not depend on sigma; theta ~ 0; generic).  V v = t
// is solved by the adjugate; the tangent dv = V^-1 (dt - dV v).  Lane d
// writes column d of J to shared memory, lane 0 the residual; then the
// edge's 16 lanes write its 196 entries (J^T w J)[q][p] = sum_r (w J[r][q])
// J[r][p] and 14 entries -(sum_r (w J[r][q]) e[r]) into
// solvers/human_ba.py scatter_values' layout: out[e * 196 + q * 14 + p],
// out[E * 196 + e * 14 + q].  The compact segment_sum assembles H and b.
//
// Cost mode, one block of kThreads: lane j computes the residual of edges
// j, j + kThreads, ... (tangents zero) and adds w |e|^2 (|e|^2 left to
// right) in sequence from 0; a halving tree adds the lanes.  One order,
// no atomics: two launches are bit-equal.
//
// Against the plain version: not bit-equal.  Forward tangents and
// reverse-mode products round differently, V v = t is solved by the
// adjugate (the plain version: torch.linalg.solve), and nvcc may contract
// products and sums into multiply-adds.  chip_smoke.py holds the cost
// within SYSTEM_RTOL of the plain version's, and the system to the plain
// version in float64, edge by edge (ops/pose_graph_kernels.py held,
// edge_gaps: J^T e within SYSTEM_RTOL |J| |e| plus a few units of 2^-24 of
// |J| times the edge's translation scale, to which a float32 residual is
// known; a small residual rotation puts V's closed forms in float32
// cancellation in both versions, so each may be as far as twice the
// float32 plain version).
//
// What bounds it on an H100.  Bytes: an edge reads its two vertices and
// its measurement (~136 B) and writes 210 floats (840 B): ~1 MB at the
// map scale's 1000 edges, 0.3 us at 3.35 TB/s.  Operations: the function
// needs the residual once, 14 tangents and the 105 distinct entries of
// J^T w J, ~7,500 an edge as chip_smoke.py counts them from this source
// (_s3_ops), 0.11 us for 1000 edges at 67 TFLOP/s: bytes bound it.  This
// design does more (each lane recomputes the values; all 196 entries).
// A step's few thousand edges are one wave: the launch is latency, the
// chain of dependent operations through the residual.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 16;              // lanes an edge (GN mode)
constexpr int kEdgesBlock = 8;
constexpr int kDirs = 14;
constexpr int kEntries = kDirs * kDirs + kDirs;
constexpr int kThreads = 256;           // cost mode's lanes
constexpr float kEps = 1e-8f;           // geometry/se3.py _EPS

struct Dual {
  float v, d;
};

__device__ __forceinline__ Dual cst(float v) { return {v, 0.0f}; }
__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ __forceinline__ Dual operator*(float a, Dual b) { return {a * b.v, a * b.d}; }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
__device__ __forceinline__ Dual dsqrt(Dual a) {
  const float r = sqrtf(a.v);
  return {r, a.d / (2.0f * r)};
}
__device__ __forceinline__ Dual dsin(Dual a) { return {sinf(a.v), cosf(a.v) * a.d}; }
__device__ __forceinline__ Dual dcos(Dual a) { return {cosf(a.v), -sinf(a.v) * a.d}; }
__device__ __forceinline__ Dual dexp(Dual a) {
  const float e = expf(a.v);
  return {e, e * a.d};
}
__device__ __forceinline__ Dual dlog(Dual a) { return {logf(a.v), a.d / a.v}; }
__device__ __forceinline__ Dual datan2(Dual y, Dual x) {
  const float n = x.v * x.v + y.v * y.v;
  return {atan2f(y.v, x.v), (x.v * y.d - y.v * x.d) / n};
}
// torch.clamp(a, min=lo): the tangent passes where a >= lo
__device__ __forceinline__ Dual dmax(Dual a, float lo) {
  return a.v >= lo ? a : cst(lo);
}
__device__ __forceinline__ Dual dmin(Dual a, float hi) {
  return a.v <= hi ? a : cst(hi);
}

// C = A B, 3x3 row-major
__device__ __forceinline__ void matmul3(const Dual* A, const Dual* B, Dual* C) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      C[r * 3 + c] = A[r * 3] * B[c] + A[r * 3 + 1] * B[3 + c] +
                     A[r * 3 + 2] * B[6 + c];
}

__device__ __forceinline__ void matvec3(const Dual* A, const Dual* x, Dual* y) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    y[r] = A[r * 3] * x[0] + A[r * 3 + 1] * x[1] + A[r * 3 + 2] * x[2];
}

// hat(e_a) R: row r of the product is sum_m hat[r][m] R[m][:]
__device__ __forceinline__ void hat_rows(int a, const float* R, float* dR) {
#pragma unroll
  for (int j = 0; j < 9; ++j) dR[j] = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (a == 0) {
      dR[3 + c] = -R[6 + c];
      dR[6 + c] = R[3 + c];
    } else if (a == 1) {
      dR[c] = R[6 + c];
      dR[6 + c] = -R[c];
    } else {
      dR[c] = -R[3 + c];
      dR[3 + c] = R[c];
    }
  }
}

// geometry/se3.py so3_log with tangents
__device__ void so3_log(const Dual* R, Dual* w) {
  const Dual trace = R[0] + R[4] + R[8];
  const Dual cos_t = dmin(dmax(0.5f * (trace - cst(1.0f)), -1.0f), 1.0f);
  Dual v[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};
  const Dual vv = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  const Dual sin_t_n = 0.5f * dsqrt(dmax(vv, 1e-12f));
  const Dual theta = datan2(sin_t_n, cos_t);
  const Dual sin_t = dsin(theta);
  const bool small = fabsf(sin_t.v) < 1e-6f;
  const bool near_pi = cos_t.v < -0.999f;
  if (!near_pi) {
    const Dual scale = small ? cst(0.5f) + (theta * theta) / cst(12.0f)
                             : theta / (2.0f * sin_t);
#pragma unroll
    for (int k = 0; k < 3; ++k) w[k] = scale * v[k];
    return;
  }
  // near pi: the axis from the symmetric part's diagonal, which is R's
  const Dual den = dmax(cst(1.0f) - cos_t, 1e-12f);
  Dual axis[3];
  const Dual diag[3] = {R[0], R[4], R[8]};
#pragma unroll
  for (int k = 0; k < 3; ++k)
    axis[k] = dsqrt(dmax(dmax((diag[k] - cos_t) / den, 0.0f), 1e-12f));
  int kmax = 0;  // the first largest, as argmax
  if (axis[1].v > axis[kmax].v) kmax = 1;
  if (axis[2].v > axis[kmax].v) kmax = 2;
  const float ref = v[kmax].v >= 0.0f ? 1.0f : -1.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    axis[k] = ref * ((v[k].v >= 0.0f ? 1.0f : -1.0f) * axis[k]);
  const Dual nrm = dmax(
      dsqrt(axis[0] * axis[0] + axis[1] * axis[1] + axis[2] * axis[2]), 1e-12f);
#pragma unroll
  for (int k = 0; k < 3; ++k) w[k] = (axis[k] / nrm) * theta;
}

// geometry/se3.py _sim3_V: V = A I + B W + C W^2 in its three regimes
__device__ void sim3_V(const Dual* w, Dual sigma, Dual* V) {
  const Dual theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const Dual theta = dsqrt(theta2 + cst(kEps * kEps));
  const bool small_s = fabsf(sigma.v) < 1e-6f;
  const bool small_t = theta2.v < 1e-8f;
  Dual A, B, C;
  if (small_s) {
    A = cst(1.0f);
    if (small_t) {
      B = cst(0.5f) - theta2 / cst(24.0f);
      C = cst(1.0f / 6.0f) - theta2 / cst(120.0f);
    } else {
      B = (cst(1.0f) - dcos(theta)) / (theta2 + cst(kEps));
      C = (theta - dsin(theta)) / (theta2 * theta + cst(kEps));
    }
  } else {
    const Dual s = dexp(sigma);
    const Dual c1 = (s - cst(1.0f)) / sigma;
    A = c1;
    if (small_t) {
      B = ((sigma - cst(1.0f)) * s + cst(1.0f)) / (sigma * sigma);
      C = cst(0.0f);
    } else {
      const Dual a = sigma * sigma + theta2;
      const Dual s_cos = s * dcos(theta);
      const Dual s_sin = s * dsin(theta);
      B = (sigma * s_sin + theta * (cst(1.0f) - s_cos)) / (theta * a);
      C = (c1 - ((s_cos - cst(1.0f)) * sigma + s_sin * theta) / a) / theta2;
    }
  }
  // W = hat(w), W^2 = w w^T - |w|^2 I written out
  const Dual W[9] = {cst(0.0f), -w[2], w[1], w[2], cst(0.0f), -w[0],
                     -w[1], w[0], cst(0.0f)};
  Dual W2[9];
  matmul3(W, W, W2);
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    V[j] = B * W[j] + C * W2[j];
    if (j % 4 == 0) V[j] = A + V[j];
  }
}

// the residual of one edge, vertex i = (Ri, ti, si), vertex j, measurement
// m, all with tangents
__device__ void edge_residual(const Dual* Ri, const Dual* ti, Dual si,
                              const Dual* Rj, const Dual* tj, Dual sj,
                              const Dual* Rm, const Dual* tm, Dual sm,
                              Dual* e) {
  // sim3_inverse(j)
  Dual Rinv[9], tinv[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) Rinv[r * 3 + c] = Rj[c * 3 + r];
  const Dual sinv = cst(1.0f) / sj;
  Dual Rt[3];
  matvec3(Rinv, tj, Rt);
#pragma unroll
  for (int k = 0; k < 3; ++k) tinv[k] = (-sinv) * Rt[k];
  // S_ij = S_i S_j^-1
  Dual Rij[9], tij[3], q[3];
  matmul3(Ri, Rinv, Rij);
  matvec3(Ri, tinv, q);
#pragma unroll
  for (int k = 0; k < 3; ++k) tij[k] = si * q[k] + ti[k];
  const Dual sij = si * sinv;
  // S_e = S_m S_ij
  Dual Re[9], te[3];
  matmul3(Rm, Rij, Re);
  matvec3(Rm, tij, q);
#pragma unroll
  for (int k = 0; k < 3; ++k) te[k] = sm * q[k] + tm[k];
  const Dual se = sm * sij;
  // sim3_log
  Dual w[3], V[9];
  so3_log(Re, w);
  const Dual sigma = dlog(se);
  sim3_V(w, sigma, V);
  // V v = te: v = adj(V) te / det, dv = V^-1 (dte - dV v)
  float a = V[0].v, b = V[1].v, c = V[2].v, d = V[3].v, f = V[4].v,
        g = V[5].v, h = V[6].v, k = V[7].v, l = V[8].v;
  const float inv[9] = {f * l - g * k, -(b * l - c * k), b * g - c * f,
                        -(d * l - g * h), a * l - c * h, -(a * g - c * d),
                        d * k - f * h, -(a * k - b * h), a * f - b * d};
  const float inv_det = 1.0f / (a * inv[0] + b * inv[3] + c * inv[6]);
  float vv[3], rhs[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    vv[r] = (inv[r * 3] * te[0].v + inv[r * 3 + 1] * te[1].v +
             inv[r * 3 + 2] * te[2].v) * inv_det;
#pragma unroll
  for (int r = 0; r < 3; ++r)
    rhs[r] = te[r].d - (V[r * 3].d * vv[0] + V[r * 3 + 1].d * vv[1] +
                        V[r * 3 + 2].d * vv[2]);
#pragma unroll
  for (int r = 0; r < 3; ++r)
    e[r] = {vv[r], (inv[r * 3] * rhs[0] + inv[r * 3 + 1] * rhs[1] +
                    inv[r * 3 + 2] * rhs[2]) * inv_det};
#pragma unroll
  for (int r = 0; r < 3; ++r) e[3 + r] = w[r];
  e[6] = sigma;
}

struct EdgeArgs {
  const float* R;        // [K, 9]
  const float* t;        // [K, 3]
  const float* s;        // [K]
  const int32_t* e_i;    // [E]
  const int32_t* e_j;    // [E]
  const float* Rm;       // [E, 9]
  const float* tm;       // [E, 3]
  const float* sm;       // [E]
  const float* w;        // [E]
  float* out;            // [E * kEntries] or [1]
  int n_edges;
};

// edge `ed`'s residual, direction `dir` (>= kDirs: none) as the tangent
__device__ void edge_with_tangent(const EdgeArgs& a, int ed, int dir,
                                  Dual* e) {
  const int vi = a.e_i[ed], vj = a.e_j[ed];
  Dual R2[2][9], t2[2][3], s2[2];
  const int vert[2] = {vi, vj};
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int v = vert[side];
    float R[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) R[j] = a.R[v * 9 + j];
    float dR[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    const int k = dir - 7 * side;  // this side's direction, if in 0..6
    if (k >= 3 && k < 6) hat_rows(k - 3, R, dR);
#pragma unroll
    for (int j = 0; j < 9; ++j) R2[side][j] = {R[j], dR[j]};
#pragma unroll
    for (int c = 0; c < 3; ++c)
      t2[side][c] = {a.t[v * 3 + c], k == c ? 1.0f : 0.0f};
    const float s = a.s[v];
    s2[side] = {s, k == 6 ? s : 0.0f};
  }
  Dual Rm[9], tm[3];
#pragma unroll
  for (int j = 0; j < 9; ++j) Rm[j] = cst(a.Rm[ed * 9 + j]);
#pragma unroll
  for (int c = 0; c < 3; ++c) tm[c] = cst(a.tm[ed * 3 + c]);
  edge_residual(R2[0], t2[0], s2[0], R2[1], t2[1], s2[1], Rm, tm,
                cst(a.sm[ed]), e);
}

__global__ void __launch_bounds__(kLanes * kEdgesBlock)
sim3_gn_kernel(const EdgeArgs a) {
  __shared__ float J[kEdgesBlock][7][kDirs];
  __shared__ float res[kEdgesBlock][7];
  const int local = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int ed = blockIdx.x * kEdgesBlock + local;
  const bool live = ed < a.n_edges;
  if (live) {
    Dual e[7];
    edge_with_tangent(a, ed, lane, e);
    if (lane < kDirs)
#pragma unroll
      for (int r = 0; r < 7; ++r) J[local][r][lane] = e[r].d;
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < 7; ++r) res[local][r] = e[r].v;
  }
  __syncthreads();
  if (!live) return;
  const float wt = a.w[ed];
  const int64_t E = a.n_edges;
  for (int o = lane; o < kEntries; o += kLanes) {
    if (o < kDirs * kDirs) {
      const int q = o / kDirs, p = o % kDirs;
      float acc = (wt * J[local][0][q]) * J[local][0][p];
#pragma unroll
      for (int r = 1; r < 7; ++r) acc += (wt * J[local][r][q]) * J[local][r][p];
      a.out[static_cast<int64_t>(ed) * (kDirs * kDirs) + o] = acc;
    } else {
      const int q = o - kDirs * kDirs;
      float acc = (wt * J[local][0][q]) * res[local][0];
#pragma unroll
      for (int r = 1; r < 7; ++r) acc += (wt * J[local][r][q]) * res[local][r];
      a.out[E * (kDirs * kDirs) + static_cast<int64_t>(ed) * kDirs + q] = -acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads) sim3_cost_kernel(const EdgeArgs a) {
  __shared__ float red[kThreads];
  const int t = threadIdx.x;
  float s = 0.0f;
  for (int ed = t; ed < a.n_edges; ed += kThreads) {
    Dual e[7];
    edge_with_tangent(a, ed, kDirs, e);
    float q = __fmul_rn(e[0].v, e[0].v);
#pragma unroll
    for (int r = 1; r < 7; ++r) q = __fadd_rn(q, __fmul_rn(e[r].v, e[r].v));
    s = __fadd_rn(s, __fmul_rn(q, a.w[ed]));
  }
  red[t] = s;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (t < off) red[t] = __fadd_rn(red[t], red[t + off]);
    __syncthreads();
  }
  if (t == 0) a.out[0] = red[0];
}

}  // namespace

// R: [K, 3, 3], t: [K, 3], s: [K], e_i, e_j: [E] int32, Rm: [E, 3, 3],
// tm: [E, 3], sm, w: [E], all float32 but the indices; out: [E * 210]
// (Gauss-Newton mode) or [1] (cost mode).
extern "C" int airdos_sim3_edges(const void* R, const void* t, const void* s,
                                 const void* e_i, const void* e_j,
                                 const void* Rm, const void* tm,
                                 const void* sm, const void* w, void* out,
                                 int n_edges, int cost, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  EdgeArgs a;
  a.R = static_cast<const float*>(R);
  a.t = static_cast<const float*>(t);
  a.s = static_cast<const float*>(s);
  a.e_i = static_cast<const int32_t*>(e_i);
  a.e_j = static_cast<const int32_t*>(e_j);
  a.Rm = static_cast<const float*>(Rm);
  a.tm = static_cast<const float*>(tm);
  a.sm = static_cast<const float*>(sm);
  a.w = static_cast<const float*>(w);
  a.out = static_cast<float*>(out);
  a.n_edges = n_edges;
  if (cost) {
    sim3_cost_kernel<<<1, kThreads, 0, st>>>(a);
  } else {
    if (n_edges <= 0) return static_cast<int>(cudaGetLastError());
    const int blocks = (n_edges + kEdgesBlock - 1) / kEdgesBlock;
    sim3_gn_kernel<<<blocks, kLanes * kEdgesBlock, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
