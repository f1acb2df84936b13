// The human BA's three edge families, for sm_90a: joint projections, limb
// rigidity and constant-velocity motion, each edge's residual, Jacobian,
// Huber weight and its entries of the normal equations, its robust cost,
// or each family's LM cost summed in one launch.
//
// Replaces airdos_tpu/solvers/human_ba.py:188 residuals (the human half),
// gn_step :257-301 (the family weights, J_m, J_r and the scatter helper's
// products) and the human families' cost sums of :223-243: XLA fusions of
// gathers, stacks, einsums and reductions.  The port's plain version is
// ops/ba_human.py human_edges_ref; eager, ~120 launches a call.  For an
// edge of each family:
//
//   projection: csrc/ba_project.cuh's e, Jc, Jp of the joint seen from
//     its camera; chi2 = (e.e) SigmaHuman; J = [Jc | Jp] [3 x 9];
//   rigidity: d = p1 - p2, dist = sqrt((d.d) + 1e-12), er = dist - limb,
//     u = d / dist, chi2 = (er er) SigmaRigidity; J = [u, -u, -1] [1 x 7];
//   motion: v = p2 - t dt, xm = R^T v (each entry ((R_0i v0 + R_1i v1) +
//     R_2i v2)), em = p1 - xm, chi2 = (em.em) SigmaMotion; J = [I, -R^T,
//     R^T dt, -[xm]x] [3 x 12];
//   Huber (huber != 0): the family's delta, factor delta / sq past it;
//     w = (sigma factor) active, or sigma active.
//
// Gauss-Newton mode (human_rows_kernel): the edge's J^T w J (row-major)
// at the family's offset in the column plus Q Q edge, its -J^T w e after
// every family's J^T w J, each entry sum over rows r of (w A[r][q])
// A[r][p] over the columns A = [J | e], in float64 rounded to float32
// once (ops/ba_static.py normal_rows).  A block takes kRowEdges edges of
// one family, kLanes lanes an edge; the code is a template a family, so
// no warp branches between families.  Every lane gathers the edge's
// state and computes its residual, Jacobian and w (the same float32
// operations, so the same bits); the lanes stage A and w A in float64 in
// shared memory (lane l its columns l, l + 8), so that an entry is R
// products and R - 1 sums, no conversion.  Each of the family's distinct
// entries (45 + 9, 28 + 7, 78 + 12: J^T w J is
// symmetric bit for bit, since (w A_q) A_p and (w A_p) A_q are one
// rounding of the same exact product, w A being exact in float64) is
// one word of the lane plan (ops/ba_human.py gn_lane_plan, passed by
// value): its columns and its one or two places among the edge's Q Q + Q
// entries.  The block's slices of the column (its edges' J^T w J, then
// their -J^T w e) are staged in shared memory at the phase that the
// slice's first float has modulo 16 bytes, and written out 16 bytes a
// thread, consecutive threads on consecutive addresses, the head and the
// tail off 16 bytes one float a thread.
//
// Cost mode (human_cost_kernel): a thread an edge, rho and chi2 at the
// edge's place among all edges, and each projection's depth.
//
// Cost-sum mode (human_cost_sum_kernel): a block of 1024 threads a
// family, ops/lm_cost.py's sum of where(isfinite(rho), rho, 1e30) *
// active in lm_cost_ref's order: thread j adds the terms j, j + 1024,
// ... of its family in sequence from 0, then a halving tree over the 1024
// partials (j + 512, ..., 32 in shared memory, the last five by warp
// shuffles: the same adds).  A family's sum is one block's, so nothing
// passes between blocks: no counter in device memory, no cluster, and
// launches on concurrent streams share nothing.
//
// Exact: every product and sum is an __fmul_rn / __fadd_rn / __fsub_rn
// (the float64 ones __dmul_rn / __dadd_rn), the divisions and square
// roots correctly rounded (__fdiv_rn, __fsqrt_rn), in the plain version's
// order; so the outputs are bit-equal to it.
//
// What bounds it on an H100.  Bytes: the crowd-27 flagship (T = 8
// trajectories x L = 8 poses: 896 projection, 896 rigidity and 280 motion
// edges) writes 90 + 56 + 156 floats an edge, ~0.7 MB, and reads ~60 kB:
// ~0.2 us at 3.35 TB/s.  Operations: ~100 float32 operations an edge and
// 504, 70 and 852 float64 ones, ~0.1 us at 34 TFLOP/s.  Bytes bound it;
// the edges' two dependent gathers, the entries' float64 chains and the
// launch set its time.  The earlier design, a thread an edge (17
// blocks), summed an edge's 90-156 entries in sequence in one thread and
// stored each where it lands, a warp's stores strided by 324-576 bytes.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "ba_project.cuh"

namespace {

using ba::add;
using ba::mul;
using ba::sub;

constexpr int kLanes = 8;                  // Gauss-Newton: lanes an edge
constexpr int kRowThreads = 128;
constexpr int kRowEdges = kRowThreads / kLanes;
constexpr int kNone = 255;                 // a plan word's empty second place
constexpr int kCostThreads = 128;
constexpr int kSumThreads = 1024;          // lm_cost_ref's partials
constexpr float kNonFinite = 1e30f;

// rows R and variables Q of each family's Jacobian, slots a lane in the
// plan and the family's first plan word
template <int F> struct Family;
template <> struct Family<0> {
  static constexpr int R = 3, Q = 9, kSlots = 7, kPlan = 0;
};
template <> struct Family<1> {
  static constexpr int R = 1, Q = 7, kSlots = 5, kPlan = kLanes * 7;
};
template <> struct Family<2> {
  static constexpr int R = 3, Q = 12, kSlots = 12, kPlan = kLanes * (7 + 5);
};
constexpr int kPlanWords = kLanes * (7 + 5 + 12);

// The lanes' entries: word s of a family's lane l is plan[kPlan + l *
// kSlots + s], -1 for none, else q | p << 4 | first place << 8 | second
// place << 16 | negate << 24 (ops/ba_human.py gn_lane_plan).
struct Plan {
  int32_t word[kPlanWords];
};

struct Consts {
  ba::Intrinsics cam;
  float sigma[3];   // SigmaHuman, SigmaRigidity, SigmaMotion
  float delta[3];   // the families' Huber deltas
};

struct State {
  const float* camR;
  const float* camt;
  const float* joints;
  const float* seg_len;
  const float* motR;
  const float* mott;
};

struct Tables {
  const int32_t* hp_cam;
  const int32_t* hp_joint;
  const float* hp_obs;
  const int32_t* rg_j1;
  const int32_t* rg_j2;
  const int32_t* rg_seg;
  const int32_t* mo_j1;
  const int32_t* mo_j2;
  const int32_t* mo_traj;
  const float* mo_dt;
  const float* act[3];
};

template <int F>
struct Edge {
  float e[Family<F>::R];
  float J[Family<F>::R][Family<F>::Q];
  float chi2, z;
};

__device__ __forceinline__ void edge(const State& st, const Tables& tb,
                                     int i, const Consts& k, Edge<0>& ed) {
  const int64_t c = tb.hp_cam[i], j = tb.hp_joint[i];
  ba::Projection pr;
  ba::project(st.camR + 9 * c, st.camt + 3 * c, st.joints + 3 * j,
              tb.hp_obs + 3 * int64_t{i}, k.cam, pr);
  ed.chi2 = mul(ba::sqnorm3(pr.e), k.sigma[0]);
  ed.z = pr.z;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    ed.e[r] = pr.e[r];
#pragma unroll
    for (int q = 0; q < 6; ++q) ed.J[r][q] = pr.Jc[r][q];
#pragma unroll
    for (int q = 0; q < 3; ++q) ed.J[r][6 + q] = pr.Jp[r][q];
  }
}

__device__ __forceinline__ void edge(const State& st, const Tables& tb,
                                     int i, const Consts& k, Edge<1>& ed) {
  const float* p1 = st.joints + 3 * int64_t{tb.rg_j1[i]};
  const float* p2 = st.joints + 3 * int64_t{tb.rg_j2[i]};
  const float d[3] = {sub(p1[0], p2[0]), sub(p1[1], p2[1]),
                      sub(p1[2], p2[2])};
  const float dist = __fsqrt_rn(add(ba::sqnorm3(d), 1e-12f));
  ed.e[0] = sub(dist, st.seg_len[tb.rg_seg[i]]);
  ed.chi2 = mul(mul(ed.e[0], ed.e[0]), k.sigma[1]);
  ed.z = 0.0f;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float u = __fdiv_rn(d[q], dist);
    ed.J[0][q] = u;
    ed.J[0][3 + q] = -u;
  }
  ed.J[0][6] = -1.0f;
}

__device__ __forceinline__ void edge(const State& st, const Tables& tb,
                                     int i, const Consts& k, Edge<2>& ed) {
  const int64_t tr = tb.mo_traj[i];
  const float* R = st.motR + 9 * tr;
  const float* t = st.mott + 3 * tr;
  const float dt = tb.mo_dt[i];
  const float* p1 = st.joints + 3 * int64_t{tb.mo_j1[i]};
  const float* p2 = st.joints + 3 * int64_t{tb.mo_j2[i]};
  float v[3], xm[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) v[r] = sub(p2[r], mul(t[r], dt));
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    xm[r] = add(add(mul(R[r], v[0]), mul(R[3 + r], v[1])),
                mul(R[6 + r], v[2]));
    ed.e[r] = sub(p1[r], xm[r]);
  }
  ed.chi2 = mul(ba::sqnorm3(ed.e), k.sigma[2]);
  ed.z = 0.0f;
  // J = [I, -R^T, R^T dt, -[xm]x]; row r of R^T is column r of R
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      ed.J[r][q] = r == q ? 1.0f : 0.0f;
      ed.J[r][3 + q] = -R[3 * q + r];
      ed.J[r][6 + q] = mul(R[3 * q + r], dt);
    }
  }
  ed.J[0][9] = 0.0f;
  ed.J[0][10] = xm[2];
  ed.J[0][11] = -xm[1];
  ed.J[1][9] = -xm[2];
  ed.J[1][10] = 0.0f;
  ed.J[1][11] = xm[0];
  ed.J[2][9] = xm[1];
  ed.J[2][10] = -xm[0];
  ed.J[2][11] = 0.0f;
}

// the edge's robust cost, and its weight w when asked
template <int F>
__device__ __forceinline__ float robust(const Edge<F>& ed, const Consts& k,
                                        int huber, float* factor) {
  float rho = ed.chi2;
  *factor = 1.0f;
  if (huber) ba::huber(ed.chi2, k.delta[F], factor, &rho);
  return rho;
}

// count floats from shared src to global dst, src at dst's phase modulo
// 16 bytes: 16 bytes a thread from dst's first 16-byte boundary, the head
// before it and the tail one float a thread
__device__ __forceinline__ void copy_out(float* __restrict__ dst,
                                         const float* __restrict__ src,
                                         int count, int phase) {
  const int head = min((4 - phase) & 3, count);
  const int n4 = (count - head) / 4;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  for (int m = threadIdx.x; m < n4; m += kRowThreads) d4[m] = s4[m];
  const int tail = head + 4 * n4;
  for (int m = threadIdx.x; m < head + count - tail; m += kRowThreads) {
    const int at = m < head ? m : tail + m - head;
    dst[at] = src[at];
  }
}

__device__ __forceinline__ int phase_of(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// shared memory of a Gauss-Newton block, in floats: w A and A in float64
// (kA doubles each), then the J^T w J slice and the -J^T w e slice, each
// from a 16-byte boundary with 4 floats of room for its phase
template <int F>
struct RowsSmem {
  static constexpr int R = Family<F>::R, Q = Family<F>::Q;
  static constexpr int kA = kRowEdges * R * (Q + 1);
  static constexpr int kH = 4 * kA;
  static constexpr int kB = kH + (kRowEdges * Q * Q + 4 + 3) / 4 * 4;
  static constexpr int kSize = kB + kRowEdges * Q + 4;
};
constexpr int kRowsSmem = RowsSmem<2>::kSize;  // the largest family's
static_assert(RowsSmem<0>::kSize <= kRowsSmem &&
                  RowsSmem<1>::kSize <= kRowsSmem,
              "the motion family's block needs the most shared memory");

// block `blk` of family F: its kRowEdges edges' entries; h and b point at
// the family's J^T w J and -J^T w e in the column
template <int F>
__device__ __forceinline__ void rows_block(const State& st, const Tables& tb,
                                           int n, int blk, const Consts& k,
                                           int huber, const Plan& plan,
                                           float* __restrict__ h,
                                           float* __restrict__ b,
                                           float* __restrict__ smem,
                                           int32_t* __restrict__ plan_s) {
  using Fam = Family<F>;
  using Sm = RowsSmem<F>;
  constexpr int R = Fam::R, Q = Fam::Q, kCols = Q + 1;
  const int sub_lane = threadIdx.x % kLanes;
  const int le = threadIdx.x / kLanes;
  const int first = blk * kRowEdges;
  const int i = first + le;
  const int nb = min(kRowEdges, n - first);
  double* wa_s = reinterpret_cast<double*>(smem);
  double* a_s = wa_s + Sm::kA;
  float* hout = h + static_cast<int64_t>(Q * Q) * first;
  float* bout = b + static_cast<int64_t>(Q) * first;
  const int h_phase = phase_of(hout), b_phase = phase_of(bout);
  float* h_s = smem + Sm::kH + h_phase;
  float* b_s = smem + Sm::kB + b_phase;
  if (threadIdx.x < kLanes * Fam::kSlots)
    plan_s[threadIdx.x] = plan.word[Fam::kPlan + threadIdx.x];
  if (i < n) {
    Edge<F> ed;
    edge(st, tb, i, k, ed);
    float factor;
    robust(ed, k, huber, &factor);
    const float sigma = k.sigma[F];
    const double wd = mul(huber ? mul(sigma, factor) : sigma, tb.act[F][i]);
    // A = [J | e] and w A (exact) in float64, lane l the columns l, l + 8
    double* a = a_s + le * R * kCols;
    double* wa = wa_s + le * R * kCols;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        if (q % kLanes != sub_lane) continue;
        const double v = q < Q ? ed.J[r][q] : ed.e[r];
        a[r * kCols + q] = v;
        wa[r * kCols + q] = __dmul_rn(wd, v);
      }
    }
  }
  __syncthreads();
  if (i < n) {
    // every entry first, then the stores: a store to shared memory might
    // alias A, so an entry summed after a store waits for it
    const double* a = a_s + le * R * kCols;
    const double* wa = wa_s + le * R * kCols;
    int32_t word[Fam::kSlots];
    float v[Fam::kSlots];
#pragma unroll
    for (int s = 0; s < Fam::kSlots; ++s) {
      word[s] = plan_s[sub_lane * Fam::kSlots + s];
      const int32_t qp = word[s] < 0 ? 0 : word[s];   // an empty slot: A_0 A_0
      const int q = qp & 15, p = (qp >> 4) & 15;
      double acc = __dmul_rn(wa[q], a[p]);
#pragma unroll
      for (int r = 1; r < R; ++r)
        acc = __dadd_rn(acc, __dmul_rn(wa[r * kCols + q], a[r * kCols + p]));
      v[s] = __double2float_rn((word[s] >> 24) & 1 ? -acc : acc);
    }
#pragma unroll
    for (int s = 0; s < Fam::kSlots; ++s) {
      if (word[s] < 0) continue;
#pragma unroll
      for (int place = 0; place < 2; ++place) {
        const int d = (word[s] >> (8 + 8 * place)) & 255;
        if (d == kNone) continue;
        if (d < Q * Q) h_s[le * Q * Q + d] = v[s];
        else b_s[le * Q + d - Q * Q] = v[s];
      }
    }
  }
  __syncthreads();
  copy_out(hout, h_s, Q * Q * nb, h_phase);
  copy_out(bout, b_s, Q * nb, b_phase);
}

__global__ void __launch_bounds__(kRowThreads)
human_rows_kernel(State st, Tables tb, int Eh, int Er, int Em, Consts k,
                  int huber, const __grid_constant__ Plan plan,
                  float* __restrict__ col) {
  __shared__ __align__(16) float smem[kRowsSmem];
  __shared__ int32_t plan_s[kLanes * Family<2>::kSlots];  // the most slots
  const int bh = (Eh + kRowEdges - 1) / kRowEdges;
  const int br = (Er + kRowEdges - 1) / kRowEdges;
  // the families' J^T w J blocks, then their -J^T w e rows
  float* b = col + 81 * int64_t{Eh} + 49 * int64_t{Er} + 144 * int64_t{Em};
  const int blk = blockIdx.x;
  if (blk < bh) {
    rows_block<0>(st, tb, Eh, blk, k, huber, plan, col, b, smem, plan_s);
  } else if (blk < bh + br) {
    rows_block<1>(st, tb, Er, blk - bh, k, huber, plan,
                  col + 81 * int64_t{Eh}, b + 9 * int64_t{Eh}, smem, plan_s);
  } else {
    rows_block<2>(st, tb, Em, blk - bh - br, k, huber, plan,
                  col + 81 * int64_t{Eh} + 49 * int64_t{Er},
                  b + 9 * int64_t{Eh} + 7 * int64_t{Er}, smem, plan_s);
  }
}

template <int F>
__device__ __forceinline__ void cost_edge(const State& st, const Tables& tb,
                                          int i, int at, const Consts& k,
                                          int huber, float* __restrict__ rho,
                                          float* __restrict__ chi2,
                                          float* __restrict__ z) {
  Edge<F> ed;
  edge(st, tb, i, k, ed);
  float factor;
  rho[at] = robust(ed, k, huber, &factor);
  chi2[at] = ed.chi2;
  if (F == 0) z[i] = ed.z;
}

__global__ void __launch_bounds__(kCostThreads)
human_cost_kernel(State st, Tables tb, int Eh, int Er, int Em, Consts k,
                  int huber, float* __restrict__ rho,
                  float* __restrict__ chi2, float* __restrict__ z) {
  const int idx = blockIdx.x * kCostThreads + threadIdx.x;
  if (idx < Eh) cost_edge<0>(st, tb, idx, idx, k, huber, rho, chi2, z);
  else if (idx < Eh + Er)
    cost_edge<1>(st, tb, idx - Eh, idx, k, huber, rho, chi2, z);
  else if (idx < Eh + Er + Em)
    cost_edge<2>(st, tb, idx - Eh - Er, idx, k, huber, rho, chi2, z);
}

// partial j of family F's LM cost: its terms j, j + 1024, ... in sequence
template <int F>
__device__ __forceinline__ float cost_partial(const State& st,
                                              const Tables& tb, int n,
                                              const Consts& k, int huber) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += kSumThreads) {
    Edge<F> ed;
    edge(st, tb, i, k, ed);
    float factor;
    const float rho = robust(ed, k, huber, &factor);
    acc = __fadd_rn(acc, __fmul_rn(isfinite(rho) ? rho : kNonFinite,
                                   tb.act[F][i]));
  }
  return acc;
}

__global__ void __launch_bounds__(kSumThreads, 1)
human_cost_sum_kernel(State st, Tables tb, int Eh, int Er, int Em, Consts k,
                      int huber, float* __restrict__ out) {
  __shared__ float partial[kSumThreads];
  const int tid = threadIdx.x;
  const int fam = blockIdx.x;
  partial[tid] = fam == 0 ? cost_partial<0>(st, tb, Eh, k, huber)
               : fam == 1 ? cost_partial<1>(st, tb, Er, k, huber)
                          : cost_partial<2>(st, tb, Em, k, huber);
  __syncthreads();
  for (int half = kSumThreads / 2; half >= 32; half /= 2) {
    if (tid < half) partial[tid] = __fadd_rn(partial[tid], partial[tid + half]);
    __syncthreads();
  }
  if (tid < 32) {                            // the last five halvings
    float v = partial[tid];
#pragma unroll
    for (int half = 16; half > 0; half /= 2)
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, half));
    if (tid == 0) out[fam] = v;
  }
}

}  // namespace

// camR [C, 3, 3], camt [C, 3], joints [NJ, 3], seg_len [NS], motR [T, 3,
// 3], mott [T, 3] float32; tables: the device pointers (in host memory)
// of hp_cam, hp_joint [Eh], hp_obs [Eh, 3], rg_j1, rg_j2, rg_seg [Er],
// mo_j1, mo_j2, mo_traj [Em] (int32 but hp_obs) and mo_dt [Em] (float32);
// act_* [E*] float32 (unread in cost mode); consts: fx, fy, cx, cy, bf,
// the three sigmas and the three Huber deltas in host memory.  mode 0,
// Gauss-Newton: out0 the column [90 Eh + 56 Er + 156 Em], plan: the lane
// plan's kPlanWords words in host memory; mode 1, cost: out0 rho, out1
// chi2 [Eh + Er + Em], out2 the projections' depths [Eh]; mode 2, cost
// sum: out0 the three families' LM costs [3].  All float32.
extern "C" int airdos_human_edges(
    const void* camR, const void* camt, const void* joints,
    const void* seg_len, const void* motR, const void* mott,
    const int64_t* tables, const void* act_h, const void* act_r,
    const void* act_m, int Eh, int Er, int Em, const float* consts,
    int huber, int mode, const int32_t* plan, void* out0, void* out1,
    void* out2, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* x) { return static_cast<const float*>(x); };
  const auto i32 = [](int64_t x) {
    return reinterpret_cast<const int32_t*>(x);
  };
  const auto f32 = [](int64_t x) { return reinterpret_cast<const float*>(x); };
  const State st{f(camR), f(camt), f(joints), f(seg_len), f(motR), f(mott)};
  const Tables tb{i32(tables[0]), i32(tables[1]), f32(tables[2]),
                  i32(tables[3]), i32(tables[4]), i32(tables[5]),
                  i32(tables[6]), i32(tables[7]), i32(tables[8]),
                  f32(tables[9]), {f(act_h), f(act_r), f(act_m)}};
  const Consts k{{consts[0], consts[1], consts[2], consts[3], consts[4]},
                 {consts[5], consts[6], consts[7]},
                 {consts[8], consts[9], consts[10]}};
  if (Eh < 0 || Er < 0 || Em < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 2) {
    human_cost_sum_kernel<<<3, kSumThreads, 0, s>>>(
        st, tb, Eh, Er, Em, k, huber, static_cast<float*>(out0));
    return static_cast<int>(cudaGetLastError());
  }
  const int n = Eh + Er + Em;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (mode == 1) {
    human_cost_kernel<<<(n + kCostThreads - 1) / kCostThreads, kCostThreads,
                        0, s>>>(st, tb, Eh, Er, Em, k, huber,
                                static_cast<float*>(out0),
                                static_cast<float*>(out1),
                                static_cast<float*>(out2));
    return static_cast<int>(cudaGetLastError());
  }
  if (mode != 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  for (int w = 0; w < kPlanWords; ++w) p.word[w] = plan[w];
  const int blocks = (Eh + kRowEdges - 1) / kRowEdges +
                     (Er + kRowEdges - 1) / kRowEdges +
                     (Em + kRowEdges - 1) / kRowEdges;
  human_rows_kernel<<<blocks, kRowThreads, 0, s>>>(
      st, tb, Eh, Er, Em, k, huber, p, static_cast<float*>(out0));
  return static_cast<int>(cudaGetLastError());
}
