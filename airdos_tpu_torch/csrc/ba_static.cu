// The static projection edges of the local and human BAs, for sm_90a:
// residual, Jacobians, Huber weight and the Gauss-Newton rows of every
// edge, its robust cost, or the family's LM cost summed in one launch.
//
// Replaces airdos_tpu/solvers/local_ba.py:43 _proj_residual and the
// weighted products of gn_step (:107-129), and the static half of
// airdos_tpu/solvers/human_ba.py:188 residuals and gn_step (:257-284):
// XLA fusions of gathers, stacks and einsums; and, in the cost-sum mode,
// the static family's cost sum of local_ba.py:176-182 and
// human_ba.py:223-243.  The port's plain version is ops/ba_static.py
// static_edges_ref; eager, it is ~150 launches a call.
// For edge i with camera c = e_cam[i] and point p = e_pt[i]
// (csrc/ba_project.cuh gives e, Jc, Jp, z):
//
//   chi2 = ((e.e) info) scale;  base = info scale;
//   Huber (huber != 0): sq = sqrt(max(chi2, 1e-12)), delta = 2.795483
//     (stereo) or 2.447749 (mono); past delta the weight factor is
//     delta / sq and rho = 2 delta sq - delta^2; else factor 1, rho = chi2;
//   w = (base factor) active (base active without Huber);
//   Gauss-Newton mode: cam row [42] = Jc^T w Jc (row-major) | -Jc^T w e,
//     pt row [12] = Jp^T w Jp | -Jp^T w e, pc row [18] = Jc^T w Jp, each
//     entry summed over the residual's three rows in order after the
//     products (w J) J, in float64 and rounded to float32 once
//     (ops/ba_static.py normal_rows says why);
//   cost mode: rho, chi2, z;
//   cost-sum mode: ops/lm_cost.py's sum of where(isfinite(rho), rho,
//     1e30) * active, in its order.
//
// Gauss-Newton mode (static_rows_kernel): kLanes lanes an edge, 32 edges
// a block of 256 threads.  Every lane gathers the edge's camera, point and
// observation and computes the projection, the Huber factor and w (the
// same float32 operations, so the same bits); lane 0 puts the edge's
// A = [Jc | Jp | e] (3 x 10 floats) in shared memory.  Each of the 54
// distinct entries of the 72 (J^T w J is symmetric: (w J_q) J_p and
// (w J_p) J_q are the one rounding of the same exact product, w J being
// exact in float64) is a column pair (q, p) of A,
//   sum over rows r of (w A[r][q]) A[r][p], negated for a b entry,
// and the lane plan (ops/ba_static.py gn_lane_plan, passed by value)
// gives each lane its entries and where each goes in the edge's 72 (two
// places for an off-diagonal H entry).  The rows are staged in shared
// memory as the block's contiguous cam, pt and pc rows and written out
// as 16-byte stores, consecutive threads on consecutive addresses.
//
// Cost mode (static_cost_kernel): one thread an edge, rho, chi2, z.
//
// Cost-sum mode (static_cost_sum_kernel): a thread block cluster of 8
// blocks of 1024 threads.  Block r owns lm_cost_ref's partials j in
// [128 r, 128 r + 128).  Per chunk of 8192 edges its 1024 threads compute
// the terms j + 1024 m, m = 0..7 of the chunk, into shared memory, and
// thread j adds them to its partial in order, so that over the chunks
// partial j adds the terms j, j + 1024, j + 2048, ... in sequence from 0,
// as lm_cost_ref's partial j does.  The 128 partials then go into the
// leader's (block 0's) shared memory through distributed shared memory;
// after one cluster barrier the leader runs lm_cost_ref's halving tree
// over the 1024 partials (j + 512, then 256, ..., 1; the last five by
// warp shuffles, the same adds).  Every sum is the same __fadd_rn in the
// same order, so the result is bit-equal to lm_cost_ref(rho, active), on the
// card and on the CPU.  A cluster barrier, not a counter in device
// memory: concurrent launches on other streams share nothing.
//
// Every rounding is the plain version's (ba_project.cuh says how; the
// float64 products and sums are __dmul_rn / __dadd_rn), so the outputs
// are bit-equal to it.
//
// What bounds it on an H100.  Bytes: at E = 8192 edges, C = 24, P = 2048,
// the edges' 32 bytes, the cameras and points once (~26 kB) and 288 bytes
// of rows an edge: ~2.6 MB, ~0.8 us at 3.35 TB/s; the costs ~0.3 MB, the
// cost sum 0.26 MB.  Operations: ~100 float32 and ~420 float64 operations
// an edge, 3.4 MFLOP of float64, ~0.1 us at the card's 34 TFLOP/s of
// float64 outside the tensor cores.  Bytes bound it.  PR 11's kernel ran
// a thread an edge, 64 blocks, each thread's 72 stores at strides of 168,
// 48 and 72 bytes: its stores took ~17,000 of a warp's ~20,600 cycles and
// the float64 rows ~1,100 (tools/kernel_split.py, PERF.md section 6).
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "ba_project.cuh"

namespace cg = cooperative_groups;

namespace {

using ba::add;
using ba::mul;

constexpr float kDeltaStereo = 2.795483f;
constexpr float kDeltaMono = 2.447749f;

// Gauss-Newton mode
constexpr int kLanes = 8;                 // lanes an edge
constexpr int kSlots = 7;                 // entries a lane, at most
constexpr int kRowThreads = 256;
constexpr int kRowEdges = kRowThreads / kLanes;
constexpr int kCols = 10;                 // A = [Jc (6) | Jp (3) | e]
constexpr int kNone = 127;                // a plan word's empty second place
// cost mode
constexpr int kCostThreads = 128;
// cost-sum mode
constexpr int kSumCluster = 8;
constexpr int kSumThreads = 1024;         // lm_cost_ref's partials
constexpr int kOwned = kSumThreads / kSumCluster;   // partials a block
constexpr int kSumRows = kSumThreads / kOwned;      // terms a partial a chunk
constexpr int kChunk = kSumRows * kSumThreads;
constexpr float kNonFinite = 1e30f;

struct Consts {
  ba::Intrinsics cam;
  float scale;
};

// A lane's entries: word s of lane l is plan[l * kSlots + s], -1 for none,
// else q | p << 4 | first place << 8 | second place << 15 | negate << 22
// (ops/ba_static.py gn_lane_plan).
struct Plan {
  int32_t word[kLanes * kSlots];
};

struct Edge {
  ba::Projection pr;
  float chi2, factor, rho;
};

__device__ __forceinline__ void edge(
    int64_t i, const float* __restrict__ R, const float* __restrict__ t,
    const float* __restrict__ pts, const int32_t* __restrict__ e_cam,
    const int32_t* __restrict__ e_pt, const float* __restrict__ obs,
    const float* __restrict__ info, const Consts& k, int huber, Edge& ed) {
  const int64_t c = e_cam[i], p = e_pt[i];
  ba::project(R + 9 * c, t + 3 * c, pts + 3 * p, obs + 3 * i, k.cam, ed.pr);
  ed.chi2 = mul(mul(ba::sqnorm3(ed.pr.e), info[i]), k.scale);
  ed.factor = 1.0f;
  ed.rho = ed.chi2;
  if (huber)
    ba::huber(ed.chi2, ed.pr.stereo ? kDeltaStereo : kDeltaMono, &ed.factor,
              &ed.rho);
}

// count floats from shared src to global dst, 16 bytes a thread where
// both are 16-byte aligned (dst is: the block's first edge is a multiple
// of kRowEdges), the tail one by one
__device__ __forceinline__ void copy_out(float* __restrict__ dst,
                                         const float* __restrict__ src,
                                         int count) {
  const int n4 = count / 4;
  float4* d4 = reinterpret_cast<float4*>(dst);
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int k = threadIdx.x; k < n4; k += kRowThreads) d4[k] = s4[k];
  for (int k = 4 * n4 + threadIdx.x; k < count; k += kRowThreads)
    dst[k] = src[k];
}

__global__ void __launch_bounds__(kRowThreads)
static_rows_kernel(const float* __restrict__ R, const float* __restrict__ t,
                   const float* __restrict__ pts,
                   const int32_t* __restrict__ e_cam,
                   const int32_t* __restrict__ e_pt,
                   const float* __restrict__ obs,
                   const float* __restrict__ info,
                   const float* __restrict__ active, int n, Consts k,
                   int huber, const Plan plan, float* __restrict__ cam,
                   float* __restrict__ pt, float* __restrict__ pc) {
  __shared__ __align__(16) float cam_s[kRowEdges * 42];
  __shared__ __align__(16) float pt_s[kRowEdges * 12];
  __shared__ __align__(16) float pc_s[kRowEdges * 18];
  __shared__ float a_s[kRowEdges][3 * kCols];
  __shared__ int32_t plan_s[kLanes * kSlots];
  const int sub = threadIdx.x % kLanes;
  const int le = threadIdx.x / kLanes;
  const int first = blockIdx.x * kRowEdges;
  const int i = first + le;
  const int nb = min(kRowEdges, n - first);
  if (threadIdx.x < kLanes * kSlots) plan_s[threadIdx.x] = plan.word[threadIdx.x];
  float w = 0.0f;
  if (i < n) {
    Edge ed;
    edge(i, R, t, pts, e_cam, e_pt, obs, info, k, huber, ed);
    const float base = mul(info[i], k.scale);
    w = mul(huber ? mul(base, ed.factor) : base, active[i]);
    if (sub == 0) {
      float* a = a_s[le];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int q = 0; q < 6; ++q) a[r * kCols + q] = ed.pr.Jc[r][q];
#pragma unroll
        for (int q = 0; q < 3; ++q) a[r * kCols + 6 + q] = ed.pr.Jp[r][q];
        a[r * kCols + 9] = ed.pr.e[r];
      }
    }
  }
  __syncthreads();
  if (i < n) {
    const float* a = a_s[le];
    const double wd = w;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int32_t word = plan_s[sub * kSlots + s];
      if (word < 0) continue;
      const int q = word & 15, p = (word >> 4) & 15;
      double acc = __dmul_rn(__dmul_rn(wd, a[q]), a[p]);
      acc = __dadd_rn(acc, __dmul_rn(__dmul_rn(wd, a[kCols + q]),
                                     a[kCols + p]));
      acc = __dadd_rn(acc, __dmul_rn(__dmul_rn(wd, a[2 * kCols + q]),
                                     a[2 * kCols + p]));
      const float v = __double2float_rn((word >> 22) & 1 ? -acc : acc);
#pragma unroll
      for (int place = 0; place < 2; ++place) {
        const int d = (word >> (8 + 7 * place)) & 127;
        if (d == kNone) continue;
        float* dst = d < 42 ? cam_s + le * 42 + d
                   : d < 54 ? pt_s + le * 12 + (d - 42)
                            : pc_s + le * 18 + (d - 54);
        *dst = v;
      }
    }
  }
  __syncthreads();
  copy_out(cam + 42 * int64_t{first}, cam_s, 42 * nb);
  copy_out(pt + 12 * int64_t{first}, pt_s, 12 * nb);
  copy_out(pc + 18 * int64_t{first}, pc_s, 18 * nb);
}

__global__ void __launch_bounds__(kCostThreads)
static_cost_kernel(const float* __restrict__ R, const float* __restrict__ t,
                   const float* __restrict__ pts,
                   const int32_t* __restrict__ e_cam,
                   const int32_t* __restrict__ e_pt,
                   const float* __restrict__ obs,
                   const float* __restrict__ info, int n, Consts k,
                   int huber, float* __restrict__ rho,
                   float* __restrict__ chi2, float* __restrict__ z) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kCostThreads +
                    threadIdx.x;
  if (i >= n) return;
  Edge ed;
  edge(i, R, t, pts, e_cam, e_pt, obs, info, k, huber, ed);
  rho[i] = ed.rho;
  chi2[i] = ed.chi2;
  z[i] = ed.pr.z;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__global__ void __cluster_dims__(kSumCluster, 1, 1)
__launch_bounds__(kSumThreads, 1)
static_cost_sum_kernel(const float* __restrict__ R,
                       const float* __restrict__ t,
                       const float* __restrict__ pts,
                       const int32_t* __restrict__ e_cam,
                       const int32_t* __restrict__ e_pt,
                       const float* __restrict__ obs,
                       const float* __restrict__ info,
                       const float* __restrict__ active, int n, Consts k,
                       int huber, float* __restrict__ out) {
  __shared__ float terms[kSumRows][kOwned];  // a chunk's terms of the block
  __shared__ float partial[kSumThreads];     // the leader's: every partial
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();                  // this block has started
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int col = tid % kOwned, row = tid / kOwned;
  const int j = rank * kOwned + col;         // the partial of this thread
  float acc = 0.0f;                          // partial j, on threads < kOwned
  for (int64_t base = 0; base < n; base += kChunk) {
    const int64_t i = base + static_cast<int64_t>(row) * kSumThreads + j;
    float term = 0.0f;                       // past n: the plain version's pad
    if (i < n) {
      Edge ed;
      edge(i, R, t, pts, e_cam, e_pt, obs, info, k, huber, ed);
      term = __fmul_rn(isfinite(ed.rho) ? ed.rho : kNonFinite, active[i]);
    }
    terms[row][col] = term;
    __syncthreads();
    if (row == 0) {
#pragma unroll
      for (int r = 0; r < kSumRows; ++r) acc = __fadd_rn(acc, terms[r][col]);
    }
    __syncthreads();                         // read before it is overwritten
  }
  cluster_wait();                            // every block has started
  if (row == 0) cluster.map_shared_rank(partial, 0)[j] = acc;
  cluster.sync();                            // the partials are in the leader
  if (rank != 0) return;
  for (int half = kSumThreads / 2; half >= 32; half /= 2) {
    if (tid < half) partial[tid] = __fadd_rn(partial[tid], partial[tid + half]);
    __syncthreads();
  }
  if (tid < 32) {                            // the last five halvings
    float v = partial[tid];
#pragma unroll
    for (int half = 16; half > 0; half /= 2)
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, half));
    if (tid == 0) *out = v;
  }
}

}  // namespace

// R [C, 3, 3], t [C, 3], pts [P, 3], obs [n, 3], info [n], active [n]
// (unread in cost mode) float32; e_cam, e_pt [n] int32; consts: fx, fy,
// cx, cy, bf, scale in host memory.  mode 0, Gauss-Newton: out0 [n, 42],
// out1 [n, 12], out2 [n, 18], plan: the lane plan's kLanes x kSlots words
// in host memory; mode 1, cost: out0 rho, out1 chi2, out2 z, each [n];
// mode 2, cost sum: out0 one float.  All float32 row-major.
extern "C" int airdos_static_edges(const void* R, const void* t,
                                   const void* pts, const void* e_cam,
                                   const void* e_pt, const void* obs,
                                   const void* info, const void* active,
                                   int n, const float* consts, int huber,
                                   int mode, const int32_t* plan,
                                   void* out0, void* out1, void* out2,
                                   void* stream) {
  const Consts k{{consts[0], consts[1], consts[2], consts[3], consts[4]},
                 consts[5]};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* x) { return static_cast<const float*>(x); };
  const auto i32 = [](const void* x) { return static_cast<const int32_t*>(x); };
  if (n < 0) n = 0;
  if (mode == 2) {
    static_cost_sum_kernel<<<kSumCluster, kSumThreads, 0, s>>>(
        f(R), f(t), f(pts), i32(e_cam), i32(e_pt), f(obs), f(info),
        f(active), n, k, huber, static_cast<float*>(out0));
    return static_cast<int>(cudaGetLastError());
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (mode == 1) {
    static_cost_kernel<<<(n + kCostThreads - 1) / kCostThreads,
                         kCostThreads, 0, s>>>(
        f(R), f(t), f(pts), i32(e_cam), i32(e_pt), f(obs), f(info), n, k,
        huber, static_cast<float*>(out0), static_cast<float*>(out1),
        static_cast<float*>(out2));
    return static_cast<int>(cudaGetLastError());
  }
  if (mode != 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  for (int w = 0; w < kLanes * kSlots; ++w) p.word[w] = plan[w];
  static_rows_kernel<<<(n + kRowEdges - 1) / kRowEdges, kRowThreads, 0, s>>>(
      f(R), f(t), f(pts), i32(e_cam), i32(e_pt), f(obs), f(info), f(active),
      n, k, huber, p, static_cast<float*>(out0), static_cast<float*>(out1),
      static_cast<float*>(out2));
  return static_cast<int>(cudaGetLastError());
}
