// The human BA's three edge families in one launch, for sm_90a: joint
// projections, limb rigidity and constant-velocity motion, each edge's
// residual, Jacobian, Huber weight and its entries of the normal
// equations, or its robust cost.
//
// Replaces airdos_tpu/solvers/human_ba.py:188 residuals (the human half)
// and gn_step :257-301 (the family weights, J_m, J_r and the scatter
// helper's products): XLA fusions of gathers, stacks and einsums.  The
// port's plain version is ops/ba_human.py human_edges_ref; eager, ~120
// launches a call.  Threads 0 .. Eh - 1 take the projections, the next Er
// the rigidity edges, the last Em the motion edges:
//
//   projection: csrc/ba_project.cuh's e, Jc, Jp of the joint seen from
//     its camera; chi2 = (e.e) SigmaHuman; J = [Jc | Jp] [3 x 9];
//   rigidity: d = p1 - p2, dist = sqrt((d.d) + 1e-12), er = dist - limb,
//     u = d / dist, chi2 = (er er) SigmaRigidity; J = [u, -u, -1] [1 x 7];
//   motion: v = p2 - t dt, xm = R^T v (each entry ((R_0i v0 + R_1i v1) +
//     R_2i v2)), em = p1 - xm, chi2 = (em.em) SigmaMotion; J = [I, -R^T,
//     R^T dt, -[xm]x] [3 x 12];
//   Huber (huber != 0): the family's delta, factor delta / sq past it;
//     w = (sigma factor) active, or sigma active;
//   Gauss-Newton mode: the edge's J^T w J (row-major) at the family's
//     offset in the column plus q q edge, its -J^T w e after every
//     family's J^T w J, each entry summed over the residual's rows in
//     order after the products (w J) J (ba_project.cuh normal_rows);
//   cost mode: rho and chi2 at the edge's place among all edges, and
//     each projection's depth.
//
// Exact: every product and sum is an __fmul_rn / __fadd_rn / __fsub_rn,
// the divisions and square roots correctly rounded (__fdiv_rn,
// __fsqrt_rn), in the plain version's order; so the outputs are bit-equal
// to it.
//
// What bounds it on an H100.  Bytes: the crowd-27 flagship (T = 8
// trajectories x L = 8 poses: 896 projection, 896 rigidity and 280 motion
// edges) writes 90 + 56 + 156 floats an edge, ~0.7 MB, and reads ~60 kB:
// ~0.2 us at 3.35 TB/s.  Operations: ~1,000 (projection), ~400 (rigidity)
// and ~1,000 (motion) float32 operations an edge, ~1.6 MFLOP, ~0.03 us at
// 67 TFLOP/s.  Bytes bound it; with 2,072 threads the launch and each
// thread's serial chain of products set its time.  A thread writes its
// edge's entries in order, so a warp's stores are strided by an edge's
// width: whole sectors are written only after L2 merges them.
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

constexpr int kThreads = 128;

struct Consts {
  ba::Intrinsics cam;
  float sigma[3];   // SigmaHuman, SigmaRigidity, SigmaMotion
  float delta[3];   // the families' Huber deltas
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

__global__ void __launch_bounds__(kThreads)
human_edges_kernel(const float* __restrict__ camR,
                   const float* __restrict__ camt,
                   const float* __restrict__ joints,
                   const float* __restrict__ seg_len,
                   const float* __restrict__ motR,
                   const float* __restrict__ mott, Tables tb, int Eh, int Er,
                   int Em, Consts k, int huber, int cost_mode,
                   float* __restrict__ out0, float* __restrict__ out1,
                   float* __restrict__ out2) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= Eh + Er + Em) return;
  const int fam = idx < Eh ? 0 : (idx < Eh + Er ? 1 : 2);
  const int i = idx - (fam == 0 ? 0 : (fam == 1 ? Eh : Eh + Er));
  // offsets of the family's J^T w J blocks and -J^T w e rows in the column
  const int64_t h_off[3] = {0, 81 * int64_t{Eh}, 81 * int64_t{Eh} + 49 * int64_t{Er}};
  const int64_t b_base = h_off[2] + 144 * int64_t{Em};
  const int64_t b_off[3] = {b_base, b_base + 9 * int64_t{Eh},
                            b_base + 9 * int64_t{Eh} + 7 * int64_t{Er}};

  float chi2, z = 0.0f;
  float e3[3], e1[1];
  float J3x9[3][9], J1x7[1][7], J3x12[3][12];
  if (fam == 0) {
    const int64_t c = tb.hp_cam[i], j = tb.hp_joint[i];
    ba::Projection pr;
    ba::project(camR + 9 * c, camt + 3 * c, joints + 3 * j,
                tb.hp_obs + 3 * int64_t{i}, k.cam, pr);
    chi2 = mul(ba::sqnorm3(pr.e), k.sigma[0]);
    z = pr.z;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      e3[r] = pr.e[r];
#pragma unroll
      for (int q = 0; q < 6; ++q) J3x9[r][q] = pr.Jc[r][q];
#pragma unroll
      for (int q = 0; q < 3; ++q) J3x9[r][6 + q] = pr.Jp[r][q];
    }
  } else if (fam == 1) {
    const float* p1 = joints + 3 * int64_t{tb.rg_j1[i]};
    const float* p2 = joints + 3 * int64_t{tb.rg_j2[i]};
    const float d[3] = {sub(p1[0], p2[0]), sub(p1[1], p2[1]),
                        sub(p1[2], p2[2])};
    const float dist = __fsqrt_rn(add(ba::sqnorm3(d), 1e-12f));
    e1[0] = sub(dist, seg_len[tb.rg_seg[i]]);
    chi2 = mul(mul(e1[0], e1[0]), k.sigma[1]);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float u = __fdiv_rn(d[q], dist);
      J1x7[0][q] = u;
      J1x7[0][3 + q] = -u;
    }
    J1x7[0][6] = -1.0f;
  } else {
    const int64_t tr = tb.mo_traj[i];
    const float* R = motR + 9 * tr;
    const float* t = mott + 3 * tr;
    const float dt = tb.mo_dt[i];
    const float* p1 = joints + 3 * int64_t{tb.mo_j1[i]};
    const float* p2 = joints + 3 * int64_t{tb.mo_j2[i]};
    float v[3], xm[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) v[r] = sub(p2[r], mul(t[r], dt));
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      xm[r] = add(add(mul(R[r], v[0]), mul(R[3 + r], v[1])),
                  mul(R[6 + r], v[2]));
      e3[r] = sub(p1[r], xm[r]);
    }
    chi2 = mul(ba::sqnorm3(e3), k.sigma[2]);
    // J = [I, -R^T, R^T dt, -[xm]x]; row r of R^T is column r of R
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        J3x12[r][q] = r == q ? 1.0f : 0.0f;
        J3x12[r][3 + q] = -R[3 * q + r];
        J3x12[r][6 + q] = mul(R[3 * q + r], dt);
      }
    }
    J3x12[0][9] = 0.0f;
    J3x12[0][10] = xm[2];
    J3x12[0][11] = -xm[1];
    J3x12[1][9] = -xm[2];
    J3x12[1][10] = 0.0f;
    J3x12[1][11] = xm[0];
    J3x12[2][9] = xm[1];
    J3x12[2][10] = -xm[0];
    J3x12[2][11] = 0.0f;
  }

  float factor = 1.0f, rho = chi2;
  if (huber) ba::huber(chi2, k.delta[fam], &factor, &rho);
  if (cost_mode) {
    out0[idx] = rho;
    out1[idx] = chi2;
    if (fam == 0) out2[i] = z;
    return;
  }
  const float sigma = k.sigma[fam];
  const float w = mul(huber ? mul(sigma, factor) : sigma, tb.act[fam][i]);
  if (fam == 0) {
    ba::normal_rows<3, 9>(J3x9, w, e3, out0 + h_off[0] + 81 * int64_t{i},
                          out0 + b_off[0] + 9 * int64_t{i});
  } else if (fam == 1) {
    ba::normal_rows<1, 7>(J1x7, w, e1, out0 + h_off[1] + 49 * int64_t{i},
                          out0 + b_off[1] + 7 * int64_t{i});
  } else {
    ba::normal_rows<3, 12>(J3x12, w, e3, out0 + h_off[2] + 144 * int64_t{i},
                           out0 + b_off[2] + 12 * int64_t{i});
  }
}

}  // namespace

// camR [C, 3, 3], camt [C, 3], joints [NJ, 3], seg_len [NS], motR [T, 3,
// 3], mott [T, 3], hp_obs [Eh, 3], mo_dt [Em], act_* [E*] (unread in cost
// mode) float32; hp_cam, hp_joint [Eh], rg_j1, rg_j2, rg_seg [Er], mo_j1,
// mo_j2, mo_traj [Em] int32; consts: fx, fy, cx, cy, bf, the three sigmas
// and the three Huber deltas in host memory.  Gauss-Newton mode: out0 the
// column [90 Eh + 56 Er + 156 Em]; cost mode: out0 rho, out1 chi2 [Eh + Er
// + Em], out2 the projections' depths [Eh].  All float32.
extern "C" int airdos_human_edges(
    const void* camR, const void* camt, const void* joints,
    const void* seg_len, const void* motR, const void* mott,
    const void* hp_cam, const void* hp_joint, const void* hp_obs,
    const void* rg_j1, const void* rg_j2, const void* rg_seg,
    const void* mo_j1, const void* mo_j2, const void* mo_traj,
    const void* mo_dt, const void* act_h, const void* act_r,
    const void* act_m, int Eh, int Er, int Em, const float* consts,
    int huber, int cost_mode, void* out0, void* out1, void* out2,
    void* stream) {
  const int n = Eh + Er + Em;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Consts k{{consts[0], consts[1], consts[2], consts[3], consts[4]},
                 {consts[5], consts[6], consts[7]},
                 {consts[8], consts[9], consts[10]}};
  const Tables tb{static_cast<const int32_t*>(hp_cam),
                  static_cast<const int32_t*>(hp_joint),
                  static_cast<const float*>(hp_obs),
                  static_cast<const int32_t*>(rg_j1),
                  static_cast<const int32_t*>(rg_j2),
                  static_cast<const int32_t*>(rg_seg),
                  static_cast<const int32_t*>(mo_j1),
                  static_cast<const int32_t*>(mo_j2),
                  static_cast<const int32_t*>(mo_traj),
                  static_cast<const float*>(mo_dt),
                  {static_cast<const float*>(act_h),
                   static_cast<const float*>(act_r),
                   static_cast<const float*>(act_m)}};
  human_edges_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(camR), static_cast<const float*>(camt),
      static_cast<const float*>(joints), static_cast<const float*>(seg_len),
      static_cast<const float*>(motR), static_cast<const float*>(mott), tb,
      Eh, Er, Em, k, huber, cost_mode, static_cast<float*>(out0),
      static_cast<float*>(out1), static_cast<float*>(out2));
  return static_cast<int>(cudaGetLastError());
}
