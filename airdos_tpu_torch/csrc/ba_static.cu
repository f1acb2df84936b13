// The static projection edges of the local and human BAs in one launch,
// for sm_90a: residual, Jacobians, Huber weight and the Gauss-Newton rows
// of every edge, or its robust cost.
//
// Replaces airdos_tpu/solvers/local_ba.py:43 _proj_residual and the
// weighted products of gn_step (:107-129), and the static half of
// airdos_tpu/solvers/human_ba.py:188 residuals and gn_step (:257-284):
// XLA fusions of gathers, stacks and einsums.  The port's plain version is
// ops/ba_static.py static_edges_ref; eager, it is ~150 launches a call.
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
//   cost mode: rho, chi2, z.
//
// One thread an edge: the camera's 12 floats and the point's 3 are read
// through L1 / L2 (many edges share them), the edge's 8 and its 72 row
// floats (GN) or 3 (cost) go to device memory.  Every rounding is the
// plain version's (ba_project.cuh says how; the float64 products and sums
// are __dmul_rn / __dadd_rn), so the outputs are bit-equal to it.
//
// What bounds it on an H100.  Bytes: at E = 8192 edges, C = 24, P = 2048,
// the edges' 32 bytes, the cameras and points once (~26 kB) and 288 bytes
// of rows an edge: ~2.6 MB, ~0.8 us at 3.35 TB/s.  Operations: ~100
// float32 and ~420 float64 operations an edge, 3.4 MFLOP of float64, ~0.1
// us at the card's 34 TFLOP/s of float64 outside the tensor cores.  Bytes
// bound it; at 64 blocks on 132 SMs the launch and each thread's serial
// chain of ~500 dependent operations set its time.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "ba_project.cuh"

namespace {

using ba::add;
using ba::mul;

constexpr int kThreads = 128;
constexpr float kDeltaStereo = 2.795483f;
constexpr float kDeltaMono = 2.447749f;

struct Consts {
  ba::Intrinsics cam;
  float scale;
};

__global__ void __launch_bounds__(kThreads)
static_edges_kernel(const float* __restrict__ R, const float* __restrict__ t,
                    const float* __restrict__ pts,
                    const int32_t* __restrict__ e_cam,
                    const int32_t* __restrict__ e_pt,
                    const float* __restrict__ obs,
                    const float* __restrict__ info,
                    const float* __restrict__ active, int n, Consts k,
                    int huber, int cost_mode, float* __restrict__ out0,
                    float* __restrict__ out1, float* __restrict__ out2) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t c = e_cam[i], p = e_pt[i];
  ba::Projection pr;
  ba::project(R + 9 * c, t + 3 * c, pts + 3 * p, obs + 3 * int64_t{i}, k.cam,
              pr);
  const float chi2 = mul(mul(ba::sqnorm3(pr.e), info[i]), k.scale);
  float factor = 1.0f, rho = chi2;
  if (huber)
    ba::huber(chi2, pr.stereo ? kDeltaStereo : kDeltaMono, &factor, &rho);
  if (cost_mode) {
    out0[i] = rho;
    out1[i] = chi2;
    out2[i] = pr.z;
    return;
  }
  const float base = mul(info[i], k.scale);
  const float w = mul(huber ? mul(base, factor) : base, active[i]);
  float* cam = out0 + 42 * int64_t{i};
  float* pt = out1 + 12 * int64_t{i};
  float* pc = out2 + 18 * int64_t{i};
  ba::normal_rows<3, 6>(pr.Jc, w, pr.e, cam, cam + 36);
  ba::normal_rows<3, 3>(pr.Jp, w, pr.e, pt, pt + 9);
  ba::weighted_cross<3, 6, 3>(pr.Jc, w, pr.Jp, pc);
}

}  // namespace

// R [C, 3, 3], t [C, 3], pts [P, 3], obs [n, 3], info [n], active [n]
// (unread in cost mode) float32; e_cam, e_pt [n] int32; consts: fx, fy,
// cx, cy, bf, scale in host memory.  Gauss-Newton mode (cost_mode 0):
// out0 [n, 42], out1 [n, 12], out2 [n, 18]; cost mode: out0 rho, out1
// chi2, out2 z, each [n].  All float32 row-major.
extern "C" int airdos_static_edges(const void* R, const void* t,
                                   const void* pts, const void* e_cam,
                                   const void* e_pt, const void* obs,
                                   const void* info, const void* active,
                                   int n, const float* consts, int huber,
                                   int cost_mode, void* out0, void* out1,
                                   void* out2, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Consts k{{consts[0], consts[1], consts[2], consts[3], consts[4]},
                 consts[5]};
  static_edges_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(R), static_cast<const float*>(t),
      static_cast<const float*>(pts), static_cast<const int32_t*>(e_cam),
      static_cast<const int32_t*>(e_pt), static_cast<const float*>(obs),
      static_cast<const float*>(info), static_cast<const float*>(active), n,
      k, huber, cost_mode, static_cast<float*>(out0),
      static_cast<float*>(out1), static_cast<float*>(out2));
  return static_cast<int>(cudaGetLastError());
}
